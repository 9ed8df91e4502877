"""Closed-form sampling routines on `jax.random` counter-based keys.

Replaces the reference's per-pixel curand streams (seed 1984, main.cu:127)
and its rejection-sampled unit-sphere/disk draws (Utils.h:69-78,96-104) with
closed-form inverse-CDF transforms — batched wavefronts cannot afford
divergent retry loops, and closed forms are also what makes the samplers
reparameterizable for gradients (sample = deterministic function of uniforms).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rtnw.config import DTYPE

TWO_PI = 6.283185307179586


def uniform(key, shape=(), lo=0.0, hi=1.0) -> jnp.ndarray:
    """U[lo, hi) — Utils::random(randState, min, max) (Utils.h:53-59)."""
    return jax.random.uniform(key, shape, dtype=DTYPE, minval=lo, maxval=hi)


def in_unit_disk(key, shape=()) -> jnp.ndarray:
    """Uniform in the unit disk, returned as (..., 2).

    Closed form r=sqrt(u1), phi=2*pi*u2 — same distribution as the rejection
    loop Utils::randomInUnitDisk (Utils.h:96-104) without divergence.
    """
    u = jax.random.uniform(key, (*shape, 2), dtype=DTYPE)
    r = jnp.sqrt(u[..., 0])
    phi = TWO_PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def unit_vector(key, shape=()) -> jnp.ndarray:
    """Uniform direction on the unit sphere as (..., 3).

    Closed form z=1-2u1, phi=2*pi*u2 — distribution of
    Utils::randomUnitVector (Utils.h:80-94, normalize of in-sphere point).
    """
    u = jax.random.uniform(key, (*shape, 2), dtype=DTYPE)
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def in_unit_sphere(key, shape=()) -> jnp.ndarray:
    """Uniform inside the unit ball as (..., 3).

    Direction * cbrt(u) — distribution of the rejection loop
    Utils::randomInUnitSphere (Utils.h:69-78). Used for metal fuzz
    (Material.h:47).
    """
    kd, kr = jax.random.split(key)
    d = unit_vector(kd, shape)
    r = jnp.cbrt(jax.random.uniform(kr, shape, dtype=DTYPE))
    return d * r[..., None]


def hemisphere(key, normal: jnp.ndarray) -> jnp.ndarray:
    """Uniform direction in the hemisphere around `normal` (Utils.h randomHemiSphere)."""
    d = unit_vector(key, normal.shape[:-1])
    sign = jnp.where(jnp.sum(d * normal, axis=-1) > 0.0, 1.0, -1.0)
    return d * sign[..., None]


def orthonormal_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Branchless tangent frame (t, b) for unit normals `n` (..., 3).

    Frisvad/Pixar construction — replaces the axis-pick branch the reference
    uses to build its diffuse basis (CUDAPathTracer.cu:459-466).
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t0 = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    t1 = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t0, t1


def cosine_hemisphere_from_uniforms(u1, u2, normal: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted direction about `normal` from two uniforms
    (CUDAPathTracer.cu:455-476): phi=2*pi*u1, r=sqrt(u2),
    d = t*cos(phi)*r + b*sin(phi)*r + n*sqrt(1-u2)."""
    phi = TWO_PI * u1
    r2 = u2
    r = jnp.sqrt(r2)
    t, b = orthonormal_basis(normal)
    return (
        t * (jnp.cos(phi) * r)[..., None]
        + b * (jnp.sin(phi) * r)[..., None]
        + normal * jnp.sqrt(jnp.maximum(0.0, 1.0 - r2))[..., None]
    )


def cosine_hemisphere(key, normal: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted direction about `normal` (single-key convenience)."""
    u = jax.random.uniform(key, (*normal.shape[:-1], 2), dtype=DTYPE)
    return cosine_hemisphere_from_uniforms(u[..., 0], u[..., 1], normal)


def phong_lobe_from_uniforms(u1, u2, axis: jnp.ndarray, exponent) -> jnp.ndarray:
    """Phong-lobe direction about unit `axis` from two uniforms.

    Path B's METAL importance sample (CUDAPathTracer.cu:479-504):
    cos(alpha) = u1^(1/(exp+1)), phi = 2*pi*u2.
    """
    cos_a = jnp.power(u1, 1.0 / (exponent + 1.0))
    sin_a = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_a * cos_a))
    phi = TWO_PI * u2
    t, b = orthonormal_basis(axis)
    return (
        t * (jnp.cos(phi) * sin_a)[..., None]
        + b * (jnp.sin(phi) * sin_a)[..., None]
        + axis * cos_a[..., None]
    )


def phong_lobe(key, axis: jnp.ndarray, exponent: jnp.ndarray) -> jnp.ndarray:
    """Phong-lobe direction about `axis` (single-key convenience)."""
    u = jax.random.uniform(key, (*axis.shape[:-1], 2), dtype=DTYPE)
    return phong_lobe_from_uniforms(u[..., 0], u[..., 1], axis, exponent)
