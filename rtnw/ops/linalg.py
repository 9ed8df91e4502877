"""Vectorized 3D math over trailing-axis-3 arrays.

Replaces the reference's scalar `Vector3Df` class (LinearAlgebra.h:26-113),
the alternate `Vec3` (Vec3.h:10-142) and NVIDIA's cutil_math.h operator zoo
with plain jnp ops over `(..., 3)` arrays — SoA, branchless, fusible by XLA.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis (LinearAlgebra.h:58)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (LinearAlgebra.h:66-71)."""
    return jnp.cross(a, b)


def reciprocal(n: int) -> float:
    """1 / n rounded to f32, as an f32 division computes it."""
    return float(np.float32(1.0) / np.float32(n))


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(v, v))


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return dot(v, v)


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Safe normalize: guards the zero vector so autodiff stays finite.

    (The reference divides by length unguarded, LinearAlgebra.h:80-86; the
    guard only changes behavior on the measure-zero degenerate input.)
    """
    norm_sq = length_squared(v)
    safe = jnp.where(norm_sq > 0.0, norm_sq, 1.0)
    inv = jnp.where(norm_sq > 0.0, 1.0 / jnp.sqrt(safe), 0.0)
    return v * inv[..., None]


def lerp(a: jnp.ndarray, b: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """a + t*(b-a) (LinearAlgebra.h lerp; used for sky at main.cu:88)."""
    return a + t * (b - a)


def near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """True where all components are < 1e-8 in magnitude (Utils.h:106-110)."""
    return jnp.all(jnp.abs(v) < 1e-8, axis=-1)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection v - 2*dot(v,n)*n (Utils.h:112-114)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: jnp.ndarray, n: jnp.ndarray, eta_ratio: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction of unit vector `uv` about `n` (Utils.h:116-121).

    `eta_ratio` broadcasts against the batch; caller guarantees refraction is
    geometrically possible (total internal reflection is decided upstream,
    Material.h:73-91). The sqrt argument is clamped so autodiff stays finite
    at grazing angles.
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    k = 1.0 - length_squared(r_out_perp)
    pos = k > 0.0
    r_parallel_mag = jnp.where(pos, jnp.sqrt(jnp.where(pos, k, 1.0)), 0.0)
    return r_out_perp - r_parallel_mag[..., None] * n


def rotate_y(v: jnp.ndarray, degrees) -> jnp.ndarray:
    """Rotate about +Y by degrees (LinearAlgebra.h rotateY; ModelLoader.cpp:441)."""
    rad = jnp.deg2rad(jnp.asarray(degrees, dtype=v.dtype))
    c, s = jnp.cos(rad), jnp.sin(rad)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([c * x + s * z, y, -s * x + c * z], axis=-1)
