"""Counter-based per-ray RNG: pcg4d hash on (pixel, sample, bounce) counters.

The reference gives every pixel a curand stream (curand_init(1984, pixel),
main.cu:127) and draws sequentially. Here a draw is a pure function of
(seed, sample, pixel, bounce) — device-placement independent, so
tile-sharded renders stay bit-identical to single-device renders — and the
hash is pcg4d [Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020]: 4 lanes of LCG + cross-feedback + xorshift, ~22 integer ops for 4
uniforms, far cheaper than folding a threefry key per ray and bounce.
pcg4d passes BigCrush-style batteries in the paper's evaluation and is the
de-facto shader-path-tracer standard.

The hash input is (pixel_id, base0, counter, base1) where (base0, base1)
are the two uint32 words of a jax.random key — the public API stays keyed;
only the per-ray inner loop leaves threefry-land. The same jnp code runs
inside the megastep kernel (ops/pallas/bounce_kernel.py), which generates
its uniforms in registers and so consumes the XLA engine's exact stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from typing import NamedTuple

# Distinct counter domains so raygen and bounce draws never collide:
# bounce b uses counter = b + 1 (1..bounces); raygen uses these.
RAYGEN_DOMAIN = jnp.uint32(0x9E3779B9)
RAYGEN_DOMAIN2 = jnp.uint32(0x85EBCA6B)

# Plain Python float: a jnp constant would be a captured tracer when this
# runs inside a Pallas kernel (to_uniform is shared by both engines).
_U24_INV = 1.0 / 16777216.0  # 2^-24, exactly representable


class RayCtx(NamedTuple):
    """Per-wavefront RNG context threaded through the integrator.

    pixel_id: (N,) uint32 — global pixel index of each ray (stable under
        sharding: a tile render passes its global ids, so randomness never
        depends on device placement).
    base0/base1: () or (N,) uint32 — the two words of the per-sample
        jax.random key (seed, pass and sample index all folded in by the
        caller's split/fold_in tree). Scalar for a single-sample wavefront;
        consumers broadcast them against pixel_id.
    """

    pixel_id: jnp.ndarray
    base0: jnp.ndarray
    base1: jnp.ndarray


def key_bases(key) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The two uint32 words of a (possibly batched) jax.random key."""
    data = jax.random.key_data(key)
    return data[..., 0].astype(jnp.uint32), data[..., 1].astype(jnp.uint32)


def pcg4d(a, b, c, d):
    """pcg4d hash: 4 uint32 arrays in, 4 decorrelated uint32 arrays out."""
    a = a * jnp.uint32(1664525) + jnp.uint32(1013904223)
    b = b * jnp.uint32(1664525) + jnp.uint32(1013904223)
    c = c * jnp.uint32(1664525) + jnp.uint32(1013904223)
    d = d * jnp.uint32(1664525) + jnp.uint32(1013904223)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def to_uniform(u):
    """uint32 -> float32 in [0, 1): top 24 bits scaled by 2^-24.

    The uint32 is shifted into [0, 2^24) and converted via int32 (the value
    fits), the same conversion in both engines.
    """
    return (u >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * _U24_INV


def uniforms4(ctx: RayCtx, counter) -> jnp.ndarray:
    """(N, 4) uniforms for the given scalar/array uint32 counter."""
    pid = ctx.pixel_id.astype(jnp.uint32)
    cnt = jnp.broadcast_to(jnp.asarray(counter, jnp.uint32), pid.shape)
    a, b, c, d = pcg4d(
        pid,
        jnp.broadcast_to(ctx.base0, pid.shape),
        cnt,
        jnp.broadcast_to(ctx.base1, pid.shape),
    )
    return jnp.stack(
        [to_uniform(a), to_uniform(b), to_uniform(c), to_uniform(d)], axis=-1
    )


def bounce_uniforms(ctx: RayCtx, bounce_idx) -> jnp.ndarray:
    """(N, 4) uniforms for bounce `bounce_idx` (0-based) — slots 0-2 feed
    ops.materials.scatter, slot 3 Russian roulette."""
    return uniforms4(ctx, jnp.asarray(bounce_idx, jnp.uint32) + jnp.uint32(1))


def shutter_uniform(ctx: RayCtx) -> jnp.ndarray:
    """(N,) shutter-time uniform — raygen slot 4, from its own counter
    domain (the megastep draws it the same way)."""
    pid = ctx.pixel_id.astype(jnp.uint32)
    t, _, _, _ = pcg4d(
        pid,
        jnp.broadcast_to(ctx.base0, pid.shape),
        jnp.broadcast_to(RAYGEN_DOMAIN2, pid.shape),
        jnp.broadcast_to(ctx.base1, pid.shape),
    )
    return to_uniform(t)


def raygen_uniforms(ctx: RayCtx) -> jnp.ndarray:
    """(N, 5) uniforms for camera ray generation: pixel jitter (2),
    lens disk (2), shutter time (1)."""
    u4 = uniforms4(ctx, RAYGEN_DOMAIN)
    return jnp.concatenate([u4, shutter_uniform(ctx)[..., None]], axis=-1)


__all__ = [
    "RayCtx", "key_bases", "pcg4d", "to_uniform", "uniforms4",
    "bounce_uniforms", "raygen_uniforms", "shutter_uniform",
    "RAYGEN_DOMAIN", "RAYGEN_DOMAIN2",
]
