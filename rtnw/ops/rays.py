"""Ray and hit-record SoA pytrees.

Replaces Ray.h:7-27 (per-ray origin/direction/inverseDirection/signs/time
object) and HitResult.h:8-19 (t/normal/bFrontFace/Material*) with batched
NamedTuple pytrees. Material pointers become integer ids into the scene's
material table; inverse directions are computed where needed instead of being
carried (XLA CSEs the division).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rtnw.config import FLT_EPSILON


class Rays(NamedTuple):
    """A wavefront of N rays (SoA)."""

    origin: jnp.ndarray     # (N, 3)
    direction: jnp.ndarray  # (N, 3) — NOT necessarily unit length
    time: jnp.ndarray       # (N,)   — shutter sample for motion blur (Ray.h:24)

    def at(self, t: jnp.ndarray) -> jnp.ndarray:
        """origin + t * direction (Ray.h:21-23)."""
        return self.origin + t[..., None] * self.direction

    @property
    def count(self) -> int:
        return self.origin.shape[0]


class Hit(NamedTuple):
    """Closest-hit record for a wavefront of N rays (SoA).

    `t` is +inf where there is no hit; `material_id` is -1 there.
    """

    t: jnp.ndarray            # (N,)
    normal: jnp.ndarray       # (N, 3) — faceted toward the ray (HitResult.h:17)
    front_face: jnp.ndarray   # (N,) bool
    material_id: jnp.ndarray  # (N,) int32
    valid: jnp.ndarray        # (N,) bool

    @staticmethod
    def none(n: int, dtype=jnp.float32) -> "Hit":
        return Hit(
            t=jnp.full((n,), jnp.inf, dtype=dtype),
            normal=jnp.zeros((n, 3), dtype=dtype),
            front_face=jnp.zeros((n,), dtype=bool),
            material_id=jnp.full((n,), -1, dtype=jnp.int32),
            valid=jnp.zeros((n,), dtype=bool),
        )


def face_normal(ray_dir: jnp.ndarray, outward: jnp.ndarray):
    """(front_face, oriented_normal) — HitResult::setFaceNormal.

    front_face = dot(dir, outward) < FLT_EPSILON (HitResult.h:16 uses the
    machine epsilon, not Math::epsilon); the stored normal always opposes the
    incoming ray.
    """
    front = jnp.sum(ray_dir * outward, axis=-1) < FLT_EPSILON
    normal = jnp.where(front[..., None], outward, -outward)
    return front, normal


def closer(a: Hit, b: Hit) -> Hit:
    """Merge two hit records, keeping the nearer valid hit per ray.

    The batched analogue of the closest-so-far loop over `constantObjects`
    (main.cu:43-57).
    """
    take_b = b.valid & (~a.valid | (b.t < a.t))
    tb = take_b[..., None]
    return Hit(
        t=jnp.where(take_b, b.t, a.t),
        normal=jnp.where(tb, b.normal, a.normal),
        front_face=jnp.where(take_b, b.front_face, a.front_face),
        material_id=jnp.where(take_b, b.material_id, a.material_id),
        valid=a.valid | b.valid,
    )
