"""Batched ray-primitive intersection.

Each function intersects a wavefront of R rays against all primitives of one
type at once ((R, P) broadcast) and reduces to the per-ray closest
hit. This replaces the reference's per-object virtual `Hitable::hit` loop
(main.cu:43-57) — the loop over objects becomes an argmin over an axis.

Gradients: `t`, `normal` and hit positions are differentiable wrt sphere
centers/radii, plane positions and triangle vertices; the *selection* of the
closest primitive is discrete and therefore piecewise-constant (correct a.e.).
"""

from __future__ import annotations

import jax.numpy as jnp

from rtnw.config import EPSILON, FLT_EPSILON
from rtnw.ops import linalg
from rtnw.ops.geometry import (
    PLANE_XY,
    PLANE_XZ,
    PLANE_YZ,
    Planes,
    Spheres,
    Triangles,
)
from rtnw.ops.rays import Hit, Rays, face_normal


def _reduce_closest(
    rays: Rays,
    t: jnp.ndarray,          # (R, P) candidate distances
    valid: jnp.ndarray,      # (R, P)
    outward_fn,              # (r_idx arrays) -> outward normals for winners
    material_id: jnp.ndarray,  # (P,) int32
) -> Hit:
    """Select the per-ray closest valid candidate and build the Hit record."""
    t_masked = jnp.where(valid, t, jnp.inf)
    best = jnp.argmin(t_masked, axis=-1)                       # (R,)
    r_idx = jnp.arange(t.shape[0])
    best_t = t_masked[r_idx, best]                             # (R,)
    any_valid = jnp.isfinite(best_t)
    outward = outward_fn(r_idx, best, jnp.where(any_valid, best_t, 0.0))
    front, normal = face_normal(rays.direction, outward)
    return Hit(
        t=best_t,
        normal=jnp.where(any_valid[..., None], normal, 0.0),
        front_face=front & any_valid,
        material_id=jnp.where(any_valid, material_id[best], -1).astype(jnp.int32),
        valid=any_valid,
    )


def intersect_spheres(rays: Rays, spheres: Spheres, tmin, tmax) -> Hit:
    """Quadratic sphere test, nearest-root-in-range (Sphere.cu:3-78).

    Static and moving spheres share one code path: the center is evaluated at
    each ray's shutter time (constant for static spheres). Uses the half-b
    form with discriminant > FLT_EPSILON (Sphere.cu:11 — Math::epsilon is
    "not precise enough" per the reference comment). Negative radii flip the
    outward normal via division by the signed radius (Sphere.cu:32).
    """
    centers = spheres.center_at(rays.time)                     # (R, S, 3)
    oc = rays.origin[:, None, :] - centers                     # (R, S, 3)
    d = rays.direction[:, None, :]                             # (R, 1, 3)
    a = linalg.length_squared(rays.direction)[:, None]         # (R, 1)
    half_b = linalg.dot(oc, d)                                 # (R, S)
    c = linalg.length_squared(oc) - spheres.radius[None, :] ** 2
    disc = half_b * half_b - a * c
    has_root = disc > FLT_EPSILON
    sqrt_disc = jnp.sqrt(jnp.where(has_root, disc, 1.0))
    inv_a = 1.0 / a
    root0 = (-half_b - sqrt_disc) * inv_a
    root1 = (-half_b + sqrt_disc) * inv_a
    in0 = (root0 >= tmin) & (root0 <= tmax)
    in1 = (root1 >= tmin) & (root1 <= tmax)
    t = jnp.where(in0, root0, root1)
    valid = has_root & (in0 | in1)

    def outward(r_idx, best, best_t):
        pos = rays.at(best_t)                                   # (R, 3)
        center = centers[r_idx, best]                           # (R, 3)
        return (pos - center) / spheres.radius[best][..., None]

    return _reduce_closest(rays, t, valid, outward, spheres.material_id)


def intersect_planes(rays: Rays, planes: Planes, tmin, tmax) -> Hit:
    """Finite axis-oriented plane test (Plane.cu:4-52).

    t = dot(position - origin, n) / dot(d, n); the denominator gate is
    |d.n| > Math::epsilon when two-sided else d.n > Math::epsilon; the finite
    extent is a strict 2-axis interval test selected by `orientation`. Note
    the reference's asymmetry: t in [tMin, tMax) (Plane.cu:48) vs the
    sphere's [tMin, tMax].
    """
    denom = linalg.dot(planes.normal[None, :, :], rays.direction[:, None, :])
    proceed = jnp.where(
        planes.two_sided[None, :], jnp.abs(denom) > EPSILON, denom > EPSILON
    )
    po = planes.position[None, :, :] - rays.origin[:, None, :]
    denom_safe = jnp.where(proceed, denom, 1.0)
    t = linalg.dot(po, planes.normal[None, :, :]) / denom_safe  # (R, P)
    hit_pos = rays.origin[:, None, :] + t[..., None] * rays.direction[:, None, :]
    lo = planes.position - planes.extend
    hi = planes.position + planes.extend
    inside = (hit_pos > lo[None, :, :]) & (hit_pos < hi[None, :, :])  # (R,P,3)
    in_x, in_y, in_z = inside[..., 0], inside[..., 1], inside[..., 2]
    orient = planes.orientation[None, :]
    in_range = jnp.where(
        orient == PLANE_XY,
        in_x & in_y,
        jnp.where(orient == PLANE_YZ, in_y & in_z, in_x & in_z),
    )
    valid = proceed & in_range & (t >= tmin) & (t < tmax)

    def outward(r_idx, best, best_t):
        return planes.normal[best]

    return _reduce_closest(rays, t, valid, outward, planes.material_id)


def moller_trumbore(
    rays: Rays, vertices: jnp.ndarray, tmin, tmax, backface_cull: bool = True
):
    """Möller–Trumbore over all (ray, triangle) pairs.

    vertices: (T, 3, 3). Returns (t, valid, geom_normal) with shapes
    ((R, T), (R, T), (T, 3)). Mirrors TriangleMesh.cu:57-80: backface cull
    via det > eps (the reference culls dot(d, E1 x E2) <= 0), strict
    barycentric bounds, t in (tmin, tmax).
    """
    v0 = vertices[:, 0, :]                                     # (T, 3)
    e1 = vertices[:, 1, :] - v0
    e2 = vertices[:, 2, :] - v0
    d = rays.direction[:, None, :]                             # (R, 1, 3)
    pvec = linalg.cross(d, e2[None, :, :])                     # (R, T, 3)
    det = linalg.dot(e1[None, :, :], pvec)                     # (R, T)
    if backface_cull:
        det_ok = det > FLT_EPSILON
    else:
        det_ok = jnp.abs(det) > FLT_EPSILON
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    tvec = rays.origin[:, None, :] - v0[None, :, :]            # (R, T, 3)
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1[None, :, :])                  # (R, T, 3)
    v = linalg.dot(d, qvec) * inv_det
    t = linalg.dot(e2[None, :, :], qvec) * inv_det
    valid = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    geom_normal = linalg.cross(e1, e2)                         # (T, 3) unnormalized
    return t, valid, geom_normal


def intersect_triangles(
    rays: Rays, triangles: Triangles, tmin, tmax, backface_cull: bool = True
) -> Hit:
    """Brute-force closest hit over a triangle soup (TriangleMesh.cu:34-117).

    The BVH path (ops/traverse.py) supersedes this for large meshes; this is
    the exact-reference-capability fallback and the oracle for BVH tests.
    """
    t, valid, geom_n = moller_trumbore(
        rays, triangles.vertices, tmin, tmax, backface_cull
    )

    def outward(r_idx, best, best_t):
        return linalg.normalize(geom_n[best])

    return _reduce_closest(rays, t, valid, outward, triangles.material_id)
