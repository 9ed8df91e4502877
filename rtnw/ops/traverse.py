"""Batched BVH traversal as a lockstep wavefront while_loop.

Replaces the per-thread stack megakernel traversal BVH_IntersectTriangles
(CUDAPathTracer.cu:192-352): every ray in the wavefront carries its own
short stack as a row of an (N, STACK) array, and one `lax.while_loop` steps
all rays together until every stack is empty. Divergence is masked, not
branched; ordered (near-child-first) descent plus best-t-bounded AABB tests
give the same early-out the reference gets from its explicit stack.

The reference's `avoidSelf` previous-triangle exclusion
(CUDAPathTracer.cu:290-291) is unnecessary here: the integrator re-bases
rays with tmin = Math::epsilon like Path A does (main.cu:69).

Differentiability: the returned t/normal are functions of the *gathered*
triangle vertices (Möller–Trumbore), so gradients flow to vertices; boxes
and the winner selection are discrete and gradient-free by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtnw.config import FLT_EPSILON
from rtnw.ops import linalg
from rtnw.ops.bvh import BVH
from rtnw.ops.geometry import Triangles
from rtnw.ops.rays import Hit, Rays, face_normal

# Karras trees over <= 2^20 triangles stay far below this; the reference
# budgets 32 (BVH_STACK_SIZE, CUDAPathTracer.cu:42) for its >=4-triangle
# leaves — single-triangle leaves need more headroom.
STACK_SIZE = 64


class _State(NamedTuple):
    stack: jnp.ndarray   # (N, STACK) int32
    sp: jnp.ndarray      # (N,) int32
    best_t: jnp.ndarray  # (N,)
    best_u: jnp.ndarray  # (N,)
    best_v: jnp.ndarray  # (N,)
    best_tri: jnp.ndarray  # (N,) int32 — winning *original* triangle index


def _slab_test(origin, inv_dir, lo, hi, tmin, tmax):
    """Branchless AABB slab test (min/max form).

    Replaces the sign-indexed branchy slab test (AABBox.h:28-69 and
    RayIntersectsBox CUDAPathTracer.cu:124-181) with the standard
    min/max formulation that vectorizes cleanly. Returns (hit, t_entry).
    IEEE inf semantics handle axis-parallel rays.
    """
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax)
    return hit, t_near


def _mt_single(origin, direction, v0, v1, v2, tmin, tmax, backface_cull):
    """Möller–Trumbore for one triangle per ray (all (N, 3) inputs)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = linalg.cross(direction, e2)
    det = linalg.dot(e1, pvec)
    det_ok = det > FLT_EPSILON if backface_cull else jnp.abs(det) > FLT_EPSILON
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    tvec = origin - v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(direction, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    valid = (
        det_ok
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin) & (t < tmax)
    )
    return t, u, v, valid


def traverse(rays: Rays, triangles: Triangles, bvh: BVH, tmin, tmax,
             backface_cull: bool = True):
    """Closest-hit traversal. Returns (best_t, best_tri, u, v) per ray;
    best_tri == -1 on miss."""
    n = rays.count
    num_internal = bvh.num_internal
    inv_dir = 1.0 / rays.direction  # inf on zero components is fine for slabs
    rows = jnp.arange(n)

    state = _State(
        stack=jnp.zeros((n, STACK_SIZE), jnp.int32),
        sp=jnp.ones((n,), jnp.int32),  # stack[:, 0] = 0 = root
        best_t=jnp.full((n,), tmax, rays.origin.dtype),
        best_u=jnp.zeros((n,), rays.origin.dtype),
        best_v=jnp.zeros((n,), rays.origin.dtype),
        best_tri=jnp.full((n,), -1, jnp.int32),
    )

    verts = triangles.vertices

    def cond(s: _State):
        return jnp.any(s.sp > 0)

    def body(s: _State) -> _State:
        active = s.sp > 0
        top = jnp.maximum(s.sp - 1, 0)
        node = jnp.where(active, s.stack[rows, top], 0)
        sp = jnp.where(active, s.sp - 1, s.sp)

        is_leaf = node >= num_internal

        # ---- internal: test both children, push far then near ----
        inner = jnp.clip(node, 0, max(num_internal - 1, 0))
        lchild = bvh.left[inner]
        rchild = bvh.right[inner]
        lhit, lt = _slab_test(
            rays.origin, inv_dir, bvh.node_lo[lchild], bvh.node_hi[lchild],
            tmin, s.best_t,
        )
        rhit, rt = _slab_test(
            rays.origin, inv_dir, bvh.node_lo[rchild], bvh.node_hi[rchild],
            tmin, s.best_t,
        )
        left_near = lt <= rt
        near = jnp.where(left_near, lchild, rchild)
        far = jnp.where(left_near, rchild, lchild)
        near_hit = jnp.where(left_near, lhit, rhit)
        far_hit = jnp.where(left_near, rhit, lhit)

        do_inner = active & ~is_leaf
        push_far = do_inner & far_hit
        stack = s.stack.at[rows, sp].set(
            jnp.where(push_far, far, s.stack[rows, sp])
        )
        sp = sp + push_far
        push_near = do_inner & near_hit
        stack = stack.at[rows, sp].set(
            jnp.where(push_near, near, stack[rows, sp])
        )
        sp = sp + push_near

        # ---- leaf: Möller–Trumbore on the leaf triangle ----
        leaf_pos = jnp.clip(node - num_internal, 0, bvh.num_leaves - 1)
        tri = bvh.tri_order[leaf_pos]
        tv = verts[tri]  # (N, 3, 3)
        t, u, v, valid = _mt_single(
            rays.origin, rays.direction, tv[:, 0], tv[:, 1], tv[:, 2],
            tmin, s.best_t, backface_cull,
        )
        win = active & is_leaf & valid
        return _State(
            stack=stack,
            sp=sp,
            best_t=jnp.where(win, t, s.best_t),
            best_u=jnp.where(win, u, s.best_u),
            best_v=jnp.where(win, v, s.best_v),
            best_tri=jnp.where(win, tri, s.best_tri),
        )

    final = jax.lax.while_loop(cond, body, state)
    return final.best_t, final.best_tri, final.best_u, final.best_v


def intersect_bvh(rays: Rays, triangles: Triangles, bvh: BVH, tmin, tmax,
                  backface_cull: bool = True) -> Hit:
    """BVH-accelerated closest hit over a triangle soup, as a Hit record.

    Recomputes t/normal from the winning triangle's vertices (not the
    traversal temporaries) so the values carry vertex gradients.
    """
    # Selection only: no tangents enter the while_loop, so reverse mode
    # never has to differentiate it.
    best_t, best_tri, _, _ = traverse(
        *jax.lax.stop_gradient((rays, triangles)), bvh, tmin, tmax,
        backface_cull,
    )
    valid = best_tri >= 0
    tri = jnp.maximum(best_tri, 0)
    tv = triangles.vertices[tri]
    t, _, _, _ = _mt_single(
        rays.origin, rays.direction, tv[:, 0], tv[:, 1], tv[:, 2],
        tmin, jnp.inf, backface_cull,
    )
    t = jnp.where(valid, t, jnp.inf)
    geom_n = linalg.normalize(
        linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    )
    front, normal = face_normal(rays.direction, geom_n)
    material_id = jnp.where(valid, triangles.material_id[tri], -1).astype(jnp.int32)
    return Hit(
        t=t,
        normal=jnp.where(valid[..., None], normal, 0.0),
        front_face=front & valid,
        material_id=material_id,
        valid=valid,
    )
