"""LBVH construction (Morton sort + Karras binary radix tree).

Replaces the reference's recursive host SAH builder + cache-friendly flatten
(BVH.cpp:94-497) with an array-friendly design:

* topology (child indices, leaf order) is built host-side in vectorized NumPy
  from Morton codes — O(T log T), milliseconds for the reference's meshes,
  and deterministic (no float-cost ties). This mirrors the reference's split
  of host build vs device traversal (BVH.cpp build -> CUDAPathTracer.cu
  traversal).
* AABBs live in flat (node_lo, node_hi) arrays — the analogue of the 32-byte
  CacheFriendlyBVHNode limits (BVH.h:46-67) — and can be *refit* under jit
  (`refit`) for moving geometry / inverse rendering without rebuilding
  topology. Gradients do not flow through boxes (selection only), matching
  the stop-gradient-the-selection rule.

Node id convention: ids [0, T-2] are internal nodes, ids [T-1, 2T-2] are
leaves; leaf id i holds triangle `tri_order[i - (T-1)]`. The root is node 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rtnw.config import DTYPE

MORTON_BITS = 10  # 10 bits/axis -> 30-bit codes (same granularity class as
                  # typical LBVH builders; reference SAH bins ~1024 too,
                  # BVH.cpp:171)


class BVH(NamedTuple):
    left: jnp.ndarray        # (I,) int32 — child node id
    right: jnp.ndarray       # (I,) int32
    node_lo: jnp.ndarray     # (I+T, 3) — internal then leaf boxes
    node_hi: jnp.ndarray     # (I+T, 3)
    tri_order: jnp.ndarray   # (T,) int32 — leaf i -> triangle tri_order[i]
    range_first: jnp.ndarray  # (I,) int32 — sorted-leaf range covered by node
    range_last: jnp.ndarray   # (I,) int32

    @property
    def num_internal(self) -> int:
        return self.left.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.tri_order.shape[0]


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits of v over 30 bits (bit i -> bit 3i)."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points normalized to the scene AABB."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.where(hi - lo > 0, hi - lo, 1.0)
    q = ((centroids - lo) / extent * (2**MORTON_BITS - 1)).astype(np.uint64)
    q = np.minimum(q, 2**MORTON_BITS - 1)
    return (
        (_expand_bits(q[:, 0]) << np.uint64(2))
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | _expand_bits(q[:, 2])
    )


def _floor_log2(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) for uint64 x > 0, exact (no float round-off)."""
    x = x.astype(np.uint64)
    result = np.zeros(x.shape, np.int64)
    cur = x.copy()
    for s in (32, 16, 8, 4, 2, 1):
        mask = (cur >> np.uint64(s)) != 0
        result[mask] += s
        cur = np.where(mask, cur >> np.uint64(s), cur)
    return result


def _karras_topology(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized Karras 2012 binary radix tree over sorted unique codes.

    codes: (T,) uint64, strictly increasing (caller augments with index bits).
    Returns (left, right) child node ids with the id convention above.
    """
    T = codes.shape[0]
    I = T - 1

    def delta(i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """Common-prefix length of codes i and j; -1 out of range."""
        out = np.full(i.shape, -1, np.int64)
        ok = (j >= 0) & (j < T)
        ii, jj = i[ok], j[ok]
        x = codes[ii] ^ codes[jj]
        out[ok] = 63 - _floor_log2(np.where(x == 0, 1, x))  # x>0 (codes unique)
        return out

    i = np.arange(I, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Upper bound on range length: double until prefix drops to <= delta_min.
    lmax = np.full(I, 2, np.int64)
    while True:
        over = delta(i, i + lmax * d) > delta_min
        if not over.any():
            break
        lmax[over] *= 2

    # Binary-search the exact other end j = i + l*d.
    l = np.zeros(I, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        step = np.where(t >= 1, t, 0)
        cond = (step > 0) & (delta(i, i + (l + step) * d) > delta_min)
        l[cond] += step[cond]
        t //= 2

    j = i + l * d
    delta_node = delta(i, j)

    # Binary-search the split position.
    s = np.zeros(I, np.int64)
    t = l.copy()
    while True:
        t = (t + 1) // 2
        cand = s + t
        cond = (delta(i, i + cand * d) > delta_node) & (cand < l)
        s[cond] = cand[cond]
        if (t <= 1).all():
            break
    gamma = i + s * d + np.minimum(d, 0)

    lo_range = np.minimum(i, j)
    hi_range = np.maximum(i, j)
    # Child is a leaf iff it covers exactly one sorted position.
    left = np.where(lo_range == gamma, gamma + I, gamma)
    right = np.where(hi_range == gamma + 1, gamma + 1 + I, gamma + 1)
    return (
        left.astype(np.int32),
        right.astype(np.int32),
        lo_range.astype(np.int32),
        hi_range.astype(np.int32),
    )


def build_bvh(triangles) -> BVH:
    """Build the LBVH for a Triangles batch (host topology + box fit).

    Triangle AABBs and centroids come from stop-gradient'd vertices; the tree
    is static per scene and boxes can be refit under jit with `refit`.
    """
    vertices = np.asarray(jax.lax.stop_gradient(triangles.vertices), np.float32)
    T = vertices.shape[0]
    if T < 2:
        raise ValueError("build_bvh needs >= 2 triangles (use brute force)")

    centroids = vertices.mean(axis=1)
    codes = morton_codes(centroids)
    # Make codes strictly increasing: append the sorted position in the low
    # 32 bits (ties by original index) — Karras' duplicate-code fix.
    order = np.argsort(codes, kind="stable").astype(np.int64)
    aug = (codes[order] << np.uint64(32)) | np.arange(T, dtype=np.uint64)

    left, right, first, last = _karras_topology(aug)

    tri_lo = vertices.min(axis=1)[order]  # leaf boxes in sorted order
    tri_hi = vertices.max(axis=1)[order]
    node_lo, node_hi = _fit_boxes_host(left, right, tri_lo, tri_hi)

    return BVH(
        left=jnp.asarray(left),
        right=jnp.asarray(right),
        node_lo=jnp.asarray(node_lo, DTYPE),
        node_hi=jnp.asarray(node_hi, DTYPE),
        tri_order=jnp.asarray(order.astype(np.int32)),
        range_first=jnp.asarray(first),
        range_last=jnp.asarray(last),
    )


def _fit_boxes_host(left, right, tri_lo, tri_hi):
    """Bottom-up AABB fit (NumPy): process internal nodes in decreasing
    range-size order so children always resolve first."""
    T = tri_lo.shape[0]
    I = T - 1
    node_lo = np.empty((I + T, 3), np.float32)
    node_hi = np.empty((I + T, 3), np.float32)
    node_lo[I:] = tri_lo
    node_hi[I:] = tri_hi

    # Child -> parent dependency: iterate until fixpoint, vectorized.
    done = np.zeros(I + T, bool)
    done[I:] = True
    pending = np.arange(I)
    while pending.size:
        l, r = left[pending], right[pending]
        ready = done[l] & done[r]
        idx = pending[ready]
        node_lo[idx] = np.minimum(node_lo[left[idx]], node_lo[right[idx]])
        node_hi[idx] = np.maximum(node_hi[left[idx]], node_hi[right[idx]])
        done[idx] = True
        pending = pending[~ready]
    return node_lo, node_hi


def refit(bvh: BVH, triangles) -> BVH:
    """Re-fit node boxes to current vertices under jit (topology fixed).

    Uses a sparse-table range-min over the sorted leaf boxes: a Karras
    internal node always covers a contiguous sorted-leaf range
    (bvh.range_first/last, recorded at build). O(T log T), fully vectorized —
    the array analogue of a refit pass, enabling per-step vertex updates in
    inverse rendering without host round-trips.
    """
    verts = jax.lax.stop_gradient(triangles.vertices)
    T = bvh.num_leaves
    tri_lo = jnp.min(verts, axis=1)[bvh.tri_order]
    tri_hi = jnp.max(verts, axis=1)[bvh.tri_order]

    first = bvh.range_first
    last = bvh.range_last

    # Sparse tables of prefix mins/maxes at power-of-two windows.
    levels = max(1, int(np.floor(np.log2(T))) + 1)
    lo_tabs = [tri_lo]
    hi_tabs = [tri_hi]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev_lo, prev_hi = lo_tabs[-1], hi_tabs[-1]
        shifted_lo = jnp.concatenate([prev_lo[half:], prev_lo[-half:]], axis=0)
        shifted_hi = jnp.concatenate([prev_hi[half:], prev_hi[-half:]], axis=0)
        lo_tabs.append(jnp.minimum(prev_lo, shifted_lo))
        hi_tabs.append(jnp.maximum(prev_hi, shifted_hi))
    lo_tab = jnp.stack(lo_tabs)  # (levels, T, 3)
    hi_tab = jnp.stack(hi_tabs)

    length = last - first + 1
    k = jnp.clip(jnp.floor(jnp.log2(length.astype(jnp.float32))), 0, levels - 1).astype(jnp.int32)
    pow2k = (1 << k).astype(jnp.int32)
    a_lo = lo_tab[k, first]
    b_lo = lo_tab[k, last - pow2k + 1]
    a_hi = hi_tab[k, first]
    b_hi = hi_tab[k, last - pow2k + 1]
    int_lo = jnp.minimum(a_lo, b_lo)
    int_hi = jnp.maximum(a_hi, b_hi)

    node_lo = jnp.concatenate([int_lo, tri_lo], axis=0)
    node_hi = jnp.concatenate([int_hi, tri_hi], axis=0)
    return bvh._replace(node_lo=node_lo, node_hi=node_hi)
