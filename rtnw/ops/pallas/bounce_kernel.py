"""Whole-render megastep: raygen + every sample + every bounce in ONE kernel.

The forward-only production render path for analytic scenes (spheres,
planes, brute-force meshes) on the GPU, written for Pallas' Triton route.
The XLA wavefront (models/integrator.trace) moves each bounce's ray state
through device memory as a chain of fusions; this kernel keeps it in
registers instead, the design of the reference's per-pixel megakernel
(renderKernel, main.cu:160-206):

  * one program per 1-D block of RAY_BLOCK pixels; each thread owns its
    rays for the whole render;
  * per sample: thin-lens raygen in-register (`_raygen_core`), then a
    bounce loop that exits as soon as no ray of the block is alive;
  * per bounce: closest hit over every packed primitive, with the winner's
    normal and material row carried through the loop (no post-hoc lookup),
    then the full 8-kind branchless BSDF (ops/materials.scatter,
    expression for expression) and the radiance bookkeeping of
    integrator._bounce_body;
  * the scene is ONE small table (`MegastepScene.prims`) read as
    block-uniform scalars: a few KB for the Cornell box, resident in L1.

RNG: the kernel hashes the same pcg4d counters (ops/rng) from the same
per-sample key words as the XLA engine, so both engines consume identical
random streams and agree to float tolerance (tests/test_bounce_kernel.py).

Differentiability: none, by design. Gradients flow through the XLA engine
(the unfinalized scene); differentiating this kernel raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rtnw.config import EPSILON, FLT_EPSILON
from rtnw.ops.geometry import (
    COAT,
    DIELECTRIC,
    EMISSION,
    LAMBERTIAN,
    METAL,
    PHONG_METAL,
    REFRACTION,
    SPECULAR,
)
from rtnw.ops.linalg import reciprocal
from rtnw.ops.rng import RAYGEN_DOMAIN, RAYGEN_DOMAIN2, pcg4d, to_uniform

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)

# Rays per program and warps per program. One ray per thread keeps every
# live value of a path in registers.
RAY_BLOCK = 128
NUM_WARPS = 4

# Plain Python scalar: a jnp constant would be a captured tracer in a kernel.
BIG = 3.0e38

# Row layout of MegastepScene.prims (one column per primitive):
#   spheres  0-2 center0, 3-5 center1-center0, 6 time0, 7 1/(time1-time0),
#            8 radius
#   planes   0-2 position, 3-5 normal, 6-8 lo, 9-11 hi (open axis +-3e38),
#            12 two_sided
#   tris and quads (Havel form, _havel_rows)  0-2 unit normal, 3 plane
#            offset, 4-7 edge plane 1, 8-11 edge plane 2
#   boxes    0-2 center, 3-11 unit axes u v w, 12-14 half extents
#   all      MAT_ROW + 0..7: kind, albedo rgb, param, emission rgb
MAT_ROW = 16
TABLE_ROWS = 32

# Primitive loops with at most this many columns are unrolled in Python.
_UNROLL = 64


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@jax.tree_util.register_pytree_node_class
class MegastepScene:
    """The scene as the megastep reads it (built by `pack_megastep`).

    `prims` is a (TABLE_ROWS, pow2) f32 table with the primitive types in
    consecutive column ranges, `counts` = (spheres, planes, triangles,
    quads, boxes). Counts, the set of material kinds present and whether
    any material has additive emission are static, so absent primitive
    types and BSDF kinds compile to nothing.
    """

    def __init__(self, prims, counts, used_kinds, has_emission):
        self.prims = prims
        self.counts = counts
        self.used_kinds = used_kinds
        self.has_emission = has_emission

    def tree_flatten(self):
        return (self.prims,), (self.counts, self.used_kinds, self.has_emission)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


def _merge_parallelograms(verts, mat_id):
    """Detect coplanar triangle pairs that form parallelograms.

    A pair qualifies when it shares an edge, the two opposite vertices are
    reflections through the edge midpoint (within 1e-5 relative), both
    triangles carry the same material, and their windings agree (so
    backface culling is preserved). Each merged pair costs ONE quad
    intersection in the megastep instead of two triangle tests — the same
    spirit as the reference's precomputed v0/E1/E2 ladder step
    (images/images.MD:44-53), applied at the representation level.

    Returns (q_v0, q_e1, q_e2, q_mat, rest_idx): quad parallelogram frames
    (points v0 + u*e1 + v*e2, u,v in [0,1]) and indices of unmerged tris.
    """
    T = verts.shape[0]
    edge_map: dict = {}
    for t in range(T):
        for k in range(3):
            a = verts[t, k].tobytes()
            b = verts[t, (k + 1) % 3].tobytes()
            key = (a, b) if a < b else (b, a)
            edge_map.setdefault(key, []).append((t, (k + 2) % 3))
    used = np.zeros(T, bool)
    q_v0, q_e1, q_e2, q_mat = [], [], [], []
    for lst in edge_map.values():
        if len(lst) != 2:
            continue
        (t1, o1), (t2, o2) = lst
        if t1 == t2 or used[t1] or used[t2] or mat_id[t1] != mat_id[t2]:
            continue
        p1, p2 = verts[t1, o1], verts[t2, o2]
        a = verts[t1, (o1 + 1) % 3]
        b = verts[t1, (o1 + 2) % 3]
        scale = max(float(np.abs(verts[t1]).max()), 1e-6)
        if np.abs((a + b - p1) - p2).max() > 1e-5 * scale:
            continue
        n1 = np.cross(verts[t1, 1] - verts[t1, 0], verts[t1, 2] - verts[t1, 0])
        n2 = np.cross(verts[t2, 1] - verts[t2, 0], verts[t2, 2] - verts[t2, 0])
        if np.dot(n1, n2) <= 0.0:  # inconsistent winding: culling would change
            continue
        e1, e2 = a - p1, b - p1
        if np.dot(n1, np.cross(e1, e2)) < 0.0:
            e1, e2 = e2, e1
        used[t1] = used[t2] = True
        q_v0.append(p1)
        q_e1.append(e1)
        q_e2.append(e2)
        q_mat.append(mat_id[t1])
    rest = np.nonzero(~used)[0]
    return (
        np.asarray(q_v0, np.float32).reshape(-1, 3),
        np.asarray(q_e1, np.float32).reshape(-1, 3),
        np.asarray(q_e2, np.float32).reshape(-1, 3),
        np.asarray(q_mat, np.int32).reshape(-1),
        rest,
    )


def _merge_boxes(q_v0, q_e1, q_e2, q_mat):
    """Detect groups of 6 parallelogram quads forming a closed box (OBB).

    The reference's Cornell cubes are rotated cube meshes
    (cornellbox2.yaml `cube_small.obj` + rotateY) that quad-merge into 6
    parallelograms each; a closed box admits ONE oriented-slab test
    (~1/3 the arithmetic of 6 quad Havel tests and 1/6 the winner
    selects), the representation-level successor of the reference's
    Cube = 6 planes composite (Cube.cu:10-23).

    A 6-quad vertex-connected component qualifies when its corners are
    exactly 8 points c +- hu*u +- hv*v +- hw*w for an orthogonal frame
    (u, v, w), and every quad's outward normal points away from c (so
    backface culling is preserved: entry-face hits only, interior rays
    miss). Quads failing any check stay quads.

    Returns (box_c (B,3), box_axes (B,3,3) unit rows, box_h (B,3),
    box_mat (B,), rest_idx) with rest_idx indexing surviving quads.
    """
    Q = q_v0.shape[0]
    if Q < 6:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3), np.float32), np.zeros((0,), np.int32),
                np.arange(Q))
    corners = np.stack(
        [q_v0, q_v0 + q_e1, q_v0 + q_e2, q_v0 + q_e1 + q_e2], axis=1
    )  # (Q, 4, 3)
    # Union-find over exact vertex bytes (merged quads reuse mesh verts).
    parent = list(range(Q))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    vert_owner: dict = {}
    for q in range(Q):
        for k in range(4):
            key = corners[q, k].tobytes()
            if key in vert_owner:
                a, b = find(vert_owner[key]), find(q)
                if a != b:
                    parent[b] = a
            else:
                vert_owner[key] = q
    groups: dict = {}
    for q in range(Q):
        groups.setdefault(find(q), []).append(q)

    used = np.zeros(Q, bool)
    box_c, box_axes, box_h, box_mat = [], [], [], []
    for members in groups.values():
        if len(members) != 6:
            continue
        qs = np.asarray(members)
        if len(set(int(q_mat[q]) for q in qs)) != 1:
            continue
        pts = corners[qs].reshape(-1, 3)
        uniq = np.unique(pts.round(decimals=6), axis=0)
        if uniq.shape[0] != 8:
            continue
        c = uniq.mean(axis=0)
        # Box axes: the 3 distinct (+-) edge directions among the quads.
        edges = np.concatenate([q_e1[qs], q_e2[qs]], axis=0)  # (12, 3)
        lens = np.linalg.norm(edges, axis=1)
        if (lens < 1e-12).any():
            continue
        dirs = edges / lens[:, None]
        axes = []
        ok = True
        for d, ln in zip(dirs, lens):
            for a, _ in axes:
                if abs(np.dot(d, a)) > 1.0 - 1e-5:
                    break
            else:
                axes.append((d, ln))
        if len(axes) != 3:
            continue
        A = np.stack([a for a, _ in axes])       # (3, 3)
        H = np.asarray([ln for _, ln in axes]) * 0.5
        # Orthogonal frame?
        G = A @ A.T
        if np.abs(G - np.eye(3)).max() > 1e-4:
            continue
        # All 8 corners are c +- H*axes?
        loc = (uniq - c) @ A.T                   # (8, 3) local coords
        scale = max(float(np.abs(uniq).max()), 1e-6)
        if np.abs(np.abs(loc) - H[None, :]).max() > 1e-4 * scale:
            ok = False
        # Outward-facing quads (culling parity).
        if ok:
            for q in qs:
                n = np.cross(q_e1[q], q_e2[q])
                qc = corners[q].mean(axis=0)
                if np.dot(n, qc - c) <= 0.0:
                    ok = False
                    break
        if not ok:
            continue
        used[qs] = True
        box_c.append(c)
        box_axes.append(A)
        box_h.append(H)
        box_mat.append(int(q_mat[qs[0]]))
    rest = np.nonzero(~used)[0]
    return (
        np.asarray(box_c, np.float32).reshape(-1, 3),
        np.asarray(box_axes, np.float32).reshape(-1, 3, 3),
        np.asarray(box_h, np.float32).reshape(-1, 3),
        np.asarray(box_mat, np.int32).reshape(-1),
        rest,
    )


def _havel_rows(v0, e1, e2):
    """(K, 3) parallelogram/triangle frames -> (12, K) Havel rows.

    Rows: unit normal (3), plane offset dc = n̂·v0, edge plane 1 (3) + d1,
    edge plane 2 (3) + d2. The hit test is then t = (dc - n̂·o)/(n̂·d);
    u = e1p·h + d1; v = e2p·h + d2 — the precomputed-plane formulation the
    reference bakes per triangle (Loader.cpp:189-201, consumed
    CUDAPathTracer.cu:294-326).
    """
    n = np.cross(e1, e2)
    nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
    n_unit = n / np.sqrt(nn)
    e1p = np.cross(e2, n) / nn
    e2p = np.cross(n, e1) / nn
    return np.concatenate([
        n_unit.T, (n_unit * v0).sum(-1)[None],
        e1p.T, -(e1p * v0).sum(-1)[None],
        e2p.T, -(e2p * v0).sum(-1)[None],
    ], axis=0)


def pack_megastep(scene) -> MegastepScene:
    """Pack a concrete (host-built) scene for the megastep.

    Triangles are merged into parallelogram quads and closed quad shells
    into oriented boxes, then stored in Havel form. Padding columns are
    zero, which no primitive test accepts (radius 0, normal 0, box half
    extents 0), so they never win.
    """
    g = lambda a: np.asarray(jax.device_get(a))
    mats = scene.materials
    m_kind = g(mats.kind)
    m_table = np.concatenate([
        m_kind.astype(np.float32)[:, None], g(mats.albedo).astype(np.float32),
        g(mats.param).astype(np.float32)[:, None],
        g(mats.emission).astype(np.float32),
    ], axis=1)  # (M, 8)

    cols, mat_ids = [], []

    sph = scene.spheres
    if sph.count:
        c0 = g(sph.center0).astype(np.float32)
        t0 = g(sph.time0).astype(np.float32)
        t1 = g(sph.time1).astype(np.float32)
        cols.append(np.concatenate([
            c0.T, (g(sph.center1) - c0).T, t0[None],
            (np.float32(1.0) / (t1 - t0))[None], g(sph.radius)[None],
        ], axis=0))
        mat_ids.append(g(sph.material_id))

    pla = scene.planes
    if pla.count:
        pos = g(pla.position).astype(np.float32)
        ext = g(pla.extend).astype(np.float32)
        # The finite-extent test checks only the two axes named by the
        # orientation (Plane.cu:24-46): XY -> z free, YZ -> x free,
        # XZ -> y free.
        open_axis = np.asarray([2, 0, 1], np.int32)[g(pla.orientation)]
        is_open = np.arange(3)[None, :] == open_axis[:, None]
        lo = np.where(is_open, np.float32(-3e38), pos - ext)
        hi = np.where(is_open, np.float32(3e38), pos + ext)
        cols.append(np.concatenate([
            pos.T, g(pla.normal).T, lo.T, hi.T,
            g(pla.two_sided).astype(np.float32)[None],
        ], axis=0))
        mat_ids.append(g(pla.material_id))

    n_tri = n_quad = n_box = 0
    if scene.triangles.count:
        verts = g(scene.triangles.vertices).astype(np.float32)
        tmat = g(scene.triangles.material_id)
        qv0, qe1, qe2, qmat, rest = _merge_parallelograms(verts, tmat)
        b_c, b_axes, b_h, b_mat, qrest = _merge_boxes(qv0, qe1, qe2, qmat)
        v0 = verts[rest, 0]
        n_tri, n_quad, n_box = len(rest), len(qrest), len(b_mat)
        if n_tri:
            cols.append(_havel_rows(v0, verts[rest, 1] - v0,
                                    verts[rest, 2] - v0))
            mat_ids.append(tmat[rest])
        if n_quad:
            cols.append(_havel_rows(qv0[qrest], qe1[qrest], qe2[qrest]))
            mat_ids.append(qmat[qrest])
        if n_box:
            cols.append(np.concatenate(
                [b_c.T, b_axes.reshape(n_box, 9).T, b_h.T], axis=0))
            mat_ids.append(b_mat)

    counts = (sph.count, pla.count, n_tri, n_quad, n_box)
    total = sum(counts)
    prims = np.zeros((TABLE_ROWS, _pow2(max(total, 1))), np.float32)
    start = 0
    for block, mids in zip(cols, mat_ids):
        k = block.shape[1]
        prims[: block.shape[0], start:start + k] = block
        prims[MAT_ROW:MAT_ROW + 8, start:start + k] = \
            m_table[np.maximum(mids, 0)].T
        start += k
    return MegastepScene(
        jnp.asarray(prims), counts,
        tuple(sorted({int(k) for k in m_kind})),
        bool(np.any(g(mats.emission))),
    )


def _bounce_core(
    ox, oy, oz, dx, dy, dz, tm, alive,
    tpx, tpy, tpz, rx, ry, rz,
    u0, u1, u2, u3, do_rr, prims_ref,
    *, counts, tmin: float, sky: bool, used_kinds, russian_roulette: bool,
    additive_emission: bool,
):
    """One whole bounce on in-register (RAY_BLOCK,) ray values.

    Returns the advanced state (ox..dz, tpx..z, rx..z, cont_bool).
    """
    shape = ox.shape
    M = MAT_ROW

    def _use(k):
        return used_kinds is None or k in used_kinds

    best_t = jnp.full(shape, BIG, jnp.float32)
    zero = jnp.zeros(shape, jnp.float32)
    a = dx * dx + dy * dy + dz * dz  # |d|^2, ray-invariant across prims
    # Winner attributes, carried through the primitive loops:
    # t, kind (-1 miss), outward normal, albedo, param, additive emission.
    carry = (best_t, jnp.full(shape, -1.0, jnp.float32), zero, zero, zero,
             zero, zero, zero, zero, zero, zero, zero)

    def take(win, t, nx, ny, nz, i, c):
        """Winner select of one candidate into the carry `c`."""
        def sel(new, old):
            return jnp.where(win, new, old)

        def sel_e(row, old):
            # Additive-emission rows are statically elided when no material
            # emits (the carried zeros pass through, op-free).
            return sel(prims_ref[M + row, i], old) if additive_emission \
                else old

        return (
            sel(t, c[0]), sel(prims_ref[M + 0, i], c[1]),
            sel(nx, c[2]), sel(ny, c[3]), sel(nz, c[4]),
            sel(prims_ref[M + 1, i], c[5]), sel(prims_ref[M + 2, i], c[6]),
            sel(prims_ref[M + 3, i], c[7]), sel(prims_ref[M + 4, i], c[8]),
            sel_e(5, c[9]), sel_e(6, c[10]), sel_e(7, c[11]),
        )

    def sphere_body(i, c):
        best_t = c[0]
        w = (tm - prims_ref[6, i]) * prims_ref[7, i]
        cx = prims_ref[0, i] + prims_ref[3, i] * w
        cy = prims_ref[1, i] + prims_ref[4, i] * w
        cz = prims_ref[2, i] + prims_ref[5, i] * w
        r = prims_ref[8, i]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = half_b * half_b - a * cc
        ok = disc > FLT_EPSILON
        sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
        inv_a = 1.0 / a
        r0 = (-half_b - sq) * inv_a
        r1 = (-half_b + sq) * inv_a
        in0 = (r0 >= tmin) & (r0 <= best_t)
        in1 = (r1 >= tmin) & (r1 <= best_t)
        t = jnp.where(in0, r0, r1)
        win = ok & (in0 | in1)
        inv_r = 1.0 / jnp.where(r != 0.0, r, 1.0)
        return take(win, t, (ox + t * dx - cx) * inv_r,
                    (oy + t * dy - cy) * inv_r, (oz + t * dz - cz) * inv_r,
                    i, c)

    def plane_body(i, c):
        nx, ny, nz = prims_ref[3, i], prims_ref[4, i], prims_ref[5, i]
        denom = dx * nx + dy * ny + dz * nz
        two_sided = prims_ref[12, i] > 0.5
        gate = ((jnp.abs(denom) > EPSILON) & two_sided) | (
            (denom > EPSILON) & jnp.logical_not(two_sided)
        )
        inv_den = 1.0 / jnp.where(gate, denom, 1.0)
        t = ((prims_ref[0, i] - ox) * nx + (prims_ref[1, i] - oy) * ny
             + (prims_ref[2, i] - oz) * nz) * inv_den
        hx = ox + t * dx
        hy = oy + t * dy
        hz = oz + t * dz
        inside = (
            (hx > prims_ref[6, i]) & (hx < prims_ref[9, i])
            & (hy > prims_ref[7, i]) & (hy < prims_ref[10, i])
            & (hz > prims_ref[8, i]) & (hz < prims_ref[11, i])
        )
        win = gate & inside & (t >= tmin) & (t < c[0])
        return take(win, t, jnp.full(shape, nx), jnp.full(shape, ny),
                    jnp.full(shape, nz), i, c)

    def make_havel_body(quad):
        """Precomputed plane + edge-plane test (reference parity:
        Loader.cpp:189-201 precompute, CUDAPathTracer.cu:294-326 test).
        Back faces are culled, as by the XLA engine's Möller–Trumbore
        (`quad` statically selects the parallelogram uv bound)."""

        def h_body(i, c):
            nx, ny, nz = prims_ref[0, i], prims_ref[1, i], prims_ref[2, i]
            dn = dx * nx + dy * ny + dz * nz
            ok = dn < -FLT_EPSILON
            inv = 1.0 / jnp.where(ok, dn, 1.0)
            t = (prims_ref[3, i] - (ox * nx + oy * ny + oz * nz)) * inv
            hx = ox + t * dx
            hy = oy + t * dy
            hz = oz + t * dz
            u = (prims_ref[4, i] * hx + prims_ref[5, i] * hy
                 + prims_ref[6, i] * hz + prims_ref[7, i])
            v = (prims_ref[8, i] * hx + prims_ref[9, i] * hy
                 + prims_ref[10, i] * hz + prims_ref[11, i])
            if quad:
                uv_ok = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
            else:
                uv_ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            win = ok & uv_ok & (t > tmin) & (t < c[0])
            return take(win, t, jnp.full(shape, nx), jnp.full(shape, ny),
                        jnp.full(shape, nz), i, c)

        return h_body

    def box_body(i, c):
        """Oriented-box slab test (the 6-quad cube collapsed to one
        primitive — _merge_boxes). Entry-face hits only (tn >= tmin),
        matching the culled closed quad shell: interior and tangent rays
        miss. Normal = the entry slab's outward axis."""
        eps_b = 1e-20
        relx = ox - prims_ref[0, i]
        rely = oy - prims_ref[1, i]
        relz = oz - prims_ref[2, i]
        tn = jnp.full(shape, -BIG, jnp.float32)
        tf = jnp.full(shape, BIG, jnp.float32)
        nxw, nyw, nzw = zero, zero, zero
        for axis in range(3):
            axx = prims_ref[3 + 3 * axis, i]
            axy = prims_ref[4 + 3 * axis, i]
            axz = prims_ref[5 + 3 * axis, i]
            h = prims_ref[12 + axis, i]
            ol = relx * axx + rely * axy + relz * axz
            dl = dx * axx + dy * axy + dz * axz
            dls = jnp.where(jnp.abs(dl) < eps_b,
                            jnp.where(dl >= 0.0, eps_b, -eps_b), dl)
            inv = 1.0 / dls
            t0 = (-h - ol) * inv
            t1 = (h - ol) * inv
            tna = jnp.minimum(t0, t1)
            tfa = jnp.maximum(t0, t1)
            upd = tna > tn
            s = jnp.where(dl >= 0.0, -1.0, 1.0)
            nxw = jnp.where(upd, s * axx, nxw)
            nyw = jnp.where(upd, s * axy, nyw)
            nzw = jnp.where(upd, s * axz, nzw)
            tn = jnp.maximum(tn, tna)
            tf = jnp.minimum(tf, tfa)
        win = (tf >= tn) & (tn >= tmin) & (tn < c[0])
        return take(win, tn, nxw, nyw, nzw, i, c)

    n_sph, n_pla, n_tri, n_quad, n_box = counts
    start = 0
    for count, body in ((n_sph, sphere_body), (n_pla, plane_body),
                        (n_tri, make_havel_body(False)),
                        (n_quad, make_havel_body(True)), (n_box, box_body)):
        if count <= _UNROLL:
            for i in range(start, start + count):
                carry = body(i, carry)
        else:
            carry = jax.lax.fori_loop(start, start + count, body, carry)
        start += count

    (best_t, w_kind, w_nx, w_ny, w_nz,
     w_ar, w_ag, w_ab, w_par, w_er, w_eg, w_eb) = carry

    valid = w_kind >= 0.0

    # ---- face the normal toward the ray (HitResult::setFaceNormal) ----
    d_dot_n = dx * w_nx + dy * w_ny + dz * w_nz
    front = d_dot_n < FLT_EPSILON
    sgn = jnp.where(front, 1.0, -1.0)
    nx_, ny_, nz_ = w_nx * sgn, w_ny * sgn, w_nz * sgn

    # ---- unit incoming direction ----
    il = jax.lax.rsqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-30))
    ux, uy, uz = dx * il, dy * il, dz * il

    # ---- shared azimuth (ops/materials.scatter parity) ----
    two_pi = 6.283185307179586
    phi = two_pi * u1
    cos_phi = jnp.cos(phi)
    sin_phi = jnp.sin(phi)

    def azimuth(z):
        r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
        return r * cos_phi, r * sin_phi, z

    def normalize3(x, y, z):
        inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-30))
        return x * inv, y * inv, z * inv

    # mirror = u - 2 dot(u, n) n
    u_dot_n = ux * nx_ + uy * ny_ + uz * nz_
    mx = ux - 2.0 * u_dot_n * nx_
    my = uy - 2.0 * u_dot_n * ny_
    mz = uz - 2.0 * u_dot_n * nz_

    def is_kind(k):
        return w_kind == float(k)

    # ---- Lambertian ----
    avx, avy, avz = azimuth(1.0 - 2.0 * u0)
    if _use(LAMBERTIAN):
        lrx, lry, lrz = nx_ + avx, ny_ + avy, nz_ + avz
        nzero = ((jnp.abs(lrx) < 1e-8) & (jnp.abs(lry) < 1e-8)
                 & (jnp.abs(lrz) < 1e-8))
        lrx = jnp.where(nzero, nx_, lrx)
        lry = jnp.where(nzero, ny_, lry)
        lrz = jnp.where(nzero, nz_, lrz)
        sdx, sdy, sdz = normalize3(lrx, lry, lrz)
    else:
        sdx, sdy, sdz = nx_, ny_, nz_

    # Tangent frame about an axis, shared azimuth (Frisvad/Pixar).
    def frame_lobe(ax, ay, az, cos_t):
        s = jnp.where(az >= 0.0, 1.0, -1.0)
        a = -1.0 / (s + az)
        b = ax * ay * a
        t0x, t0y, t0z = 1.0 + s * ax * ax * a, s * b, -s * ax
        t1x, t1y, t1z = b, s + ay * ay * a, -ay
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        cp, sp = cos_phi * sin_t, sin_phi * sin_t
        return (
            t0x * cp + t1x * sp + ax * cos_t,
            t0y * cp + t1y * sp + ay * cos_t,
            t0z * cp + t1z * sp + az * cos_t,
        )

    one = jnp.ones(shape, jnp.float32)
    atr, atg, atb = w_ar, w_ag, w_ab
    scattered = jnp.logical_not(is_kind(EMISSION))

    def pick(sel, gx, gy, gz, d):
        return (jnp.where(sel, gx, d[0]), jnp.where(sel, gy, d[1]),
                jnp.where(sel, gz, d[2]))

    # ---- Metal (fuzz ball + absorption) ----
    if _use(METAL):
        fuzz = jnp.minimum(w_par, 1.0)
        ballr = jnp.exp(jnp.log(jnp.maximum(u2, 1e-12)) / 3.0)
        bx, by, bz = avx * ballr, avy * ballr, avz * ballr
        mrx = mx + fuzz * bx
        mry = my + fuzz * by
        mrz = mz + fuzz * bz
        metal_ok = (mrx * nx_ + mry * ny_ + mrz * nz_) > 0.0
        gx = jnp.where(metal_ok, mrx, mx)
        gy = jnp.where(metal_ok, mry, my)
        gz = jnp.where(metal_ok, mrz, mz)
        sel = is_kind(METAL)
        sdx, sdy, sdz = pick(sel, *normalize3(gx, gy, gz), (sdx, sdy, sdz))
        okf = metal_ok.astype(jnp.float32)
        atr = jnp.where(sel, w_ar * okf, atr)
        atg = jnp.where(sel, w_ag * okf, atg)
        atb = jnp.where(sel, w_ab * okf, atb)
        scattered = scattered & jnp.logical_not(
            sel & jnp.logical_not(metal_ok))

    # ---- Dielectric (Schlick + TIR) ----
    if _use(DIELECTRIC):
        sel = is_kind(DIELECTRIC)
        ior = jnp.where(sel & (w_par > 0.0), w_par, 1.5)
        eta = jnp.where(front, 1.0 / ior, ior)
        cos_t = jnp.minimum(-(ux * nx_ + uy * ny_ + uz * nz_), 1.0)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        cannot = eta * sin_t > 1.0
        r0s = (1.0 - eta) / (1.0 + eta)
        r0s = r0s * r0s
        omc = 1.0 - cos_t
        omc2 = omc * omc
        rp = r0s + (1.0 - r0s) * omc2 * omc2 * omc
        choose = cannot | (rp > u2)
        # refract(u, n, eta): perp = eta (u + cos n); par = -sqrt(1-|perp|²) n
        px_ = eta * (ux + cos_t * nx_)
        py_ = eta * (uy + cos_t * ny_)
        pz_ = eta * (uz + cos_t * nz_)
        k = 1.0 - (px_ * px_ + py_ * py_ + pz_ * pz_)
        pos = k > 0.0
        rpar = jnp.where(pos, jnp.sqrt(jnp.where(pos, k, 1.0)), 0.0)
        fx = px_ - rpar * nx_
        fy = py_ - rpar * ny_
        fz = pz_ - rpar * nz_
        gx = jnp.where(choose, mx, fx)
        gy = jnp.where(choose, my, fy)
        gz = jnp.where(choose, mz, fz)
        sdx, sdy, sdz = pick(sel, *normalize3(gx, gy, gz), (sdx, sdy, sdz))
        atr = jnp.where(sel, one, atr)
        atg = jnp.where(sel, one, atg)
        atb = jnp.where(sel, one, atb)

    # ---- Phong metal (Path B METAL) ----
    if _use(PHONG_METAL):
        sel = is_kind(PHONG_METAL)
        pc = jnp.exp(
            jnp.log(jnp.maximum(u0, 1e-12)) / (jnp.maximum(w_par, 0.0) + 1.0)
        )
        ax, ay, az = normalize3(mx, my, mz)
        sdx, sdy, sdz = pick(sel, *frame_lobe(ax, ay, az, pc),
                             (sdx, sdy, sdz))

    # ---- Specular mirror (Path B) ----
    if _use(SPECULAR):
        sel = is_kind(SPECULAR)
        sdx, sdy, sdz = pick(sel, *normalize3(mx, my, mz), (sdx, sdy, sdz))

    # ---- Coat (Path B: 5% specular else diffuse cosine lobe) ----
    if _use(COAT):
        sel = is_kind(COAT)
        spec = u2 < 0.05
        ccos = jnp.sqrt(jnp.maximum(0.0, 1.0 - u0))
        gx, gy, gz = frame_lobe(nx_, ny_, nz_, ccos)
        gx = jnp.where(spec, mx, gx)
        gy = jnp.where(spec, my, gy)
        gz = jnp.where(spec, mz, gz)
        sdx, sdy, sdz = pick(sel, gx, gy, gz, (sdx, sdy, sdz))
        specf = spec.astype(jnp.float32)
        atr = jnp.where(sel, specf + (1.0 - specf) * w_ar, atr)
        atg = jnp.where(sel, specf + (1.0 - specf) * w_ag, atg)
        atb = jnp.where(sel, specf + (1.0 - specf) * w_ab, atb)

    # ---- smallpt refraction (Path B REFRACTION) ----
    if _use(REFRACTION):
        sel = is_kind(REFRACTION)
        nt = jnp.where(sel & (w_par > 0.0), w_par, 1.5)
        nnt = jnp.where(front, 1.0 / nt, nt)
        ddn = ux * nx_ + uy * ny_ + uz * nz_
        cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
        tir = cos2t < 0.0
        cos_t = jnp.minimum(-ddn, 1.0)
        px_ = nnt * (ux + cos_t * nx_)
        py_ = nnt * (uy + cos_t * ny_)
        pz_ = nnt * (uz + cos_t * nz_)
        k = 1.0 - (px_ * px_ + py_ * py_ + pz_ * pz_)
        pos = k > 0.0
        rpar = jnp.where(pos, jnp.sqrt(jnp.where(pos, k, 1.0)), 0.0)
        tdx, tdy, tdz = normalize3(
            px_ - rpar * nx_, py_ - rpar * ny_, pz_ - rpar * nz_
        )
        r0s = (nt - 1.0) / (nt + 1.0)
        r0s = r0s * r0s
        c1m = 1.0 - jnp.where(front, -ddn, tdx * nx_ + tdy * ny_ + tdz * nz_)
        c1m2 = c1m * c1m
        re = r0s + (1.0 - r0s) * c1m2 * c1m2 * c1m
        prob = 0.25 + 0.5 * re
        choose = tir | (u2 < prob)
        nmx, nmy, nmz = normalize3(mx, my, mz)
        gx = jnp.where(choose, nmx, tdx)
        gy = jnp.where(choose, nmy, tdy)
        gz = jnp.where(choose, nmz, tdz)
        sdx, sdy, sdz = pick(sel, gx, gy, gz, (sdx, sdy, sdz))
        w = jnp.where(
            tir, 1.0, jnp.where(choose, re / prob, (1.0 - re) / (1.0 - prob))
        )
        atr = jnp.where(sel, w_ar * w, atr)
        atg = jnp.where(sel, w_ag * w, atg)
        atb = jnp.where(sel, w_ab * w, atb)

    # ---- bookkeeping (integrator._bounce_body parity) ----
    miss = alive & jnp.logical_not(valid)
    if sky:
        t_sky = 0.5 * (uy + 1.0)
        skyr = SKY_WHITE[0] + t_sky * (SKY_BLUE[0] - SKY_WHITE[0])
        skyg = SKY_WHITE[1] + t_sky * (SKY_BLUE[1] - SKY_WHITE[1])
        skyb = SKY_WHITE[2] + t_sky * (SKY_BLUE[2] - SKY_WHITE[2])
        missf = miss.astype(jnp.float32)
        rx = rx + missf * tpx * skyr
        ry = ry + missf * tpy * skyg
        rz = rz + missf * tpz * skyb

    if additive_emission:
        # Path B additive emission (zero rows for Path A materials).
        hitf = (alive & valid).astype(jnp.float32)
        rx = rx + hitf * tpx * w_er
        ry = ry + hitf * tpy * w_eg
        rz = rz + hitf * tpz * w_eb
    if _use(EMISSION):
        termf = (alive & valid & is_kind(EMISSION)).astype(jnp.float32)
        rx = rx + termf * tpx * w_ar * w_par
        ry = ry + termf * tpy * w_ag * w_par
        rz = rz + termf * tpz * w_ab * w_par

    cont = alive & valid & scattered
    contf = cont.astype(jnp.float32)
    ntpx = tpx * (1.0 - contf + contf * atr)
    ntpy = tpy * (1.0 - contf + contf * atg)
    ntpz = tpz * (1.0 - contf + contf * atb)

    if russian_roulette:
        p = jnp.minimum(
            jnp.maximum(jnp.maximum(jnp.maximum(ntpx, ntpy), ntpz), 0.05),
            1.0)
        survive = jnp.logical_not(do_rr) | (u3 < p)
        bf = (cont & do_rr & survive).astype(jnp.float32)
        inv_p = 1.0 / p
        ntpx = ntpx * (1.0 - bf + bf * inv_p)
        ntpy = ntpy * (1.0 - bf + bf * inv_p)
        ntpz = ntpz * (1.0 - bf + bf * inv_p)
        cont = cont & survive

    safe_t = jnp.where(valid, best_t, 0.0)
    return (
        jnp.where(cont, ox + safe_t * dx, ox),
        jnp.where(cont, oy + safe_t * dy, oy),
        jnp.where(cont, oz + safe_t * dz, oz),
        jnp.where(cont, sdx, dx),
        jnp.where(cont, sdy, dy),
        jnp.where(cont, sdz, dz),
        ntpx, ntpy, ntpz,
        rx, ry, rz,
        cont,
    )


def _raygen_core(pid, b0, b1, frame_ref, *, width: int, height: int):
    """In-register thin-lens ray generation (camera.generate_rays parity).

    Consumes the exact pcg4d stream of ops/rng.raygen_uniforms and writes
    the expressions of models/camera.generate_rays_ctx in its order, so both
    compilers fuse the same multiply-adds and both engines start from
    bit-identical primary rays. `frame_ref` holds the camera frame packed
    by `_pack_frame`. Returns (ox, oy, oz, dx, dy, dz, tm).
    """
    shape = pid.shape
    xs = (pid % jnp.uint32(width)).astype(jnp.float32)
    ys = (pid // jnp.uint32(width)).astype(jnp.float32)
    dom = jnp.full(shape, int(RAYGEN_DOMAIN), jnp.uint32)
    dom2 = jnp.full(shape, int(RAYGEN_DOMAIN2), jnp.uint32)
    h0, h1, h2, h3 = pcg4d(pid, b0, dom, b1)
    u0, u1, u2, u3 = (to_uniform(h0), to_uniform(h1),
                      to_uniform(h2), to_uniform(h3))
    t0h, _, _, _ = pcg4d(pid, b0, dom2, b1)
    u4 = to_uniform(t0h)

    f = lambda i: frame_ref[i]
    # Pixel sample placement dx=(x+u)/(width-1) (main.cu:179-183), as a
    # multiply by the f32 reciprocal.
    dxs = (xs + u0) * reciprocal(width - 1)
    dys = (ys + u1) * reciprocal(height - 1)

    # Closed-form lens disk (Utils.h:96-104) scaled by lens radius.
    r = jnp.sqrt(u2)
    phi = 6.283185307179586 * u3
    disk_x = f(18) * r * jnp.cos(phi)
    disk_y = f(18) * r * jnp.sin(phi)

    ox = f(0) + (disk_x * f(12) + disk_y * f(15))
    oy = f(1) + (disk_x * f(13) + disk_y * f(16))
    oz = f(2) + (disk_x * f(14) + disk_y * f(17))

    dx = f(3) + dxs * f(6) + dys * f(9) - ox
    dy = f(4) + dxs * f(7) + dys * f(10) - oy
    dz = f(5) + dxs * f(8) + dys * f(11) - oz
    # Safe normalize with a reciprocal square root, as generate_rays_ctx.
    nsq = dx * dx + dy * dy + dz * dz
    pos = nsq > 0.0
    inv = jnp.where(pos, jax.lax.rsqrt(jnp.where(pos, nsq, 1.0)), 0.0)
    tm = u4 * (f(20) - f(19)) + f(19)
    return ox, oy, oz, dx * inv, dy * inv, dz * inv, tm


def _render_kernel(
    bases_ref, frame_ref, pid_ref, prims_ref, orx_ref, ory_ref, orz_ref,
    *, n_samples: int, width: int, height: int, bounces: int, rr_start: int,
    **consts,
):
    """One block of pixels: every sample, every bounce, in registers.

    bases_ref: (2, pow2 >= n_samples) uint32 — the per-sample jax.random key
    words, so the RNG stream is exactly the XLA engine's (split(key, S)
    then per-ray pcg4d).
    """
    pid = pid_ref[...]
    shape = pid.shape
    zero = jnp.zeros(shape, jnp.float32)
    one = jnp.ones(shape, jnp.float32)

    def sample_body(s, acc):
        b0 = jnp.full(shape, bases_ref[0, s])
        b1 = jnp.full(shape, bases_ref[1, s])
        ox, oy, oz, dx, dy, dz, tm = _raygen_core(
            pid, b0, b1, frame_ref, width=width, height=height,
        )

        # The live mask rides the loop as i32; the block leaves the loop
        # once none of its rays is alive.
        def cond(c):
            return (c[0] < bounces) & (jnp.max(c[13]) > 0)

        def body(c):
            (b, ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, rx, ry, rz,
             alive_i) = c
            cnt = jnp.full(shape, 1, jnp.uint32) + b.astype(jnp.uint32)
            h0, h1, h2, h3 = pcg4d(pid, b0, cnt, b1)
            out = _bounce_core(
                ox, oy, oz, dx, dy, dz, tm, alive_i != 0,
                tpx, tpy, tpz, rx, ry, rz,
                to_uniform(h0), to_uniform(h1), to_uniform(h2),
                to_uniform(h3), b >= rr_start, prims_ref, **consts,
            )
            return (b + 1, *out[:12], out[12].astype(jnp.int32))

        init = (jnp.int32(0), ox, oy, oz, dx, dy, dz,
                one, one, one, zero, zero, zero,
                jnp.ones(shape, jnp.int32))
        final = jax.lax.while_loop(cond, body, init)
        return (acc[0] + final[10], acc[1] + final[11], acc[2] + final[12])

    rx, ry, rz = jax.lax.fori_loop(
        0, n_samples, sample_body, (zero, zero, zero)
    )
    orx_ref[...] = rx
    ory_ref[...] = ry
    orz_ref[...] = rz


@functools.partial(
    jax.jit,
    static_argnames=("counts", "n_samples", "width", "height", "tmin", "sky",
                     "used_kinds", "russian_roulette", "additive_emission",
                     "bounces", "rr_start", "interpret"),
)
def _run_render(pid, bases, frame, prims, counts, n_samples, width, height,
                tmin, sky, used_kinds, russian_roulette, additive_emission,
                bounces, rr_start, interpret):
    n = pid.shape[0]
    kern = functools.partial(
        _render_kernel,
        n_samples=n_samples, width=width, height=height,
        bounces=bounces, rr_start=rr_start, counts=counts,
        tmin=tmin, sky=sky, used_kinds=used_kinds,
        russian_roulette=russian_roulette,
        additive_emission=additive_emission,
    )
    ray_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    out = jax.ShapeDtypeStruct((n,), jnp.float32)
    return pl.pallas_call(
        kern,
        grid=(n // RAY_BLOCK,),
        in_specs=[whole(bases), whole(frame), ray_spec, whole(prims)],
        out_specs=[ray_spec] * 3,
        out_shape=[out] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="megastep_render",
    )(bases, frame, pid, prims)


# Floats of the packed camera frame, padded to a power of two.
_FRAME_LEN = 32


def _pack_frame(frame) -> jnp.ndarray:
    """CameraFrame -> the flat layout _raygen_core reads."""
    vec = jnp.concatenate([
        jnp.asarray(frame.origin, jnp.float32).reshape(3),
        jnp.asarray(frame.lower_left, jnp.float32).reshape(3),
        jnp.asarray(frame.horizontal, jnp.float32).reshape(3),
        jnp.asarray(frame.vertical, jnp.float32).reshape(3),
        jnp.asarray(frame.right, jnp.float32).reshape(3),
        jnp.asarray(frame.true_up, jnp.float32).reshape(3),
        jnp.asarray(frame.lens_radius, jnp.float32).reshape(1),
        jnp.asarray(frame.time0, jnp.float32).reshape(1),
        jnp.asarray(frame.time1, jnp.float32).reshape(1),
    ])
    return jnp.pad(vec, (0, _FRAME_LEN - vec.shape[0]))


@functools.partial(jax.jit, static_argnames=("width", "height", "interpret"))
def primary_rays(frame, key, width: int, height: int,
                 interpret: bool = False):
    """The megastep's in-kernel raygen alone, one ray per pixel of the
    image: (origins (N, 3), directions (N, 3), times (N,)). For checking
    the kernel against camera.generate_rays (same frame and key)."""
    n = width * height
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(2)
    pid = jnp.arange(n, dtype=jnp.uint32)

    def kernel(key_ref, frame_ref, pid_ref, *out_refs):
        p = pid_ref[...]
        rays = _raygen_core(p, jnp.full(p.shape, key_ref[0]),
                            jnp.full(p.shape, key_ref[1]), frame_ref,
                            width=width, height=height)
        for ref, value in zip(out_refs, rays):
            ref[...] = value

    frame_vec = _pack_frame(frame)
    ray_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    ox, oy, oz, dx, dy, dz, tm = pl.pallas_call(
        kernel,
        grid=(n // RAY_BLOCK,),
        in_specs=[whole(kd), whole(frame_vec), ray_spec],
        out_specs=[ray_spec] * 7,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * 7,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="megastep_raygen",
    )(kd, frame_vec, pid)
    return (jnp.stack([ox, oy, oz], -1), jnp.stack([dx, dy, dz], -1), tm)


def render_samples(packed: MegastepScene, frame, sample_keys, cfg,
                   pixel_ids=None, interpret: bool = False) -> jnp.ndarray:
    """Render `len(sample_keys)` spp of `pixel_ids` in ONE kernel launch.

    `frame` is a camera.CameraFrame; `sample_keys` the (S,)-batched
    jax.random keys of integrator.render_pass (one per sample, the stream
    the XLA engine consumes). `pixel_ids` defaults to the whole image; a
    shard passes its global ids. The ray count is padded to a RAY_BLOCK
    multiple (padding rays trace pixel 0 and are dropped). Returns the
    summed radiance (N, 3). `interpret=True` runs the kernel through the
    Pallas interpreter (tests on a CPU).
    """
    if pixel_ids is None:
        pixel_ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    n = pixel_ids.shape[0]
    n_pad = -(-n // RAY_BLOCK) * RAY_BLOCK
    pid = jnp.pad(pixel_ids.astype(jnp.uint32), (0, n_pad - n))
    kd = jax.random.key_data(sample_keys).astype(jnp.uint32)
    n_samples = int(kd.shape[0])
    bases = jnp.pad(kd.T, ((0, 0), (0, _pow2(n_samples) - n_samples)))
    frame_vec, prims = _forward_only((_pack_frame(frame), packed.prims))
    rx, ry, rz = _run_render(
        pid, bases, frame_vec, prims, packed.counts, n_samples,
        int(cfg.width), int(cfg.height), float(cfg.tmin),
        bool(cfg.sky_background), packed.used_kinds,
        bool(cfg.russian_roulette), bool(packed.has_emission),
        int(cfg.bounces), int(cfg.rr_start_bounce), bool(interpret),
    )
    return jnp.stack([rx[:n], ry[:n], rz[:n]], axis=-1)


@jax.custom_vjp
def _forward_only(tree):
    """Identity that FAILS LOUDLY under reverse-mode AD.

    A plain stop_gradient here would silently return zero gradients to
    anyone differentiating a megastep render; this raises instead.
    """
    return tree


def _forward_only_fwd(tree):
    return tree, None


def _forward_only_bwd(_, ct):
    raise NotImplementedError(
        "the megastep (a finalized scene rendered on a GPU) is forward-only; "
        "differentiate the unfinalized scene (SceneBuilder.build()), which "
        "renders through the differentiable XLA wavefront engine."
    )


_forward_only.defvjp(_forward_only_fwd, _forward_only_bwd)


__all__ = ["MegastepScene", "pack_megastep", "render_samples", "RAY_BLOCK"]
