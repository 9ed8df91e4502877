"""LBVH build invariants, traversal-vs-brute-force equivalence, refit, cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtnw.io.procedural import uv_sphere_mesh
from rtnw.ops import intersect, traverse
from rtnw.ops.bvh import BVH, build_bvh, refit
from rtnw.ops.geometry import Triangles
from rtnw.ops.rays import Rays

INF = float("inf")


def soup(n, seed=0, spread=2.0, size=0.3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 1, 3)).astype(np.float32)
    verts = base + rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    return Triangles(
        vertices=jnp.asarray(verts),
        material_id=jnp.asarray(rng.integers(0, 4, n), jnp.int32),
        mesh_id=jnp.zeros((n,), jnp.int32),
    )


def random_rays(n, seed=1, spread=4.0):
    """Rays from a shell, aimed at jittered points near the origin — high
    hit rate against scenes concentrated in the central +-spread/2 cube."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target = rng.uniform(-spread / 3, spread / 3, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(jnp.asarray(o), jnp.asarray(d), jnp.zeros((n,), jnp.float32))


def test_tree_invariants():
    tris = soup(257)
    bvh = build_bvh(tris)
    T = 257
    I = T - 1
    assert bvh.left.shape == (I,) and bvh.right.shape == (I,)
    left, right = np.asarray(bvh.left), np.asarray(bvh.right)
    first, last = np.asarray(bvh.range_first), np.asarray(bvh.range_last)
    # Root covers everything.
    assert first[0] == 0 and last[0] == T - 1
    # Every node is someone's child exactly once (except root).
    children = np.concatenate([left, right])
    assert len(np.unique(children)) == len(children) == 2 * I
    assert 0 not in children  # root has no parent
    # Leaf boxes contain their triangles; parents contain children.
    lo, hi = np.asarray(bvh.node_lo), np.asarray(bvh.node_hi)
    order = np.asarray(bvh.tri_order)
    v = np.asarray(tris.vertices)[order]
    np.testing.assert_allclose(lo[I:], v.min(axis=1), atol=1e-6)
    np.testing.assert_allclose(hi[I:], v.max(axis=1), atol=1e-6)
    assert (lo[np.arange(I)] <= lo[left] + 1e-6).all()
    assert (hi[np.arange(I)] >= hi[left] - 1e-6).all()
    assert (lo[np.arange(I)] <= lo[right] + 1e-6).all()
    assert (hi[np.arange(I)] >= hi[right] - 1e-6).all()
    # Internal ranges: children partition the parent's range.
    for node in [0, 1, I // 2, I - 1]:
        lf = first[left[node]] if left[node] < I else left[node] - I
        ll = last[left[node]] if left[node] < I else left[node] - I
        rf = first[right[node]] if right[node] < I else right[node] - I
        rl = last[right[node]] if right[node] < I else right[node] - I
        assert lf == first[node] and rl == last[node] and ll + 1 == rf


def _compare(tris, rays, backface_cull=True):
    bvh = build_bvh(tris)
    brute = intersect.intersect_triangles(rays, tris, 1e-3, INF, backface_cull)
    accel = traverse.intersect_bvh(rays, tris, bvh, 1e-3, INF, backface_cull)
    np.testing.assert_array_equal(np.asarray(brute.valid), np.asarray(accel.valid))
    bt, at = np.asarray(brute.t), np.asarray(accel.t)
    valid = np.asarray(brute.valid)
    np.testing.assert_allclose(bt[valid], at[valid], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(brute.material_id), np.asarray(accel.material_id)
    )
    np.testing.assert_allclose(
        np.asarray(brute.normal)[valid], np.asarray(accel.normal)[valid],
        atol=1e-5,
    )
    assert valid.mean() > 0.05  # the comparison actually exercised hits


def test_bvh_matches_brute_force_soup():
    _compare(soup(313, seed=3), random_rays(512, seed=4))


def test_bvh_matches_brute_force_two_sided():
    _compare(soup(128, seed=5), random_rays(256, seed=6), backface_cull=False)


def test_bvh_matches_brute_force_mesh():
    mesh = uv_sphere_mesh(0.8, n_lat=12, n_lon=24)
    tris = Triangles(
        vertices=jnp.asarray(mesh),
        material_id=jnp.zeros((mesh.shape[0],), jnp.int32),
        mesh_id=jnp.zeros((mesh.shape[0],), jnp.int32),
    )
    _compare(tris, random_rays(512, seed=7, spread=2.0))


def test_refit_matches_rebuild():
    tris = soup(100, seed=8)
    bvh = build_bvh(tris)
    moved = tris._replace(vertices=tris.vertices + 0.5)
    refitted = refit(bvh, moved)
    rebuilt_boxes = build_bvh(moved)
    # Topology unchanged...
    np.testing.assert_array_equal(np.asarray(bvh.left), np.asarray(refitted.left))
    # ...boxes equal to a fresh host fit (same topology: uniform translation
    # preserves Morton order).
    np.testing.assert_allclose(
        np.asarray(refitted.node_lo), np.asarray(rebuilt_boxes.node_lo),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(refitted.node_hi), np.asarray(rebuilt_boxes.node_hi),
        atol=1e-5,
    )


def test_refit_is_jittable():
    tris = soup(64, seed=9)
    bvh = build_bvh(tris)
    refit_jit = jax.jit(refit)
    out = refit_jit(bvh, tris)
    np.testing.assert_allclose(
        np.asarray(out.node_lo), np.asarray(bvh.node_lo), atol=1e-5
    )


def test_vertex_gradient_through_bvh_hit():
    tris = soup(128, seed=10, size=0.8)
    bvh = build_bvh(tris)
    rays = random_rays(256, seed=11)

    hit0 = traverse.intersect_bvh(rays, tris, bvh, 1e-3, INF)
    target = np.flatnonzero(np.asarray(hit0.valid))[0]

    def t_of_shift(dz):
        shifted = tris._replace(
            vertices=tris.vertices.at[:, :, 2].add(dz)
        )
        hit = traverse.intersect_bvh(rays, shifted, bvh, 1e-3, INF)
        return hit.t[target]

    g = jax.grad(t_of_shift)(jnp.float32(0.0))
    fd = (t_of_shift(jnp.float32(1e-3)) - t_of_shift(jnp.float32(-1e-3))) / 2e-3
    np.testing.assert_allclose(np.asarray(g), np.asarray(fd), rtol=2e-2, atol=1e-3)


def test_cache_roundtrip(tmp_path):
    from rtnw.io.bvh_cache import (
        build_or_load,
        cache_path_for,
        load_bvh,
        save_bvh,
    )

    tris = soup(50, seed=12)
    bvh = build_bvh(tris)
    p = str(tmp_path / "m.bvh.npz")
    save_bvh(p, bvh)
    back = load_bvh(p)
    for a, b in zip(bvh, back):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    mesh_path = str(tmp_path / "mesh.obj")
    b1 = build_or_load(tris, mesh_path)
    import os

    assert os.path.exists(cache_path_for(mesh_path, tris.vertices))
    b2 = build_or_load(tris, mesh_path)  # cache hit
    np.testing.assert_array_equal(np.asarray(b1.left), np.asarray(b2.left))


def _sphere_mesh(seed):
    mesh = uv_sphere_mesh(0.8 + 0.1 * seed, n_lat=8 + 4 * seed,
                          n_lon=16 + 8 * seed)
    return Triangles(
        vertices=jnp.asarray(mesh),
        material_id=jnp.zeros((mesh.shape[0],), jnp.int32),
        mesh_id=jnp.zeros((mesh.shape[0],), jnp.int32),
    )


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
@pytest.mark.parametrize("mesh", ["soup", "sphere"])
@pytest.mark.parametrize("seed", [0, 1])
def test_traverse_winner_exact_vs_brute(builder, mesh, seed):
    """The BVH walk finds exactly the brute-force closest triangle, for
    both builders finalize() may use, and its t to a few ulps (the walk and
    the (rays, triangles) broadcast round differently in the last bits)."""
    from rtnw import native

    if builder == "sah" and not native.available():
        pytest.skip("native library could not be built")
    tris = soup(300 + 50 * seed, seed=seed) if mesh == "soup" \
        else _sphere_mesh(seed)
    rays = random_rays(1024, seed=10 + seed, spread=4.0 if mesh == "soup"
                       else 2.0)
    bvh = native.build_sah_bvh(tris) if builder == "sah" else build_bvh(tris)
    t, valid, _ = intersect.moller_trumbore(rays, tris.vertices, 1e-3, INF)
    masked = np.where(np.asarray(valid), np.asarray(t), np.inf)
    winner = masked.argmin(axis=1)
    t_brute = masked[np.arange(masked.shape[0]), winner]
    winner = np.where(np.isfinite(t_brute), winner, -1)
    best_t, best_tri, _, _ = traverse.traverse(rays, tris, bvh, 1e-3, INF)
    np.testing.assert_array_equal(np.asarray(best_tri), winner)
    hit = winner >= 0
    assert not np.isfinite(np.asarray(best_t)[~hit]).any()
    np.testing.assert_allclose(np.asarray(best_t)[hit], t_brute[hit],
                               rtol=1e-6)
    assert hit.mean() > 0.05
