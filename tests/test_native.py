"""Native binned-SAH builder vs LBVH: identical traversal results, same
tree contract, and a tree-quality (SAH cost) comparison."""

import os

import numpy as np
import pytest

from rtnw import native
from rtnw.ops import intersect, traverse
from rtnw.ops.bvh import build_bvh

from tests.test_bvh import random_rays, soup


@pytest.fixture(autouse=True)
def _native_library():
    """Built from native/*.cpp at first use; skips where no compiler is."""
    if not native.available():
        pytest.skip(f"native library could not be built: {native._BUILD_ERROR}")


INF = float("inf")


def test_contract_invariants():
    tris = soup(200, seed=20)
    bvh = native.build_sah_bvh(tris)
    T = 200
    I = T - 1
    left, right = np.asarray(bvh.left), np.asarray(bvh.right)
    first, last = np.asarray(bvh.range_first), np.asarray(bvh.range_last)
    assert first[0] == 0 and last[0] == T - 1
    children = np.concatenate([left, right])
    assert len(np.unique(children)) == 2 * I and 0 not in children
    assert sorted(np.asarray(bvh.tri_order)) == list(range(T))
    lo, hi = np.asarray(bvh.node_lo), np.asarray(bvh.node_hi)
    # parent boxes contain children
    assert (lo[np.arange(I)] <= lo[left] + 1e-6).all()
    assert (hi[np.arange(I)] >= hi[right] - 1e-6).all()


def test_traversal_matches_brute_force():
    tris = soup(257, seed=21)
    rays = random_rays(512, seed=22)
    bvh = native.build_sah_bvh(tris)
    brute = intersect.intersect_triangles(rays, tris, 1e-3, INF)
    accel = traverse.intersect_bvh(rays, tris, bvh, 1e-3, INF)
    np.testing.assert_array_equal(np.asarray(brute.valid), np.asarray(accel.valid))
    v = np.asarray(brute.valid)
    np.testing.assert_allclose(
        np.asarray(brute.t)[v], np.asarray(accel.t)[v], rtol=1e-5
    )
    assert v.mean() > 0.1


def _sah_cost(bvh):
    lo, hi = np.asarray(bvh.node_lo), np.asarray(bvh.node_hi)
    ext = np.maximum(hi - lo, 0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    root = area[0] if area[0] > 0 else 1.0
    return area.sum() / root


def test_sah_tree_no_worse_than_lbvh():
    tris = soup(1000, seed=23)
    sah = native.build_sah_bvh(tris)
    lbvh = build_bvh(tris)
    # Total normalized surface area (expected node visits proxy): SAH should
    # be competitive or better.
    assert _sah_cost(sah) <= _sah_cost(lbvh) * 1.1


def test_build_from_sources():
    """The library is compiled from native/*.cpp (nothing binary is kept in
    the repository) and is fresh afterwards."""
    path = native.build()
    assert path == native.LIB_PATH and os.path.getsize(path) > 0
    assert not native._stale()
