"""BVH sidecar cache.

The reference serializes its flattened BVH to `<mesh>.bvh` next to the model
and invalidates by file mtime (BVH.cpp:500-554). Here the cache is an .npz
keyed by a content hash of the triangle tensor — mtime lies, bytes don't —
stored either next to the mesh or under a cache dir.
"""

from __future__ import annotations

import hashlib
import os

import jax.numpy as jnp
import numpy as np

from rtnw.ops.bvh import BVH, build_bvh


def mesh_hash(vertices) -> str:
    arr = np.ascontiguousarray(np.asarray(vertices, np.float32))
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def cache_path_for(mesh_path: str, vertices) -> str:
    return f"{mesh_path}.{mesh_hash(vertices)}.bvh.npz"


def save_bvh(path: str, bvh: BVH) -> None:
    np.savez_compressed(
        path,
        left=np.asarray(bvh.left),
        right=np.asarray(bvh.right),
        node_lo=np.asarray(bvh.node_lo),
        node_hi=np.asarray(bvh.node_hi),
        tri_order=np.asarray(bvh.tri_order),
        range_first=np.asarray(bvh.range_first),
        range_last=np.asarray(bvh.range_last),
    )


def load_bvh(path: str) -> BVH:
    with np.load(path) as z:
        return BVH(
            left=jnp.asarray(z["left"]),
            right=jnp.asarray(z["right"]),
            node_lo=jnp.asarray(z["node_lo"]),
            node_hi=jnp.asarray(z["node_hi"]),
            tri_order=jnp.asarray(z["tri_order"]),
            range_first=jnp.asarray(z["range_first"]),
            range_last=jnp.asarray(z["range_last"]),
        )


def build_or_load(triangles, mesh_path: str | None = None) -> BVH:
    """Build the LBVH, consulting the sidecar cache when a path is given."""
    if mesh_path is None:
        return build_bvh(triangles)
    path = cache_path_for(mesh_path, triangles.vertices)
    if os.path.exists(path):
        try:
            return load_bvh(path)
        except Exception:
            pass  # corrupt cache -> rebuild
    bvh = build_bvh(triangles)
    try:
        save_bvh(path, bvh)
    except OSError:
        pass  # read-only location -> skip caching
    return bvh
