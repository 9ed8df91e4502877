"""ctypes bindings for the native C++ components.

`build_sah_bvh` is the native counterpart of ops/bvh.build_bvh: a binned-SAH
builder (better tree quality than LBVH — fewer node visits per ray) filling
the exact same flat-array contract, so traversal code is builder-agnostic.
The library is compiled from native/*.cpp at first use into the git-ignored
native/build/ (or ahead of time with `python -m rtnw.native`); callers fall
back to LBVH when no C++ compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import jax.numpy as jnp
import numpy as np

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SOURCES = [os.path.join(_NATIVE, f) for f in ("bvh_builder.cpp", "asset_loader.cpp")]
LIB_PATH = os.path.join(_NATIVE, "build", "librtnw_native.so")

_LIB = None
_BUILD_ERROR = None


def build() -> str:
    """Compile native/*.cpp into LIB_PATH and return the path.

    The compiler writes a temporary file that is then renamed into place,
    so concurrent first uses (test workers) never load a partial library.
    """
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(LIB_PATH), suffix=".so")
    os.close(fd)
    try:
        subprocess.run(
            ["c++", "-O3", "-std=c++17", "-fno-math-errno", "-shared", "-fPIC",
             *_SOURCES, "-o", tmp],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(src) > built for src in _SOURCES)


def _load():
    """The loaded library, built first if missing or older than its
    sources; None when it cannot be built (the error is kept in
    `_BUILD_ERROR`)."""
    global _LIB, _BUILD_ERROR
    if _LIB is not None or _BUILD_ERROR is not None:
        return _LIB
    if _stale():
        try:
            build()
        except (OSError, subprocess.CalledProcessError) as e:
            _BUILD_ERROR = getattr(e, "stderr", None) or str(e)
            return None
    lib = ctypes.CDLL(LIB_PATH)
    lib.rtnw_build_sah_bvh.restype = ctypes.c_int32
    lib.rtnw_build_sah_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rtnw_load_mesh.restype = ctypes.c_int64
    lib.rtnw_load_mesh.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.c_float, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rtnw_mesh_read.restype = ctypes.c_int32
    lib.rtnw_mesh_read.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    ]
    lib.rtnw_last_error.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_sah_bvh(triangles):
    """Native binned-SAH build -> ops.bvh.BVH (same contract as build_bvh).

    Raises RuntimeError if the native library cannot be built or the build
    fails.
    """
    from rtnw.ops.bvh import BVH

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library could not be built: {_BUILD_ERROR}")
    verts = np.ascontiguousarray(np.asarray(triangles.vertices), np.float32)
    t = verts.shape[0]
    if t < 2:
        raise ValueError("need >= 2 triangles")
    i_n = t - 1
    left = np.empty(i_n, np.int32)
    right = np.empty(i_n, np.int32)
    node_lo = np.empty((2 * t - 1, 3), np.float32)
    node_hi = np.empty((2 * t - 1, 3), np.float32)
    tri_order = np.empty(t, np.int32)
    range_first = np.empty(i_n, np.int32)
    range_last = np.empty(i_n, np.int32)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    depth = lib.rtnw_build_sah_bvh(
        fp(verts), t, ip(left), ip(right), fp(node_lo), fp(node_hi),
        ip(tri_order), ip(range_first), ip(range_last),
    )
    if depth <= 0:
        raise RuntimeError(f"native SAH build failed (code {depth})")
    return BVH(
        left=jnp.asarray(left),
        right=jnp.asarray(right),
        node_lo=jnp.asarray(node_lo),
        node_hi=jnp.asarray(node_hi),
        tri_order=jnp.asarray(tri_order),
        range_first=jnp.asarray(range_first),
        range_last=jnp.asarray(range_last),
    )


def _load_mesh(path: str, kind: int, scale, rotate_y: float, offset,
               normalize: bool, max_coord: float) -> np.ndarray:
    """Native mesh parse + transform -> (T, 3, 3) f32 triangles.

    The C++ counterpart of io/obj.load_obj (kind=0) and io/ply.load_ply
    (kind=1) — same transforms, single-pass tokenizer, plus
    binary_little_endian PLY support the Python parser lacks.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library could not be built: {_BUILD_ERROR}")
    sc = np.asarray(scale, np.float32).reshape(3)
    off = np.asarray(offset, np.float32).reshape(3)
    count = ctypes.c_int32(0)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    handle = lib.rtnw_load_mesh(
        path.encode(), kind, fp(sc), float(rotate_y), fp(off),
        1 if normalize else 0, float(max_coord), ctypes.byref(count),
    )
    if handle < 0:
        raise ValueError(
            f"{path}: {lib.rtnw_last_error().decode(errors='replace')}"
        )
    tris = np.empty((count.value, 3, 3), np.float32)
    if lib.rtnw_mesh_read(handle, fp(tris)) != 0:
        raise RuntimeError(lib.rtnw_last_error().decode(errors="replace"))
    return tris


def load_obj_native(path: str, scale=(1.0, 1.0, 1.0), rotate=(0.0, 0.0, 0.0),
                    offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Native OBJ load: v *= scale; rotateY(v); v += offset
    (ModelLoader.cpp:438-445 — only rotate.y is used, like the reference)."""
    rot_y = float(np.asarray(rotate, np.float32).reshape(3)[1])
    return _load_mesh(path, 0, scale, rot_y, offset, False, 1.0)


def load_ply_native(path: str, offset=(0.0, 0.0, 0.0), normalize: bool = True,
                    max_coord: float = 1.0) -> np.ndarray:
    """Native PLY load (ascii or binary_little_endian) with the reference's
    center/unit-scale/offset normalization (Loader.cpp:104-150)."""
    return _load_mesh(path, 1, (1.0, 1.0, 1.0), 0.0, offset, normalize,
                      max_coord)


if __name__ == "__main__":
    print(build())
