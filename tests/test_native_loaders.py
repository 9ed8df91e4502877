"""Native C++ mesh loaders (native/asset_loader.cpp) vs the Python oracle.

The native loaders are the counterpart of the reference's C++ asset layer
(ModelLoader.cpp OBJ, Loader.cpp PLY); the Python parsers in io/ are the
oracle. Skipped where the library cannot be built.
"""

import struct

import numpy as np
import pytest

from rtnw import native
from rtnw.io import obj as obj_mod
from rtnw.io import ply as ply_mod


@pytest.fixture(autouse=True)
def _native_library():
    """Built from native/*.cpp at first use; skips where no compiler is."""
    if not native.available():
        pytest.skip(f"native library could not be built: {native._BUILD_ERROR}")


OBJ_TEXT = """# comment
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.0
v 0.5 0.5 1.0
f 1 2 3 4
f 1/2/3 2//1 5/4
f -1 -2 -3
"""

PLY_ASCII = """ply
format ascii 1.0
comment made by hand
element vertex 5
property float x
property float y
property float z
property float confidence
element face 3
property list uchar int vertex_indices
end_header
0 0 0 0.5
2 0 0 0.5
2 2 0 0.5
0 2 0 0.5
1 1 3 0.5
3 0 1 2
3 0 2 3
4 0 1 4 3
"""


def _write_binary_ply(path, positions, faces):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % len(positions))
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"element face %d\n" % len(faces))
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        for p in positions:
            f.write(struct.pack("<3f", *p))
        for face in faces:
            f.write(struct.pack("<B", len(face)))
            f.write(struct.pack("<%di" % len(face), *face))


def test_obj_native_matches_python(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    kwargs = dict(scale=(2.0, 1.0, 0.5), rotate=(0.0, 30.0, 0.0),
                  offset=(1.0, -2.0, 3.0))
    nat = obj_mod.load_obj(str(path), **kwargs, prefer_native=True)
    ref = obj_mod.load_obj(str(path), **kwargs, prefer_native=False)
    assert nat.shape == ref.shape and nat.shape[0] == 4  # 2 + 1 + 1 fans
    np.testing.assert_allclose(nat, ref, rtol=1e-6, atol=1e-6)


def test_ply_ascii_native_matches_python(tmp_path):
    path = tmp_path / "mesh.ply"
    path.write_text(PLY_ASCII)
    nat = ply_mod.load_ply(str(path), offset=(0.5, 0.0, -1.0),
                           prefer_native=True)
    ref = ply_mod.load_ply(str(path), offset=(0.5, 0.0, -1.0),
                           prefer_native=False)
    assert nat.shape == ref.shape and nat.shape[0] == 4  # 1 + 1 + 2 fans
    np.testing.assert_allclose(nat, ref, rtol=1e-6, atol=1e-6)


def test_ply_binary_native(tmp_path):
    """binary_little_endian is native-only capability; verify against the
    same geometry written as ascii."""
    positions = [(0, 0, 0), (2, 0, 0), (2, 2, 0), (0, 2, 0), (1, 1, 3)]
    faces = [(0, 1, 2), (0, 2, 3), (0, 1, 4, 3)]
    path = tmp_path / "mesh_bin.ply"
    _write_binary_ply(str(path), positions, faces)
    ascii_path = tmp_path / "mesh.ply"
    ascii_path.write_text(PLY_ASCII)
    nat_bin = native.load_ply_native(str(path))
    ref = ply_mod.load_ply(str(ascii_path), prefer_native=False)
    np.testing.assert_allclose(nat_bin, ref, rtol=1e-6, atol=1e-6)


def test_native_repo_asset_matches_python():
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
    path = os.path.join(root, "cube", "cube_small.obj")
    nat = obj_mod.load_obj(path, scale=(2.0, 2.0, 2.0), rotate=(0, 15.0, 0),
                           offset=(0.5, -0.7, -1.0), prefer_native=True)
    ref = obj_mod.load_obj(path, scale=(2.0, 2.0, 2.0), rotate=(0, 15.0, 0),
                           offset=(0.5, -0.7, -1.0), prefer_native=False)
    np.testing.assert_allclose(nat, ref, rtol=1e-6, atol=1e-6)


def test_native_error_reporting(tmp_path):
    with pytest.raises(ValueError):
        native.load_obj_native(str(tmp_path / "missing.obj"))
    bad = tmp_path / "bad.ply"
    bad.write_text("not a ply\n")
    with pytest.raises(ValueError):
        native.load_ply_native(str(bad))
