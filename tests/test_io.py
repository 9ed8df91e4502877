"""IO round-trips: PNG, PPM, OBJ, PLY, YAML scenes."""

import os

import numpy as np
import pytest

from rtnw.io.image import read_png, write_png, write_ppm
from rtnw.io.obj import load_obj, parse_obj
from rtnw.io.ply import load_ply, normalize_mesh, parse_ply
from rtnw.io.procedural import (
    cube_mesh,
    uv_sphere_mesh,
    write_obj,
)
from rtnw.io.yaml_scene import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MODELS = "/root/reference/RayTracingTheNextWeekCUDA/resources/models"


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    path = str(tmp_path / "t.png")
    write_png(path, img)
    back = read_png(path)
    np.testing.assert_array_equal(img, back)


def test_ppm_write(tmp_path):
    img = np.zeros((2, 3, 3), np.uint8)
    img[0, 0] = (255, 128, 0)
    path = str(tmp_path / "t.ppm")
    write_ppm(path, img)
    lines = open(path).read().split("\n")
    assert lines[0] == "P3" and lines[1] == "3 2" and lines[2] == "255"
    assert lines[3] == "255 128 0"


def test_obj_roundtrip(tmp_path):
    tris = cube_mesh(0.25)
    path = str(tmp_path / "cube.obj")
    write_obj(path, tris)
    back = load_obj(path)
    assert back.shape == (12, 3, 3)
    # Same geometry: matching AABB and total area.
    np.testing.assert_allclose(back.reshape(-1, 3).min(0), -0.25, atol=1e-5)
    np.testing.assert_allclose(back.reshape(-1, 3).max(0), 0.25, atol=1e-5)


def area(tris):
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()


def test_cube_mesh_geometry():
    tris = cube_mesh(0.25)
    np.testing.assert_allclose(area(tris), 6 * 0.5**2, atol=1e-5)
    # All normals point outward.
    c = tris.mean(axis=1)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    assert (np.sum(c * n, axis=1) > 0).all()


def test_uv_sphere_area_converges():
    tris = uv_sphere_mesh(1.0, n_lat=64, n_lon=128)
    np.testing.assert_allclose(area(tris), 4 * np.pi, rtol=2e-3)


def test_obj_transform_matches_reference_order():
    # scale -> rotateY -> offset (ModelLoader.cpp:438-445).
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tri.obj")
        with open(path, "w") as f:
            f.write("v 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\n")
        out = load_obj(path, scale=(2, 2, 2), rotate=(0, 90, 0), offset=(1, 0, 0))
    # (1,0,0)*2 = (2,0,0); rotY90: x'=z=0, z'=-x=-2 -> (0,0,-2); +1x -> (1,0,-2)
    np.testing.assert_allclose(out[0, 0], [1, 0, -2], atol=1e-5)


def test_normalize_mesh():
    pts = np.asarray([[0, 0, 0], [4, 2, 0], [2, 1, 6]], np.float32)
    out = normalize_mesh(pts, offset=(1, 1, 1))
    centered = out - 1
    assert abs(np.abs(centered).max() - 1.0) < 1e-6
    np.testing.assert_allclose(
        (centered.min(0) + centered.max(0)) / 2, 0, atol=1e-6
    )


def test_yaml_scene_loads_shipped_cornell():
    scene, camera = load_scene(
        os.path.join(REPO, "scenes", "cornellbox.yaml"),
        model_roots=[os.path.join(REPO, "assets", "models")],
    )
    assert scene.planes.count == 6
    assert scene.spheres.count == 2
    assert scene.triangles.count == 24  # two cubes
    import numpy as np

    np.testing.assert_allclose(np.asarray(camera.eye), [0, 0, 1])
    np.testing.assert_allclose(float(camera.focus_distance), 2.0)
    # Material table: emission at id 8 with intensity 5.
    assert int(scene.materials.kind[8]) == 3
    assert float(scene.materials.param[8]) == 5.0


@pytest.mark.skipif(not os.path.isdir(REF_MODELS), reason="reference assets absent")
def test_reference_obj_loads():
    tris = load_obj(os.path.join(REF_MODELS, "cube", "cube_small.obj"))
    assert tris.shape == (12, 3, 3)
    np.testing.assert_allclose(tris.reshape(-1, 3).min(0), -0.25, atol=1e-6)


@pytest.mark.skipif(not os.path.isdir(REF_MODELS), reason="reference assets absent")
def test_reference_ply_loads_and_normalizes():
    tris = load_ply(os.path.join(REF_MODELS, "bunny", "bunny.ply"))
    assert tris.shape[0] == 4968 * 1 or tris.shape[0] >= 4968  # fan >= faces
    flat = tris.reshape(-1, 3)
    assert abs(np.abs(flat).max() - 1.0) < 1e-5  # normalized to max-coord 1


@pytest.mark.skipif(
    not os.path.isdir("/root/reference/RayTracingTheNextWeekCUDA/resources/scenes"),
    reason="reference scenes absent",
)
def test_reference_yaml_scene_loads_verbatim():
    """Reference scene files load without modification (schema parity)."""
    scene, camera = load_scene(
        "/root/reference/RayTracingTheNextWeekCUDA/resources/scenes/cornellbox2.yaml",
        model_roots=[REF_MODELS],
    )
    assert scene.planes.count == 6
    assert scene.spheres.count == 2
    assert scene.triangles.count == 24


@pytest.mark.skipif(
    not os.path.isdir("/root/reference/RayTracingTheNextWeekCUDA/resources/scenes"),
    reason="reference scenes absent",
)
@pytest.mark.parametrize("name", [
    "cornellbox_empty.yaml", "cornellbox0.yaml", "cornellbox1.yaml",
    "cornellbox3.yaml", "scene.yaml",
])
def test_all_reference_yaml_scenes_load(name):
    """EVERY shipped reference scene file loads verbatim (schema parity:
    main.cu:629-786 camera + object/material maps)."""
    scene, camera = load_scene(
        f"/root/reference/RayTracingTheNextWeekCUDA/resources/scenes/{name}",
        model_roots=[REF_MODELS],
    )
    assert scene.materials.kind.shape[0] >= 1
    assert float(camera.fov) > 0
    # Every scene must also finalize for one of the engines.
    from rtnw.models.scene import finalize

    ready = finalize(scene)
    assert ready.packed is not None or ready.bvh is not None


SCENE_FILES = sorted(
    f for f in os.listdir(os.path.join(REPO, "scenes")) if f.endswith(".yaml")
)


@pytest.mark.parametrize("name", SCENE_FILES)
def test_yaml_parser_matches_pyyaml_scene(name, monkeypatch):
    """Every shipped scene loads to the same scene with the built-in parser
    as with PyYAML (where PyYAML is installed)."""
    yaml = pytest.importorskip("yaml")
    import jax

    from rtnw.io import yaml_scene

    path = os.path.join(REPO, "scenes", name)
    ours, cam = yaml_scene.load_scene(path)
    monkeypatch.setattr(yaml_scene, "parse_yaml", yaml.safe_load)
    ref, ref_cam = yaml_scene.load_scene(path)
    for a, b in zip(jax.tree_util.tree_leaves((ours, cam)),
                    jax.tree_util.tree_leaves((ref, ref_cam))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_yaml_parser_subset():
    from rtnw.io.yaml_scene import parse_yaml

    text = """# header
camera:
  eye: [0.0, -1, 2.5e1]   # trailing comment
  label: "a # b"
objects:
  - plane:
      twoSide: false
      material: {type: 3, albedo: [1.0, 1.0, 1.0], name: 'x y'}
  -
    sphere: {radius: 0.5}
  - 7
empty:
"""
    assert parse_yaml(text) == {
        "camera": {"eye": [0.0, -1, 25.0], "label": "a # b"},
        "objects": [
            {"plane": {"twoSide": False, "material": {
                "type": 3, "albedo": [1.0, 1.0, 1.0], "name": "x y"}}},
            {"sphere": {"radius": 0.5}},
            7,
        ],
        "empty": None,
    }


@pytest.mark.parametrize("bad", [
    "a: [1, 2\n",          # unterminated flow sequence
    "a: 1\n  b: 2\n",      # indentation that opens nothing
    "a: {x 1}\n",          # flow mapping without ':'
])
def test_yaml_parser_rejects_malformed(bad):
    from rtnw.io.yaml_scene import parse_yaml

    with pytest.raises(ValueError):
        parse_yaml(bad)
