"""Scene presets build + tiny renders; CLI end-to-end."""

import os
import subprocess
import sys

import numpy as np

from rtnw.config import RenderConfig
from rtnw.models import integrator, presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_render(scene, camera, **kw):
    cfg = RenderConfig(
        width=kw.get("width", 24), height=kw.get("height", 24),
        spp=kw.get("spp", 2), bounces=kw.get("bounces", 3), spp_per_pass=2,
    )
    film = integrator.render(scene, camera, cfg)
    img = np.asarray(film.mean)
    assert np.isfinite(img).all()
    return img


def test_diffuse_sphere_plane():
    img = tiny_render(*presets.diffuse_sphere_plane())
    assert img.mean() > 0.05


def test_defocus_blur_scene():
    scene, camera = presets.defocus_blur()
    assert scene.spheres.count == 5
    img = tiny_render(scene, camera)
    assert img.mean() > 0.05


def test_cornell_box_scene():
    scene, camera = presets.cornell_box()
    assert scene.planes.count == 6
    assert scene.spheres.count == 2
    assert scene.triangles.count == 24
    img = tiny_render(scene, camera, spp=4, bounces=5)
    # Lit from above: image not black, not blown out everywhere.
    assert 0.005 < img.mean() < 1.0


def test_rtiow_final_scene():
    scene, camera = presets.rtiow_final(seed=1)
    assert scene.spheres.count >= 400  # ~484 + overlap-culled variants
    img = tiny_render(scene, camera, spp=1, bounces=2)
    assert img.mean() > 0.05


def test_mesh_showcase_scene():
    scene, camera = presets.mesh_showcase(n_lat=6, n_lon=12)
    assert scene.triangles.count > 50
    img = tiny_render(scene, camera, spp=2, bounces=3)
    assert img.mean() > 0.001


def test_cli_render_end_to_end(tmp_path):
    out = str(tmp_path / "out.png")
    env = dict(os.environ, RTNW_PLATFORM="cpu")
    proc = subprocess.run(
        [
            sys.executable, "-m", "rtnw.cli", "render",
            "--preset", "sphere-plane", "--width", "32", "--height", "32",
            "--spp", "2", "--bounces", "2", "--out", out,
        ],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    from rtnw.io.image import read_png

    img = read_png(out)
    assert img.shape == (32, 32, 3)
    assert img.mean() > 10  # not black


def test_cli_render_yaml_scene(tmp_path):
    out = str(tmp_path / "cornell.png")
    env = dict(os.environ, RTNW_PLATFORM="cpu")
    proc = subprocess.run(
        [
            sys.executable, "-m", "rtnw.cli", "render",
            "--scene", os.path.join(REPO, "scenes", "cornellbox.yaml"),
            "--width", "24", "--height", "24", "--spp", "2", "--bounces", "3",
            "--out", out,
        ],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(out)
