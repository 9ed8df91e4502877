"""Aux subsystems: timing, progress, checkpoint/resume, interactive session."""

import io
import os

import jax
import numpy as np

from rtnw.config import RenderConfig
from rtnw.models import integrator, presets
from rtnw.models.checkpoint import (
    load_render_state,
    render_resumable,
    save_render_state,
)
from rtnw.models.film import Film
from rtnw.utils.progress import Progress
from rtnw.utils.timing import Timer, throughput

CFG = RenderConfig(width=16, height=16, spp=4, bounces=3, spp_per_pass=2)


def test_timer_and_throughput():
    t = Timer().start()
    x = jax.numpy.ones((128,)) * 2
    ms = t.stop(x)
    assert ms >= 0
    assert throughput(1000, 100.0) == 10000.0


def test_progress_prints_steps():
    buf = io.StringIO()
    p = Progress(10, step_percent=20, stream=buf)
    for _ in range(10):
        p.update()
    out = buf.getvalue()
    assert "20.00%" in out and "100.00%" in out


def test_checkpoint_roundtrip(tmp_path):
    scene, camera = presets.diffuse_sphere_plane()
    film = integrator.render(scene, camera, CFG)
    path = str(tmp_path / "ckpt.npz")
    save_render_state(path, film, CFG.seed, 2, scene, camera, CFG)
    film2, seed, passes = load_render_state(path, scene, camera)
    np.testing.assert_array_equal(np.asarray(film.accum), np.asarray(film2.accum))
    assert seed == CFG.seed and passes == 2


def test_checkpoint_stale_detection(tmp_path):
    scene, camera = presets.diffuse_sphere_plane()
    film = Film.create(CFG.width, CFG.height)
    path = str(tmp_path / "ckpt.npz")
    save_render_state(path, film, CFG.seed, 1, scene, camera, CFG)
    moved = camera._replace(eye=camera.eye + 1.0)
    import pytest

    with pytest.raises(ValueError, match="stale"):
        load_render_state(path, scene, moved)


def test_render_resumable_matches_straight_render(tmp_path):
    scene, camera = presets.diffuse_sphere_plane()
    straight = integrator.render(scene, camera, CFG)

    path = str(tmp_path / "resume.npz")
    # Simulate an interrupted run: checkpoint after every pass, then delete
    # the film and resume from disk.
    film1 = render_resumable(scene, camera, CFG, path, checkpoint_every=1)
    np.testing.assert_allclose(
        np.asarray(straight.accum), np.asarray(film1.accum), rtol=1e-6
    )
    # Resume when already complete: must be a no-op.
    film2 = render_resumable(scene, camera, CFG, path)
    np.testing.assert_array_equal(
        np.asarray(film1.accum), np.asarray(film2.accum)
    )


def test_interactive_session_dirty_reset_and_screenshot(tmp_path):
    from rtnw.apps.interactive import InteractiveSession

    scene, camera = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=3)
    s = InteractiveSession(scene, camera, cfg, spp_per_frame=1)
    s.step()
    s.step()
    assert s.sample_count == 2
    eye_before = np.asarray(s.camera.eye).copy()
    s.walk(0.5)
    assert not np.allclose(np.asarray(s.camera.eye), eye_before)
    s.step()  # dirty -> reset accumulation
    assert s.sample_count == 1
    s.yaw(10.0)
    s.step()
    assert s.sample_count == 1
    s.set_fov(40.0)
    s.step()
    assert s.sample_count == 1
    path = s.screenshot(str(tmp_path))
    assert path.endswith("render_16x16_spp1.png") and os.path.exists(path)


def test_interactive_orbit_preserves_distance():
    from rtnw.apps.interactive import InteractiveSession

    scene, camera = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=8, height=8, spp=1, bounces=2)
    s = InteractiveSession(scene, camera, cfg)
    target = (0.0, 0.0, -1.0)
    d0 = np.linalg.norm(np.asarray(s.camera.eye)[[0, 2]] - np.asarray(target)[[0, 2]])
    for _ in range(10):
        s.orbit(target, 0.1)
    d1 = np.linalg.norm(np.asarray(s.camera.eye)[[0, 2]] - np.asarray(target)[[0, 2]])
    np.testing.assert_allclose(d0, d1, rtol=1e-5)


def test_terminal_viewer_frame_and_live_loop(tmp_path):
    """The live preview (L8 realtime display analogue): a scripted session
    drives camera moves through run_live; the terminal frames contain ANSI
    truecolor cells, and a camera move resets the accumulation to
    spp_per_frame on the next frame (main.cu:877-881 dirty protocol)."""
    import numpy as np

    from rtnw.apps.interactive import (
        InteractiveSession,
    )
    from rtnw.apps.viewer import (
        TerminalViewer,
        run_live,
    )
    from rtnw.config import RenderConfig
    from rtnw.models import presets
    from rtnw.models.scene import finalize

    scene, camera = presets.diffuse_sphere_plane()
    scene = finalize(scene)
    cfg = RenderConfig(width=32, height=32, spp=1, bounces=3)
    session = InteractiveSession(scene, camera, cfg, spp_per_frame=1)

    import io

    out = io.StringIO()
    viewer = TerminalViewer(cols=16, rows=8, stream=out)
    # 2 idle frames, a walk (dirty -> reset), 2 more frames, screenshot.
    shots = run_live(session, commands=["w", "enter", "x"], viewer=viewer,
                     frames_per_command=2, out_dir=str(tmp_path))
    text = out.getvalue()
    assert "\x1b[38;2;" in text and "▀" in text  # truecolor half-blocks
    # After the walk's dirty reset + 2 frames + screenshot idle frames:
    # accumulation restarted (2 frames after move + 2 after screenshot).
    assert session.sample_count == 4
    # Screenshot was taken right after the walk's reset + 2 frames (spp 2),
    # proving the dirty protocol: without the reset it would read spp 4.
    assert len(shots) == 1 and shots[0].endswith("_spp2.png")

    # Frame text is well-formed for an arbitrary image.
    img = (np.random.default_rng(0).random((40, 50, 3)) * 255).astype(
        np.uint8
    )
    t = viewer.frame_text(img, status="ok")
    assert t.count("\n") == 8  # rows + status line


def test_http_viewer_serves_frames():
    import urllib.request

    import numpy as np

    from rtnw.apps.viewer import HTTPViewer

    v = HTTPViewer(port=0)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        img[:, :, 1] = 200
        v.show(img)
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{v.port}/", timeout=5
        ).read()
        assert b"frame.png" in page
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{v.port}/frame.png", timeout=5
        ).read()
        assert png.startswith(b"\x89PNG")
    finally:
        v.close()
