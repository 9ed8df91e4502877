import jax
import jax.numpy as jnp
import numpy as np

from rtnw.models import camera as cam

W, H = 16, 16


def simple_camera(aperture=0.0):
    return cam.Camera.make(
        eye=(0.0, 0.0, 1.0),
        center=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        fov=60.0,
        aperture=aperture,
        focus_distance=2.0,
        time0=0.0,
        time1=1.0,
    )


def test_frame_matches_reference_math():
    frame = cam.derive(simple_camera(), aspect_ratio=1.0)
    # scale = tan(30 deg); viewport = 2*scale * focus (Camera.h:88-99).
    s = np.tan(np.deg2rad(30.0))
    np.testing.assert_allclose(np.asarray(frame.horizontal), [2 * s * 2.0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(frame.vertical), [0, 2 * s * 2.0, 0], atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(frame.lower_left), [-2 * s, -2 * s, -1.0], atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(frame.lens_radius), 0.0)


def test_center_ray_points_forward():
    frame = cam.derive(simple_camera(), aspect_ratio=1.0)
    rays, _ = cam.generate_rays(frame, jax.random.key(0), W, H)
    assert rays.origin.shape == (W * H, 3)
    d = np.asarray(rays.direction)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    # All rays point forward (-z) for this fov.
    assert (d[:, 2] < 0).all()
    np.testing.assert_allclose(np.asarray(rays.origin), [[0, 0, 1]] * (W * H))
    # Mean direction is near the forward axis. NOTE: the reference divides
    # by (width-1), not width (main.cu:182-183), so the sample lattice spans
    # [0, w/(w-1)] and the mean sits slightly off-center — we reproduce that.
    np.testing.assert_allclose(d.mean(axis=0)[:2], [0, 0], atol=0.05)


def test_aperture_spreads_origins_within_lens_disk():
    frame = cam.derive(simple_camera(aperture=0.5), aspect_ratio=1.0)
    rays, _ = cam.generate_rays(frame, jax.random.key(1), W, H)
    o = np.asarray(rays.origin) - np.asarray([0, 0, 1.0])
    r = np.linalg.norm(o[:, :2], axis=1)
    assert r.max() <= 0.25 + 1e-6  # lensRadius = aperture/2 (Camera.h:112)
    assert r.max() > 0.05


def test_shutter_times_in_range():
    frame = cam.derive(simple_camera(), aspect_ratio=1.0)
    rays, _ = cam.generate_rays(frame, jax.random.key(2), W, H)
    t = np.asarray(rays.time)
    assert (t >= 0.0).all() and (t < 1.0).all()
    assert t.std() > 0.1


def test_rays_differentiable_wrt_eye():
    def mean_dir_x(eye_x):
        camera = cam.Camera.make(
            eye=jnp.stack([eye_x, jnp.float32(0.0), jnp.float32(1.0)]),
            center=(0.0, 0.0, -1.0),
            fov=60.0,
            aperture=0.0,
            focus_distance=2.0,
        )
        frame = cam.derive(camera, 1.0)
        rays, _ = cam.generate_rays(frame, jax.random.key(3), 4, 4)
        return jnp.mean(rays.direction[:, 0])

    g = jax.grad(mean_dir_x)(jnp.float32(0.0))
    assert np.isfinite(np.asarray(g))
    fd = (mean_dir_x(jnp.float32(1e-2)) - mean_dir_x(jnp.float32(-1e-2))) / 2e-2
    np.testing.assert_allclose(g, fd, rtol=1e-2, atol=1e-4)
