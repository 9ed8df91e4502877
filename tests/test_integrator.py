"""End-to-end integrator tests: analytic cases + NumPy-oracle comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtnw.config import RenderConfig
from rtnw.models import camera as cam
from rtnw.models import integrator
from rtnw.models.film import Film, to_image, tonemap_u8
from rtnw.models.scene import SceneBuilder
from rtnw.ops.rays import Rays

from tests.oracle import OracleScene, render_oracle


def look_down_z(width=32, height=32, **kw):
    return cam.Camera.make(
        eye=(0.0, 0.0, 1.0), center=(0.0, 0.0, -1.0), fov=60.0,
        aperture=0.0, focus_distance=2.0, **kw
    )


def test_empty_scene_renders_sky():
    b = SceneBuilder()
    b.lambertian(0, (1, 1, 1))
    scene = b.build()
    cfg = RenderConfig(width=8, height=8, spp=4, bounces=3, spp_per_pass=4)
    film = integrator.render(scene, look_down_z(), cfg)
    img = np.asarray(film.mean.reshape(-1, 3))
    # Every pixel must be on the white<->(.5,.7,1) gradient line: g and b
    # components satisfy b = 1 - 0.6*(1-g)/0.3... simpler: r <= g <= b <= 1.
    assert (img[:, 0] <= img[:, 1] + 1e-5).all()
    assert (img[:, 1] <= img[:, 2] + 1e-5).all()
    assert img.min() > 0.4 and img.max() <= 1.0


def test_enclosing_emissive_sphere_radiance():
    b = SceneBuilder()
    b.emission(0, (1.0, 0.5, 0.25), intensity=3.0)
    b.sphere((0, 0, 0), 50.0, 0)
    scene = b.build()
    cfg = RenderConfig(width=8, height=8, spp=2, bounces=3, spp_per_pass=2)
    film = integrator.render(scene, look_down_z(), cfg)
    img = np.asarray(film.mean)
    np.testing.assert_allclose(
        img, np.broadcast_to([3.0, 1.5, 0.75], img.shape), atol=1e-4
    )


def test_bounce_exhaustion_returns_black():
    # Sealed mirror box (cube of metal planes around the camera): rays never
    # terminate -> black (main.cu:93).
    b = SceneBuilder()
    b.metal(0, (1, 1, 1), fuzz=0.0)
    b.cube((0, 0, 0), (2, 2, 2), 0)
    scene = b.build()
    cfg = RenderConfig(width=4, height=4, spp=2, bounces=4, spp_per_pass=2)
    film = integrator.render(scene, look_down_z(), cfg)
    np.testing.assert_allclose(np.asarray(film.mean), 0.0, atol=1e-6)


def test_tonemap_matches_reference_gamma():
    vals = jnp.asarray([[0.0, 0.25, 1.0], [2.0, 0.5, 0.999**2]], jnp.float32)
    out = np.asarray(tonemap_u8(vals))
    expect = (255.99 * np.clip(np.sqrt(np.asarray(vals)), 0, 0.999)).astype(np.uint8)
    np.testing.assert_array_equal(out, expect)


def test_film_accumulation():
    film = Film.create(2, 2)
    ones = jnp.ones((2, 2, 3), jnp.float32)
    film = film.add(ones * 4, 4).add(ones * 2, 2)
    np.testing.assert_allclose(np.asarray(film.mean), 1.0)
    assert int(film.sample_count) == 6


def test_render_pass_is_deterministic():
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.sphere((0, 0, -1), 0.5, 0)
    scene = b.build()
    cfg = RenderConfig(width=8, height=8, spp=2, bounces=3, spp_per_pass=2)
    k = jax.random.key(0)
    a = integrator.render_pass(scene, look_down_z(), k, cfg, 2)
    b2 = integrator.render_pass(scene, look_down_z(), k, cfg, 2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b2))


@pytest.mark.slow
def test_matches_numpy_oracle_diffuse_sphere_plane():
    """BASELINE config 1: diffuse sphere + ground plane, statistical match."""
    albedo = (0.7, 0.3, 0.3)
    ground = (0.8, 0.8, 0.0)

    b = SceneBuilder()
    b.lambertian(0, albedo)
    b.lambertian(1, ground)
    b.sphere((0, 0, -1), 0.5, 0)
    b.plane((0, -0.5, 0), (0, 1, 0), (50, 0, 50), 2, 1, two_sided=True)
    scene = b.build()

    o = OracleScene()
    o.material(0, 0, albedo)
    o.material(1, 0, ground)
    o.sphere((0, 0, -1), 0.5, 0)
    o.plane((0, -0.5, 0), (0, 1, 0), (50, 0, 50), 2, 1)

    W = H = 48
    spp = 96
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=6, spp_per_pass=32)
    camera = cam.Camera.make(
        eye=(0, 0.25, 1.5), center=(0, 0, -1), fov=60.0, aperture=0.0,
        focus_distance=1.0,
    )
    film = integrator.render(scene, camera, cfg)
    ours = np.asarray(film.mean)

    theirs = render_oracle(
        o, eye=(0, 0.25, 1.5), center=(0, 0, -1), up=(0, 1, 0), fov=60.0,
        width=W, height=H, spp=spp, bounces=6, focus_distance=1.0,
    )

    # Converged means should agree tightly on the whole-image average and
    # loosely per 8x8 tile (MC noise at 96 spp).
    np.testing.assert_allclose(ours.mean(), theirs.mean(), rtol=0.02)
    ours_t = ours.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    theirs_t = theirs.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(ours_t, theirs_t, atol=0.06)


def test_russian_roulette_unbiased():
    b = SceneBuilder()
    b.lambertian(0, (0.6, 0.6, 0.6))
    b.sphere((0, 0, -1), 0.5, 0)
    scene = b.build()
    camera = look_down_z()
    base_cfg = RenderConfig(width=16, height=16, spp=64, bounces=8, spp_per_pass=32)
    rr_cfg = RenderConfig(
        width=16, height=16, spp=64, bounces=8, spp_per_pass=32,
        russian_roulette=True, rr_start_bounce=2,
    )
    plain = np.asarray(integrator.render(scene, camera, base_cfg).mean).mean()
    rr = np.asarray(integrator.render(scene, camera, rr_cfg, key=jax.random.key(123)).mean).mean()
    np.testing.assert_allclose(plain, rr, rtol=0.03)


def test_pixel_gradient_wrt_albedo():
    """Gradients flow through the full render (fixed sampling topology)."""
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.emission(1, (1, 1, 1), 2.0)
    b.sphere((0, 0, -1), 0.5, 0)
    b.sphere((0, 0, 0), 20.0, 1)  # emissive enclosure lights everything
    scene = b.build()
    cfg = RenderConfig(width=8, height=8, spp=4, bounces=4, spp_per_pass=4)
    camera = look_down_z()
    key = jax.random.key(5)

    def loss(albedo_r):
        s = scene._replace(
            materials=scene.materials._replace(
                albedo=scene.materials.albedo.at[0, 0].set(albedo_r)
            )
        )
        img = integrator.render_pass(s, camera, key, cfg, cfg.spp)
        return jnp.mean(img)

    g = jax.grad(loss)(jnp.float32(0.5))
    assert np.isfinite(np.asarray(g))
    eps = 1e-2
    fd = (loss(jnp.float32(0.5 + eps)) - loss(jnp.float32(0.5 - eps))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g), np.asarray(fd), rtol=5e-2, atol=1e-4)


def test_to_image_flips_vertically():
    film = Film.create(2, 2)
    grad = jnp.asarray(
        [[[0.0, 0, 0], [0, 0, 0]], [[1.0, 1, 1], [1, 1, 1]]], jnp.float32
    )
    film = film.add(grad, 1)
    img = to_image(film)
    assert img[0, 0, 0] > img[1, 0, 0]  # bright film row (y=1) ends on top


def _engine_scenes():
    """(unfinalized analytic, finalized analytic, finalized BVH mesh)."""
    from rtnw.io.procedural import uv_sphere_mesh
    from rtnw.models.scene import BVH_THRESHOLD, finalize

    b = SceneBuilder()
    b.lambertian(0, (0.7, 0.3, 0.3))
    b.sphere((0, 0, -1), 0.5, 0)
    b.mesh(uv_sphere_mesh(0.4, (1, 0, -1), 4, 8), 0)
    plain = b.build()
    b.mesh(uv_sphere_mesh(0.4, (-1, 0, -1), 16, 32), 0)
    big = b.build()
    assert big.triangles.count > BVH_THRESHOLD >= plain.triangles.count
    return {"unfinalized": plain, "finalized": finalize(plain),
            "bvh": finalize(big)}


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("kind,on_gpu,on_cpu", [
    ("unfinalized", integrator.XLA, integrator.XLA),
    ("finalized", integrator.MEGASTEP, integrator.XLA),
    ("bvh", integrator.XLA_BVH, integrator.XLA_BVH),
])
def test_select_engine(platform, kind, on_gpu, on_cpu, monkeypatch):
    """One selection point, from the platform and what the scene holds:
    the megastep only on a GPU and only for a scene finalize() packed for
    it; a CPU never runs a kernel; a BVH scene always walks its BVH."""
    scene = _engine_scenes()[kind]
    monkeypatch.setattr(integrator.jax, "default_backend", lambda: platform)
    expect = on_gpu if platform == "gpu" else on_cpu
    assert integrator.select_engine(scene) == expect
