"""Path B material-model parity: additive emission, smallpt refraction."""

import jax
import jax.numpy as jnp
import numpy as np

from rtnw.config import RenderConfig
from rtnw.models import integrator, presets
from rtnw.models.scene import SceneBuilder
from rtnw.ops.geometry import REFRACTION
from tests.test_materials import setup

from rtnw.ops.materials import scatter


def keys_for(rays):
    return jax.random.split(jax.random.key(0), rays.origin.shape[0])


def test_refraction_tir_reflects_with_full_weight():
    rays, hit, mat = setup(
        REFRACTION, param=1.5, direction=(1, -0.2, 0), normal=(0, 1, 0),
        front=False, n=64, albedo=(1, 1, 1),
    )
    s = scatter(keys_for(rays), rays, hit, mat)
    d = np.asarray(s.direction)
    # grazing from inside -> TIR -> mirror, weight exactly albedo.
    want = np.asarray([1, 0.2, 0]) / np.linalg.norm([1, 0.2, 0])
    np.testing.assert_allclose(d, np.tile(want, (64, 1)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(s.attenuation), 1.0, atol=1e-6)


def test_refraction_head_on_splits_weighted():
    rays, hit, mat = setup(
        REFRACTION, param=1.5, direction=(0, 0, -1), n=100_000, albedo=(1, 1, 1)
    )
    s = scatter(keys_for(rays), rays, hit, mat)
    d = np.asarray(s.direction)
    att = np.asarray(s.attenuation)[:, 0]
    refl = d[:, 2] > 0
    # Head-on: Re = r0 = 0.04, P = 0.27 -> ~27% reflect.
    np.testing.assert_allclose(refl.mean(), 0.27, atol=0.01)
    # RP = Re/P ~ 0.148, TP = Tr/(1-P) ~ 1.315; E[att] = Re + Tr = 1.
    np.testing.assert_allclose(att[refl].mean(), 0.04 / 0.27, rtol=1e-3)
    np.testing.assert_allclose(att[~refl].mean(), 0.96 / 0.73, rtol=1e-3)
    np.testing.assert_allclose(att.mean(), 1.0, atol=0.01)  # unbiased


def test_additive_emission_keeps_bouncing():
    """A sphere with additive emission contributes radiance AND reflects."""
    b = SceneBuilder()
    # Diffuse enclosure that emits per hit (Path B sky style).
    b.material(0, 0, (0.5, 0.5, 0.5), 0.0, emission=(0.3, 0.3, 0.3))
    b.sphere((0, 0, 0), 20.0, 0)
    scene = b.build()
    from rtnw.models.camera import Camera

    camera = Camera.make(eye=(0, 0, 1), center=(0, 0, -1), fov=60.0,
                         aperture=0.0, focus_distance=2.0)
    cfg = RenderConfig(width=8, height=8, spp=16, bounces=12, spp_per_pass=16,
                       sky_background=False)
    img = np.asarray(integrator.render(scene, camera, cfg).mean)
    # Geometric series: sum_k 0.3 * 0.5^k = 0.6 (minus truncation tail).
    np.testing.assert_allclose(img.mean(), 0.6, rtol=0.05)


def test_smallpt_preset_renders():
    scene, camera = presets.smallpt_spheres()
    assert scene.spheres.count == 6
    cfg = RenderConfig(width=24, height=24, spp=4, bounces=5, spp_per_pass=4,
                       sky_background=False)
    img = np.asarray(integrator.render(scene, camera, cfg).mean)
    assert np.isfinite(img).all()
    # Sun + sky + horizon make the image clearly non-black.
    assert img.mean() > 0.05
    lum = img.mean(axis=2)
    # The emissive sun (upper middle) should be among the brightest areas.
    assert lum[12:, 6:18].max() >= lum.max() * 0.8
