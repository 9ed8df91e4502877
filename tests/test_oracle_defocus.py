"""Defocus blur + motion blur statistical parity vs the NumPy oracle.

Covers the SCENE 0 feature pair (thin-lens aperture + shutter-time lerped
sphere centers) end to end, the way SURVEY §4 prescribes: converged means,
independent implementation.
"""

import numpy as np
import pytest

from rtnw.config import RenderConfig
from rtnw.models import integrator
from rtnw.models.camera import Camera
from rtnw.models.scene import SceneBuilder

from tests.oracle import OracleScene, render_oracle


@pytest.mark.slow
def test_defocus_and_motion_match_oracle():
    eye, center, up = (0.0, 0.5, 2.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0)
    fov, aperture = 45.0, 0.3
    focus = float(np.linalg.norm(np.asarray(center) - np.asarray(eye)))

    b = SceneBuilder()
    b.lambertian(0, (0.4, 0.6, 0.3))
    b.lambertian(1, (0.8, 0.8, 0.0))
    b.moving_sphere((0, 0, -1), (0, 0.4, -1), 0.0, 1.0, 0.5, 0)
    b.plane((0, -0.5, 0), (0, 1, 0), (60, 0, 60), 2, 1)
    scene = b.build()
    camera = Camera.make(
        eye=eye, center=center, up=up, fov=fov, aperture=aperture,
        focus_distance=focus, time0=0.0, time1=1.0,
    )

    o = OracleScene()
    o.material(0, 0, (0.4, 0.6, 0.3))
    o.material(1, 0, (0.8, 0.8, 0.0))
    o.moving_sphere((0, 0, -1), (0, 0.4, -1), 0.0, 1.0, 0.5, 0)
    o.plane((0, -0.5, 0), (0, 1, 0), (60, 0, 60), 2, 1)

    W = H = 40
    spp = 96
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=5, spp_per_pass=32)
    ours = np.asarray(integrator.render(scene, camera, cfg).mean)
    theirs = render_oracle(
        o, eye=eye, center=center, up=up, fov=fov, width=W, height=H,
        spp=spp, bounces=5, aperture=aperture, focus_distance=focus,
    )
    np.testing.assert_allclose(ours.mean(), theirs.mean(), rtol=0.02)
    ours_t = ours.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    theirs_t = theirs.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(ours_t, theirs_t, atol=0.07)
