"""Inverse rendering (BASELINE config 5): gbuffer AOVs + fit convergence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtnw.config import RenderConfig
from rtnw.models import integrator, presets


def test_gbuffer_outputs():
    scene, camera = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=16, height=16, spp=2, bounces=3)
    g = integrator.render_gbuffer(scene, camera, jax.random.key(0), cfg, 2)
    assert g["radiance"].shape == (16, 16, 3)
    assert g["depth"].shape == (16, 16)
    assert g["normal"].shape == (16, 16, 3)
    d = np.asarray(g["depth"])
    m = np.asarray(g["hit_mask"])
    assert (m >= 0).all() and (m <= 1).all() and m.mean() > 0.5
    assert (d[m > 0.5] > 0).all()
    # Sample-averaged normals: averages of unit vectors, norm in [0, 1]
    # (edge pixels can average opposing normals toward 0).
    n = np.asarray(g["normal"])[m > 0.99]
    norms = np.linalg.norm(n, axis=-1)
    assert (norms <= 1.0 + 1e-4).all() and norms.mean() > 0.8


def test_gbuffer_depth_gradient_wrt_center():
    """Depth is continuously geometry-dependent — the position signal."""
    scene, camera = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=16, height=16, spp=2, bounces=2)
    key = jax.random.key(1)

    def mean_depth(cz):
        s = scene._replace(
            spheres=scene.spheres._replace(
                center0=scene.spheres.center0.at[0, 2].set(cz),
                center1=scene.spheres.center1.at[0, 2].set(cz),
            )
        )
        g = integrator.render_gbuffer(s, camera, key, cfg, 2)
        return jnp.mean(g["depth"])

    grad = jax.grad(mean_depth)(jnp.float32(-1.0))
    assert np.isfinite(np.asarray(grad)) and abs(float(grad)) > 1e-4


@pytest.mark.slow
def test_fit_recovers_scene():
    from rtnw.apps.fit import run_fit
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        result = run_fit(
            steps=60, out=os.path.join(d, "fit.png"), width=48, height=48,
            spp=4, verbose=False,
        )
    assert result.converged  # loss halved at minimum


@pytest.mark.slow
def test_fit_mesh_recovers_deformation():
    """`rtnw fit --mesh`: triangle-vertex fit (anisotropic scale) through
    the BVH walk converges (loss at least halves)."""
    from rtnw.apps.fit import run_fit_mesh
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        result = run_fit_mesh(
            steps=32, out=os.path.join(d, "fit_mesh.png"), width=48,
            height=48, spp=4, refresh=8, verbose=False,
        )
    assert result.converged
