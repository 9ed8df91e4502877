"""Golden-image regression tests.

The reference's de-facto regression machinery is its committed renders
(images/images.MD + PNGs, SURVEY.md §4). Ours is the same idea made
automatic: small fixed-seed renders committed as .npz, compared on every
run. Goldens were generated on the CPU backend; the comparison tolerance
absorbs backend/version-level fp reassociation, while real regressions
(semantics changes) blow way past it.

Regenerate deliberately with:
    python tests/regen_goldens.py
"""

import os

import numpy as np
import pytest

from rtnw.config import RenderConfig
from rtnw.models import integrator, presets

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

CASES = {
    "sphere_plane": (presets.diffuse_sphere_plane,
                     dict(width=64, height=64, spp=16, bounces=4, spp_per_pass=8)),
    "cornell": (presets.cornell_box,
                dict(width=64, height=64, spp=16, bounces=8, spp_per_pass=8)),
    "defocus_motion": (presets.defocus_blur,
                       dict(width=64, height=64, spp=16, bounces=6, spp_per_pass=8)),
    "smallpt": (presets.smallpt_spheres,
                dict(width=48, height=48, spp=8, bounces=5, spp_per_pass=8,
                     sky_background=False)),
    "mesh": (lambda: presets.mesh_showcase(n_lat=8, n_lon=16),
             dict(width=48, height=48, spp=8, bounces=4, spp_per_pass=8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    build, kw = CASES[name]
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    with np.load(path) as z:
        golden = z["image"]
    scene, camera = build()
    cfg = RenderConfig(**kw)
    img = np.asarray(integrator.render(scene, camera, cfg).mean)
    # Same seed, same sampler: differences are fp-reassociation only.
    np.testing.assert_allclose(img, golden, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_fused_path_matches(name):
    """The megastep (Triton kernel, interpreted here) must reproduce the
    golden too."""
    from tests.test_bounce_kernel import megastep_mean

    build, kw = CASES[name]
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    with np.load(path) as z:
        golden = z["image"]
    scene, camera = build()
    img = megastep_mean(scene, camera, RenderConfig(**kw))
    # Boundary-epsilon cases may pick a different (equally valid) closest
    # hit in the megastep; allow a small fraction of outlier pixels.
    # smallpt gets a bigger budget: its 1e5-radius spheres make the f32
    # sphere quadratic catastrophically cancel (|oc|^2 - r^2 ~ 1e10 with
    # ~1e3 ulp), so last-ulp t differences between the two pipelines shift
    # visible hit points — same conditioning the CUDA reference has. In the
    # megastep EVERY bounce's hit point differs in the last ulps, so
    # per-path divergence compounds while the image mean agrees — two
    # estimators of the same integral; see test_bounce_kernel.py.
    budget = 0.20 if name == "smallpt" else 0.005
    diff = np.abs(img - golden)
    frac_off = (diff > 5e-3 + 1e-2 * np.abs(golden)).mean()
    assert frac_off < budget, f"{frac_off:.4%} pixels off, max diff {diff.max():.4f}"
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=5e-3)
