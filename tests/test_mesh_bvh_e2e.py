"""End-to-end large-mesh renders: BVH walk vs brute force.

BASELINE config 4 (OBJ/PLY mesh under BVH traversal) at test scale, using
the reference's bunny.ply when mounted, else a procedural dense sphere.
"""

import os

import jax
import numpy as np
import pytest

from rtnw.config import RenderConfig
from rtnw.io.procedural import uv_sphere_mesh
from rtnw.models import integrator
from rtnw.models.camera import Camera
from rtnw.models.scene import SceneBuilder, finalize

BUNNY = "/root/reference/RayTracingTheNextWeekCUDA/resources/models/bunny/bunny.ply"


def build_mesh_scene(tris):
    b = SceneBuilder()
    b.lambertian(0, (0.73, 0.73, 0.73))
    b.coat(1, (0.9, 0.3, 0.0))
    b.emission(2, (1.0, 1.0, 1.0), 3.0)
    b.plane((0, -1.05, 0), (0, 1, 0), (5, 0, 5), 2, 0)
    b.sphere((0, 4, 0), 2.0, 2)  # area-ish light
    b.mesh(tris, 1)
    camera = Camera.make(
        eye=(0, 0.4, 2.6), center=(0, 0, 0), fov=45.0, aperture=0.0,
        focus_distance=2.6, time1=1.0,
    )
    return b.build(), camera


def _render(scene, camera, use_bvh):
    scene = finalize(scene, use_bvh=use_bvh)
    cfg = RenderConfig(width=24, height=24, spp=2, bounces=3, spp_per_pass=2)
    img = np.asarray(integrator.render(scene, camera, cfg).mean)
    assert np.isfinite(img).all()
    return img


def test_dense_mesh_bvh_matches_brute():
    tris = uv_sphere_mesh(0.9, (0, 0, 0), 16, 32)  # 960 triangles
    scene, camera = build_mesh_scene(tris)
    brute = _render(scene, camera, use_bvh=False)
    accel = _render(scene, camera, use_bvh=True)
    # Same sampler, same winners (up to boundary ties): images nearly equal.
    diff = np.abs(brute - accel)
    assert (diff > 1e-3).mean() < 0.01
    assert brute.mean() > 0.02


@pytest.mark.skipif(not os.path.exists(BUNNY), reason="reference bunny absent")
@pytest.mark.slow
def test_bunny_bvh_render():
    from rtnw.io.ply import load_ply

    tris = load_ply(BUNNY)  # ~5k triangles, normalized to unit box
    scene, camera = build_mesh_scene(tris)
    img = _render(scene, camera, use_bvh=True)
    assert img.mean() > 0.02


def test_mesh_vertex_gradient_through_tile_bvh():
    """d(hit t)/d(vertices) through the BVH mesh path vs FD.

    The BVH walk is selection-only (stop-gradient); the hit is recomputed
    from the winning triangle's LIVE vertices (ops/traverse.intersect_bvh),
    so shifting the mesh moves hit distances with exact first-order
    gradients at fixed topology — what makes inverse rendering on meshes
    work through the same engine that renders them.
    """
    import jax
    import jax.numpy as jnp

    from rtnw.models import camera as camera_mod

    tris = uv_sphere_mesh(0.9, (0, 0, 0), 16, 32)
    scene, camera = build_mesh_scene(tris)
    scene = finalize(scene, use_bvh=True)
    assert integrator.select_engine(scene) == integrator.XLA_BVH

    frame = camera_mod.derive(camera, 1.0)
    rays, _ = camera_mod.generate_rays(frame, jax.random.key(2), 24, 24)
    base_hit = integrator.intersect_scene(scene, rays, 1e-3, float("inf"))
    mesh_mask = base_hit.valid & (base_hit.material_id == 1)
    assert bool(mesh_mask.sum() > 20)

    def loss(dz):
        verts = scene.triangles.vertices.at[:, :, 2].add(dz)
        s = scene._replace(
            triangles=scene.triangles._replace(vertices=verts)
        )
        # The BVH stays FIXED (fixed-topology winner selection); only the
        # recompute sees the shifted vertices.
        hit = integrator.intersect_scene(s, rays, 1e-3, float("inf"))
        return jnp.sum(jnp.where(mesh_mask, hit.t, 0.0))

    g = jax.grad(loss)(jnp.float32(0.0))
    eps = 1e-3
    fd = (loss(jnp.float32(eps)) - loss(jnp.float32(-eps))) / (2 * eps)
    assert np.isfinite(np.asarray(g))
    np.testing.assert_allclose(np.asarray(g), np.asarray(fd),
                               rtol=2e-2, atol=1e-2)
