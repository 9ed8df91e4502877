"""Multi-chip tests on the 8-device virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8 — the standard JAX way to test
multi-device code without hardware)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtnw.config import RenderConfig
from rtnw.models import integrator, presets
from rtnw.parallel.mesh import make_mesh
from rtnw.parallel.render import (
    render_pass_sharded,
    render_sharded,
)



@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


CFG = RenderConfig(width=32, height=32, spp=4, bounces=4, spp_per_pass=4)


def test_sharded_render_bit_identical_to_single_device():
    """The counter-based PRNG makes tile-sharding invisible: same bits."""
    scene, camera = presets.diffuse_sphere_plane()
    key = jax.random.key(7)
    single = integrator.render_pass(scene, camera, key, CFG, 4)
    mesh8 = make_mesh(8)
    sharded = render_pass_sharded(scene, camera, key, CFG, 4, mesh8)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def test_sharded_render_mesh_sizes():
    scene, camera = presets.diffuse_sphere_plane()
    key = jax.random.key(8)
    ref = integrator.render_pass(scene, camera, key, CFG, 4)
    for n in (1, 2, 4):
        mesh = make_mesh(n)
        out = render_pass_sharded(scene, camera, key, CFG, 4, mesh)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


def test_sharded_film_accumulation():
    scene, camera = presets.diffuse_sphere_plane()
    mesh = make_mesh(8)
    film = render_sharded(scene, camera, CFG, mesh)
    assert int(film.sample_count) == CFG.spp
    img = np.asarray(film.mean)
    assert np.isfinite(img).all() and img.mean() > 0.05


def test_sharded_gradients_match_single_device():
    """psum'd scene-parameter grads == single-device grads (same RNG)."""
    scene, camera = presets.diffuse_sphere_plane()
    key = jax.random.key(9)
    mesh = make_mesh(8)

    def scene_with_albedo(a):
        return scene._replace(
            materials=scene.materials._replace(
                albedo=scene.materials.albedo.at[0, 0].set(a)
            )
        )

    def loss_single(a):
        img = integrator.render_pass(scene_with_albedo(a), camera, key, CFG, 4)
        return jnp.mean(img)

    def loss_sharded(a):
        img = render_pass_sharded(scene_with_albedo(a), camera, key, CFG, 4, mesh)
        return jnp.mean(img)

    g1 = jax.grad(loss_single)(jnp.float32(0.7))
    with jax.set_mesh(mesh):
        g8 = jax.grad(loss_sharded)(jnp.float32(0.7))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g8), rtol=1e-5)


def test_graft_entry_single_chip():
    import importlib.util, os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_graft_entry_dryrun_multichip():
    import importlib.util, os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_sharded_fused_megastep_bit_identical(monkeypatch):
    """With the megastep selected, a finalized scene under shard_map runs
    the whole-render kernel over each device's global pixel ids
    (parallel.render._pass_local) and matches the single-device render
    bit-for-bit. The kernel runs in the Pallas interpreter here."""
    import dataclasses
    import functools

    from rtnw.models.scene import finalize
    from rtnw.ops.pallas import bounce_kernel

    scene, camera = presets.cornell_box()
    scene = finalize(scene)
    monkeypatch.setattr(integrator, "select_engine",
                        lambda s: integrator.MEGASTEP)
    monkeypatch.setattr(bounce_kernel, "render_samples", functools.partial(
        bounce_kernel.render_samples, interpret=True))
    # A config no other test traces, so both jitted passes compile afresh
    # under the patched selection.
    cfg = dataclasses.replace(CFG, seed=515151)
    key = jax.random.key(11)
    single = integrator.render_pass(scene, camera, key, cfg, 4)
    sharded = render_pass_sharded(scene, camera, key, cfg, 4, make_mesh(8))
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def _bvh_mesh_scene():
    from rtnw.io.procedural import uv_sphere_mesh
    from rtnw.models.camera import Camera
    from rtnw.models.scene import (
        SceneBuilder,
        finalize,
    )

    b = SceneBuilder()
    b.lambertian(0, (0.73, 0.73, 0.73))
    b.metal(1, (0.9, 0.6, 0.2), 0.05)
    b.emission(2, (1.0, 1.0, 1.0), 3.0)
    b.plane((0, -1.05, 0), (0, 1, 0), (5, 0, 5), 2, 0)
    b.sphere((0, 4, 0), 2.0, 2)
    b.mesh(uv_sphere_mesh(0.9, (0, 0, 0), 8, 16), 1)
    scene = finalize(b.build(), use_bvh=True)
    camera = Camera.make(eye=(0, 0.4, 2.6), center=(0, 0, 0), fov=45.0,
                         aperture=0.0, focus_distance=2.6, time1=1.0)
    return scene, camera


def test_sharded_mesh_path_bit_identical():
    """The mesh path (the XLA engine's BVH walk under shard_map) renders
    bit-identically to single-device."""
    scene, camera = _bvh_mesh_scene()
    assert integrator.select_engine(scene) == integrator.XLA_BVH
    key = jax.random.key(13)
    single = integrator.render_pass(scene, camera, key, CFG, 4)
    sharded = render_pass_sharded(scene, camera, key, CFG, 4, make_mesh(8))
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def test_sharded_mesh_vertex_gradients_match_single_device():
    """Triangle-VERTEX gradients through the BVH mesh path, psum'd over 8
    virtual devices == single-device gradients."""
    scene, camera = _bvh_mesh_scene()
    cfg = CFG
    key = jax.random.key(14)
    mesh = make_mesh(8)
    verts0 = scene.triangles.vertices

    def scene_with_dv(dv):
        # Anisotropic per-axis scale: bends the cross-product normals (a
        # translation would not), so the metal mesh's reflected radiance
        # carries real vertex gradients at fixed winner topology.
        tri = scene.triangles._replace(vertices=verts0 * (1.0 + dv))
        return scene._replace(triangles=tri)

    def loss_single(dv):
        img = integrator.render_pass(scene_with_dv(dv), camera, key, cfg, 2)
        return jnp.mean(img)

    def loss_sharded(dv):
        img = render_pass_sharded(scene_with_dv(dv), camera, key, cfg, 2,
                                  mesh)
        return jnp.mean(img)

    dv = jnp.asarray([0.01, -0.02, 0.005], jnp.float32)
    g1 = jax.grad(loss_single)(dv)
    with jax.set_mesh(mesh):
        g8 = jax.grad(loss_sharded)(dv)
    assert float(jnp.max(jnp.abs(g1))) > 0.0, "zero vertex grads"
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g8), rtol=2e-5,
                               atol=1e-8)


def test_measure_scaling_virtual_mesh():
    """measure_scaling runs end-to-end on the virtual mesh and reports a
    positive rate per device count (no efficiency assertion on CPU — the
    virtual devices share one host's cores)."""
    from rtnw.parallel.multihost import (
        measure_scaling,
    )

    scene, camera = presets.diffuse_sphere_plane()
    rates = measure_scaling(scene, camera, CFG, device_counts=[1, 2],
                            spp=2, verbose=False)
    assert set(rates) == {1, 2}
    assert all(r > 0 for r in rates.values())


def test_measure_scaling_mesh_scene():
    """The scaling harness also runs the mesh path (the BVH walk under
    shard_map) — the scaling story covers the mesh engine, not just the
    analytic preset."""
    import dataclasses

    from rtnw.parallel.multihost import (
        measure_scaling,
    )

    scene, camera = _bvh_mesh_scene()
    cfg = dataclasses.replace(CFG, width=32, height=32, bounces=3)
    assert integrator.select_engine(scene) == integrator.XLA_BVH
    rates = measure_scaling(scene, camera, cfg, device_counts=[1, 2],
                            spp=2, verbose=False)
    assert set(rates) == {1, 2}
    assert all(r > 0 for r in rates.values())
