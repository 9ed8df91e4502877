"""Megastep (ops/pallas/bounce_kernel.py) vs the XLA wavefront engine.

Both engines consume the identical RNG stream, so images must agree to
float tolerance on every preset. Here the Triton kernel runs in the Pallas
interpreter; tests marked `gpu` run it compiled on the card. Also pinned:
the pack's power-of-two table, the wrapper's ray padding and global pixel
ids, the kernel's lowering to Triton IR, and that differentiating a
megastep render fails loudly.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rtnw.config import RenderConfig
from rtnw.models import camera as camera_mod
from rtnw.models import integrator, presets
from rtnw.models.scene import finalize
from rtnw.ops.pallas import bounce_kernel

PRESETS = {
    "sphere_plane": presets.diffuse_sphere_plane,
    "cornell": presets.cornell_box,
    "defocus": presets.defocus_blur,
    "smallpt": presets.smallpt_spheres,  # Path B kinds incl. COAT/REFRACTION
    "mesh": presets.mesh_showcase,
}


def megastep_pass(scene, camera, key, cfg, samples, pixel_ids=None):
    """integrator.render_pass's megastep branch with the kernel run by the
    Pallas interpreter; returns the summed radiance (N, 3)."""
    packed = finalize(scene, use_bvh=False).packed
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    return bounce_kernel.render_samples(
        packed, frame, jax.random.split(key, samples), cfg,
        pixel_ids=pixel_ids, interpret=True,
    )


def megastep_mean(scene, camera, cfg):
    """integrator.render(...).mean through the interpreted megastep."""
    key = jax.random.key(cfg.seed)
    accum = sum(
        megastep_pass(scene, camera, jax.random.fold_in(key, i), cfg, chunk)
        for i, chunk in enumerate(cfg.passes())
    )
    return np.asarray(accum).reshape(cfg.height, cfg.width, 3) / cfg.spp


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_fused_bounce_matches_wavefront(name):
    scene, camera = PRESETS[name]()
    cfg = RenderConfig(width=24, height=24, spp=4, bounces=6, spp_per_pass=4)
    key = jax.random.key(7)
    fused = np.asarray(megastep_pass(scene, camera, key, cfg, 4)).reshape(
        24, 24, 3)
    xla = np.asarray(integrator.render_pass(scene, camera, key, cfg, 4))
    assert np.isfinite(fused).all()
    if name == "smallpt":
        # smallpt's 1e5-radius wall spheres sit at the edge of f32: a point
        # on such a sphere has ~0.01 absolute position uncertainty (ulp at
        # 1e5), so the two engines' per-bounce hit points differ in the last
        # ulps every bounce and a small fraction of paths diverge discretely
        # (measured: 1.3% of pixels differ > 0.2 at 6 bounces, image mean
        # agrees to 0.04%). Per-pixel equality is not achievable at this
        # scale in f32 — compare as two estimators of the same integral.
        diff = np.abs(fused - xla)
        assert (diff > 0.2).mean() < 0.05, f"{(diff > 0.2).mean():.2%} off"
        np.testing.assert_allclose(fused.mean(), xla.mean(), rtol=1e-2)
    else:
        np.testing.assert_allclose(fused, xla, rtol=1e-4, atol=1e-4)


def test_fused_bounce_russian_roulette_matches():
    scene, camera = presets.cornell_box()
    cfg = RenderConfig(width=16, height=16, spp=4, bounces=8, spp_per_pass=4,
                       russian_roulette=True, rr_start_bounce=2)
    key = jax.random.key(3)
    fused = np.asarray(megastep_pass(scene, camera, key, cfg, 4))
    xla = np.asarray(integrator.render_pass(scene, camera, key, cfg, 4))
    np.testing.assert_allclose(fused.reshape(xla.shape), xla,
                               rtol=1e-4, atol=1e-4)


def test_fused_bounce_grad_raises(monkeypatch):
    """Differentiating a megastep render fails loudly, never silently
    returning zero gradients (the custom_vjp guard in bounce_kernel)."""
    scene, camera = presets.diffuse_sphere_plane()
    scene = finalize(scene)
    monkeypatch.setattr(integrator, "select_engine",
                        lambda s: integrator.MEGASTEP)
    monkeypatch.setattr(bounce_kernel, "render_samples", functools.partial(
        bounce_kernel.render_samples, interpret=True))
    # A config no other test traces, so render_pass compiles afresh under
    # the patched selection.
    cfg = RenderConfig(width=8, height=8, spp=1, bounces=2, spp_per_pass=1,
                       seed=424242)

    def loss(cz):
        s = scene._replace(
            spheres=scene.spheres._replace(
                center0=scene.spheres.center0.at[0, 2].set(cz)
            )
        )
        img = integrator.render_pass(s, camera, jax.random.key(0), cfg, 1)
        return jnp.mean(img)

    with pytest.raises(NotImplementedError, match="forward-only"):
        jax.grad(loss)(jnp.float32(-1.0))


def test_fused_bounce_black_background():
    scene, camera = presets.cornell_box()
    cfg = RenderConfig(width=16, height=16, spp=2, bounces=4, spp_per_pass=2,
                       sky_background=False)
    key = jax.random.key(1)
    fused = np.asarray(megastep_pass(scene, camera, key, cfg, 2))
    xla = np.asarray(integrator.render_pass(scene, camera, key, cfg, 2))
    np.testing.assert_allclose(fused.reshape(xla.shape), xla,
                               rtol=1e-4, atol=1e-4)


def test_merge_parallelograms_cube():
    """A cube mesh's 12 triangles merge into exactly 6 parallelogram quads;
    a lone non-parallelogram triangle is left unmerged."""
    from rtnw.io.procedural import cube_mesh
    from rtnw.ops.pallas.bounce_kernel import _merge_parallelograms

    tris = np.asarray(cube_mesh(0.5, (0.0, 0.0, 0.0)), np.float32)
    mats = np.zeros((tris.shape[0],), np.int32)
    qv0, qe1, qe2, qmat, rest = _merge_parallelograms(tris, mats)
    assert qv0.shape[0] == 6 and rest.shape[0] == 0

    # Append a skewed triangle: stays a triangle.
    skew = np.asarray(
        [[[5.0, 0.0, 0.0], [6.0, 0.0, 0.0], [5.0, 1.3, 0.7]]], np.float32
    )
    tris2 = np.concatenate([tris, skew])
    mats2 = np.zeros((13,), np.int32)
    qv0, _, _, _, rest = _merge_parallelograms(tris2, mats2)
    assert qv0.shape[0] == 6 and rest.shape[0] == 1

    # Different materials across the shared edge block merging.
    mats3 = np.arange(12, dtype=np.int32)
    qv0, _, _, _, rest = _merge_parallelograms(tris, mats3)
    assert qv0.shape[0] == 0 and rest.shape[0] == 12


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_pack_megastep_power_of_two_table(name):
    """Triton loads need power-of-two shapes: the packed table is
    (TABLE_ROWS, 2^k) with every primitive in its own column and the
    padding columns all zero (never hit)."""
    scene, _ = PRESETS[name]()
    packed = finalize(scene, use_bvh=False).packed
    rows, cols = packed.prims.shape
    assert rows == bounce_kernel.TABLE_ROWS
    assert cols & (cols - 1) == 0
    total = sum(packed.counts)
    assert cols >= total > cols // 2 or cols == 1
    prims = np.asarray(packed.prims)
    assert not prims[:, total:].any()
    assert packed.counts[0] == scene.spheres.count
    assert packed.counts[1] == scene.planes.count


def test_pack_megastep_cornell_merges_cubes_into_boxes():
    """The Cornell box's two rotated cube meshes (24 triangles) pack as two
    oriented boxes; material rows carry each primitive's material."""
    scene, _ = presets.cornell_box()
    packed = finalize(scene).packed
    assert packed.counts == (2, 6, 0, 0, 2)
    kind = np.asarray(packed.prims[bounce_kernel.MAT_ROW, :10])
    table = np.asarray(scene.materials.kind, np.float32)
    ids = np.concatenate([np.asarray(scene.spheres.material_id),
                          np.asarray(scene.planes.material_id), [3, 3]])
    np.testing.assert_array_equal(kind, table[ids])


def test_render_samples_pixel_subset_and_padding():
    """A ragged subset of global pixel ids (not a RAY_BLOCK multiple) renders
    exactly those pixels of the full image: the padding rays are dropped
    and the RNG keys by global pixel id (the sharding contract)."""
    scene, camera = presets.cornell_box()
    cfg = RenderConfig(width=16, height=16, spp=2, bounces=3)
    key = jax.random.key(5)
    full = np.asarray(megastep_pass(scene, camera, key, cfg, 2))
    ids = jnp.arange(37, 37 + 150, dtype=jnp.uint32)
    assert ids.shape[0] % bounce_kernel.RAY_BLOCK
    part = np.asarray(megastep_pass(scene, camera, key, cfg, 2,
                                    pixel_ids=ids))
    assert part.shape == (150, 3)
    np.testing.assert_array_equal(part, full[37:187])


def test_render_samples_odd_sample_count():
    """A non-power-of-two sample count pads the per-sample key table; the
    padding keys are never read."""
    scene, camera = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=16, height=8, spp=3, bounces=3)
    key = jax.random.key(9)
    fused = np.asarray(megastep_pass(scene, camera, key, cfg, 3))
    xla = np.asarray(integrator.render_pass(scene, camera, key, cfg, 3))
    np.testing.assert_allclose(fused.reshape(xla.shape), xla,
                               rtol=1e-4, atol=1e-4)


def _pallas_eqn(jaxpr):
    """The first pallas_call equation in `jaxpr` or its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            return eqn
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns") and (found := _pallas_eqn(sub)):
                return found
    return None


@pytest.mark.parametrize("name", sorted({**PRESETS, "rtiow_final": None}))
def test_megastep_lowers_to_triton(name):
    """Every operation of the kernel has a Triton lowering rule, for each
    primitive mix: unrolled primitive loops, and the scf.for over more than
    64 columns (the mesh's triangles, rtiow-final's 488 spheres). The
    lowering to Triton IR runs on a CPU; compiling it needs the card."""
    from jax._src.pallas.triton import lowering

    build = PRESETS.get(name, presets.rtiow_final)
    scene, camera = build()
    packed = finalize(scene, use_bvh=False).packed
    cfg = RenderConfig(width=16, height=16, spp=2, bounces=4,
                       russian_roulette=True)
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    jaxpr = jax.make_jaxpr(
        lambda k: bounce_kernel.render_samples(packed, frame, k, cfg)
    )(jax.random.split(jax.random.key(0), 2))
    eqn = _pallas_eqn(jaxpr.jaxpr)
    assert eqn.params["compiler_params"]["triton"].num_warps == \
        bounce_kernel.NUM_WARPS
    module = lowering.lower_jaxpr_to_triton_module(
        eqn.params["jaxpr"], eqn.params["grid_mapping"], "cuda").module
    asm = module.operation.get_asm()
    assert "scf.while" in asm  # the bounce loop, left once no ray is alive
    # The sample loop, and one loop per primitive type of more than 64.
    assert asm.count("scf.for") == 1 + sum(c > 64 for c in packed.counts)


@pytest.mark.gpu
def test_megastep_compiled_matches_xla():
    """On the card: the compiled megastep against the XLA engine. The two
    compilers contract different multiply-adds, so a few paths diverge at
    discrete decisions; every other pixel agrees to 1e-4, and the mean."""
    scene, camera = presets.cornell_box()
    ready = finalize(scene)
    assert integrator.select_engine(ready) == integrator.MEGASTEP
    key = jax.random.key(11)
    cfg = RenderConfig(width=128, height=128, spp=4, bounces=10)
    mk = np.asarray(integrator.render_pass(ready, camera, key, cfg, 4)) / 4
    with jax.default_matmul_precision("highest"):
        xla = np.asarray(integrator.render_pass(scene, camera, key, cfg, 4)) / 4
    off = np.abs(mk - xla) > 1e-4 + 1e-4 * np.abs(xla)
    assert off.any(-1).mean() < 1e-3
    np.testing.assert_allclose(mk.mean(), xla.mean(), rtol=1e-4)


def _rays_pair(name, width, height, interpret):
    """The megastep's primary rays and camera.generate_rays', same key."""
    _, camera = PRESETS[name]()
    frame = camera_mod.derive(camera, width / height)
    key = jax.random.key(5)
    kernel = bounce_kernel.primary_rays(frame, key, width, height,
                                        interpret=interpret)
    rays, _ = camera_mod.generate_rays(frame, key, width, height)
    return kernel, (rays.origin, rays.direction, rays.time)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_primary_rays_match_camera(name):
    """The kernel's raygen writes camera.generate_rays_ctx's expressions in
    its order. Interpreted on a CPU, the compiler fuses the interpreter's
    multiply-adds its own way, so the rays agree to a few ulps here; on
    the card they agree bit for bit (test_primary_rays_bitwise_on_card)."""
    kernel, ref = _rays_pair(name, 32, 16, interpret=True)
    for k, r in zip(kernel, ref):
        np.testing.assert_allclose(np.asarray(k), np.asarray(r),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_primary_rays_bitwise_on_card(name):
    """Compiled for the card, the megastep starts every path from exactly
    the XLA engine's primary ray."""
    kernel, ref = _rays_pair(name, 512, 512, interpret=False)
    for k, r in zip(kernel, ref):
        np.testing.assert_array_equal(np.asarray(k), np.asarray(r))
