"""Wavefront path tracer and the choice of render engine.

The reference renders with a per-pixel megakernel: renderKernel
(main.cu:160-206) loops spp x bounces per thread, calling pathTrace
(CUDAPathTracer.cu:358-622) with divergent branches, per-thread BVH stacks
and rejection-sampled RNG. The XLA engine here treats the whole image as
one ray wavefront: a `lax.scan` over bounces carries (origin, direction,
throughput, radiance, alive) SoA state, every phase (intersect-all,
scatter-all) is a batched op, and spp accumulates over passes. On a GPU,
finalized analytic scenes render through the megastep instead
(ops/pallas/bounce_kernel), a per-pixel kernel like the reference's;
`select_engine` decides. Bounce semantics match Path A's `rayColor`
(main.cu:63-94):

  hit + scatter      -> throughput *= attenuation, continue
  hit + no scatter   -> radiance += throughput * emitted (emission term or
                        metal absorption zero), terminate
  miss               -> radiance += throughput * sky gradient, terminate
  bounce exhaustion  -> contribute black

Russian roulette is a config extension (reference TODO CUDAPathTracer.cu:532).
The XLA engine is differentiable wrt scene + camera parameters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rtnw.config import INFINITY, RenderConfig
from rtnw.models import camera as camera_mod
from rtnw.models.film import Film
from rtnw.models.scene import Scene
from rtnw.ops import intersect, linalg, rng, traverse
from rtnw.ops.pallas import bounce_kernel
from rtnw.ops.materials import scatter
from rtnw.ops.rays import Hit, Rays, closer

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def sky_color(direction: jnp.ndarray) -> jnp.ndarray:
    """RTiOW sky gradient on the unit direction (main.cu:86-89)."""
    unit = linalg.normalize(direction)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = jnp.asarray(SKY_WHITE, direction.dtype)
    blue = jnp.asarray(SKY_BLUE, direction.dtype)
    return linalg.lerp(white, blue, t[..., None])


# Engines, chosen by select_engine from what the code can observe.
MEGASTEP = "megastep"  # whole-render Triton kernel (ops/pallas/bounce_kernel)
XLA_BVH = "xla-bvh"    # XLA wavefront, triangles through the BVH walk
XLA = "xla"            # XLA wavefront, brute-force intersection


def select_engine(scene: Scene) -> str:
    """The one place the render engine is chosen.

    * MEGASTEP on a GPU, for a scene that models.scene.finalize packed for
      the megastep (analytic primitives and small brute-force meshes). It
      is forward-only.
    * XLA_BVH when the scene carries a BVH (finalize builds one above
      models.scene.BVH_THRESHOLD triangles): the XLA wavefront with the
      mesh walked by ops/traverse.
    * XLA otherwise: the differentiable wavefront with brute-force
      intersection. This covers every unfinalized scene, and a CPU, where
      production code never runs a kernel.
    """
    if scene.bvh is not None:
        return XLA_BVH
    if scene.packed is not None and jax.default_backend() == "gpu":
        return MEGASTEP
    return XLA


def intersect_scene(scene: Scene, rays: Rays, tmin, tmax) -> Hit:
    """Closest hit across all primitive batches (the XLA engines).

    Triangles go through the BVH walk when select_engine says so, and are
    brute-forced otherwise. The per-type empty checks are static
    (trace-time) shape tests, so absent primitive types compile to
    nothing — the analogue of null entries in the reference's
    `constantObjects` table (main.cu:47-49).
    """
    hit = Hit.none(rays.count)
    if scene.spheres.count:
        hit = closer(hit, intersect.intersect_spheres(rays, scene.spheres, tmin, tmax))
    if scene.planes.count:
        hit = closer(hit, intersect.intersect_planes(rays, scene.planes, tmin, tmax))
    if scene.triangles.count:
        if select_engine(scene) == XLA_BVH:
            hit = closer(
                hit, traverse.intersect_bvh(rays, scene.triangles, scene.bvh, tmin, tmax)
            )
        else:
            hit = closer(
                hit,
                intersect.intersect_triangles(rays, scene.triangles, tmin, tmax),
            )
    return hit


def _grad_probe(scene: Scene) -> jnp.ndarray:
    """Grad guard for the forward-only megastep.

    The megastep reads a packed copy of the scene, so differentiating a
    megastep render wrt scene parameters would SILENTLY yield zero
    gradients. This probe is exactly 0.0 in the primal but carries the
    scene-parameter tangents into a custom_vjp whose bwd raises.
    """
    probe = sum(
        jnp.sum(leaf)
        for leaf in jax.tree_util.tree_leaves(
            (scene.spheres, scene.planes, scene.triangles, scene.materials)
        )
        if jnp.issubdtype(leaf.dtype, jnp.floating)
    )
    probe = bounce_kernel._forward_only(probe)
    return probe - jax.lax.stop_gradient(probe)


def _bounce_body(scene: Scene, cfg: RenderConfig, state, ctx, bounce_idx):
    """One XLA wavefront bounce: intersect + gather + scatter + bookkeeping.

    `state` = (rays, throughput (N,3), radiance (N,3), alive (N,) bool);
    `ctx` the per-ray RNG context; `bounce_idx` traced uint32. Returns the
    advanced state.
    """
    rays_b, throughput, radiance, alive = state
    n = rays_b.count
    dtype = rays_b.origin.dtype

    hit = intersect_scene(scene, rays_b, cfg.tmin, INFINITY)
    mat = scene.materials.gather(hit.material_id)
    # Static kind set (recorded at pack time) prunes absent BSDF branches.
    used_kinds = getattr(scene.packed, "used_kinds", None)
    # One (N, 4) uniform block per bounce covers every scatter draw
    # (slots 0-2, see ops.materials.scatter) plus Russian roulette
    # (slot 3) — a single pcg4d sweep instead of one hash per draw.
    u4 = rng.bounce_uniforms(ctx, bounce_idx)
    scat = scatter(u4, rays_b, hit, mat, used_kinds)

    if cfg.sky_background:
        sky = sky_color(rays_b.direction)
    else:
        sky = jnp.zeros((n, 3), dtype)

    miss = alive & ~hit.valid
    terminal = alive & hit.valid & ~scat.scattered
    radiance = radiance + jnp.where(miss[..., None], throughput * sky, 0.0)
    radiance = radiance + jnp.where(
        terminal[..., None], throughput * scat.emitted, 0.0
    )
    # Path B additive emission: every hit releases mask*emit and the
    # path continues (CUDAPathTracer.cu:430,449). Zero for Path A
    # materials, so this is free there.
    radiance = radiance + jnp.where(
        (alive & hit.valid)[..., None], throughput * mat.emission, 0.0
    )

    cont = alive & hit.valid & scat.scattered
    new_throughput = jnp.where(
        cont[..., None], throughput * scat.attenuation, throughput
    )

    if cfg.russian_roulette:
        p = jnp.clip(jnp.max(new_throughput, axis=-1), 0.05, 1.0)
        p = jax.lax.stop_gradient(p)
        u = u4[:, 3]  # reserved RR slot, decorrelated from slots 0-2
        do_rr = bounce_idx >= cfg.rr_start_bounce
        survive = ~do_rr | (u < p)
        new_throughput = jnp.where(
            (cont & do_rr & survive)[..., None],
            new_throughput / p[..., None],
            new_throughput,
        )
        cont = cont & survive

    safe_t = jnp.where(hit.valid, hit.t, 0.0)
    hit_point = rays_b.at(safe_t)
    new_rays = Rays(
        origin=jnp.where(cont[..., None], hit_point, rays_b.origin),
        direction=jnp.where(cont[..., None], scat.direction, rays_b.direction),
        time=rays_b.time,
    )
    return (new_rays, new_throughput, radiance, cont)


def trace(scene: Scene, rays: Rays, ctx, cfg: RenderConfig) -> jnp.ndarray:
    """Path-trace a wavefront to completion with the XLA engine. Returns
    radiance (N, 3).

    `ctx` is the per-ray RNG context (camera.ray_context); each bounce hashes
    the bounce index in, so every random draw is a pure function of
    (seed, pass, pixel, bounce) — independent of device placement. The
    megastep has no per-wavefront entry: it renders whole passes
    (render_pass).
    """
    n = rays.count
    dtype = rays.origin.dtype

    state = (
        rays,
        jnp.ones((n, 3), dtype),   # throughput
        jnp.zeros((n, 3), dtype),  # radiance
        jnp.ones((n,), bool),      # alive
    )

    def bounce(state, bounce_idx):
        return _bounce_body(scene, cfg, state, ctx, bounce_idx), None

    # Path A runs a fixed 10-bounce loop with per-thread early returns
    # (main.cu:66-93); the wavefront equivalent skips a whole bounce once
    # every ray has terminated. lax.cond (scalar predicate) executes only
    # the taken branch at runtime, and — unlike lax.while_loop — stays
    # reverse-mode differentiable for the inverse-rendering path.
    def bounce_or_skip(state, bounce_idx):
        return jax.lax.cond(
            jnp.any(state[3]),
            lambda s: bounce(s, bounce_idx)[0],
            lambda s: s,
            state,
        ), None

    (_, _, radiance, _), _ = jax.lax.scan(
        bounce_or_skip, state, jnp.arange(cfg.bounces)
    )
    return radiance


@functools.partial(jax.jit, static_argnames=("cfg", "samples"))
def render_pass(scene: Scene, camera: camera_mod.Camera, key, cfg: RenderConfig, samples: int) -> jnp.ndarray:
    """Trace `samples` spp and return the summed radiance image (H, W, 3).

    With the XLA engines, samples run as a `lax.scan` so device memory
    holds one wavefront at a time regardless of spp — the analogue of the
    reference's per-frame 1-spp progressive loop (main.cu:883-885),
    batched per pass. With the megastep the whole pass (raygen + all
    samples + all bounces) is ONE kernel launch.
    """
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    sample_keys = jax.random.split(key, samples)

    if select_engine(scene) == MEGASTEP:
        accum = bounce_kernel.render_samples(scene.packed, frame, sample_keys, cfg)
        accum = accum + _grad_probe(scene)
        return accum.reshape(cfg.height, cfg.width, 3)

    def one_sample(accum, skey):
        rays, ray_keys = camera_mod.generate_rays(frame, skey, cfg.width, cfg.height)
        radiance = trace(scene, rays, ray_keys, cfg)
        return accum + radiance, None

    accum = jnp.zeros((cfg.num_pixels, 3), frame.origin.dtype)
    accum, _ = jax.lax.scan(one_sample, accum, sample_keys)
    return accum.reshape(cfg.height, cfg.width, 3)


@functools.partial(jax.jit, static_argnames=("cfg", "samples"))
def render_gbuffer(scene: Scene, camera: camera_mod.Camera, key, cfg: RenderConfig, samples: int):
    """Render radiance + geometry AOVs (depth, normal, primary albedo).

    The G-buffer quantities are continuous functions of scene geometry,
    which makes them the practical inverse-rendering signal for *positions*:
    fixed-topology radiance gradients w.r.t. geometry are exactly zero in
    purely-diffuse scenes (radiance = product of albedos; geometry only
    selects the discrete path), so `fit` losses combine radiance with depth
    and normal terms. Also a standard denoiser/compositing feature.

    Returns dict with radiance (H,W,3) summed over samples, and
    sample-averaged depth (H,W), normal (H,W,3), albedo (H,W,3),
    hit_mask (H,W).
    """
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    sample_keys = jax.random.split(key, samples)
    n = cfg.num_pixels

    def one_sample(accum, skey):
        rays, ray_keys = camera_mod.generate_rays(frame, skey, cfg.width, cfg.height)
        hit = intersect_scene(scene, rays, cfg.tmin, INFINITY)
        mat = scene.materials.gather(hit.material_id)
        depth = jnp.where(hit.valid, hit.t, 0.0)
        radiance = trace(scene, rays, ray_keys, cfg)
        acc_rad, acc_depth, acc_norm, acc_alb, acc_mask = accum
        return (
            acc_rad + radiance,
            acc_depth + depth,
            acc_norm + hit.normal,
            acc_alb + jnp.where(hit.valid[:, None], mat.albedo, 0.0),
            acc_mask + hit.valid.astype(jnp.float32),
        ), None

    init = (
        jnp.zeros((n, 3)), jnp.zeros((n,)), jnp.zeros((n, 3)),
        jnp.zeros((n, 3)), jnp.zeros((n,)),
    )
    (rad, depth, norm, alb, mask), _ = jax.lax.scan(one_sample, init, sample_keys)
    shape2 = (cfg.height, cfg.width)
    inv = 1.0 / samples
    return {
        "radiance": rad.reshape(*shape2, 3),
        "depth": (depth * inv).reshape(shape2),
        "normal": (norm * inv).reshape(*shape2, 3),
        "albedo": (alb * inv).reshape(*shape2, 3),
        "hit_mask": (mask * inv).reshape(shape2),
    }


def render(scene: Scene, camera: camera_mod.Camera, cfg: RenderConfig, key=None) -> Film:
    """Full offline render: accumulate cfg.spp over passes into a Film."""
    if key is None:
        key = jax.random.key(cfg.seed)
    film = Film.create(cfg.width, cfg.height)
    for i, chunk in enumerate(cfg.passes()):
        pass_key = jax.random.fold_in(key, i)
        film = film.add(render_pass(scene, camera, pass_key, cfg, chunk), chunk)
    return film
