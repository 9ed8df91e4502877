"""Tile-sharded rendering with shard_map.

The multi-device analogue of the reference's thread-per-pixel grid
(main.cu:245-247), lifted to device granularity: every device owns a contiguous
slice of the flattened pixel array, generates and traces only its rays, and
the scene pytree is replicated. Because the PRNG is counter-based per pixel
(ops/rng), the sharded render is bit-identical to the
single-device render — there is nothing to communicate in the forward pass;
image assembly is just the sharded output's layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rtnw.config import RenderConfig
from rtnw.models import camera as camera_mod
from rtnw.models import integrator
from rtnw.models.scene import Scene
from rtnw.ops.pallas import bounce_kernel
from rtnw.parallel.mesh import TILE_AXIS


def render_pixels(scene, camera, key, cfg: RenderConfig, samples: int,
                  pixel_ids: jnp.ndarray) -> jnp.ndarray:
    """Summed radiance (len(pixel_ids), 3) of `samples` spp over the given
    global pixel ids: one device's share of a render pass."""
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    sample_keys = jax.random.split(key, samples)

    if integrator.select_engine(scene) == integrator.MEGASTEP:
        # The same whole-render kernel as the single-device path, over these
        # pixel ids. The counter RNG keys by GLOBAL pixel id, so the image
        # is bit-identical to the single-device render.
        accum = bounce_kernel.render_samples(
            scene.packed, frame, sample_keys, cfg, pixel_ids=pixel_ids,
        )
        return accum + integrator._grad_probe(scene)

    def one_sample(accum, skey):
        rays, ray_keys = camera_mod.generate_rays(
            frame, skey, cfg.width, cfg.height, pixel_ids=pixel_ids
        )
        return accum + integrator.trace(scene, rays, ray_keys, cfg), None

    accum = jnp.zeros((pixel_ids.shape[0], 3), jnp.float32)
    accum, _ = jax.lax.scan(one_sample, accum, sample_keys)
    return accum


def _pass_local(scene, camera, key, cfg: RenderConfig, samples: int):
    """Render this device's pixel slice; runs inside shard_map."""
    n_shards = jax.lax.axis_size(TILE_AXIS)
    shard = jax.lax.axis_index(TILE_AXIS)
    n_local = cfg.num_pixels // n_shards
    pixel_ids = (shard * n_local + jnp.arange(n_local)).astype(jnp.uint32)
    return render_pixels(scene, camera, key, cfg, samples, pixel_ids)


@functools.partial(
    jax.jit, static_argnames=("cfg", "samples", "mesh")
)
def render_pass_sharded(
    scene: Scene, camera, key, cfg: RenderConfig, samples: int, mesh: Mesh
) -> jnp.ndarray:
    """Sharded render pass -> (H, W, 3) radiance sum (tile-sharded rows).

    cfg.num_pixels must divide evenly by the mesh size (512x512 over 2^k
    devices always does).
    """
    if cfg.num_pixels % mesh.size:
        raise ValueError(
            f"num_pixels {cfg.num_pixels} not divisible by mesh size {mesh.size}"
        )
    fn = jax.shard_map(
        functools.partial(_pass_local, cfg=cfg, samples=samples),
        mesh=mesh,
        in_specs=(P(), P(), P()),   # scene, camera, key replicated
        out_specs=P(TILE_AXIS),     # pixel rows sharded
        # The integrator's scan carries are initialized from constants, which
        # the varying-manual-axes checker rejects; semantics are unaffected.
        check_vma=False,
    )
    accum = fn(scene, camera, key)
    return accum.reshape(cfg.height, cfg.width, 3)


def render_sharded(scene: Scene, camera, cfg: RenderConfig, mesh: Mesh, key=None):
    """Full sharded render accumulating cfg.spp, returns a Film."""
    from rtnw.models.film import Film

    if key is None:
        key = jax.random.key(cfg.seed)
    film = Film.create(cfg.width, cfg.height)
    for i, chunk in enumerate(cfg.passes()):
        pass_key = jax.random.fold_in(key, i)
        film = film.add(
            render_pass_sharded(scene, camera, pass_key, cfg, chunk, mesh), chunk
        )
    return film
