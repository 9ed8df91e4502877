"""Distributed inverse rendering: sharded forward+backward, psum'd gradients.

The distributed training loop: each device renders/backprops its pixel tile
against its slice of the target image; scene-parameter gradients are
all-reduced over the `tiles` axis. With `shard_map` + replicated params the
reverse-mode psum is inserted by AD — no hand-written collectives in the
model code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from rtnw.config import RenderConfig
from rtnw.parallel.render import render_pass_sharded


def make_loss(params_to_scene, camera, cfg: RenderConfig, mesh: Mesh, spp: int):
    """Build loss(params, target, key) = MSE(sharded render, target)."""
    def loss(params, target, key):
        scene = params_to_scene(params)
        img = render_pass_sharded(scene, camera, key, cfg, spp, mesh) / spp
        return jnp.mean((img - target) ** 2)

    return loss


def make_fit_step(params_to_scene, camera, cfg, mesh, spp, optimizer=None, lr=2e-2):
    """One jitted distributed optimization step: grads psum over devices.

    `params_to_scene` must build a scene the XLA engine renders (an
    unfinalized or BVH scene): the megastep is forward-only.
    """
    if optimizer is None:
        optimizer = optax.adam(lr)
    loss_fn = make_loss(params_to_scene, camera, cfg, mesh, spp)

    @jax.jit
    def _step(params, opt_state, target, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, target, key)
        updates, opt_state = optimizer.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def step(params, opt_state, target, key):
        # The reverse-mode psum over `tiles` produces mesh-typed avals; the
        # surrounding computation must run in the mesh context.
        with jax.set_mesh(mesh):
            return _step(params, opt_state, target, key)

    return step, optimizer
