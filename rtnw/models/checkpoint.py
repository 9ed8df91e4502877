"""Checkpoint / resume.

The reference's two persistence mechanisms (SURVEY.md §5): the BVH disk
cache (BVH.cpp:500-554 — ours is io/bvh_cache.py) and the in-memory
progressive accumulation buffer (reset on camera move, main.cu:877-888).
This module makes the second durable: film state (accumulation + spp), the
PRNG base key info, and a config/camera fingerprint go to one .npz, so a
long render can be killed and resumed, and a stale checkpoint (changed
scene/camera/config) is detected instead of silently blended.

Also covers optimizer-state checkpointing for inverse-rendering runs.
"""

from __future__ import annotations

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np

from rtnw.models.film import Film


def _fingerprint(tree) -> str:
    """Content hash of a pytree (scene/camera/config identity)."""
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(tree):
        arr = np.asarray(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def save_render_state(path: str, film: Film, seed: int, passes_done: int,
                      scene=None, camera=None, cfg=None) -> None:
    meta = {
        "seed": int(seed),
        "passes_done": int(passes_done),
        "fingerprint": _fingerprint((scene, camera)) if scene is not None else "",
        "cfg": cfg.__dict__ if cfg is not None else {},
    }
    np.savez_compressed(
        path,
        accum=np.asarray(film.accum),
        sample_count=np.asarray(film.sample_count),
        meta=json.dumps(meta),
    )


def load_render_state(path: str, scene=None, camera=None):
    """Returns (film, seed, passes_done). Raises ValueError on a stale
    checkpoint when scene/camera are provided for validation."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        if scene is not None and meta.get("fingerprint"):
            now = _fingerprint((scene, camera))
            if now != meta["fingerprint"]:
                raise ValueError(
                    f"stale checkpoint {path}: scene/camera changed "
                    f"({meta['fingerprint']} -> {now})"
                )
        film = Film(
            accum=jnp.asarray(z["accum"]),
            sample_count=jnp.asarray(z["sample_count"]),
        )
        return film, meta["seed"], meta["passes_done"]


def render_resumable(scene, camera, cfg, checkpoint_path: str,
                     checkpoint_every: int = 1, key=None) -> Film:
    """Offline render that checkpoints every `checkpoint_every` passes and
    resumes from `checkpoint_path` if present and fresh."""
    import os

    from rtnw.models import integrator

    if key is None:
        key = jax.random.key(cfg.seed)
    start_pass = 0
    film = Film.create(cfg.width, cfg.height)
    if os.path.exists(checkpoint_path):
        film, _, start_pass = load_render_state(checkpoint_path, scene, camera)

    passes = cfg.passes()
    for i in range(start_pass, len(passes)):
        chunk = passes[i]
        pass_key = jax.random.fold_in(key, i)
        film = film.add(
            integrator.render_pass(scene, camera, pass_key, cfg, chunk), chunk
        )
        if (i + 1) % checkpoint_every == 0 or i == len(passes) - 1:
            save_render_state(
                checkpoint_path, film, cfg.seed, i + 1, scene, camera, cfg
            )
    return film


def save_fit_state(path: str, params, opt_state, step: int) -> None:
    flat_p, tree_p = jax.tree_util.tree_flatten(params)
    flat_o, tree_o = jax.tree_util.tree_flatten(opt_state)
    np.savez_compressed(
        path,
        step=step,
        n_params=len(flat_p),
        **{f"p{i}": np.asarray(a) for i, a in enumerate(flat_p)},
        **{f"o{i}": np.asarray(a) for i, a in enumerate(flat_o)},
    )


def load_fit_state(path: str, params_template, opt_state_template):
    with np.load(path) as z:
        n = int(z["n_params"])
        flat_p = [jnp.asarray(z[f"p{i}"]) for i in range(n)]
        tree_p = jax.tree_util.tree_structure(params_template)
        flat_o_template, tree_o = jax.tree_util.tree_flatten(opt_state_template)
        flat_o = [jnp.asarray(z[f"o{i}"]) for i in range(len(flat_o_template))]
        return (
            jax.tree_util.tree_unflatten(tree_p, flat_p),
            jax.tree_util.tree_unflatten(tree_o, flat_o),
            int(z["step"]),
        )
