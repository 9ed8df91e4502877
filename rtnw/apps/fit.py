"""Inverse rendering: fit sphere positions + albedos to a target image.

BASELINE config 5. No counterpart exists in the reference (its renderer is
forward-only); this exercises the property the rebuild was designed
around — the renderer is a differentiable function of the scene pytree, so
`jax.grad` of an image loss gives scene-parameter gradients. Fits render
through the XLA engine (unfinalized or BVH scenes, see
integrator.select_engine): the megastep is forward-only.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rtnw.config import RenderConfig
from rtnw.models import integrator
from rtnw.models.camera import Camera
from rtnw.models.scene import Scene, SceneBuilder


class FitResult(NamedTuple):
    """First and last step loss and the fitted parameters."""

    loss0: float
    loss: float
    params: object

    @property
    def converged(self) -> bool:
        """The loss at least halved."""
        return self.loss < 0.5 * self.loss0


def _make_scene(centers: jnp.ndarray, albedos: jnp.ndarray) -> Scene:
    """Two lambertian spheres on a ground plane under an emissive dome."""
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.lambertian(1, (0.5, 0.5, 0.5))
    b.lambertian(2, (0.8, 0.8, 0.8))
    b.emission(3, (1.0, 1.0, 1.0), 1.5)
    b.sphere((0.0, 0.0, 0.0), 0.4, 0)
    b.sphere((0.0, 0.0, 0.0), 0.4, 1)
    b.plane((0.0, -0.4, 0.0), (0.0, 1.0, 0.0), (50.0, 0.0, 50.0), 2, 2)
    b.sphere((0.0, 0.0, 0.0), 30.0, 3)  # emissive dome
    scene = b.build()
    spheres = scene.spheres._replace(
        center0=scene.spheres.center0.at[0:2].set(centers),
        center1=scene.spheres.center1.at[0:2].set(centers),
    )
    materials = scene.materials._replace(
        albedo=scene.materials.albedo.at[0:2].set(albedos)
    )
    return scene._replace(spheres=spheres, materials=materials)


def run_fit(
    steps: int = 60,
    out: str = "fit.png",
    width: int = 96,
    height: int = 96,
    spp: int = 8,
    lr: float = 2e-2,
    seed: int = 0,
    verbose: bool = True,
) -> FitResult:
    camera = Camera.make(
        eye=(0.0, 0.6, 2.2), center=(0.0, 0.0, 0.0), fov=45.0,
        aperture=0.0, focus_distance=2.2,
    )
    cfg = RenderConfig(width=width, height=height, spp=spp, bounces=4,
                       spp_per_pass=spp)

    true_centers = jnp.asarray([[-0.45, 0.0, 0.0], [0.5, 0.05, -0.2]], jnp.float32)
    true_albedos = jnp.asarray([[0.8, 0.2, 0.2], [0.2, 0.3, 0.8]], jnp.float32)

    key = jax.random.key(seed)
    target = integrator.render_gbuffer(
        _make_scene(true_centers, true_albedos), camera, key, cfg, spp
    )

    params = {
        "centers": jnp.asarray([[-0.2, 0.1, 0.1], [0.25, -0.05, 0.0]], jnp.float32),
        "albedos": jnp.asarray([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]], jnp.float32),
    }

    @jax.jit
    def loss_fn(params, k):
        """Radiance + G-buffer loss.

        Radiance MSE alone cannot move geometry: with fixed-topology
        gradients and diffuse materials, pixel radiance is a product of
        albedos — its derivative wrt sphere centers is exactly zero (the
        silhouette term is a visibility discontinuity). Depth and normal
        AOVs are continuous in geometry inside the silhouette, so they
        carry the position signal; albedo AOV pins colors.
        """
        g = integrator.render_gbuffer(
            _make_scene(params["centers"], params["albedos"]), camera, k, cfg, spp
        )
        both_hit = jax.lax.stop_gradient(
            (g["hit_mask"] > 0.5) & (target["hit_mask"] > 0.5)
        )
        rad = jnp.mean((g["radiance"] / spp - target["radiance"] / spp) ** 2)
        depth = jnp.mean(
            jnp.where(both_hit, (g["depth"] - target["depth"]) ** 2, 0.0)
        )
        normal = jnp.mean(
            jnp.where(both_hit[..., None], (g["normal"] - target["normal"]) ** 2, 0.0)
        )
        albedo = jnp.mean(
            jnp.where(both_hit[..., None], (g["albedo"] - target["albedo"]) ** 2, 0.0)
        )
        return rad + 0.5 * depth + 0.2 * normal + 0.5 * albedo

    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, k):
        loss, grads = jax.value_and_grad(loss_fn)(params, k)
        updates, opt_state = optimizer.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        params["albedos"] = jnp.clip(params["albedos"], 0.0, 1.0)
        return params, opt_state, loss

    t0 = time.perf_counter()
    loss0 = None
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, jax.random.fold_in(key, i + 1))
        if loss0 is None:
            loss0 = float(loss)
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"  step {i:3d}  loss {float(loss):.5f}", file=sys.stderr)

    final_loss = float(loss)
    center_err = float(jnp.abs(params["centers"] - true_centers).max())
    albedo_err = float(jnp.abs(params["albedos"] - true_albedos).max())
    if verbose:
        print(
            f"fit: loss {loss0:.5f} -> {final_loss:.5f} in "
            f"{time.perf_counter() - t0:.1f}s; max center err {center_err:.3f}, "
            f"max albedo err {albedo_err:.3f}", file=sys.stderr,
        )

    from rtnw.io.image import write_png
    from rtnw.models.film import tonemap_u8

    final = integrator.render_pass(
        _make_scene(params["centers"], params["albedos"]), camera, key, cfg, spp
    ) / spp
    side = jnp.concatenate([target["radiance"] / spp, final], axis=1)
    write_png(out, np.asarray(tonemap_u8(side))[::-1])
    return FitResult(loss0, final_loss, params)


def _make_mesh_scene(n_lat: int = 12, n_lon: int = 24):
    """A diffuse uv-sphere mesh on a ground plane under an emissive dome —
    enough triangles (~500) that finalize builds a BVH."""
    from rtnw.io.procedural import uv_sphere_mesh

    b = SceneBuilder()
    b.lambertian(0, (0.7, 0.35, 0.25))
    b.lambertian(1, (0.8, 0.8, 0.8))
    b.emission(2, (1.0, 1.0, 1.0), 1.5)
    b.mesh(uv_sphere_mesh(0.45, (0.0, 0.05, 0.0), n_lat, n_lon), 0)
    b.plane((0.0, -0.4, 0.0), (0.0, 1.0, 0.0), (50.0, 0.0, 50.0), 2, 1)
    b.sphere((0.0, 0.0, 0.0), 30.0, 2)  # emissive dome
    return b.build()


def run_fit_mesh(
    steps: int = 40,
    out: str = "fit_mesh.png",
    width: int = 96,
    height: int = 96,
    spp: int = 8,
    lr: float = 1.5e-2,
    seed: int = 0,
    refresh: int = 8,
    verbose: bool = True,
) -> FitResult:
    """Inverse rendering on TRIANGLE VERTICES through the BVH walk
    (`rtnw fit --mesh`): recover an anisotropic per-axis vertex scale
    (`v' = v * (1 + scale)`) — the same reparameterization the multi-device
    vertex-grad tests use (tests/test_parallel.py).

    The walk is selection-only (stop-gradient); gradients flow through the
    hit recomputed from the winning triangle's live vertices at fixed
    topology (ops/traverse.intersect_bvh). Every `refresh` steps the scene
    is re-finalized so the BVH tracks the deformed geometry — the standard
    differentiable-rendering split (discrete accel rebuild outside the
    gradient, continuous geometry inside it).

    Loss design (each choice measured, see round-5 notes):
    * NORMAL AOV term — anisotropic scale tilts the cross-product face
      normals, whose fixed-topology gradients are bounded (normals are
      piecewise constant in ray position), so this is the faithful
      geometry signal.
    * radiance term rendered with the TARGET'S RNG key (correlated noise
      cancels in matching regions, so low-spp MC noise cannot masquerade
      as geometry error).
    * NO raw-depth term: fixed-topology depth gradients are dominated by
      grazing-angle plane-slides (dt/dparam ~ 1/cos -> unbounded near
      silhouettes; measured to flip the descent direction), and NO
      translation parameters: a translation slides tangent planes without
      moving the fixed-topology surface, so its gradient is silhouette
      -driven — invisible at fixed topology.
    """
    from rtnw.models.scene import finalize

    camera = Camera.make(
        eye=(0.0, 0.6, 2.2), center=(0.0, 0.0, 0.0), fov=45.0,
        aperture=0.0, focus_distance=2.2,
    )
    cfg = RenderConfig(width=width, height=height, spp=spp, bounces=4,
                       spp_per_pass=spp)

    base = _make_mesh_scene()
    true_scale = jnp.asarray([0.18, -0.15, 0.08], jnp.float32)

    def deform(scene, s3):
        tri = scene.triangles._replace(
            vertices=scene.triangles.vertices * (1.0 + s3)
        )
        return scene._replace(triangles=tri)

    def refinalize(s3):
        """Host-side accel rebuild at the CURRENT deformation (outside the
        gradient): winner topology follows the geometry."""
        return finalize(deform(base, np.asarray(
            jax.lax.stop_gradient(s3))))

    key = jax.random.key(seed)
    target = integrator.render_gbuffer(
        refinalize(true_scale), camera, key, cfg, spp)

    @jax.jit
    def loss_fn(s3, anchor_scene, anchor_s, k):
        # Geometry = anchor scene deformed by the RELATIVE scale from the
        # anchor's parameters to the live ones; the walk uses the anchor's
        # BVH (fixed topology between refreshes).
        rel = (1.0 + s3) / (1.0 + anchor_s) - 1.0
        s = deform(anchor_scene, rel)
        g = integrator.render_gbuffer(s, camera, k, cfg, spp)
        near = jax.lax.stop_gradient(
            (g["hit_mask"] > 0.5) & (target["hit_mask"] > 0.5)
            & (g["depth"] < 10.0) & (target["depth"] < 10.0)
        )
        rad = jnp.mean((g["radiance"] / spp - target["radiance"] / spp) ** 2)
        normal = jnp.mean(
            jnp.where(near[..., None],
                      (g["normal"] - target["normal"]) ** 2, 0.0)
        )
        return rad + 0.5 * normal

    optimizer = optax.adam(lr)
    params = jnp.zeros((3,), jnp.float32)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, anchor_scene, anchor_s, k):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, anchor_scene, anchor_s, k)
        updates, opt_state = optimizer.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    t0 = time.perf_counter()
    loss0 = None
    anchor_scene, anchor_s = refinalize(params), params
    for i in range(steps):
        if refresh and i and i % refresh == 0:
            anchor_scene, anchor_s = refinalize(params), params
        params, opt_state, loss = step(
            params, opt_state, anchor_scene, anchor_s, key)
        if loss0 is None:
            loss0 = float(loss)
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"  step {i:3d}  loss {float(loss):.5f}", file=sys.stderr)

    final_loss = float(loss)
    scale_err = float(jnp.abs(params - true_scale).max())
    if verbose:
        print(
            f"fit --mesh: loss {loss0:.5f} -> {final_loss:.5f} in "
            f"{time.perf_counter() - t0:.1f}s; max scale err "
            f"{scale_err:.3f}", file=sys.stderr,
        )

    from rtnw.io.image import write_png
    from rtnw.models.film import tonemap_u8

    final_img = integrator.render_pass(
        refinalize(params), camera, key, cfg, spp) / spp
    side = jnp.concatenate([target["radiance"] / spp, final_img], axis=1)
    write_png(out, np.asarray(tonemap_u8(side))[::-1])
    return FitResult(loss0, final_loss, params)
