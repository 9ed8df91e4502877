"""Thin-lens camera as a differentiable pytree + pure ray generator.

Replaces the stateful `Camera` class (Camera.h:12-196): the user-facing
parameters live in `Camera`, the derived viewport frame is a pure function
(`derive`, mirroring updateViewMatrix Camera.h:86-103), and ray generation is
a pure map from (frame, pixel jitter, lens sample, shutter sample) to rays
(getRay, Camera.h:151-168). The interactive walk/yaw/orbit controls live in
the progressive-render driver (apps/interactive), not here — the dirty-flag
protocol becomes "new params => new accumulation".
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtnw.config import DTYPE
from rtnw.ops import linalg, rng
from rtnw.ops.rays import Rays


class Camera(NamedTuple):
    """User parameters (Camera.h:19-34 initialize signature)."""

    eye: jnp.ndarray          # (3,)
    center: jnp.ndarray       # (3,) look-at point
    up: jnp.ndarray           # (3,)
    fov: jnp.ndarray          # () degrees, vertical
    aperture: jnp.ndarray     # ()
    focus_distance: jnp.ndarray  # ()
    time0: jnp.ndarray        # () shutter open
    time1: jnp.ndarray        # () shutter close

    @staticmethod
    def make(eye, center, up=(0.0, 1.0, 0.0), fov=90.0, aperture=2.0,
             focus_distance=1.0, time0=0.0, time1=0.0) -> "Camera":
        as_a = lambda x: jnp.asarray(x, DTYPE)
        return Camera(
            eye=as_a(eye), center=as_a(center), up=as_a(up), fov=as_a(fov),
            aperture=as_a(aperture), focus_distance=as_a(focus_distance),
            time0=as_a(time0), time1=as_a(time1),
        )

    @staticmethod
    def from_yaml_block(block: dict) -> "Camera":
        """Reference YAML camera block: eye/center/up/aperture/fov with
        focusDistance = |center - eye| (main.cu:632-638) and shutter [0, 1].
        """
        import numpy as np

        eye = np.asarray(block["eye"], np.float32)
        center = np.asarray(block["center"], np.float32)
        focus = float(np.linalg.norm(center - eye))
        return Camera.make(
            eye=eye,
            center=center,
            up=np.asarray(block.get("up", (0.0, 1.0, 0.0)), np.float32),
            fov=float(block.get("fov", 90.0)),
            aperture=float(block.get("aperture", 0.0)),
            focus_distance=focus,
            time0=0.0,
            time1=1.0,
        )


class CameraFrame(NamedTuple):
    """Derived viewport frame (updateViewMatrix outputs, Camera.h:86-103)."""

    origin: jnp.ndarray
    lower_left: jnp.ndarray
    horizontal: jnp.ndarray
    vertical: jnp.ndarray
    right: jnp.ndarray
    true_up: jnp.ndarray
    lens_radius: jnp.ndarray
    time0: jnp.ndarray
    time1: jnp.ndarray


def derive(camera: Camera, aspect_ratio: float) -> CameraFrame:
    """Pure re-derivation of the viewport frame; differentiable wrt pose/fov."""
    scale = jnp.tan(jnp.deg2rad(camera.fov / 2.0))
    viewport_h = 2.0 * scale
    viewport_w = viewport_h * aspect_ratio
    forward = linalg.normalize(camera.center - camera.eye)
    right = linalg.normalize(linalg.cross(forward, camera.up))
    true_up = linalg.cross(right, forward)
    horizontal = viewport_w * right * camera.focus_distance
    vertical = viewport_h * true_up * camera.focus_distance
    lower_left = (
        camera.eye - horizontal / 2.0 - vertical / 2.0
        + forward * camera.focus_distance
    )
    return CameraFrame(
        origin=camera.eye,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        right=right,
        true_up=true_up,
        lens_radius=camera.aperture / 2.0,  # Camera.h:112
        time0=camera.time0,
        time1=camera.time1,
    )


def ray_context(pass_key, pixel_ids: jnp.ndarray) -> rng.RayCtx:
    """Counter-based per-ray RNG context: (pixel_id, key words).

    This replaces curand's per-pixel sequence (curand_init(1984, pixel),
    main.cu:127) with a stateless derivation — a ray's randomness depends
    only on (seed, pass, pixel), never on which device traces it, which
    makes tile-sharded renders bit-identical to single-device renders.
    The pass/sample key collapses to its two uint32 words once per
    wavefront; all per-ray draws are then pcg4d hashes (ops/rng.py).
    """
    base0, base1 = rng.key_bases(pass_key)
    return rng.RayCtx(pixel_ids.astype(jnp.uint32), base0, base1)


def generate_rays(
    frame: CameraFrame, pass_key, width: int, height: int,
    pixel_ids: jnp.ndarray | None = None,
) -> tuple[Rays, rng.RayCtx]:
    """One jittered primary ray per pixel of `pixel_ids` (default: all
    pixels, flattened row-major, y=0 at the image bottom — the Canvas PNG
    writer flips vertically, Canvas.h:141-154).

    Matches renderKernel's sample placement dx=(x+u)/(width-1),
    dy=(y+v)/(height-1) (main.cu:179-183) and getRay's lens-disk offset +
    shutter-time draw (Camera.h:151-168). Directions are normalized (the
    reference normalizes primary-ray directions too, Camera.h:166).

    Returns (rays, ctx) where ctx is the RayCtx the integrator uses for
    per-bounce draws.
    """
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.uint32)
    ctx = ray_context(pass_key, pixel_ids)
    return generate_rays_ctx(frame, ctx, width, height), ctx


def generate_rays_ctx(
    frame: CameraFrame, ctx: rng.RayCtx, width: int, height: int,
) -> Rays:
    """Raygen body over a prebuilt RayCtx (see generate_rays)."""
    pixel_ids = ctx.pixel_id
    # 5 uniforms per ray: pixel jitter (2), lens disk (2), shutter time (1).
    u = rng.raygen_uniforms(ctx)

    xs = (pixel_ids % width).astype(DTYPE)
    ys = (pixel_ids // width).astype(DTYPE)
    # A multiply by the f32 reciprocal: what the compiler makes of a
    # division by a constant, written out so both engines do the same.
    dx = (xs + u[:, 0]) * linalg.reciprocal(width - 1)
    dy = (ys + u[:, 1]) * linalg.reciprocal(height - 1)

    # Closed-form unit disk from the two lens uniforms (Utils.h:96-104).
    r = jnp.sqrt(u[:, 2])
    phi = 2.0 * jnp.pi * u[:, 3]
    disk_x = frame.lens_radius * r * jnp.cos(phi)
    disk_y = frame.lens_radius * r * jnp.sin(phi)
    # The megastep's raygen (bounce_kernel._raygen_core) writes the same
    # expressions in the same order, so both compilers fuse the same
    # multiply-adds and both engines start from bit-identical rays.
    origin = frame.origin + (
        disk_x[:, None] * frame.right + disk_y[:, None] * frame.true_up)
    d = frame.lower_left + dx[:, None] * frame.horizontal
    d = d + dy[:, None] * frame.vertical - origin
    nsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    # Safe normalize (linalg.normalize) with the reciprocal square root the
    # compiler substitutes for 1 / sqrt.
    pos = nsq > 0.0
    inv = jnp.where(pos, jax.lax.rsqrt(jnp.where(pos, nsq, 1.0)), 0.0)
    time = u[:, 4] * (frame.time1 - frame.time0) + frame.time0
    return Rays(origin=origin, direction=d * inv[:, None], time=time)

