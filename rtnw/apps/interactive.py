"""Interactive progressive-render session.

The capability equivalent of the realtime OpenGL/ImGui frontend
(OpenGLFrontend.cpp:422-620) without a window: a session object owning a
camera, a scene and a progressive film, exposing the reference's controls —

  walk/strafe/raise_ (WASDQE movement, Camera.h:40-57, speed x delta),
  yaw/pitch (mouse look, Camera.h:58-77), orbit (Camera.h:78-84),
  set_aperture/set_fov/set_moving_speed (the ImGui sliders,
  OpenGLFrontend.cpp:189-197)

— each marking the camera dirty; the next `step()` then clears the
accumulation buffer exactly like pathTracing()'s dirty check
(main.cu:877-881). `screenshot()` writes render_{W}x{H}_spp{N}.png, the
naming scheme of OpenGLFrontend.cpp:334-342.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from rtnw.config import RenderConfig
from rtnw.models import integrator
from rtnw.models.camera import Camera
from rtnw.models.film import Film, to_image
from rtnw.ops import linalg


class InteractiveSession:
    def __init__(self, scene, camera: Camera, cfg: RenderConfig | None = None,
                 spp_per_frame: int = 1):
        if cfg is None:
            cfg = RenderConfig(width=512, height=512, spp=1, bounces=5)
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.spp_per_frame = spp_per_frame
        self.moving_speed = 1.5  # Camera.h:28
        self.film = Film.create(cfg.width, cfg.height)
        self._dirty = True
        self._frame = 0
        self._key = jax.random.key(cfg.seed)

    # -- camera controls (all mark dirty) ------------------------------
    def _forward(self):
        return linalg.normalize(self.camera.center - self.camera.eye)

    def _right(self):
        return linalg.normalize(linalg.cross(self._forward(), self.camera.up))

    def _move(self, direction, delta: float):
        step = direction * (self.moving_speed * delta)
        self.camera = self.camera._replace(
            eye=self.camera.eye + step, center=self.camera.center + step
        )
        self._dirty = True

    def walk(self, delta: float) -> None:
        self._move(self._forward(), delta)

    def strafe(self, delta: float) -> None:
        self._move(self._right(), delta)

    def raise_(self, delta: float) -> None:
        self._move(self.camera.up, delta)

    def yaw(self, degrees: float) -> None:
        forward = linalg.rotate_y(self._forward()[None, :], degrees)[0]
        self.camera = self.camera._replace(center=self.camera.eye + forward)
        self._dirty = True

    def pitch(self, degrees: float) -> None:
        # Rotate forward about the right axis (Camera.h:69-76).
        f = self._forward()
        r = self._right()
        rad = jnp.deg2rad(degrees)
        c, s = jnp.cos(rad), jnp.sin(rad)
        # Rodrigues about r (r is unit, f ⊥ r).
        new_f = f * c + linalg.cross(r, f) * s
        self.camera = self.camera._replace(center=self.camera.eye + new_f)
        self._dirty = True

    def orbit(self, target=(0.0, 0.0, 0.0), radians: float = 0.01) -> None:
        # XZ-plane orbit around target (Camera.h:78-84).
        t = jnp.asarray(target, jnp.float32)
        e = self.camera.eye
        x, z = e[0] - t[0], e[2] - t[2]
        c, s = np.cos(radians), np.sin(radians)
        new_eye = jnp.asarray(
            [x * c - z * s + t[0], e[1], x * s + z * c + t[2]], jnp.float32
        )
        self.camera = self.camera._replace(eye=new_eye)
        self._dirty = True

    def set_aperture(self, aperture: float) -> None:
        self.camera = self.camera._replace(aperture=jnp.float32(aperture))
        self._dirty = True

    def set_fov(self, fov: float) -> None:
        self.camera = self.camera._replace(fov=jnp.float32(fov))
        self._dirty = True

    def set_moving_speed(self, speed: float) -> None:
        self.moving_speed = float(speed)

    # -- frame loop -----------------------------------------------------
    def step(self) -> Film:
        """Render one progressive frame (spp_per_frame samples).

        Mirrors pathTracing() (main.cu:875-888): camera dirty -> clear the
        accumulation buffer and re-derive the view; then accumulate.
        """
        if self._dirty:
            self.film = Film.create(self.cfg.width, self.cfg.height)
            self._dirty = False
        pass_key = jax.random.fold_in(self._key, self._frame)
        self.film = self.film.add(
            integrator.render_pass(
                self.scene, self.camera, pass_key, self.cfg, self.spp_per_frame
            ),
            self.spp_per_frame,
        )
        self._frame += 1
        return self.film

    @property
    def sample_count(self) -> int:
        return int(self.film.sample_count)

    def image(self) -> np.ndarray:
        return to_image(self.film)

    def screenshot(self, directory: str = ".") -> str:
        """render_{W}x{H}_spp{N}.png (OpenGLFrontend.cpp:334-342)."""
        import os

        from rtnw.io.image import write_png

        name = (
            f"render_{self.cfg.width}x{self.cfg.height}_spp{self.sample_count}.png"
        )
        path = os.path.join(directory, name)
        write_png(path, self.image())
        return path
