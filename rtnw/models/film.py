"""Film: progressive accumulation buffer + tonemap.

Replaces Canvas (Canvas.h:17-217): the float accumulation buffer and sample
counter become a small pytree, and the u8 conversion replicates the
reference's gamma exactly — u8 = 255.99 * clamp(sqrt(c), 0, 0.999)
(Canvas.h:198-200). The accumulate/reset-on-camera-dirty protocol
(main.cu:877-888) is implemented by the progressive driver creating a fresh
Film when parameters change.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from rtnw.config import DTYPE


class Film(NamedTuple):
    accum: jnp.ndarray         # (H, W, 3) running radiance sum
    sample_count: jnp.ndarray  # () int32 — samples accumulated per pixel

    @staticmethod
    def create(width: int, height: int) -> "Film":
        return Film(
            accum=jnp.zeros((height, width, 3), DTYPE),
            sample_count=jnp.zeros((), jnp.int32),
        )

    def add(self, radiance_sum: jnp.ndarray, samples: int) -> "Film":
        """Accumulate the summed radiance of `samples` new samples/pixel."""
        return Film(
            accum=self.accum + radiance_sum,
            sample_count=self.sample_count + samples,
        )

    @property
    def mean(self) -> jnp.ndarray:
        scale = 1.0 / jnp.maximum(self.sample_count, 1).astype(DTYPE)
        return self.accum * scale


def tonemap_u8(mean_radiance: jnp.ndarray) -> jnp.ndarray:
    """Gamma-2 tonemap to u8: 255.99 * clamp(sqrt(c), 0, 0.999) (Canvas.h:199)."""
    c = jnp.sqrt(jnp.maximum(mean_radiance, 0.0))
    return (255.99 * jnp.clip(c, 0.0, 0.999)).astype(jnp.uint8)


def to_image(film: Film) -> np.ndarray:
    """(H, W, 3) u8 with row 0 at the image top.

    The film stores y=0 at the bottom (camera convention); the PNG flip
    mirrors Canvas::writeToPNG (Canvas.h:141-154).
    """
    return np.asarray(tonemap_u8(film.mean))[::-1]
