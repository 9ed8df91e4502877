"""Render configuration.

One typed config replaces the reference's three config tiers (compile-time
`#define RESOLUTION/SCENE/GPU_REALTIME/BOUNCES` in main.cu:208-233, runtime
YAML camera/object schema, ImGui sliders): everything is a runtime value here,
and anything that changes traced shapes (width/height/spp/bounces) is a static
field of the jitted render step.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# The reference's float configuration (CUDATypes.h:12-19): Float = float32 by
# default with a USE_DOUBLE escape hatch; float64 is for CPU-side oracles only.
DTYPE = jnp.float32

# Math::epsilon (Constants.h:23) — ray tMin and plane denominator threshold.
EPSILON = 1e-3
# FLT_EPSILON — sphere discriminant + front-face tests (Sphere.cu:11,
# HitResult.h:16) use the much tighter machine epsilon, not Math::epsilon.
FLT_EPSILON = 1.1920929e-7
INFINITY = float("inf")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static parameters of a render.

    Mirrors the union of the reference's compile-time knobs:
    width/height (`RESOLUTION`, main.cu:208-231), spp (main.cu:165-169),
    bounces (`BOUNCES`=10 main.cu:23 for the OOP engine, 5 for the BVH engine
    CUDAPathTracer.cu:366), and adds the north-star extensions (Russian
    roulette, sharding, precision) that have no reference counterpart.
    """

    width: int = 512
    height: int = 512
    spp: int = 32
    bounces: int = 10
    # Ray epsilon used as tMin on every bounce (main.cu:69 uses Math::epsilon).
    tmin: float = EPSILON
    # Samples traced per device pass; 0 means "all at once". Both engines
    # hold one sample's wavefront at a time, so device memory is O(pixels)
    # regardless of pass size and one launch is fastest; per-pass chunking
    # matters for progressive/resumable renders.
    spp_per_pass: int = 0
    # Russian roulette (absent in the reference; CUDAPathTracer.cu:532 TODO).
    russian_roulette: bool = False
    rr_start_bounce: int = 3
    # Background: RTiOW sky gradient (main.cu:86-89). When False the miss
    # shade is black (Path B style, CUDAPathTracer.cu:417).
    sky_background: bool = True
    # curand seed 1984 (main.cu:127) — here the root of the PRNG key tree.
    seed: int = 1984

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def passes(self) -> list[int]:
        """Split ``spp`` into per-pass sample counts."""
        chunk = self.spp_per_pass if self.spp_per_pass > 0 else self.spp
        chunk = max(1, min(chunk, self.spp))
        counts = [chunk] * (self.spp // chunk)
        if self.spp % chunk:
            counts.append(self.spp % chunk)
        return counts
