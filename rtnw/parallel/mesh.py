"""Device mesh construction.

The reference is single-GPU (SURVEY.md §2: its only parallelism is the SIMT
pixel grid); multi-device scaling is new capability. The model: one logical
axis `tiles` — image pixels / ray wavefronts are data-parallel over devices,
the scene is replicated in every device's memory (the multi-device analogue
of __constant__/texture memory, main.cu:850-851), and only gradient
reductions communicate (psum over `tiles`). Every card reaches every other
at the same rate, so the 1-D mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D mesh over `n_devices` (default: all visible devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (TILE_AXIS,), devices=devices)


def tile_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (pixel/ray) axis across devices."""
    return NamedSharding(mesh, P(TILE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
