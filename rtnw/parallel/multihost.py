"""Scaling measurement over this host's devices.

The reference is single-process/single-GPU. Here the global mesh spans
the devices of the host. The render is data-parallel over tiles with a
replicated scene, so there is no cross-device traffic in the forward pass
at all; the backward pass adds one psum of scene-parameter gradients.
"""

from __future__ import annotations

import time

import jax


def measure_scaling(scene, camera, cfg, device_counts=None, spp: int = 8,
                    verbose: bool = True):
    """Throughput vs device count on this host's devices.

    Returns {n_devices: paths_per_sec}. Efficiency(n) =
    rate(n) / (n * rate(1)).
    """
    from rtnw.parallel.mesh import make_mesh
    from rtnw.parallel.render import render_pass_sharded
    from rtnw.utils.timing import sync

    if device_counts is None:
        n = len(jax.devices())
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]

    results = {}
    key = jax.random.key(0)
    for n_dev in device_counts:
        mesh = make_mesh(n_dev)
        out = render_pass_sharded(scene, camera, key, cfg, spp, mesh)
        sync(out)  # compile + warm
        t0 = time.perf_counter()
        out = render_pass_sharded(scene, camera, jax.random.fold_in(key, 1), cfg, spp, mesh)
        sync(out)
        dt = time.perf_counter() - t0
        rate = cfg.num_pixels * spp / dt
        results[n_dev] = rate
        if verbose:
            base = results[device_counts[0]] * n_dev / device_counts[0]
            print(
                f"  {n_dev:3d} devices: {rate / 1e6:8.2f} Mpaths/s "
                f"(efficiency {rate / base * 100:5.1f}%)"
            )
    return results
