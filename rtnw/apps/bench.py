"""Headline benchmark: Cornell box 512x512 (BASELINE.json metric).

The reference's best published number is 3857.460 ms for 512x512 x 32 spp at
<=10 bounces on an sm_61 GPU (images/images.MD:44-53), i.e. ~2.17 M camera
paths/s. We report paths/s on the same scene geometry (Cornell walls + light
+ metal/glass spheres + two cube meshes) and `vs_baseline` as the ratio to
that 2.17 M paths/s.
"""

from __future__ import annotations

import time

REFERENCE_PATHS_PER_SEC = 512 * 512 * 32 / 3.857460  # images/images.MD:44-53


def run_bench(
    width: int = 512,
    height: int = 512,
    spp: int = 128,
    bounces: int = 10,
    # One pass = one launch: the megastep loops every sample on-chip.
    spp_per_pass: int = 128,
    warmup: bool = True,
) -> dict:
    import jax

    from rtnw.config import RenderConfig
    from rtnw.models import integrator, presets
    from rtnw.models.scene import finalize

    scene, camera = presets.cornell_box()
    # finalize() packs the scene for the megastep (the Cornell cubes stay
    # brute-force: 24 triangles, merged into two oriented boxes).
    scene = finalize(scene)

    cfg = RenderConfig(
        width=width, height=height, spp=spp, bounces=bounces,
        spp_per_pass=spp_per_pass,
    )

    key = jax.random.key(cfg.seed)
    if warmup:  # compile outside the timed region (GPUTimer analogue)
        # Warm the FULL render() path (render_pass + film accumulation ops),
        # not just render_pass: film.add compiles lazily on first use.
        warm_cfg = RenderConfig(
            width=width, height=height, spp=min(spp_per_pass, spp),
            bounces=bounces, spp_per_pass=spp_per_pass,
        )
        jax.block_until_ready(integrator.render(scene, camera, warm_cfg, key=key).accum)

    t0 = time.perf_counter()
    film = integrator.render(scene, camera, cfg, key=key)
    jax.block_until_ready(film.accum)
    dt = time.perf_counter() - t0

    paths = width * height * spp
    paths_per_sec = paths / dt
    dev = jax.devices()[0]
    return {
        "metric": "paths/s, Cornell box 512x512",
        "value": round(paths_per_sec, 1),
        "unit": "paths/s",
        "vs_baseline": round(paths_per_sec / REFERENCE_PATHS_PER_SEC, 3),
        "render_ms": round(dt * 1000, 2),
        "engine": integrator.select_engine(scene),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "config": {
            "width": width, "height": height, "spp": spp, "bounces": bounces,
        },
        "mesh_bvh": run_mesh_bench(),
        "mesh_stress": run_mesh_stress(),
        "mesh_large": run_mesh_large(),
    }


def _time_mesh_scene(scene, camera, width, height, spp, bounces,
                     spp_per_pass, tris, asset):
    import jax

    from rtnw.config import RenderConfig
    from rtnw.models import integrator
    from rtnw.models.scene import finalize

    # The production auto selection: brute-force megastep at or below
    # BVH_THRESHOLD triangles, the XLA engine's BVH walk above.
    scene = finalize(scene)

    cfg = RenderConfig(width=width, height=height, spp=spp, bounces=bounces,
                       spp_per_pass=spp_per_pass)

    key = jax.random.key(cfg.seed)
    jax.block_until_ready(integrator.render(scene, camera, cfg, key=key).accum)  # warm
    t0 = time.perf_counter()
    film = integrator.render(scene, camera, cfg, key=key)
    jax.block_until_ready(film.accum)
    dt = time.perf_counter() - t0
    paths_per_sec = width * height * spp / dt
    return {
        "paths_per_sec": round(paths_per_sec, 1),
        "vs_baseline": round(paths_per_sec / REFERENCE_PATHS_PER_SEC, 3),
        "render_ms": round(dt * 1000, 2),
        "engine": integrator.select_engine(scene),
        "triangles": tris,
        "asset": asset,
        "config": {"width": width, "height": height, "spp": spp,
                   "bounces": bounces},
    }


def run_mesh_bench(
    width: int = 512, height: int = 512, spp: int = 32, bounces: int = 10,
    spp_per_pass: int = 16,
) -> dict:
    """Mesh metric 1: the reference's PUBLISHED mesh benchmark, faithfully.

    Asset archaeology — the 3857.460 ms row (images/images.MD:44-53) is
    routinely misread as the materialball BVH scene; it is not:

      * every optimization stage in the log — per-triangle AABB cull,
        texture memory, precomputed v0/E1/E2, backface cull — is a
        feature of the BRUTE-FORCE Path-A mesh loop
        (TriangleMesh.cu:34-117), not of the BVH traversal;
      * the timed renders show the ~967-triangle suzanne statue
        (resources/models/suzanne/suzanne0.ply, "element face 967") in a
        Cornell box with the metal/glass sphere pair — materialball never
        appears in images/;
      * the rows say "Bounces 10", which is Path A's BOUNCES=10
        (main.cu:23); the later Path-B/BVH kernel caps at maxDepth=5
        (main.cu:172) and has NO published timing.

    So the published 2.17 M paths/s is: Cornell walls + area light +
    metal & glass spheres + the suzanne statue, 512x512, 32 spp,
    10 bounces — identified as cornellbox0.yaml + suzanne0.ply by
    matching the timed golden PNGs (see
    apps/bench_scenes.published_mesh_scene, which builds the scene, and
    tests/test_oracle_crossval.test_published_bench_scene_vs_timed_golden_png,
    which pins this bench's composition + radiometry against the
    reference's own committed golden). Rendered through the XLA engine's
    BVH walk; falls back to a procedural stand-in when the reference
    assets are missing.
    """
    from rtnw.apps.bench_scenes import (
        published_mesh_scene,
    )

    scene, camera, asset = published_mesh_scene()
    tris = int(scene.triangles.count)
    return _time_mesh_scene(scene, camera, width, height, spp, bounces,
                            spp_per_pass, tris, asset)


def run_mesh_stress(
    width: int = 512, height: int = 512, spp: int = 32, bounces: int = 10,
    spp_per_pass: int = 16,
) -> dict:
    """Mesh metric 2: heavyweight stress — 48x the published mesh size.

    cornellbox2.yaml (incl. its two cube meshes) + materialball.ply
    (46,816 tris, COAT, offset (0.1, 0, -1) as prepareCUDAscene loads it
    today, main.cu:428-432) at the same 512x512 x 32 spp x 10 bounces.
    The reference never published a timing for this composition (its BVH
    kernel caps at 5 bounces and the log predates materialball), so
    `vs_baseline` here compares a 48x-larger mesh workload against the
    967-tri published number — context, not parity.
    """
    from rtnw.apps.bench_scenes import (
        stress_mesh_scene,
    )

    scene, camera, asset = stress_mesh_scene()
    tris = int(scene.triangles.count)
    return _time_mesh_scene(scene, camera, width, height, spp, bounces,
                            spp_per_pass, tris, asset)


def run_mesh_large(
    width: int = 512, height: int = 512, spp: int = 8, bounces: int = 5,
    spp_per_pass: int = 8,
) -> dict:
    """Mesh metric 3: geometry scale — ~562k triangles (12x materialball),
    12x beyond anything the reference ships. No reference counterpart
    exists (its BVH kernel was never timed); lighter spp/bounces keep the
    entry's wall time proportionate.
    """
    from rtnw.apps.bench_scenes import (
        large_mesh_scene,
    )

    scene, camera, asset = large_mesh_scene()
    tris = int(scene.triangles.count)
    out = _time_mesh_scene(scene, camera, width, height, spp, bounces,
                           spp_per_pass, tris, asset)
    out["vs_baseline"] = None  # no reference number exists at this scale
    return out
