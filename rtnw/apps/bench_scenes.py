"""Benchmark scene builders, shared by apps/bench.py, tools/ and tests/.

Each builder returns (scene, camera, asset_note) with the scene NOT yet
finalized, so callers control the brute-vs-BVH path selection. The scenes
reproduce the reference's benchmark workloads (see apps/bench.py for the
asset archaeology of the published 3857.460 ms number).
"""

from __future__ import annotations

import os

_REF_RES = "/root/reference/RayTracingTheNextWeekCUDA/resources"

# Published-benchmark suzanne placement, tuned against the reference's own
# timed goldens (images/render_512x512_10bounces_32spp_*.png): the statue
# floats centered between/behind the sphere pair with its center near
# image center (pixel-measured: silhouette spans ~y 182-320 px of 512 ->
# center ndc ~ 0). Placement sweep (center-region correlation vs the
# golden, tools history): (0,-0.02,-0.25) mc 0.34 -> 0.80 vs 0.63 for the
# old floor placement. Pinned by tests/test_oracle_crossval.py's
# suzanne-golden crossval.
SUZANNE_OFFSET = (0.0, -0.02, -0.25)
SUZANNE_MAX_COORD = 0.34


def reference_assets_present() -> bool:
    return os.path.exists(f"{_REF_RES}/scenes/cornellbox2.yaml")


def published_mesh_scene():
    """The reference's PUBLISHED mesh benchmark workload (3857.460 ms row).

    Scene identification against the timed goldens
    (images/render_512x512_10bounces_32spp*.png): the sphere placement in
    every suzanne-series PNG matches cornellbox0.yaml exactly (metal at
    (-0.225,-0.325,-0.25) r 0.175 resting near the floor, glass at
    (0.275,-0.325,-0.125); cornellbox2's floating spheres do NOT match),
    and the camera is cornellbox0's eye (0,0,1.25). So the published
    workload = cornellbox0.yaml under the reference's RUNTIME material
    slots (main.cu:643-651) + the ~967-triangle suzanne0.ply statue
    centered between/behind the spheres — rendered by the brute Path-A
    loop (TriangleMesh.cu:34-117), BOUNCES=10, 32 spp, 512x512. Falls
    back to a procedural stand-in when /root/reference is not mounted.
    """
    from rtnw.models import presets

    scene_yaml = f"{_REF_RES}/scenes/cornellbox0.yaml"
    suz_ply = f"{_REF_RES}/models/suzanne/suzanne0.ply"
    if os.path.exists(scene_yaml) and os.path.exists(suz_ply):
        from rtnw.io.ply import load_ply
        from rtnw.io.yaml_scene import (
            load_scene_builder,
        )

        builder, camera = load_scene_builder(
            scene_yaml, scene1_materials=True
        )
        # White lambertian = materials[3] (createMesh binds materials[3]
        # regardless of YAML, main.cu:781).
        tris_arr = load_ply(suz_ply, offset=SUZANNE_OFFSET,
                            max_coord=SUZANNE_MAX_COORD)
        builder.mesh(tris_arr, 3)
        scene = builder.build()
        asset = "cornellbox0 walls/spheres + suzanne0.ply (published bench)"
    else:
        scene, camera = presets.mesh_showcase(n_lat=16, n_lon=32)
        asset = "procedural stand-in (reference not mounted)"
    return scene, camera, asset


def stress_mesh_scene():
    """48x the published mesh size: cornellbox2.yaml (incl. cube meshes)
    + materialball.ply (46,816 tris, COAT, offset (0.1, 0, -1) as
    prepareCUDAscene loads it today, main.cu:428-432)."""
    from rtnw.models import presets

    scene_yaml = f"{_REF_RES}/scenes/cornellbox2.yaml"
    ball_ply = f"{_REF_RES}/models/materialball/materialball.ply"
    if os.path.exists(scene_yaml) and os.path.exists(ball_ply):
        from rtnw.io.ply import load_ply
        from rtnw.io.yaml_scene import (
            load_scene_builder,
        )

        builder, camera = load_scene_builder(scene_yaml)
        tris_arr = load_ply(ball_ply, offset=(0.1, 0.0, -1.0))
        # COAT: Path B's clear-coat diffuse (CUDAPathTracer.cu:522-563);
        # specular layer is hard-coded white there, diffuse color rides
        # the triangle — materialball ships uncolored, so 0.9 grey.
        builder.coat(20, (0.9, 0.9, 0.9))
        builder.mesh(tris_arr, 20)
        scene = builder.build()
        asset = "cornellbox2.yaml + materialball.ply (48x published size)"
    else:
        scene, camera = presets.mesh_showcase(n_lat=64, n_lon=128)
        asset = "procedural uv-sphere stand-in (reference not mounted)"
    return scene, camera, asset


def large_mesh_scene(copies: int = 12):
    """Geometry-scale stress: `copies` displaced materialballs (~562k
    tris at 12)."""
    import numpy as np

    from rtnw.models import presets

    ball_ply = f"{_REF_RES}/models/materialball/materialball.ply"
    scene_yaml = f"{_REF_RES}/scenes/cornellbox2.yaml"
    if os.path.exists(scene_yaml) and os.path.exists(ball_ply):
        from rtnw.io.ply import load_ply
        from rtnw.io.yaml_scene import (
            load_scene_builder,
        )

        builder, camera = load_scene_builder(scene_yaml)
        base = np.asarray(load_ply(ball_ply, offset=(0.0, 0.0, -1.0)))
        builder.coat(20, (0.9, 0.9, 0.9))
        rng = np.random.default_rng(7)
        tris = []
        grid = int(np.ceil(np.sqrt(copies)))
        for i in range(copies):
            gx, gy = i % grid, i // grid
            off = np.array(
                [(-0.6 + 1.2 * gx / max(grid - 1, 1)),
                 (-0.25 + 0.5 * gy / max(grid - 1, 1)),
                 0.35 * rng.uniform(-1.0, 1.0)],
                np.float32,
            )
            tris.append(base * 0.45 + off[None, None, :])
        builder.mesh(np.concatenate(tris, axis=0), 20)
        scene = builder.build()
        asset = f"{copies}x materialball.ply in cornellbox2 (HBM streaming)"
    else:
        scene, camera = presets.mesh_showcase(n_lat=256, n_lon=512)
        asset = "procedural uv-sphere stand-in (reference not mounted)"
    return scene, camera, asset


__all__ = [
    "published_mesh_scene", "stress_mesh_scene", "large_mesh_scene",
    "reference_assets_present", "SUZANNE_OFFSET", "SUZANNE_MAX_COORD",
]
