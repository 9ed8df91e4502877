"""Scene pytree and host-side builder.

The scene is a pytree of packed SoA arrays — the analogue of the reference's
`constantObjects` / `constantMaterials` tables (main.cu:27-28,850-851) plus
its texture-wrapped triangle/BVH buffers (main.cu:442-549), with material
pointers replaced by table indices. Because it is a pytree, the whole scene
is a differentiable parameter of `render`, shardable with `jax.sharding`.

`SceneBuilder` replaces the <<<1,1>>> device-`new` factory kernels
(kernels.h:99-154): primitives accumulate in host lists and `build()` packs
them once into device arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from rtnw.config import DTYPE
from rtnw.ops import geometry as geom
from rtnw.ops.geometry import (
    Materials,
    Planes,
    Spheres,
    Triangles,
)


class MeshInfo(NamedTuple):
    """Per-mesh AABBs for the brute-force early-out (TriangleMesh.cu:35-37)."""

    bounds_min: jnp.ndarray  # (K, 3)
    bounds_max: jnp.ndarray  # (K, 3)


class Scene(NamedTuple):
    spheres: Spheres
    planes: Planes
    triangles: Triangles
    materials: Materials
    mesh_info: MeshInfo
    # Flat BVH arrays (ops/bvh.py contract) or None for brute-force meshes.
    bvh: Optional[tuple] = None
    # bounce_kernel.MegastepScene for the megastep, or None.
    packed: Optional[object] = None


# Above this many triangles finalize() builds a BVH and meshes are walked
# by ops/traverse; at or below it the megastep tests every triangle.
BVH_THRESHOLD = 256


def bvh_builder() -> str:
    """Which flat-BVH builder finalize() uses: the native binned-SAH build
    ("sah", native/bvh_builder.cpp) when the library builds, else LBVH."""
    from rtnw import native

    return "sah" if native.available() else "lbvh"


def finalize(scene: Scene, use_bvh: bool | None = None) -> Scene:
    """Prepare a built scene for rendering.

    `use_bvh=None` auto-selects: a mesh above BVH_THRESHOLD triangles gets
    a flat BVH (`scene.bvh`, ops/bvh.py contract) from `bvh_builder()`,
    which the XLA engine walks (ops/traverse.py) with vertex gradients
    intact. Otherwise the scene is packed for the megastep
    (`scene.packed`, ops/pallas/bounce_kernel.pack_megastep), the engine
    for analytic scenes on a GPU. integrator.select_engine reads the
    result.
    """
    if use_bvh is None:
        use_bvh = scene.triangles.count > BVH_THRESHOLD
    if use_bvh and scene.triangles.count >= 2:
        if bvh_builder() == "sah":
            from rtnw.native import build_sah_bvh as build
        else:
            from rtnw.ops.bvh import build_bvh as build
        return scene._replace(bvh=build(scene.triangles), packed=None)
    from rtnw.ops.pallas.bounce_kernel import pack_megastep

    return scene._replace(bvh=None, packed=pack_megastep(scene))


class SceneBuilder:
    """Accumulates primitives + materials, then packs the Scene pytree."""

    def __init__(self) -> None:
        self._spheres: list[tuple] = []
        self._planes: list[tuple] = []
        self._tri_vertices: list[np.ndarray] = []
        self._tri_material: list[np.ndarray] = []
        self._tri_mesh_id: list[np.ndarray] = []
        self._materials: dict[int, tuple] = {}
        self._mesh_count = 0

    # -- materials (create*Material factories, kernels.h:50-84) --------
    def material(self, material_id: int, kind: int, albedo=(0.0, 0.0, 0.0),
                 param: float = 0.0, emission=(0.0, 0.0, 0.0)) -> int:
        """Register material row `material_id`; first definition wins
        (mirrors the YAML loader's create-if-null, main.cu:710-747).

        `emission` is additive per-hit radiance (Path B's sphere `emi`,
        CUDAPathTracer.cu:430) — the path keeps bouncing after emitting.
        """
        if material_id not in self._materials:
            self._materials[material_id] = (
                kind, tuple(albedo), float(param), tuple(emission)
            )
        return material_id

    def lambertian(self, material_id: int, albedo) -> int:
        return self.material(material_id, geom.LAMBERTIAN, albedo)

    def metal(self, material_id: int, albedo, fuzz: float = 1.0) -> int:
        return self.material(material_id, geom.METAL, albedo, min(fuzz, 1.0))

    def dielectric(self, material_id: int, ior: float) -> int:
        return self.material(material_id, geom.DIELECTRIC, (1.0, 1.0, 1.0), ior)

    def emission(self, material_id: int, albedo, intensity: float = 1.0) -> int:
        return self.material(material_id, geom.EMISSION, albedo, intensity)

    def phong_metal(self, material_id: int, albedo, exponent: float = 20.0) -> int:
        return self.material(material_id, geom.PHONG_METAL, albedo, exponent)

    def specular(self, material_id: int, albedo) -> int:
        return self.material(material_id, geom.SPECULAR, albedo)

    def coat(self, material_id: int, albedo) -> int:
        return self.material(material_id, geom.COAT, albedo)

    def refraction(self, material_id: int, ior: float = 1.5) -> int:
        """Path B smallpt-style glass (CUDAPathTracer.cu:566-614)."""
        return self.material(material_id, geom.REFRACTION, (1.0, 1.0, 1.0), ior)

    # -- primitives -----------------------------------------------------
    def sphere(self, center, radius: float, material_id: int) -> None:
        """Static sphere (kernels.h createSphere); negative radius = hollow."""
        c = tuple(center)
        self._spheres.append((c, c, 0.0, 1.0, float(radius), material_id))

    def moving_sphere(self, center0, center1, time0: float, time1: float, radius: float, material_id: int) -> None:
        """Motion-blurred sphere (kernels.h createMovingSphere)."""
        if time1 == time0:
            time1 = time0 + 1.0  # avoid 0/0 in the center lerp
        self._spheres.append(
            (tuple(center0), tuple(center1), float(time0), float(time1), float(radius), material_id)
        )

    def plane(self, position, normal, extend, orientation: int, material_id: int, two_sided: bool = True) -> None:
        """Finite oriented plane (kernels.h createPlane)."""
        self._planes.append(
            (tuple(position), tuple(normal), tuple(extend), int(orientation), bool(two_sided), material_id)
        )

    def cube(self, center, extend, material_id: int) -> None:
        """Cube = 6 one-sided planes at center±extend (kernels.h:139-154)."""
        cx, cy, cz = center
        ex, ey, ez = extend
        e = (ex, ey, ez)
        self.plane((cx - ex, cy, cz), (-1.0, 0.0, 0.0), e, geom.PLANE_YZ, material_id)
        self.plane((cx + ex, cy, cz), (1.0, 0.0, 0.0), e, geom.PLANE_YZ, material_id)
        self.plane((cx, cy + ey, cz), (0.0, 1.0, 0.0), e, geom.PLANE_XZ, material_id)
        self.plane((cx, cy - ey, cz), (0.0, -1.0, 0.0), e, geom.PLANE_XZ, material_id)
        self.plane((cx, cy, cz + ez), (0.0, 0.0, 1.0), e, geom.PLANE_XY, material_id)
        self.plane((cx, cy, cz - ez), (0.0, 0.0, -1.0), e, geom.PLANE_XY, material_id)

    def mesh(self, vertices: np.ndarray, material_id: int) -> int:
        """Triangle mesh from a (T, 3, 3) float array (createMesh analogue).

        Returns the mesh id. Vertices should already carry the loader's
        scale/rotate/offset transform (ModelLoader.cpp:438-445).
        """
        vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3, 3)
        t = vertices.shape[0]
        mesh_id = self._mesh_count
        self._mesh_count += 1
        self._tri_vertices.append(vertices)
        self._tri_material.append(np.full((t,), material_id, np.int32))
        self._tri_mesh_id.append(np.full((t,), mesh_id, np.int32))
        return mesh_id

    # -- packing ---------------------------------------------------------
    def build(self) -> Scene:
        if self._spheres:
            c0, c1, t0, t1, r, m = zip(*self._spheres)
            spheres = Spheres(
                center0=jnp.asarray(c0, DTYPE),
                center1=jnp.asarray(c1, DTYPE),
                time0=jnp.asarray(t0, DTYPE),
                time1=jnp.asarray(t1, DTYPE),
                radius=jnp.asarray(r, DTYPE),
                material_id=jnp.asarray(m, jnp.int32),
            )
        else:
            spheres = geom.empty_spheres()

        if self._planes:
            p, n, e, o, ts, m = zip(*self._planes)
            planes = Planes(
                position=jnp.asarray(p, DTYPE),
                normal=jnp.asarray(n, DTYPE),
                extend=jnp.asarray(e, DTYPE),
                orientation=jnp.asarray(o, jnp.int32),
                two_sided=jnp.asarray(ts, bool),
                material_id=jnp.asarray(m, jnp.int32),
            )
        else:
            planes = geom.empty_planes()

        if self._tri_vertices:
            verts = np.concatenate(self._tri_vertices, axis=0)
            triangles = Triangles(
                vertices=jnp.asarray(verts, DTYPE),
                material_id=jnp.asarray(np.concatenate(self._tri_material), jnp.int32),
                mesh_id=jnp.asarray(np.concatenate(self._tri_mesh_id), jnp.int32),
            )
            bmin = np.stack(
                [v.reshape(-1, 3).min(axis=0) for v in self._tri_vertices]
            )
            bmax = np.stack(
                [v.reshape(-1, 3).max(axis=0) for v in self._tri_vertices]
            )
            mesh_info = MeshInfo(jnp.asarray(bmin, DTYPE), jnp.asarray(bmax, DTYPE))
        else:
            triangles = geom.empty_triangles()
            mesh_info = MeshInfo(jnp.zeros((0, 3), DTYPE), jnp.zeros((0, 3), DTYPE))

        if self._materials:
            max_id = max(self._materials) + 1
            kind = np.zeros((max_id,), np.int32)
            albedo = np.zeros((max_id, 3), np.float32)
            param = np.zeros((max_id,), np.float32)
            emission = np.zeros((max_id, 3), np.float32)
            for mid, (k, a, p, e) in self._materials.items():
                kind[mid], albedo[mid], param[mid], emission[mid] = k, a, p, e
            materials = Materials(
                kind=jnp.asarray(kind),
                albedo=jnp.asarray(albedo, DTYPE),
                param=jnp.asarray(param, DTYPE),
                emission=jnp.asarray(emission, DTYPE),
            )
        else:
            materials = geom.empty_materials()

        return Scene(
            spheres=spheres,
            planes=planes,
            triangles=triangles,
            materials=materials,
            mesh_info=mesh_info,
            bvh=None,
        )
