"""Primitive SoA pytrees: spheres, planes, triangles, materials.

Replaces the reference's heap-of-device-objects scene representation
(`Hitable*` tables built by <<<1,1>>> device-new factory kernels,
kernels.h:99-154) with packed struct-of-arrays pytrees. No virtual dispatch:
each primitive type is an array batch intersected by one vectorized kernel,
and materials are rows of a table indexed by `material_id`.

All leaf arrays are differentiable scene parameters — that is the point of
making the scene a pytree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rtnw.config import DTYPE

# Material kinds — the union of Path A's MaterialType (Material.h:8-13) and
# Path B's ReflectionType (Types.h:5). Lambertian/metal/dielectric/emissive
# come from Path A; phong-metal / specular / coat come from Path B's switch
# (CUDAPathTracer.cu:455-614). `specular` is metal with fuzz 0, kept as its
# own kind for scene-format parity.
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSION = 3
PHONG_METAL = 4   # Path B METAL: Phong lobe, exponent in `param`
SPECULAR = 5      # Path B SPECULAR: perfect mirror
COAT = 6          # Path B COAT: 5% specular else diffuse
REFRACTION = 7    # Path B REFRACTION: smallpt-style glass with RP/TP weights
NUM_MATERIAL_KINDS = 8


class Materials(NamedTuple):
    """Material table (M rows). Per-kind meaning of `param`:

    METAL: fuzz (Material.h:40-41, clamped to <=1 at build);
    DIELECTRIC / REFRACTION: index of refraction (Material.h:60);
    EMISSION: intensity (Material.h:114);
    PHONG_METAL: Phong exponent (CUDAPathTracer.cu:488 uses 20).

    `emission` is Path B's *additive* per-hit radiance (`accucolor +=
    mask*emit` then keep bouncing, CUDAPathTracer.cu:430,449) — orthogonal
    to the terminating EMISSION kind (Path A, Material.h:120-123).
    """

    kind: jnp.ndarray      # (M,) int32
    albedo: jnp.ndarray    # (M, 3)
    param: jnp.ndarray     # (M,)
    emission: jnp.ndarray  # (M, 3) additive emission (Path B style)

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def gather(self, material_id: jnp.ndarray) -> "Materials":
        """Per-ray material rows; id<0 maps to row 0 (value unused there).

        A plain row gather: its transpose is the scatter-add that
        albedo/param gradients need.
        """
        idx = jnp.maximum(material_id, 0)
        return Materials(
            kind=self.kind[idx],
            albedo=self.albedo[idx],
            param=self.param[idx],
            emission=self.emission[idx],
        )


class Spheres(NamedTuple):
    """S spheres, static and moving unified.

    A static sphere stores center0 == center1 (any time0/time1), so the
    time-lerped center (Sphere.cu:75-78) degenerates to the constant center.
    Negative radii are legal and flip normals inward — the hollow-glass trick
    (main.cu:619 radius -0.4).
    """

    center0: jnp.ndarray      # (S, 3)
    center1: jnp.ndarray      # (S, 3)
    time0: jnp.ndarray        # (S,)
    time1: jnp.ndarray        # (S,)  — time1 != time0 always (build enforces)
    radius: jnp.ndarray       # (S,)
    material_id: jnp.ndarray  # (S,) int32

    @property
    def count(self) -> int:
        return self.radius.shape[0]

    def center_at(self, time: jnp.ndarray) -> jnp.ndarray:
        """Centers at ray times: (R,) -> (R, S, 3) (Sphere.cu:75-78)."""
        w = (time[:, None] - self.time0[None, :]) / (
            self.time1[None, :] - self.time0[None, :]
        )
        return self.center0[None, :, :] + w[..., None] * (
            self.center1 - self.center0
        )[None, :, :]


# PlaneOrientation (Plane.h enum): which two axes the finite extent spans.
PLANE_XY = 0
PLANE_YZ = 1
PLANE_XZ = 2


class Planes(NamedTuple):
    """P finite axis-oriented planes (Plane.h:5-31).

    `orientation` picks the in-rectangle test axes (Plane.cu:24-46);
    `two_sided` switches the denominator test between |d.n|>eps and d.n>eps
    (Plane.cu:10).
    """

    position: jnp.ndarray     # (P, 3)
    normal: jnp.ndarray       # (P, 3) unit
    extend: jnp.ndarray       # (P, 3) half-extents
    orientation: jnp.ndarray  # (P,) int32 in {XY, YZ, XZ}
    two_sided: jnp.ndarray    # (P,) bool
    material_id: jnp.ndarray  # (P,) int32

    @property
    def count(self) -> int:
        return self.position.shape[0]


class Triangles(NamedTuple):
    """T triangles as a (T, 3, 3) vertex tensor.

    The reference packs precomputed v0/E1/E2 float4s into texture memory
    (main.cu:334-343); here edges are recomputed from vertices inside the
    intersect kernel so the vertex tensor stays the single differentiable
    parameter. XLA fuses the two subtractions into the intersection.
    """

    vertices: jnp.ndarray     # (T, 3, 3) — [tri, corner, xyz]
    material_id: jnp.ndarray  # (T,) int32
    # Per-mesh AABB early-out data (TriangleMesh.cu:35-37): mesh slice ids
    # let many meshes share one triangle array.
    mesh_id: jnp.ndarray      # (T,) int32

    @property
    def count(self) -> int:
        return self.vertices.shape[0]


def empty_spheres() -> Spheres:
    z3 = jnp.zeros((0, 3), DTYPE)
    z = jnp.zeros((0,), DTYPE)
    return Spheres(z3, z3, z, jnp.ones((0,), DTYPE), z, jnp.zeros((0,), jnp.int32))


def empty_planes() -> Planes:
    z3 = jnp.zeros((0, 3), DTYPE)
    zi = jnp.zeros((0,), jnp.int32)
    return Planes(z3, z3, z3, zi, jnp.zeros((0,), bool), zi)


def empty_triangles() -> Triangles:
    return Triangles(
        jnp.zeros((0, 3, 3), DTYPE),
        jnp.zeros((0,), jnp.int32),
        jnp.zeros((0,), jnp.int32),
    )


def empty_materials() -> Materials:
    return Materials(
        kind=jnp.zeros((1,), jnp.int32),
        albedo=jnp.zeros((1, 3), DTYPE),
        param=jnp.zeros((1,), DTYPE),
        emission=jnp.zeros((1, 3), DTYPE),
    )
