"""Analytic intersection cases for spheres, planes, cubes, triangles."""

import jax.numpy as jnp
import numpy as np

from rtnw.models.scene import SceneBuilder
from rtnw.ops import intersect
from rtnw.ops.geometry import (
    PLANE_XY,
    PLANE_XZ,
    Triangles,
)
from rtnw.ops.rays import Rays

INF = float("inf")


def make_rays(origins, directions, times=None):
    origins = jnp.asarray(origins, jnp.float32).reshape(-1, 3)
    directions = jnp.asarray(directions, jnp.float32).reshape(-1, 3)
    if times is None:
        times = jnp.zeros((origins.shape[0],), jnp.float32)
    else:
        times = jnp.asarray(times, jnp.float32)
    return Rays(origins, directions, times)


def unit_sphere_scene(radius=1.0, center=(0.0, 0.0, 0.0)):
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.sphere(center, radius, 0)
    return b.build()


def test_sphere_head_on():
    scene = unit_sphere_scene()
    rays = make_rays([0, 0, 5], [0, 0, -1])
    hit = intersect.intersect_spheres(rays, scene.spheres, 1e-3, INF)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 4.0, atol=1e-5)
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-5)
    assert bool(hit.front_face[0])
    assert int(hit.material_id[0]) == 0


def test_sphere_from_inside_picks_far_root():
    scene = unit_sphere_scene()
    rays = make_rays([0, 0, 0], [0, 0, -1])
    hit = intersect.intersect_spheres(rays, scene.spheres, 1e-3, INF)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 1.0, atol=1e-5)
    # Inside: outward normal points away from ray -> flipped, back face.
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-5)
    assert not bool(hit.front_face[0])


def test_sphere_miss():
    scene = unit_sphere_scene()
    rays = make_rays([0, 5, 5], [0, 0, -1])
    hit = intersect.intersect_spheres(rays, scene.spheres, 1e-3, INF)
    assert not bool(hit.valid[0])
    assert np.isinf(hit.t[0])
    assert int(hit.material_id[0]) == -1


def test_negative_radius_flips_normal():
    # Hollow-glass trick (main.cu:619): radius -0.4 flips the outward normal.
    scene = unit_sphere_scene(radius=-1.0)
    rays = make_rays([0, 0, 5], [0, 0, -1])
    hit = intersect.intersect_spheres(rays, scene.spheres, 1e-3, INF)
    assert bool(hit.valid[0])
    # Outward = (p-c)/r with r<0 -> points inward (-z at the near pole);
    # dot(dir, outward) > eps -> back face; stored normal opposes outward.
    assert not bool(hit.front_face[0])
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-5)


def test_moving_sphere_center_lerp():
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.moving_sphere((0, 0, -1), (0, 1, -1), 0.0, 1.0, 0.5, 0)
    scene = b.build()
    # At time=1 the center is (0,1,-1); a ray aimed at y=1 should hit.
    rays = make_rays(
        [[0, 1, 5], [0, 1, 5]], [[0, 0, -1], [0, 0, -1]], times=[0.0, 1.0]
    )
    hit = intersect.intersect_spheres(rays, scene.spheres, 1e-3, INF)
    assert not bool(hit.valid[0])  # at t=0 sphere is at y=0
    assert bool(hit.valid[1])
    np.testing.assert_allclose(hit.t[1], 5.5, atol=1e-5)


def test_sphere_closest_of_two():
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.lambertian(1, (0.1, 0.1, 0.1))
    b.sphere((0, 0, -5), 1.0, 0)
    b.sphere((0, 0, -10), 1.0, 1)
    scene = b.build()
    rays = make_rays([0, 0, 0], [0, 0, -1])
    hit = intersect.intersect_spheres(rays, scene.spheres, 1e-3, INF)
    np.testing.assert_allclose(hit.t[0], 4.0, atol=1e-5)
    assert int(hit.material_id[0]) == 0


def test_plane_xz_two_sided():
    b = SceneBuilder()
    b.lambertian(0, (1, 1, 1))
    b.plane((0, -1, 0), (0, 1, 0), (2, 0, 2), PLANE_XZ, 0, two_sided=True)
    scene = b.build()
    # From above, looking down: denominator dot(n,d) = -1; two-sided accepts.
    hit = intersect.intersect_planes(
        make_rays([0, 1, 0], [0, -1, 0]), scene.planes, 1e-3, INF
    )
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, atol=1e-5)
    np.testing.assert_allclose(hit.normal[0], [0, 1, 0], atol=1e-5)
    # Outside the finite extent -> miss.
    hit2 = intersect.intersect_planes(
        make_rays([3, 1, 0], [0, -1, 0]), scene.planes, 1e-3, INF
    )
    assert not bool(hit2.valid[0])


def test_plane_one_sided_rejects_opposite():
    b = SceneBuilder()
    b.lambertian(0, (1, 1, 1))
    b.plane((0, 1, 0), (0, 1, 0), (2, 0, 2), PLANE_XZ, 0, two_sided=False)
    scene = b.build()
    # One-sided needs denominator dot(n, d) > eps: ray going UP (+y) passes.
    up = intersect.intersect_planes(
        make_rays([0, -1, 0], [0, 1, 0]), scene.planes, 1e-3, INF
    )
    assert bool(up.valid[0])
    down = intersect.intersect_planes(
        make_rays([0, 3, 0], [0, -1, 0]), scene.planes, 1e-3, INF
    )
    assert not bool(down.valid[0])


def test_plane_xy_orientation_uses_xy_extent():
    b = SceneBuilder()
    b.lambertian(0, (1, 1, 1))
    b.plane((0, 0, -2), (0, 0, -1), (1, 1, 1), PLANE_XY, 0, two_sided=True)
    scene = b.build()
    inside = intersect.intersect_planes(
        make_rays([0.5, 0.5, 0], [0, 0, -1]), scene.planes, 1e-3, INF
    )
    assert bool(inside.valid[0])
    outside = intersect.intersect_planes(
        make_rays([1.5, 0.0, 0], [0, 0, -1]), scene.planes, 1e-3, INF
    )
    assert not bool(outside.valid[0])


def test_cube_is_six_planes():
    b = SceneBuilder()
    b.lambertian(0, (1, 1, 1))
    b.cube((0, 0, 0), (1, 1, 1), 0)
    scene = b.build()
    assert scene.planes.count == 6
    hit = intersect.intersect_planes(
        make_rays([0, 0, 5], [0, 0, -1]), scene.planes, 1e-3, INF
    )
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 4.0, atol=1e-5)
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-5)


def test_triangle_hit_and_barycentric_bounds():
    verts = jnp.asarray(
        [[[0, 0, -2], [2, 0, -2], [0, 2, -2]]], jnp.float32
    )
    tris = Triangles(
        vertices=verts,
        material_id=jnp.zeros((1,), jnp.int32),
        mesh_id=jnp.zeros((1,), jnp.int32),
    )
    hit = intersect.intersect_triangles(
        make_rays([0.5, 0.5, 0], [0, 0, -1]), tris, 1e-3, INF
    )
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, atol=1e-5)
    miss = intersect.intersect_triangles(
        make_rays([1.5, 1.5, 0], [0, 0, -1]), tris, 1e-3, INF
    )
    assert not bool(miss.valid[0])


def test_triangle_backface_cull():
    verts = jnp.asarray([[[0, 0, -2], [2, 0, -2], [0, 2, -2]]], jnp.float32)
    tris = Triangles(
        vertices=verts,
        material_id=jnp.zeros((1,), jnp.int32),
        mesh_id=jnp.zeros((1,), jnp.int32),
    )
    # From behind (z=-4 looking +z): reference culls via det sign
    # (TriangleMesh.cu:57-66 culls dot(d, E1xE2) <= 0).
    rays = make_rays([0.5, 0.5, -4], [0, 0, 1])
    culled = intersect.intersect_triangles(rays, tris, 1e-3, INF, backface_cull=True)
    twosided = intersect.intersect_triangles(rays, tris, 1e-3, INF, backface_cull=False)
    # Winding (v0,v1,v2)=((0,0),(2,0),(0,2)) has normal +z; a +z ray sees the
    # backface.
    assert not bool(culled.valid[0])
    assert bool(twosided.valid[0])


def test_sphere_gradient_wrt_center():
    import jax

    scene = unit_sphere_scene()
    rays = make_rays([0, 0, 5], [0, 0, -1])

    def t_of_cz(cz):
        spheres = scene.spheres._replace(
            center0=scene.spheres.center0.at[0, 2].set(cz),
            center1=scene.spheres.center1.at[0, 2].set(cz),
        )
        return intersect.intersect_spheres(rays, spheres, 1e-3, INF).t[0]

    g = jax.grad(t_of_cz)(jnp.float32(0.0))
    # Moving the sphere toward the camera (+z) reduces t by the same amount.
    np.testing.assert_allclose(g, -1.0, atol=1e-4)

    fd = (t_of_cz(jnp.float32(1e-2)) - t_of_cz(jnp.float32(-1e-2))) / 2e-2
    np.testing.assert_allclose(g, fd, atol=1e-3)
