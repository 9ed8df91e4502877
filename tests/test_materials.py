"""BSDF behavior vs the reference scatter semantics (Material.h/.cu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtnw.ops import linalg
from rtnw.ops.geometry import (
    COAT,
    DIELECTRIC,
    EMISSION,
    LAMBERTIAN,
    METAL,
    PHONG_METAL,
    SPECULAR,
    Materials,
)
from rtnw.ops.materials import Scatter, scatter, schlick
from rtnw.ops.rays import Hit, Rays


def setup(kind, albedo=(0.8, 0.6, 0.2), param=0.0, n=1024, direction=(0, 0, -1), normal=(0, 0, 1), front=True):
    rays = Rays(
        origin=jnp.zeros((n, 3), jnp.float32),
        direction=jnp.tile(jnp.asarray([direction], jnp.float32), (n, 1)),
        time=jnp.zeros((n,), jnp.float32),
    )
    hit = Hit(
        t=jnp.ones((n,), jnp.float32),
        normal=jnp.tile(jnp.asarray([normal], jnp.float32), (n, 1)),
        front_face=jnp.full((n,), front),
        material_id=jnp.zeros((n,), jnp.int32),
        valid=jnp.ones((n,), bool),
    )
    mat = Materials(
        kind=jnp.full((n,), kind, jnp.int32),
        albedo=jnp.tile(jnp.asarray([albedo], jnp.float32), (n, 1)),
        param=jnp.full((n,), param, jnp.float32),
        emission=jnp.zeros((n, 3), jnp.float32),
    )
    return rays, hit, mat


def test_lambertian_cosine_distribution():
    rays, hit, mat = setup(LAMBERTIAN, n=100_000)
    s = scatter(jax.random.split(jax.random.key(0), rays.origin.shape[0]), rays, hit, mat)
    d = np.asarray(s.direction)
    assert bool(np.all(np.asarray(s.scattered)))
    np.testing.assert_allclose(np.asarray(s.attenuation)[0], [0.8, 0.6, 0.2], atol=1e-6)
    # normal + unit vector is cosine-distributed: E[cos theta] = 2/3.
    np.testing.assert_allclose(d[:, 2].mean(), 2 / 3, atol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)


def test_metal_fuzz_zero_is_mirror():
    rays, hit, mat = setup(METAL, direction=(1, -1, 0), normal=(0, 1, 0), param=0.0, n=8)
    s = scatter(jax.random.split(jax.random.key(1), rays.origin.shape[0]), rays, hit, mat)
    want = np.asarray([1, 1, 0]) / np.sqrt(2)
    np.testing.assert_allclose(np.asarray(s.direction), np.tile(want, (8, 1)), atol=1e-5)
    assert bool(np.all(np.asarray(s.scattered)))


def test_metal_grazing_absorption():
    # With fuzz=1 and a grazing reflection, many samples go below the
    # surface -> absorbed (Material.h:48-50).
    rays, hit, mat = setup(METAL, direction=(1, -0.01, 0), param=1.0, n=50_000)
    s = scatter(jax.random.split(jax.random.key(2), rays.origin.shape[0]), rays, hit, mat)
    frac_absorbed = 1.0 - np.asarray(s.scattered).mean()
    assert 0.2 < frac_absorbed < 0.8
    # Absorbed rays carry zero attenuation.
    att = np.asarray(s.attenuation)
    dead = ~np.asarray(s.scattered)
    np.testing.assert_allclose(att[dead], 0.0)


def test_dielectric_total_internal_reflection():
    # Inside glass (back face -> eta = ior), grazing: TIR must reflect.
    rays, hit, mat = setup(
        DIELECTRIC, param=1.5, direction=(1, -0.2, 0), normal=(0, 1, 0),
        front=False, n=16
    )
    s = scatter(jax.random.split(jax.random.key(3), rays.origin.shape[0]), rays, hit, mat)
    d = np.asarray(s.direction)
    mirror = np.asarray(
        linalg.reflect(linalg.normalize(rays.direction), hit.normal)
    )
    np.testing.assert_allclose(d, mirror / np.linalg.norm(mirror, axis=1, keepdims=True), atol=1e-5)
    np.testing.assert_allclose(np.asarray(s.attenuation), 1.0)


def test_dielectric_head_on_mostly_refracts():
    rays, hit, mat = setup(DIELECTRIC, param=1.5, direction=(0, 0, -1), n=50_000)
    s = scatter(jax.random.split(jax.random.key(4), rays.origin.shape[0]), rays, hit, mat)
    d = np.asarray(s.direction)
    refracted = d[:, 2] < 0
    # Schlick at cos=1, eta 1/1.5: r0 = 0.04 -> ~4% reflect.
    np.testing.assert_allclose(1 - refracted.mean(), 0.04, atol=0.01)


def test_schlick_values():
    np.testing.assert_allclose(
        schlick(jnp.float32(1.0), jnp.float32(1 / 1.5)), 0.04, atol=1e-3
    )
    np.testing.assert_allclose(
        schlick(jnp.float32(0.0), jnp.float32(1 / 1.5)), 1.0, atol=1e-6
    )


def test_emission_terminates_with_scaled_albedo():
    rays, hit, mat = setup(EMISSION, albedo=(1.0, 0.5, 0.25), param=5.0, n=4)
    s = scatter(jax.random.split(jax.random.key(5), rays.origin.shape[0]), rays, hit, mat)
    assert not bool(np.any(np.asarray(s.scattered)))
    np.testing.assert_allclose(
        np.asarray(s.emitted), np.tile([5.0, 2.5, 1.25], (4, 1)), atol=1e-5
    )


def test_specular_is_perfect_mirror():
    rays, hit, mat = setup(SPECULAR, direction=(1, -1, 0), normal=(0, 1, 0), n=4)
    s = scatter(jax.random.split(jax.random.key(6), rays.origin.shape[0]), rays, hit, mat)
    want = np.asarray([1, 1, 0]) / np.sqrt(2)
    np.testing.assert_allclose(np.asarray(s.direction), np.tile(want, (4, 1)), atol=1e-5)


def test_phong_metal_concentrates_around_mirror():
    rays, hit, mat = setup(PHONG_METAL, direction=(0, -1, 0), normal=(0, 1, 0), param=20.0, n=50_000)
    s = scatter(jax.random.split(jax.random.key(7), rays.origin.shape[0]), rays, hit, mat)
    d = np.asarray(s.direction)
    # Mirror is +y; mean cos with mirror = 21/22 (pdf (n+1)cos^n).
    np.testing.assert_allclose(d[:, 1].mean(), 21 / 22, atol=5e-3)


def test_coat_mixes_specular_and_diffuse():
    rays, hit, mat = setup(COAT, albedo=(0.9, 0.3, 0.0), direction=(1, -1, 0), n=100_000)
    s = scatter(jax.random.split(jax.random.key(8), rays.origin.shape[0]), rays, hit, mat)
    att = np.asarray(s.attenuation)
    spec = np.all(att == 1.0, axis=1)
    # 5% specular probability (CUDAPathTracer.cu:526).
    np.testing.assert_allclose(spec.mean(), 0.05, atol=0.005)
    np.testing.assert_allclose(att[~spec][0], [0.9, 0.3, 0.0], atol=1e-6)


def test_albedo_gradient_flows():
    def mean_attenuation(albedo_r):
        rays, hit, mat = setup(LAMBERTIAN, n=8)
        mat = mat._replace(albedo=mat.albedo.at[:, 0].set(albedo_r))
        s = scatter(jax.random.split(jax.random.key(9), rays.origin.shape[0]), rays, hit, mat)
        return jnp.mean(s.attenuation[:, 0])

    g = jax.grad(mean_attenuation)(jnp.float32(0.5))
    np.testing.assert_allclose(g, 1.0, atol=1e-5)


@pytest.mark.parametrize("rows", [3, 65, 600])
def test_material_gather_matches_rows(rows):
    """Materials.gather is an exact row gather at every table size (no
    reduced-precision matmul), with id < 0 mapped to row 0."""
    from rtnw.ops.geometry import Materials

    rng = np.random.default_rng(rows)
    table = Materials(
        kind=jnp.asarray(rng.integers(0, 8, rows), jnp.int32),
        albedo=jnp.asarray(rng.random((rows, 3)), jnp.float32),
        param=jnp.asarray(rng.random(rows), jnp.float32),
        emission=jnp.asarray(rng.random((rows, 3)), jnp.float32),
    )
    ids = rng.integers(-1, rows, 4096)
    got = table.gather(jnp.asarray(ids, jnp.int32))
    rows_ = np.maximum(ids, 0)
    for field in ("kind", "albedo", "param", "emission"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)),
            np.asarray(getattr(table, field))[rows_])


def test_material_gather_gradient_is_scatter_add():
    """The gather's transpose accumulates each row's cotangents — the
    albedo gradient inverse rendering needs."""
    from rtnw.ops.geometry import Materials

    ids = jnp.asarray([0, 2, 2, 1, 2, -1], jnp.int32)

    def loss(albedo):
        m = Materials(kind=jnp.zeros((3,), jnp.int32), albedo=albedo,
                      param=jnp.zeros((3,)), emission=jnp.zeros((3, 3)))
        return jnp.sum(m.gather(ids).albedo * jnp.arange(1.0, 4.0))

    g = np.asarray(jax.grad(loss)(jnp.ones((3, 3))))
    np.testing.assert_array_equal(g, [[2.0, 4.0, 6.0], [1.0, 2.0, 3.0],
                                      [3.0, 6.0, 9.0]])
