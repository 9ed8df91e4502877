"""Distribution checks for the closed-form samplers.

The reference uses rejection loops (Utils.h:69-104); here we verify the
closed forms draw from the same distributions (moments + support), which is
the RNG-parity strategy from SURVEY.md §4 — statistical validation, not
stream replication.
"""

import jax
import jax.numpy as jnp
import numpy as np

from rtnw.ops import linalg, sampling

N = 200_000


def test_in_unit_disk():
    pts = np.asarray(sampling.in_unit_disk(jax.random.key(0), (N,)))
    r = np.hypot(pts[:, 0], pts[:, 1])
    assert r.max() <= 1.0
    # E[r] = 2/3 for uniform-in-disk; E[x] = 0.
    np.testing.assert_allclose(r.mean(), 2.0 / 3.0, atol=5e-3)
    np.testing.assert_allclose(pts.mean(axis=0), [0, 0], atol=5e-3)


def test_unit_vector():
    v = np.asarray(sampling.unit_vector(jax.random.key(1), (N,)))
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(v.mean(axis=0), [0, 0, 0], atol=7e-3)
    # Uniform on the sphere: each component's second moment is 1/3.
    np.testing.assert_allclose((v**2).mean(axis=0), [1 / 3] * 3, atol=5e-3)


def test_in_unit_sphere():
    v = np.asarray(sampling.in_unit_sphere(jax.random.key(2), (N,)))
    r = np.linalg.norm(v, axis=1)
    assert r.max() <= 1.0
    # E[r] = 3/4 for uniform-in-ball.
    np.testing.assert_allclose(r.mean(), 0.75, atol=5e-3)


def test_cosine_hemisphere():
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    v = np.asarray(sampling.cosine_hemisphere(jax.random.key(3), n))
    assert (v[:, 2] >= -1e-6).all()
    # E[cos(theta)] = 2/3 for cosine-weighted.
    np.testing.assert_allclose(v[:, 2].mean(), 2.0 / 3.0, atol=5e-3)


def test_hemisphere_respects_normal():
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (1000, 1))
    v = np.asarray(sampling.hemisphere(jax.random.key(4), n))
    assert (np.sum(v * np.asarray(n), axis=1) > 0).all()


def test_orthonormal_basis():
    key = jax.random.key(5)
    n = np.asarray(sampling.unit_vector(key, (1000,)))
    t, b = sampling.orthonormal_basis(jnp.asarray(n))
    t, b = np.asarray(t), np.asarray(b)
    np.testing.assert_allclose(np.sum(t * n, axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.sum(b * n, axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.sum(t * b, axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)


def test_phong_lobe_concentration():
    axis = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    exp = jnp.full((N,), 20.0)
    v = np.asarray(sampling.phong_lobe(jax.random.key(6), axis, exp))
    cos_a = v[:, 2]
    # E[cos] for pdf (n+1) cos^n = (n+1)/(n+2) = 21/22.
    np.testing.assert_allclose(cos_a.mean(), 21.0 / 22.0, atol=3e-3)
