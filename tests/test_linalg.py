import jax.numpy as jnp
import numpy as np

from rtnw.ops import linalg


def test_dot_cross_length():
    a = jnp.asarray([[1.0, 2.0, 3.0], [0.0, 1.0, 0.0]])
    b = jnp.asarray([[4.0, 5.0, 6.0], [1.0, 0.0, 0.0]])
    np.testing.assert_allclose(linalg.dot(a, b), [32.0, 0.0])
    np.testing.assert_allclose(
        linalg.cross(a, b)[0], np.cross([1, 2, 3], [4, 5, 6]), atol=1e-6
    )
    np.testing.assert_allclose(linalg.length(a)[1], 1.0)


def test_normalize_safe():
    v = jnp.asarray([[3.0, 0.0, 4.0], [0.0, 0.0, 0.0]])
    out = linalg.normalize(v)
    np.testing.assert_allclose(out[0], [0.6, 0.0, 0.8], atol=1e-6)
    np.testing.assert_allclose(out[1], [0.0, 0.0, 0.0])


def test_reflect():
    v = jnp.asarray([[1.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(linalg.reflect(v, n)[0], [1.0, 1.0, 0.0], atol=1e-6)


def test_refract_matches_snell():
    # Air -> glass at 45 degrees.
    uv = jnp.asarray([[np.sqrt(0.5), -np.sqrt(0.5), 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    eta = jnp.asarray([1.0 / 1.5], jnp.float32)
    out = np.asarray(linalg.refract(uv, n, eta)[0])
    sin_out = np.hypot(out[0], out[2])
    np.testing.assert_allclose(sin_out, np.sqrt(0.5) / 1.5, atol=1e-6)
    assert out[1] < 0  # continues into the surface


def test_rotate_y():
    v = jnp.asarray([[1.0, 2.0, 0.0]])
    out = linalg.rotate_y(v, 90.0)
    # +X rotates to -Z under the reference's rotateY convention
    # (x' = c*x + s*z, z' = -s*x + c*z).
    np.testing.assert_allclose(out[0], [0.0, 2.0, -1.0], atol=1e-6)


def test_near_zero():
    v = jnp.asarray([[1e-9, 1e-9, 1e-9], [1e-3, 0.0, 0.0]])
    np.testing.assert_array_equal(linalg.near_zero(v), [True, False])
