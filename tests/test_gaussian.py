"""Gaussian kernel and blur operator tests (parity + fast paths)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_slam.ops import gaussian
from sift_slam.utils import oracle


SIGMAS = [0.7, 0.9375, 1.2263, 2.0, 3.2, 7.5]


def test_js_round_half_away_from_zero():
    # JS Math.round = floor(x+0.5): 2.5 -> 3, 3.5 -> 4, -0.5 -> 0, -1.5 -> -1
    assert gaussian.js_round(2.5) == 3
    assert gaussian.js_round(3.5) == 4
    assert gaussian.js_round(2.4) == 2
    assert gaussian.js_round(-0.5) == 0
    assert gaussian.js_round(-1.5) == -1


@pytest.mark.parametrize("sigma", SIGMAS)
def test_kernel_matches_oracle_bitwise(sigma):
    ours = gaussian.gaussian_kernel_2d(sigma)
    ref = oracle.gaussian_kernel(sigma)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_kernel_properties(sigma):
    k = gaussian.gaussian_kernel_2d(sigma)
    assert k.shape[0] == 2 * gaussian.js_round(3 * sigma) + 1
    assert abs(k.sum() - 1.0) < 1e-12
    np.testing.assert_allclose(k, k.T, rtol=0, atol=0)  # symmetric
    # Outer product identity with the separable 1-D factor.
    k1 = gaussian.gaussian_kernel_1d(sigma)
    np.testing.assert_allclose(np.outer(k1, k1), k, rtol=1e-13, atol=1e-300)


@pytest.mark.parametrize("sigma", [0.7, 1.2263, 3.2])
def test_blur_exact_matches_oracle_bitwise(test_image, sigma):
    ref = oracle.blur(test_image, sigma)
    ours = np.asarray(gaussian.blur_exact(jnp.asarray(test_image), sigma))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("sigma", [0.7, 1.2263, 3.2])
def test_blur_separable_matches_exact(test_image, sigma):
    x = jnp.asarray(test_image)
    exact = np.asarray(gaussian.blur_exact(x, sigma))
    sep = np.asarray(gaussian.blur_separable(x, sigma))
    np.testing.assert_allclose(sep, exact, rtol=0, atol=1e-12)


@pytest.mark.parametrize("sigma", [0.7, 1.2263, 3.2])
def test_blur_matmul_matches_exact(test_image, sigma):
    x = jnp.asarray(test_image)
    exact = np.asarray(gaussian.blur_exact(x, sigma))
    mm = np.asarray(gaussian.blur_matmul(x, sigma))
    np.testing.assert_allclose(mm, exact, rtol=0, atol=1e-12)


def test_blur_batch_dims(test_image):
    x = jnp.stack([jnp.asarray(test_image)] * 3)
    for fn in (gaussian.blur_exact, gaussian.blur_separable, gaussian.blur_matmul):
        out = fn(x, 1.5)
        assert out.shape == x.shape
        np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(out[2]))


def test_blur_sigma_larger_than_image(test_image):
    """Octave-4 regime: kernel radius exceeds image size; clamp borders."""
    small = jnp.asarray(test_image[:6, :8])
    sigma = 12.8 * np.sqrt(2 ** (10 / 3) - 1)  # octave 4, scale 5 regime
    ref = oracle.blur(np.asarray(small), sigma)
    ours = np.asarray(gaussian.blur_exact(small, sigma))
    np.testing.assert_array_equal(ours, ref)
    sep = np.asarray(gaussian.blur_separable(small, sigma))
    np.testing.assert_allclose(sep, ref, rtol=0, atol=1e-12)
