"""Nearest-neighbor resize parity with Matrix2D_linearResize."""

import numpy as np
import jax.numpy as jnp

from sift_slam.ops import resize
from sift_slam.utils import oracle


def test_upsample2x_matches_oracle(test_image):
    ref = oracle.linear_resize(test_image, 0.5)
    ours = np.asarray(resize.upsample2x_nn(jnp.asarray(test_image)))
    np.testing.assert_array_equal(ours, ref)


def test_downsample2x_matches_oracle(test_image):
    ref = oracle.linear_resize(test_image, 2.0)
    ours = np.asarray(resize.downsample2x_nn(jnp.asarray(test_image)))
    np.testing.assert_array_equal(ours, ref)


def test_downsample_odd_dims():
    x = np.arange(7 * 9, dtype=np.float64).reshape(7, 9)
    ref = oracle.linear_resize(x, 2.0)
    ours = np.asarray(resize.downsample2x_nn(jnp.asarray(x)))
    assert ours.shape == (4, 5)  # ceil semantics
    np.testing.assert_array_equal(ours, ref)


def test_roundtrip_shapes(test_image):
    up = resize.upsample2x_nn(jnp.asarray(test_image))
    assert up.shape == (96, 128)
    down = resize.downsample2x_nn(up)
    assert down.shape == (48, 64)
