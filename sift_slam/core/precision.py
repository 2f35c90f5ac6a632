"""Full float32 precision for the geometry backend's matrix products."""

from __future__ import annotations

import functools

import jax


def full_precision(fn):
    """Run ``fn`` (and trace it, under ``jax.jit``) with float32 matrix
    products at full precision.

    The backend multiplies small rotation, camera and design matrices
    whose results are compared in pixels (~640 px frames). A GPU may run
    a float32 product that names no precision in TF32, which keeps about
    three decimal digits: an error of the order of a pixel, enough to
    flip RANSAC and PnP inlier tests. At 3×3 to 9×9 sizes TF32 buys no
    speed. A fresh context per call keeps nested and concurrent calls
    from restoring each other's setting.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
