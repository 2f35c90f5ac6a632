"""Gaussian kernel construction and blur operators.

The reference (reference/src/sift.js:31-149) builds a dense, sum-normalized
2-D Gaussian kernel of size ``2*round(3σ)+1`` and convolves with
clamp-to-edge sampling. A 2-D Gaussian is the outer product of two 1-D
Gaussians, and clamp-to-edge is per-axis, so the convolution is exactly
separable in real arithmetic; this module provides

- :func:`gaussian_kernel_2d` / :func:`gaussian_kernel_1d` — host-side
  (numpy) kernel builders with the reference's exact construction and
  normalization order (src/sift.js:22-67).
- :func:`blur_exact` — bit-parity path: replays the reference's per-pixel
  accumulation order (kernel row ``i`` maps to the **x** offset, column
  ``j`` to the **y** offset; ``i`` outer, ``j`` inner — src/sift.js:105-131)
  as a ``fori_loop`` over taps. Use float64 on CPU for parity testing.
- :func:`blur_separable` — fast path: edge-pad + two 1-D convolutions via
  ``lax.conv_general_dilated`` (VPU/fusion friendly).
- :func:`blur_matmul` — blur expressed as two banded matmuls
  ``B_v @ X @ B_hᵀ`` with the clamp-to-edge weights folded into the band
  matrices, so the whole blur is matrix products.

All operators take images shaped ``(..., H, W)`` and are jit/vmap friendly.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def js_round(x: float) -> int:
    """JavaScript ``Math.round``: floor(x + 0.5) — half away from zero for
    positive inputs (ties go toward +inf). Used for kernel sizing
    (reference/src/sift.js:38,44)."""
    return int(math.floor(x + 0.5))


def kernel_radius(sigma: float, radius_sigmas: float = 3.0) -> int:
    """Kernel half-width ``round(3σ)`` (reference/src/sift.js:38)."""
    return js_round(radius_sigmas * sigma)


@functools.lru_cache(maxsize=None)
def gaussian_kernel_2d(sigma: float, radius_sigmas: float = 3.0) -> np.ndarray:
    """Dense 2-D Gaussian kernel, float64, exact reference construction.

    Replays reference/src/sift.js:31-67: sample
    ``exp(((i²+j²)/σ²)·-0.5) / (2π·σ²)`` on the grid, accumulate the sum in
    row-major order, then divide elementwise. The sequential accumulation
    order matters for bit-parity of the normalizer.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    size = 2 * radius + 1
    kernel = np.empty((size, size), dtype=np.float64)
    total = 0.0
    for i in range(size):
        ii = i - radius
        for j in range(size):
            jj = j - radius
            value = math.exp(
                (((ii * ii) + (jj * jj)) / (sigma * sigma)) * -0.5
            ) / (2.0 * math.pi * (sigma * sigma))
            kernel[i, j] = value
            total += value
    return kernel / total


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma: float, radius_sigmas: float = 3.0) -> np.ndarray:
    """Separable 1-D factor ``g / Σg`` of the reference kernel.

    The reference's normalized 2-D kernel equals the outer product of this
    1-D kernel with itself up to float rounding, because the 2-D normalizer
    factors: ``Σ_{ij} g(i)g(j) = (Σg)²``.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    size = 2 * radius + 1
    g = np.empty((size,), dtype=np.float64)
    for i in range(size):
        ii = i - radius
        g[i] = math.exp(((ii * ii) / (sigma * sigma)) * -0.5)
    return g / g.sum()


# ---------------------------------------------------------------------------
# Exact (bit-parity) blur
# ---------------------------------------------------------------------------


def blur_exact(image: jax.Array, sigma: float, radius_sigmas: float = 3.0) -> jax.Array:
    """Full 2-D Gaussian blur in the reference's accumulation order.

    Per output pixel the reference does
    ``pixel_sum += input[clamp(y + (j-R))][clamp(x + (i-R))] * k[i][j]``
    with ``i`` (x offset) outer and ``j`` (y offset) inner
    (reference/src/sift.js:96-131). We replicate that order with a
    ``fori_loop`` over flattened taps ``t = i*K + j`` on an edge-padded
    image, so each pixel's float accumulation sequence is identical.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    size = 2 * radius + 1
    kernel = jnp.asarray(gaussian_kernel_2d(sigma, radius_sigmas), image.dtype)
    kflat = kernel.reshape(-1)

    batch_shape = image.shape[:-2]
    h, w = image.shape[-2], image.shape[-1]
    flat = image.reshape((-1, h, w))
    pad = [(0, 0), (radius, radius), (radius, radius)]
    padded = jnp.pad(flat, pad, mode="edge")

    # The product is software-pipelined through the loop carry so the
    # multiply never feeds the add directly: XLA:CPU's LLVM backend
    # otherwise contracts `acc + tap*k` into an FMA (single rounding),
    # breaking bit parity with the reference's two-rounding accumulation.
    def body(t, carry):
        acc, pending = carry
        acc = acc + pending
        i = t // size  # x offset index
        j = t % size  # y offset index
        tap = lax.dynamic_slice(padded, (0, j, i), flat.shape)
        return (acc, tap * kflat[t])

    zeros = jnp.zeros_like(flat)
    acc, pending = lax.fori_loop(0, size * size, body, (zeros, zeros))
    return (acc + pending).reshape(batch_shape + (h, w))


# ---------------------------------------------------------------------------
# Fast separable blur (XLA convolution)
# ---------------------------------------------------------------------------


def blur_separable(
    image: jax.Array, sigma: float, radius_sigmas: float = 3.0
) -> jax.Array:
    """Separable Gaussian blur: edge-pad + row conv + column conv.

    Mathematically identical to :func:`blur_exact` (the 2-D kernel is an
    outer product and clamp-to-edge factors per axis); differs only in
    float rounding. Intended dtype: float32.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    k1 = jnp.asarray(gaussian_kernel_1d(sigma, radius_sigmas), image.dtype)
    size = k1.shape[0]

    batch_shape = image.shape[:-2]
    h, w = image.shape[-2], image.shape[-1]
    flat = image.reshape((-1, 1, h, w))
    padded = jnp.pad(
        flat, [(0, 0), (0, 0), (radius, radius), (radius, radius)], mode="edge"
    )

    dn = lax.conv_dimension_numbers(padded.shape, (1, 1, 1, size), ("NCHW", "OIHW", "NCHW"))
    row_k = k1.reshape(1, 1, 1, size)
    col_k = k1.reshape(1, 1, size, 1)
    out = lax.conv_general_dilated(
        padded, row_k, (1, 1), "VALID", dimension_numbers=dn,
        precision=lax.Precision.HIGHEST,
    )
    out = lax.conv_general_dilated(
        out, col_k, (1, 1), "VALID", dimension_numbers=dn,
        precision=lax.Precision.HIGHEST,
    )
    return out.reshape(batch_shape + (h, w))


# ---------------------------------------------------------------------------
# Matmul blur: banded matmul with clamp-to-edge folded into the band matrix
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _blur_band_matrix(n: int, sigma: float, radius_sigmas: float) -> np.ndarray:
    """(n, n) matrix M with ``(M @ v)[y] = Σ_t k1[t+R] · v[clamp(y+t)]``.

    Clamp-to-edge is folded in by accumulating out-of-range tap weights
    into the edge columns, which is exactly the reference's border rule
    (reference/src/sift.js:116-119) applied along one axis.
    """
    radius = kernel_radius(sigma, radius_sigmas)
    k1 = gaussian_kernel_1d(sigma, radius_sigmas)
    m = np.zeros((n, n), dtype=np.float64)
    for y in range(n):
        for t in range(-radius, radius + 1):
            col = min(max(y + t, 0), n - 1)
            m[y, col] += k1[t + radius]
    return m


def blur_matmul(image: jax.Array, sigma: float, radius_sigmas: float = 3.0) -> jax.Array:
    """Gaussian blur as two matmuls: ``B_v @ X @ B_hᵀ``.

    The dense banded matmul trades wasted zero-flops for matrix-unit
    throughput; on small octave images (where σ and therefore the band is
    large) the band is dense anyway.
    """
    h, w = image.shape[-2], image.shape[-1]
    bv = jnp.asarray(_blur_band_matrix(h, sigma, radius_sigmas), image.dtype)
    bh = jnp.asarray(_blur_band_matrix(w, sigma, radius_sigmas), image.dtype)
    # precision=HIGHEST is load-bearing: a reduced-precision product
    # (bf16, or TF32 on a GPU) puts the blur error at a sizeable share
    # of the contrast threshold; bf16 was measured to create ~60%
    # spurious extrema (27% keypoint agreement with the CPU float32
    # pipeline).
    out = jnp.einsum(
        "ij,...jk->...ik", bv, image, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "...ij,kj->...ik", out, bh, precision=jax.lax.Precision.HIGHEST
    )
