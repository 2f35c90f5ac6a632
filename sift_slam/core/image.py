"""Image loading and color conversion.

Replaces the reference's browser-side ``ImageUtils_convertImageDataToMatrix2D``
(reference/src/image-utils.js:27-152): RGBA bytes → grayscale floats in
[0, 1] with weights 0.299/0.587/0.114 and a final /255. The reference's
``usePerceptualGrayscale`` flag is a no-op (both branches identical,
image-utils.js:106-111), so there is a single conversion here.
"""

from __future__ import annotations

import numpy as np

GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def rgb_to_gray(rgb: np.ndarray, dtype=np.float64) -> np.ndarray:
    """uint8 RGB(A) ``(..., H, W, C)`` → grayscale ``(..., H, W)`` in [0,1].

    Exact reference expression per pixel:
    ``((r*0.299) + (g*0.587) + (b*0.114)) / 255`` with r,g,b the integer
    byte values (reference/src/image-utils.js:107-114).
    """
    rgb = np.asarray(rgb)
    if rgb.ndim < 3 or rgb.shape[-1] < 3:
        raise ValueError(f"expected (..., H, W, C>=3) array, got {rgb.shape}")
    r = rgb[..., 0].astype(dtype)
    g = rgb[..., 1].astype(dtype)
    b = rgb[..., 2].astype(dtype)
    return ((r * dtype(0.299)) + (g * dtype(0.587)) + (b * dtype(0.114))) / dtype(255.0)


def load_image_gray(path: str, dtype=np.float64) -> np.ndarray:
    """Load an image file to a grayscale [0,1] float array via PIL."""
    from PIL import Image

    with Image.open(path) as img:
        rgb = np.asarray(img.convert("RGB"))
    return rgb_to_gray(rgb, dtype=dtype)


def pad_to_aligned(
    images: np.ndarray, h_multiple: int = 32, w_multiple: int = 64
) -> np.ndarray:
    """Edge-pad ``(..., H, W)`` images bottom/right to aligned dims.

    Real dataset frames (KITTI is 1241×376) are unaligned: the packed
    candidate selection wants every octave plane size divisible by 128
    (ops/extrema.py::select_refine_candidates). Padding H to a
    multiple of 32 and W to a multiple of 64 guarantees
    ``(2H/2^o)·(2W/2^o) % 128 == 0`` for the first four octaves.

    Edge replication is semantically transparent to the pipeline's blur:
    the reference's border rule is clamp-to-edge sampling
    (reference/src/sift.js:116-119), so blurred values over the original
    image area are unchanged. The only behavioral delta is at the old
    bottom/right border rows/cols, which become interior to the extrema
    scan (flat replicated texture there produces near-zero DoG, so the
    contrast gate rejects it). Intrinsics are unaffected (no shift of
    the principal point — padding is bottom/right only).
    """
    h, w = images.shape[-2], images.shape[-1]
    ph = (-h) % h_multiple
    pw = (-w) % w_multiple
    if not ph and not pw:
        return images
    pad = [(0, 0)] * (images.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(images, pad, mode="edge")
