"""End-to-end SIFT frontend: scale space → DoG → extrema → refinement.

Accelerator redesign of the reference pipeline orchestrator
(reference/background.js). Differences from the reference architecture
(SURVEY.md §7):

- The whole pipeline is one pure jitted function over dense arrays; the
  pyramid stays resident on device between stages instead of bouncing
  through a postMessage protocol (SURVEY.md §3.2 round-trip anti-pattern).
- Per-octave geometry is static, so octaves unroll at trace time; XLA
  compiles one program for a given input shape.
- Keypoints live in fixed-capacity masked buffers (core/types.py).

Blur strategies:
- ``"exact"``   — reference accumulation order; float64 CPU bit-parity.
- ``"separable"`` — edge-pad + two 1-D convolutions (default fast path).
- ``"matmul"``  — two banded matrix products.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from ..core.types import Extrema, Keypoints, concat_keypoints
from ..ops.descriptor import (
    DescribedKeypoints,
    concat_described,
    describe_compact,
    describe_octave,
)
from ..ops.dog import difference_of_gaussians
from ..ops.extrema import compact_extrema, find_extrema
from ..ops.gaussian import blur_exact, blur_matmul, blur_separable
from ..ops.refine import refine_keypoints, refine_keypoints_multi
from ..ops.resize import downsample2x_nn, upsample2x_nn

BLUR_STRATEGIES: dict[str, Callable] = {
    "exact": blur_exact,
    "separable": blur_separable,
    "matmul": blur_matmul,
}


def _as_unit_float(images: jax.Array) -> jax.Array:
    """Accept integer images, converting on DEVICE to unit-range float.

    uint8 uses the reference's exact ``/255`` rule
    (reference/src/image-utils.js:114) — lossless for real camera data,
    whose source is uint8. uint16 (``/65535``) is the transport for
    float-native sources that exceed 8-bit depth: the SLAM bench's
    synthetic texture measured ATE 1.55 vs 0.30 under uint8
    quantization, while uint16 still halves upload bytes vs f32. The
    conversion fuses into the jitted pipeline. Float inputs pass
    through untouched.
    """
    if images.dtype == jnp.uint8:
        return images.astype(jnp.float32) / 255.0
    if images.dtype == jnp.uint16:
        return images.astype(jnp.float32) / 65535.0
    return images


def build_scale_space(
    image: jax.Array, cfg: SiftConfig, blur: str = "separable"
) -> list[jax.Array]:
    """Gaussian scale space (reference/background.js:71-237).

    ``image``: ``(..., H, W)`` grayscale in [0,1]. Returns one stacked
    array per octave, shape ``(..., spo+3, H_o, W_o)``.

    Octave 0 blurs every scale from the 2×-upsampled base image with the
    semigroup offset sigma; octaves ≥1 seed from the previous octave's
    scale ``spo`` image decimated 2×, pushed unblurred as scale 0
    (background.js:110-143).
    """
    blur_fn = BLUR_STRATEGIES[blur]
    octaves: list[jax.Array] = []
    base = upsample2x_nn(image)
    for octave in range(cfg.num_octaves):
        scales = []
        if octave == 0:
            for s in range(cfg.scales_per_octave_total):
                scales.append(blur_fn(base, cfg.offset_sigma(octave, s)))
        else:
            base = downsample2x_nn(
                octaves[octave - 1][..., cfg.scales_per_octave, :, :]
            )
            scales.append(base)
            for s in range(1, cfg.scales_per_octave_total):
                scales.append(blur_fn(base, cfg.offset_sigma(octave, s)))
        octaves.append(jnp.stack(scales, axis=-3))
    return octaves


def build_dog(scale_space: list[jax.Array]) -> list[jax.Array]:
    """Per-octave DoG stacks ``(..., spo+2, H_o, W_o)``."""
    return [difference_of_gaussians(octave) for octave in scale_space]


def _candidates(
    dog: list[jax.Array], cfg: SiftConfig
) -> tuple[list[Extrema], list[Extrema]]:
    """Per-octave extrema (per-trio slots) and their compaction to the
    refinement capacity."""
    extrema = [
        find_extrema(d, cfg, cfg.keypoints_per_trio(octave))
        for octave, d in enumerate(dog)
    ]
    sels = [
        compact_extrema(e, cfg.refine_capacity(octave))
        for octave, e in enumerate(extrema)
    ]
    return extrema, sels


def _refine_per_octave(
    dog: list[jax.Array], sels: list[Extrema], cfg: SiftConfig
) -> list[Keypoints]:
    return [
        refine_keypoints(d, sel, octave, cfg)
        for octave, (d, sel) in enumerate(zip(dog, sels))
    ]


def detect_from_dog(
    dog: list[jax.Array], cfg: SiftConfig
) -> tuple[Keypoints, list[Extrema]]:
    """Extrema scan + refinement over per-octave DoG stacks (unbatched).

    The returned ``Extrema`` keep the raw per-trio slot layout (segment
    ``t`` = slots ``[t·cap, (t+1)·cap)``) for introspection/parity;
    refinement internally consumes a compacted copy (cost is per slot).
    """
    extrema, sels = _candidates(dog, cfg)
    if cfg.unified_refine and len({d.dtype for d in dog}) == 1:
        return refine_keypoints_multi(dog, sels, cfg), extrema
    if (
        cfg.refine_tail_pool
        and len(dog) > 2
        and len({d.dtype for d in dog[1:]}) == 1
    ):
        # Octave 0 refines alone (it holds most of the DoG bytes);
        # octaves >= 1 refine as ONE pooled pass: their DoG concat is
        # small and their static caps sit mostly empty, which is
        # exactly what the cross-octave pool (cfg.refine_pool_compaction)
        # reclaims.
        kp0 = refine_keypoints(dog[0], sels[0], 0, cfg)
        kp_tail = refine_keypoints_multi(
            dog[1:], sels[1:], cfg, octave_offset=1
        )
        return concat_keypoints([kp0, kp_tail]), extrema
    return concat_keypoints(_refine_per_octave(dog, sels, cfg)), extrema


def _describe(scale_space: list[jax.Array], cfg: SiftConfig) -> DescribedKeypoints:
    """Refined keypoints of one image, oriented and described."""
    dog = build_dog(scale_space)
    kps = _refine_per_octave(dog, _candidates(dog, cfg)[1], cfg)
    if cfg.compact_describe:
        return describe_compact(list(scale_space), kps, cfg)
    return concat_described(
        [
            describe_octave(stack, kp, octave, cfg)
            for octave, (stack, kp) in enumerate(zip(scale_space, kps))
        ]
    )


def detect(
    image: jax.Array, cfg: SiftConfig, blur: str = "separable"
) -> tuple[Keypoints, list[Extrema]]:
    """Full single-image detection: ``(H, W)`` grayscale → keypoints."""
    dog = build_dog(build_scale_space(_as_unit_float(image), cfg, blur))
    return detect_from_dog(dog, cfg)


def detect_batched(
    images: jax.Array, cfg: SiftConfig, blur: str = "separable"
) -> tuple[Keypoints, list[Extrema]]:
    """Batched detection: ``(B, H, W)`` → keypoints with leading batch axis.

    The pyramid build is natively batched (blur ops accept leading dims);
    extrema/refinement vmap over the batch.
    """
    dog = build_dog(build_scale_space(_as_unit_float(images), cfg, blur))
    return jax.vmap(lambda *d: detect_from_dog(list(d), cfg))(*dog)


def detect_and_describe(
    image: jax.Array, cfg: SiftConfig, blur: str = "separable"
) -> DescribedKeypoints:
    """Full frontend: ``(H, W)`` grayscale → oriented, described keypoints.

    Stages 1–4 of the reference pipeline plus the descriptor extension
    (BASELINE.json config[2]): per octave, refined keypoints are assigned
    up to ``max_orientations_per_keypoint`` orientations and 128-D
    descriptors from the octave's Gaussian stack.
    """
    return _describe(build_scale_space(_as_unit_float(image), cfg, blur), cfg)


def detect_and_describe_batched(
    images: jax.Array, cfg: SiftConfig, blur: str = "separable"
) -> DescribedKeypoints:
    """Batched frontend: ``(B, H, W)`` → described keypoints per image.

    The pyramid build is natively batched; per-image stages vmap over the
    leading axis.
    """
    scale_space = build_scale_space(_as_unit_float(images), cfg, blur)
    return jax.vmap(lambda *stacks: _describe(list(stacks), cfg))(*scale_space)


@functools.partial(jax.jit, static_argnames=("cfg", "blur"))
def detect_and_describe_jit(
    image: jax.Array, cfg: SiftConfig, blur: str = "separable"
) -> DescribedKeypoints:
    return detect_and_describe(image, cfg, blur)


@functools.partial(jax.jit, static_argnames=("cfg", "blur"))
def detect_and_describe_batched_jit(
    images: jax.Array, cfg: SiftConfig, blur: str = "separable"
) -> DescribedKeypoints:
    return detect_and_describe_batched(images, cfg, blur)


@functools.partial(jax.jit, static_argnames=("cfg", "blur"))
def detect_jit(image: jax.Array, cfg: SiftConfig, blur: str = "separable"):
    return detect(image, cfg, blur)


@functools.partial(jax.jit, static_argnames=("cfg", "blur"))
def detect_batched_jit(images: jax.Array, cfg: SiftConfig, blur: str = "separable"):
    return detect_batched(images, cfg, blur)
