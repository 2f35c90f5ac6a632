"""The XLA pyramid, DoG, extrema scan and gather describe, in float32,
against float64 references.

These are the geometries and semantics the removed fused-octave and
window-describe kernels were pinned to: the 2x-upsampled octave-0 base,
an unaligned width, an octave >= 1 whose scale 0 is the unblurred seed,
the packed 2-bit extrema codes, and upright and rotated descriptors.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_slam.config import SiftConfig
from sift_slam.models.frontend import (
    build_dog,
    build_scale_space,
    detect_and_describe,
)
from sift_slam.ops.dog import difference_of_gaussians
from sift_slam.ops.extrema import (
    _neighborhood_min_max,
    _trio_masks,
    compact_extrema,
    find_extrema,
    find_extrema_from_masks,
    select_refine_candidates,
)
from sift_slam.ops.gaussian import blur_exact, blur_separable
from sift_slam.ops.resize import upsample2x_nn
from sift_slam.utils import oracle
from sift_slam.utils.synthetic import textured_frames

# float32 blur of [0, 1] images: each output sums ~2·(6σ+1) products
# with weights summing to 1, so rounding stays within a few 1e-7.
ATOL_F32 = 1e-5


def _random(seed, shape):
    return np.random.default_rng(seed).random(shape)


def _octave(base, sigmas, blur):
    return jnp.stack(
        [base if s is None else blur(base, s) for s in sigmas], axis=-3
    )


@pytest.mark.parametrize(
    "shape,octave",
    [((2, 40, 56), 0), ((1, 33, 47), 0), ((2, 40, 56), 1)],
    ids=["octave0_upsampled", "unaligned_width", "unblurred_base"],
)
def test_octave_stack_and_dog_match_exact(shape, octave):
    cfg = SiftConfig()
    x = _random(shape[-1], shape)
    sigmas = [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]
    b32, b64 = jnp.asarray(x, jnp.float32), jnp.asarray(x, jnp.float64)
    if octave == 0:
        b32, b64 = upsample2x_nn(b32), upsample2x_nn(b64)
    got = _octave(b32, sigmas, blur_separable)
    ref = _octave(b64, sigmas, blur_exact)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL_F32)
    np.testing.assert_allclose(
        np.asarray(difference_of_gaussians(got)),
        np.asarray(difference_of_gaussians(ref)),
        atol=ATOL_F32,
    )


def test_multi_octave_pyramid_matches_exact():
    cfg = SiftConfig(num_octaves=3)
    x = _random(2, (2, 36, 44))
    got = build_scale_space(jnp.asarray(x, jnp.float32), cfg, "separable")
    ref = build_scale_space(jnp.asarray(x), cfg, "exact")
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=ATOL_F32)
    for g, r in zip(build_dog(got), build_dog(ref)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=ATOL_F32)


@pytest.mark.parametrize("sigma", [0.8, 1.6, 2.5])
def test_blur_separable_matches_exact(sigma):
    x = _random(0, (2, 40, 56))
    got = blur_separable(jnp.asarray(x, jnp.float32), sigma)
    ref = blur_exact(jnp.asarray(x), sigma)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL_F32)


@pytest.mark.parametrize(
    "shape,sigma",
    [((1, 300, 130), 2.0), ((1, 275, 96), 1.4)],
    ids=["tall", "tall_odd_height"],
)
def test_blur_separable_matches_exact_tall(shape, sigma):
    """Heights that crossed the removed blur kernel's row stripes."""
    x = _random(1, shape)
    got = blur_separable(jnp.asarray(x, jnp.float32), sigma)
    ref = blur_exact(jnp.asarray(x), sigma)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL_F32)


def _float32_dog(seed, h, w, octave=0):
    """One float32 DoG octave of a squared-noise image (many extrema)."""
    cfg = SiftConfig()
    sigmas = [
        None if (octave > 0 and s == 0) else cfg.offset_sigma(octave, s)
        for s in range(cfg.scales_per_octave_total)
    ]
    x = jnp.asarray(_random(seed, (h, w)) ** 2, jnp.float32)
    return cfg, difference_of_gaussians(_octave(x, sigmas, blur_separable))


@pytest.mark.parametrize("h,w", [(40, 56), (33, 47)])
def test_extrema_scan_matches_oracle(h, w):
    """The XLA 26-neighbour scan finds the oracle's candidates, in the
    oracle's row-major order, and counts its low-contrast rejects."""
    cfg, dog = _float32_dog(4, h, w)
    cap = 512
    e = find_extrema(dog, cfg, cap)
    d = np.asarray(dog, np.float64)
    found = 0
    for t, s in enumerate(range(1, cfg.dog_per_octave - 1)):
        ref = oracle.find_extremas(
            [d[s - 1], d[s], d[s + 1]], cfg.scales_per_octave
        )
        seg = slice(t * cap, (t + 1) * cap)
        v = np.asarray(e.valid[seg])
        got = list(zip(np.asarray(e.y[seg])[v], np.asarray(e.x[seg])[v]))
        want = [(k["y"], k["x"]) for k in ref["candidateKeypoints"]]
        found += len(want)
        assert got == want
        assert int(e.num_candidates[t]) == len(want)
        assert int(e.num_low_contrast[t]) == len(ref["lowContrastKeypoints"])
    assert found > 0


def _packed_codes(dog, cfg):
    """XLA scan results packed the way a fused octave kernel emits them:
    one int32 plane, trio t in bits [2t, 2t+2), 1 = candidate, 2 =
    low-contrast reject, border zero."""
    h, w = dog.shape[-2:]
    min3, max3 = _neighborhood_min_max(dog)
    packed = jnp.zeros((h, w), jnp.int32)
    for t, s in enumerate(range(1, cfg.dog_per_octave - 1)):
        cand, low = _trio_masks(dog, min3, max3, s, cfg)
        code = cand.astype(jnp.int32) + 2 * low.astype(jnp.int32)
        packed = packed.at[1:-1, 1:-1].add(code << (2 * t))
    return packed


@pytest.mark.parametrize("h,w", [(40, 56), (32, 64)], ids=["generic", "packed_fast_path"])
def test_packed_mask_consumers_match_scan(h, w):
    """find_extrema_from_masks and select_refine_candidates read the
    packed codes to the same candidates and counters as the XLA scan
    (32x64 planes take the packed-plane selection path)."""
    cfg, dog = _float32_dog(5, h, w)
    packed = _packed_codes(dog, cfg)
    cap = 256
    ref = find_extrema(dog, cfg, cap)
    got = find_extrema_from_masks(packed, dog, cfg, cap)
    for field in ("y", "x", "scale_level", "value", "valid",
                  "num_candidates", "num_low_contrast"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(ref, field))
        )

    sel = select_refine_candidates(packed, dog, cfg, cap)
    comp = compact_extrema(ref, cap)
    v = np.asarray(comp.valid)
    assert v.sum() > 0
    np.testing.assert_array_equal(np.asarray(sel.valid), v)
    for field in ("y", "x", "scale_level", "value"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sel, field))[v], np.asarray(getattr(comp, field))[v]
        )
    np.testing.assert_array_equal(
        np.asarray(sel.num_candidates), np.asarray(ref.num_candidates)
    )


@pytest.mark.parametrize("upright", [False, True], ids=["rotated", "upright"])
def test_gather_describe_float32_matches_float64(upright):
    """The gather describe path in float32 gives the float64 run's
    keypoints and descriptors: same valid slots, positions within 1e-3
    px, descriptor cosines above 0.999."""
    cfg = SiftConfig(
        num_octaves=3, max_keypoints_per_trio=128, upright=upright
    )
    img = textured_frames(1, 128, 160, seed=7)[0].astype(np.float64)
    got = detect_and_describe(jnp.asarray(img, jnp.float32), cfg)
    ref = detect_and_describe(jnp.asarray(img), cfg)
    assert got.abs_x.dtype == jnp.float32 and ref.abs_x.dtype == jnp.float64
    v = np.asarray(ref.valid)
    assert v.sum() >= 20, "degenerate test: too few keypoints"
    np.testing.assert_array_equal(np.asarray(got.valid), v)
    np.testing.assert_array_equal(np.asarray(got.octave)[v], np.asarray(ref.octave)[v])
    for f in ("abs_x", "abs_y"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f))[v], np.asarray(getattr(ref, f))[v],
            atol=1e-3,
        )
    a = np.asarray(got.descriptor, np.float64)[v]
    b = np.asarray(ref.descriptor)[v]
    cos = np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() > 0.999, cos.min()
    if upright:
        assert not np.asarray(got.theta)[v].any()
