"""End-to-end parity: JAX float64 CPU pipeline vs the reference oracle.

This is the BASELINE.json config[0] acceptance gate: single image →
Gaussian pyramid + DoG + extrema + interpolated keypoints, matched to the
reference semantics on CPU. Pyramid/DoG arrays are compared bit-for-bit;
refined keypoints match exactly on integer identity and to ≤1e-10 on
float attributes (XLA:CPU contracts isolated scalar mul+add chains in the
refinement algebra into FMAs, a 1-ulp effect; decision margins are
asserted far larger, so the keypoint *set* is provably identical).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_slam import SiftConfig
from sift_slam.core.types import (
    ACCEPTED,
    REJECT_REASON_NAMES,
)
from sift_slam.models import frontend


CFG = SiftConfig()


@pytest.fixture(scope="module")
def jax_scale_space(test_image):
    return frontend.build_scale_space(jnp.asarray(test_image), CFG, blur="exact")


@pytest.fixture(scope="module")
def jax_dog(jax_scale_space):
    return frontend.build_dog(jax_scale_space)


@pytest.fixture(scope="module")
def jax_detection(jax_dog):
    return frontend.detect_from_dog(jax_dog, CFG)


def test_scale_space_shapes(jax_scale_space):
    assert len(jax_scale_space) == CFG.num_octaves
    h, w = 96, 128
    for octave in jax_scale_space:
        assert octave.shape == (CFG.scales_per_octave_total, h, w)
        h, w = -(-h // 2), -(-w // 2)


def test_scale_space_bit_parity(jax_scale_space, oracle_result):
    for o, octave in enumerate(jax_scale_space):
        for s in range(CFG.scales_per_octave_total):
            ref = oracle_result["scaleSpace"][o][s]["image"]
            ours = np.asarray(octave[s])
            np.testing.assert_array_equal(
                ours, ref, err_msg=f"octave {o} scale {s} mismatch"
            )


def test_dog_bit_parity(jax_dog, oracle_result):
    for o, octave in enumerate(jax_dog):
        assert octave.shape[0] == CFG.dog_per_octave
        for s in range(CFG.dog_per_octave):
            ref = oracle_result["differenceOfGaussians"][o][s]["image"]
            np.testing.assert_array_equal(
                np.asarray(octave[s]), ref, err_msg=f"octave {o} dog {s} mismatch"
            )


def test_extrema_parity(jax_detection, oracle_result):
    _, extrema = jax_detection
    total_ref = 0
    total_ours = 0
    for o in range(CFG.num_octaves):
        e = extrema[o]
        for trio_idx in range(CFG.trios_per_octave):
            ref_trio = oracle_result["candidateKeypoints"][o][trio_idx]
            ref_kps = ref_trio["localExtremas"]
            assert int(e.num_candidates[trio_idx]) == len(ref_kps)
            assert int(e.num_low_contrast[trio_idx]) == ref_trio["lowContrastCount"]
            # Slot-by-slot comparison within this trio's segment.
            cap = CFG.max_keypoints_per_trio
            seg = slice(trio_idx * cap, (trio_idx + 1) * cap)
            valid = np.asarray(e.valid[seg])
            n = valid.sum()
            assert n == len(ref_kps), "capacity overflow in test image"
            ys = np.asarray(e.y[seg])[valid]
            xs = np.asarray(e.x[seg])[valid]
            vals = np.asarray(e.value[seg])[valid]
            for i, ref_kp in enumerate(ref_kps):
                assert ys[i] == ref_kp["y"], (o, trio_idx, i)
                assert xs[i] == ref_kp["x"], (o, trio_idx, i)
                assert vals[i] == ref_kp["value"], (o, trio_idx, i)
            total_ref += len(ref_kps)
        total_ours += int(np.asarray(e.valid).sum())
    assert total_ours == total_ref
    assert total_ref > 20, "test image should produce a healthy candidate count"


def _keypoint_key(kp):
    return (kp["octave"], kp["scaleLevel"], kp["localY"], kp["localX"])


def test_refined_keypoints_parity(jax_detection, oracle_result):
    keypoints, _ = jax_detection
    ref_kps = oracle_result["refinedKeypoints"]
    assert len(ref_kps) > 5, "test image should produce refined keypoints"

    valid = np.asarray(keypoints.valid)
    ours = {
        (
            int(keypoints.octave[i]),
            int(keypoints.scale_level[i]),
            int(keypoints.local_y[i]),
            int(keypoints.local_x[i]),
        ): i
        for i in np.nonzero(valid)[0]
    }
    assert len(ours) == len(valid.nonzero()[0])  # no duplicate identities

    ref_keys = [_keypoint_key(kp) for kp in ref_kps]
    assert sorted(ours.keys()) == sorted(ref_keys)

    for kp in ref_kps:
        i = ours[_keypoint_key(kp)]
        np.testing.assert_allclose(
            float(keypoints.abs_x[i]), kp["absoluteX"], rtol=0, atol=1e-10
        )
        np.testing.assert_allclose(
            float(keypoints.abs_y[i]), kp["absoluteY"], rtol=0, atol=1e-10
        )
        np.testing.assert_allclose(
            float(keypoints.abs_sigma[i]), kp["absoluteSigma"], rtol=1e-10
        )
        np.testing.assert_allclose(
            float(keypoints.value[i]), kp["interpolatedValue"], rtol=0, atol=1e-10
        )


def test_rejection_taxonomy_parity(jax_detection, oracle_result):
    keypoints, _ = jax_detection
    counts = np.asarray(keypoints.reject_counts())
    ref = oracle_result["rejectionCounts"]
    for code, name in enumerate(REJECT_REASON_NAMES):
        assert counts[code] == ref[name], (
            name,
            int(counts[code]),
            ref[name],
        )


def test_decision_margins_robust(oracle_result):
    """Assert every accept/reject decision in the oracle has margin far
    above FMA-level (1 ulp) perturbations, making the tolerance-based
    keypoint comparison a sound bit-parity argument."""
    import math

    from sift_slam.utils import oracle as orc

    thr = CFG.contrast_threshold_scaled
    edge_thr = CFG.edge_threshold
    dog = [
        [e["image"] for e in oct_] for oct_ in oracle_result["differenceOfGaussians"]
    ]
    checked = 0
    for octave in range(CFG.num_octaves):
        for scale_i in range(CFG.scales_per_octave):
            trio = oracle_result["candidateKeypoints"][octave][scale_i]
            for ex in trio["localExtremas"]:
                s, m, n = trio["scaleLevel"], ex["y"], ex["x"]
                g = orc._gradient(dog[octave], s, m, n)
                hess = orc._hessian(dog[octave], s, m, n)
                inv = orc._inverse3x3(hess)
                if inv is None:
                    continue
                alpha = [
                    -(inv[i][0] * g[0] + inv[i][1] * g[1] + inv[i][2] * g[2])
                    for i in range(3)
                ]
                for a in alpha:
                    assert abs(abs(a) - 0.6) > 1e-9
                if all(abs(a) < 0.6 for a in alpha):
                    omega = ex["value"] + 0.5 * sum(a * gg for a, gg in zip(alpha, g))
                    assert abs(abs(omega) - thr) > 1e-12
                    tr = hess[1][1] + hess[2][2]
                    det2 = hess[1][1] * hess[2][2] - hess[1][2] * hess[2][1]
                    if det2 != 0 and math.isfinite(tr * tr / det2):
                        assert abs(tr * tr / det2 - edge_thr) > 1e-9
                checked += 1
    assert checked > 0


def test_low_contrast_positions_parity(jax_dog, oracle_result):
    """Low-contrast pre-filter rejects match the reference's first-class
    records one-to-one (positions, values, row-major order;
    reference/src/sift.js:296-307, background.js:408-421)."""
    from sift_slam.ops.extrema import (
        find_low_contrast_extrema,
    )

    total = 0
    for o, d in enumerate(jax_dog):
        low = find_low_contrast_extrema(d, CFG)
        cap = CFG.max_keypoints_per_trio
        for trio_idx in range(CFG.trios_per_octave):
            ref = oracle_result["candidateKeypoints"][o][trio_idx][
                "lowContrastKeypoints"
            ]
            seg = slice(trio_idx * cap, (trio_idx + 1) * cap)
            valid = np.asarray(low.valid[seg])
            assert valid.sum() == len(ref)
            ys = np.asarray(low.y[seg])[valid]
            xs = np.asarray(low.x[seg])[valid]
            vals = np.asarray(low.value[seg])[valid]
            for i, kp in enumerate(ref):
                assert ys[i] == kp["y"], (o, trio_idx, i)
                assert xs[i] == kp["x"], (o, trio_idx, i)
                assert vals[i] == kp["value"], (o, trio_idx, i)
            total += len(ref)
    assert total > 5, "test image should produce low-contrast rejects"


def test_per_keypoint_decision_parity(jax_dog, jax_detection, oracle_result):
    """Every candidate's accept/reject FATE matches the oracle's decision
    log one-to-one, in the reference's iteration order (SURVEY.md §5.5
    'diff rejection reasons one-to-one')."""
    from sift_slam.ops.extrema import (
        compact_extrema,
    )

    keypoints, extrema = jax_detection
    decisions = oracle_result["decisions"]
    ref_by_octave = {}
    for d in decisions:
        ref_by_octave.setdefault(d["octave"], []).append(d)

    offset = 0
    checked = 0
    for octave, e in enumerate(extrema):
        cap = CFG.refine_capacity(octave)
        sel = compact_extrema(e, cap)
        sv = np.asarray(sel.valid)
        sy = np.asarray(sel.y)
        sx = np.asarray(sel.x)
        ss = np.asarray(sel.scale_level)
        refs = ref_by_octave.get(octave, [])
        assert sv.sum() == len(refs), f"octave {octave} candidate count"
        kp_reason = np.asarray(keypoints.reject_reason)[offset : offset + cap]
        k = 0
        for i in range(cap):
            if not sv[i]:
                continue
            ref = refs[k]
            assert int(ss[i]) == ref["scaleLevel"], (octave, k)
            assert int(sy[i]) == ref["y"], (octave, k)
            assert int(sx[i]) == ref["x"], (octave, k)
            got = REJECT_REASON_NAMES[int(kp_reason[i])]
            assert got == ref["reason"], (
                octave,
                k,
                (int(sy[i]), int(sx[i])),
                got,
                ref["reason"],
            )
            k += 1
            checked += 1
        offset += cap
    assert checked == len(decisions)
    assert checked > 20


def test_unified_refine_matches_per_octave_path():
    """cfg.unified_refine: one cross-octave refinement pass must equal
    the per-octave path bit-for-bit (same elementwise ops per slot,
    same slot order) — through ``detect`` on a square image and through
    ``detect_from_dog`` on a precomputed XLA DoG of an unaligned one."""
    import dataclasses

    from sift_slam.models.frontend import (
        build_dog,
        build_scale_space,
        detect,
        detect_from_dog,
    )

    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float64)
    img = (
        0.4
        + 0.25 * np.sin(xx / 5) * np.cos(yy / 7)
        + 0.3 * np.exp(-((yy - 32) ** 2 + (xx - 32) ** 2) / 30.0)
    )
    img = jnp.asarray(
        np.clip(img + 0.04 * rng.standard_normal((64, 64)), 0, 1),
        jnp.float32,
    )
    cfg = SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    cfg_u = dataclasses.replace(cfg, unified_refine=True)

    kp_a, _ = detect(img, cfg)
    kp_b, _ = detect(img, cfg_u)
    for f in ("octave", "scale_level", "local_y", "local_x", "abs_y",
              "abs_x", "abs_sigma", "value", "valid", "reject_reason"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kp_a, f)), np.asarray(getattr(kp_b, f)), f
        )

    dogs = build_dog(build_scale_space(img[:, :50], cfg, "separable"))
    kp_c, _ = detect_from_dog(dogs, cfg)
    kp_d, _ = detect_from_dog(dogs, cfg_u)
    assert np.asarray(kp_c.valid).sum() > 0
    for f in ("abs_x", "abs_y", "abs_sigma", "valid", "reject_reason"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kp_c, f)), np.asarray(getattr(kp_d, f)), f
        )


def test_tail_pool_refine_matches_per_octave_path():
    """cfg.refine_tail_pool: octave 0 alone + pooled octaves >= 1 must
    equal the per-octave path bit-for-bit when nothing overflows (the
    pool only re-packs slots; same elementwise ops per candidate)."""
    import dataclasses

    rng = np.random.default_rng(33)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float64)
    img = (
        0.4
        + 0.25 * np.sin(xx / 5) * np.cos(yy / 7)
        + 0.3 * np.exp(-((yy - 32) ** 2 + (xx - 32) ** 2) / 30.0)
    )
    img = jnp.asarray(
        np.clip(img + 0.04 * rng.standard_normal((64, 64)), 0, 1),
        jnp.float32,
    )
    cfg = SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    cfg_t = dataclasses.replace(cfg, refine_tail_pool=True)

    kp_a, _ = frontend.detect(img, cfg)
    kp_b, _ = frontend.detect(img, cfg_t)
    for f in ("octave", "scale_level", "local_y", "local_x", "abs_y",
              "abs_x", "abs_sigma", "value", "valid", "reject_reason"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kp_a, f)), np.asarray(getattr(kp_b, f)), f
        )


def test_integer_image_inputs_match_float_path():
    """uint8/uint16 inputs convert ON DEVICE (``_as_unit_float``:
    /255 per reference/src/image-utils.js:114, /65535 for the 16-bit
    transport) and must produce exactly the keypoints of the
    equivalently pre-converted float32 image — the division happens in
    float32 either way, so the paths are bit-identical."""
    rng = np.random.default_rng(11)
    cfg = SiftConfig(num_octaves=2, max_keypoints_per_trio=128)
    for dtype, scale in ((np.uint8, 255.0), (np.uint16, 65535.0)):
        raw = rng.integers(0, int(scale) + 1, size=(96, 128)).astype(dtype)
        as_float = raw.astype(np.float32) / np.float32(scale)
        kp_int, _ = frontend.detect(jnp.asarray(raw), cfg)
        kp_float, _ = frontend.detect(jnp.asarray(as_float), cfg)
        np.testing.assert_array_equal(
            np.asarray(kp_int.valid), np.asarray(kp_float.valid)
        )
        v = np.asarray(kp_float.valid)
        np.testing.assert_array_equal(
            np.asarray(kp_int.abs_x)[v], np.asarray(kp_float.abs_x)[v]
        )
        np.testing.assert_array_equal(
            np.asarray(kp_int.abs_y)[v], np.asarray(kp_float.abs_y)[v]
        )
