"""Descriptor extension tests: orientations + 128-D descriptors.

The reference has no descriptors (reference/readme.md:11), so there is no
oracle; these are property tests — shape/validity invariants, unit norm,
orientation correctness on a synthetic gradient, and 90°-rotation
equivariance of the full frontend.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_slam import (
    SiftConfig,
    detect_and_describe_jit,
)
from sift_slam.ops.descriptor import (
    _extract_peaks,
    _smooth_circular,
)

CFG = SiftConfig(num_octaves=3, max_keypoints_per_trio=256)


@pytest.fixture(scope="module")
def described(test_image):
    return detect_and_describe_jit(jnp.asarray(test_image), CFG)


def test_shapes_and_validity(described):
    n = described.capacity
    assert described.descriptor.shape == (n, 128)
    assert described.theta.shape == (n,)
    assert int(described.valid.sum()) > 0


def test_descriptors_unit_norm_and_clipped(described):
    valid = np.asarray(described.valid)
    desc = np.asarray(described.descriptor)[valid]
    norms = np.linalg.norm(desc, axis=1)
    # Keypoints in flat regions can have ~zero gradient mass; their norm
    # collapses to ~0 rather than 1. All others must be unit.
    nonzero = norms > 0.5
    np.testing.assert_allclose(norms[nonzero], 1.0, atol=1e-3)
    assert desc.min() >= 0.0
    # Components are clamped at 0.2·‖d‖ *before* the final renormalize,
    # so post-renorm values can exceed 0.2 but stay well below the
    # unclipped regime (a single dominant bin would otherwise hit ~1.0).
    assert desc[nonzero].max() <= 0.5


def test_theta_range(described):
    valid = np.asarray(described.valid)
    theta = np.asarray(described.theta)[valid]
    assert np.all(theta >= 0.0) and np.all(theta < 2 * np.pi + 1e-6)


def test_peak_extraction_simple():
    """A single clean histogram peak is found and interpolated."""
    nbins = CFG.n_orientation_bins
    hist = jnp.asarray(
        np.exp(-0.5 * ((np.arange(nbins) - 10.3) / 1.5) ** 2), jnp.float32
    )
    theta, valid = _extract_peaks(hist, CFG)
    assert bool(valid[0])
    # Peak near bin 10.3 → angle ≈ (10.3+0.5)/36·2π (half-bin center shift).
    expected = (10.3 + 0.5) / nbins * 2 * np.pi
    assert abs(float(theta[0]) - expected) < 0.05
    # Second slot must not report a second fake peak ≥ 0.8·max.
    assert not bool(valid[1])


def test_smooth_preserves_mass():
    hist = jnp.asarray(np.random.default_rng(0).random(36), jnp.float32)
    sm = _smooth_circular(hist, 6)
    np.testing.assert_allclose(float(sm.sum()), float(hist.sum()), rtol=1e-5)


def test_rotation_equivariance(test_image):
    """Rotating the image 90° rotates keypoints and shifts theta by π/2.

    NN-upsampling half-pixel asymmetries shift keypoints slightly, so we
    match by position with a 1.5 px tolerance and require most matched
    pairs to agree in orientation delta and descriptor similarity.
    """
    img = jnp.asarray(test_image)
    rot = jnp.rot90(img, k=-1)  # clockwise: (y,x) -> (x, H-1-y)

    a = detect_and_describe_jit(img, CFG)
    b = detect_and_describe_jit(rot, CFG)

    av = np.asarray(a.valid)
    bv = np.asarray(b.valid)
    ay, ax = np.asarray(a.abs_y)[av], np.asarray(a.abs_x)[av]
    by, bx = np.asarray(b.abs_y)[bv], np.asarray(b.abs_x)[bv]
    at, bt = np.asarray(a.theta)[av], np.asarray(b.theta)[bv]
    ad, bd = np.asarray(a.descriptor)[av], np.asarray(b.descriptor)[bv]

    h = test_image.shape[0]
    # Expected position of a's keypoints in the rotated frame.
    ey, ex = ax, (h - 1) - ay

    matched = 0
    agree_theta = 0
    agree_desc = 0
    for i in range(len(ey)):
        d2 = (by - ey[i]) ** 2 + (bx - ex[i]) ** 2
        j = int(np.argmin(d2))
        if d2[j] < 1.5**2:
            matched += 1
            dtheta = (bt[j] - at[i]) % (2 * np.pi)
            # Clockwise image rotation decreases the gradient angle by π/2
            # in our (y-down, atan2(gy,gx)) convention — accept either
            # sense to stay robust to convention, just require ±π/2.
            if (
                min(abs(dtheta - np.pi / 2), abs(dtheta - 3 * np.pi / 2))
                < 0.35
            ):
                agree_theta += 1
            if float(ad[i] @ bd[j]) > 0.8:
                agree_desc += 1

    assert matched >= 10, f"only {matched} matched keypoints"
    assert agree_theta / matched > 0.7, (agree_theta, matched)
    assert agree_desc / matched > 0.7, (agree_desc, matched)


# ---------------------------------------------------------------------------
# Unified compacted describe path (ops/descriptor.py::describe_compact)
# ---------------------------------------------------------------------------


def _sorted_valid(d, b=None):
    v = np.asarray(d.valid if b is None else d.valid[b])
    pick = lambda f: np.asarray(f if b is None else f[b])[v]
    fields = [pick(d.abs_y), pick(d.abs_x), pick(d.abs_sigma), pick(d.theta)]
    descs = pick(d.descriptor)
    order = np.lexsort((fields[3], fields[2], fields[1], fields[0]))
    return [f[order] for f in fields], descs[order]


def test_compact_describe_matches_per_octave(test_image):
    """Compacted cross-octave describe = per-octave describe, bit-exact.

    Same keypoint set (order-insensitive), same thetas, same
    descriptors — compaction only removes invalid slots.
    """
    import dataclasses

    from sift_slam.models.frontend import (
        detect_and_describe,
    )

    img = jnp.asarray(test_image)
    old = detect_and_describe(
        img, dataclasses.replace(CFG, compact_describe=False)
    )
    new = detect_and_describe(
        img, dataclasses.replace(CFG, compact_describe=True)
    )
    (fo, do) = _sorted_valid(old)
    (fn, dn) = _sorted_valid(new)
    assert len(fo[0]) == len(fn[0]) > 0
    for a, c in zip(fo, fn):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(do, dn)


def test_upright_mode(test_image):
    """Upright: one θ=0 descriptor per unique keypoint position."""
    import dataclasses

    from sift_slam.models.frontend import (
        detect_and_describe,
    )

    img = jnp.asarray(test_image)
    ref = detect_and_describe(img, CFG)
    up = detect_and_describe(img, dataclasses.replace(CFG, upright=True))
    v_r = np.asarray(ref.valid)
    v_u = np.asarray(up.valid)
    pos_r = set(
        zip(
            np.asarray(ref.abs_y)[v_r].tolist(),
            np.asarray(ref.abs_x)[v_r].tolist(),
        )
    )
    pos_u = set(
        zip(
            np.asarray(up.abs_y)[v_u].tolist(),
            np.asarray(up.abs_x)[v_u].tolist(),
        )
    )
    assert pos_r == pos_u and len(pos_u) > 0
    assert np.all(np.asarray(up.theta)[v_u] == 0.0)


def test_upright_requires_compact():
    with pytest.raises(ValueError):
        SiftConfig(upright=True, compact_describe=False)
