"""Packed-plane candidate selection vs the generic prefix-sum selection.

``_first_k_candidates_packed`` (ops/extrema.py) selects refinement
candidates straight from the fused kernel's packed int32 mask plane
without materializing the unpacked (T, H, W) bool volume. It must be
slot-for-slot identical to ``first_k_set_indices`` over the unpacked
candidate mask — including capacity overflow, underflow, and the
zero-candidate case — and its by-product per-trio counters must match
direct counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_slam.ops.extrema import (
    _first_k_candidates_packed,
    first_k_set_indices,
    unpack_mask_codes,
)


def _random_packed(rng, h, w, t):
    codes = rng.integers(0, 3, size=(t, h, w))
    packed = np.zeros((h, w), np.int32)
    for i in range(t):
        packed |= codes[i].astype(np.int32) << (2 * i)
    return codes, packed


@pytest.mark.parametrize(
    "h,w,t,cap",
    [
        (8, 16, 3, 16),    # overflow: far more candidates than capacity
        (16, 128, 5, 64),  # bench-like trio count
        (32, 256, 2, 8),   # tiny capacity
        (8, 16, 1, 512),   # underflow: capacity > candidates
    ],
)
def test_packed_selection_matches_generic(h, w, t, cap):
    assert (h * w) % 128 == 0
    rng = np.random.default_rng(h * w + t)
    codes, packed = _random_packed(rng, h, w, t)

    idx_f, val_f, n_cand, n_low = (
        np.asarray(a)
        for a in _first_k_candidates_packed(jnp.asarray(packed), t, cap)
    )
    cand = unpack_mask_codes(jnp.asarray(packed), t) == 1
    idx_r, val_r, _ = first_k_set_indices(jnp.asarray(cand).reshape(-1), cap)

    np.testing.assert_array_equal(idx_f, np.asarray(idx_r))
    np.testing.assert_array_equal(val_f, np.asarray(val_r))
    np.testing.assert_array_equal(n_cand, (codes == 1).sum(axis=(1, 2)))
    np.testing.assert_array_equal(n_low, (codes == 2).sum(axis=(1, 2)))


def test_packed_selection_zero_candidates():
    packed = jnp.zeros((16, 128), jnp.int32)
    idx, valid, n_cand, n_low = (
        np.asarray(a) for a in _first_k_candidates_packed(packed, 3, 32)
    )
    assert valid.sum() == 0
    assert n_cand.sum() == 0 and n_low.sum() == 0
    assert (idx == 0).all()
