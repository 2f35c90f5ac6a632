"""Pytree data types for the SIFT frontend.

The reference passes dynamic JS arrays of per-keypoint objects between
stages (reference/background.js:433-436, :619-628). XLA requires
static shapes, so keypoints live in fixed-capacity struct-of-array
buffers with validity masks (SURVEY.md §7 "hard parts (a)").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import pytree

# Rejection taxonomy mirroring the reference's console.log categories
# (reference/background.js:581, :602, :648-663, :672 — SURVEY.md §5.5),
# plus SINGULAR_HESSIAN: the reference crashes on a singular Hessian
# (matrix2d.js:482 returns null, caller never checks); we reject instead.
ACCEPTED = 0
REJECT_LOW_CONTRAST = 1
REJECT_EDGE = 2
REJECT_OUT_OF_BOUNDS = 3
REJECT_MAX_ITERATIONS = 4
REJECT_SINGULAR_HESSIAN = 5

REJECT_REASON_NAMES = (
    "accepted",
    "low_contrast",
    "edge",
    "out_of_bounds",
    "max_iterations",
    "singular_hessian",
)
NUM_REJECT_REASONS = len(REJECT_REASON_NAMES)


@pytree.dataclass
class Extrema:
    """Fixed-capacity candidate extrema for one octave (all trios).

    Mirrors the reference extrema records ``{x, y, value}`` plus the trio's
    ``scaleLevel`` (reference/src/sift.js:274-278, background.js:433-436).
    Invalid slots have ``valid == False``; ``num_candidates`` /
    ``num_low_contrast`` count *all* pre-filter decisions (not capped), so
    counter parity with the reference is testable even on overflow.
    """

    y: jax.Array  # (N,) int32 row (m)
    x: jax.Array  # (N,) int32 column (n)
    scale_level: jax.Array  # (N,) int32 DoG scale s in [1, spo]
    value: jax.Array  # (N,) float DoG value at the extremum
    valid: jax.Array  # (N,) bool
    num_candidates: jax.Array  # (trios,) int32 per-trio accepted counts
    num_low_contrast: jax.Array  # (trios,) int32 per-trio pre-filter rejects

    @property
    def capacity(self) -> int:
        return self.y.shape[-1]


@pytree.dataclass
class Keypoints:
    """Refined keypoints, fixed capacity, struct-of-arrays.

    Field names follow the reference keypoint record schema
    (reference/background.js:619-628). ``reject_reason`` carries the
    rejection taxonomy for slots with ``valid == False``.
    """

    octave: jax.Array  # (N,) int32
    scale_level: jax.Array  # (N,) int32 (s at acceptance)
    local_y: jax.Array  # (N,) int32 (m at acceptance)
    local_x: jax.Array  # (N,) int32 (n at acceptance)
    abs_y: jax.Array  # (N,) float
    abs_x: jax.Array  # (N,) float
    abs_sigma: jax.Array  # (N,) float
    value: jax.Array  # (N,) float interpolatedValue
    valid: jax.Array  # (N,) bool
    reject_reason: jax.Array  # (N,) int32

    @property
    def capacity(self) -> int:
        return self.octave.shape[-1]

    def reject_counts(self) -> jax.Array:
        """(NUM_REJECT_REASONS,) histogram over occupied slots."""
        occupied = self.reject_reason >= 0
        return jnp.bincount(
            jnp.where(occupied, self.reject_reason, 0),
            weights=occupied.astype(jnp.int32),
            length=NUM_REJECT_REASONS,
        ).astype(jnp.int32)


def concat_keypoints(parts: list[Keypoints]) -> Keypoints:
    """Concatenate fixed-capacity keypoint buffers along the slot axis."""
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=-1), *parts)
