"""Frozen configuration for the SIFT scale-space frontend.

Every default below is the exact constant used by the reference
implementation (bingjetli/sift-scale-space-extrema-detection), cited by
file:line so config parity is auditable:

- ``num_octaves=5, scales_per_octave=3, min_blur_level=0.8,
  assumed_blur=0.5, chunk_size=32``: reference/src/worker.js:33-37 and
  reference/main.js:21-24.
- ``min_interpixel_distance=0.5``: reference/src/worker.js:88.
- ``contrast_threshold=0.015`` and the ``0.8`` pre-filter factor:
  reference/src/sift.js:285-293.
- ``edge_ratio=10`` (threshold ``(c+1)^2/c = 12.1``):
  reference/background.js:598.
- ``max_refine_iterations=5`` and ``convergence_threshold=0.6``:
  reference/background.js:480, background.js:558.
- kernel radius of 3 standard deviations: reference/src/sift.js:38.

The JAX build adds static-shape capacities (``max_keypoints_per_trio``)
because XLA requires fixed shapes; the reference uses dynamic JS arrays.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    # --- reference algorithm constants -----------------------------------
    num_octaves: int = 5
    scales_per_octave: int = 3
    min_blur_level: float = 0.8
    assumed_blur: float = 0.5
    chunk_size: int = 32  # display tiling in the reference; unused here
    min_interpixel_distance: float = 0.5
    contrast_threshold: float = 0.015
    contrast_prefilter_factor: float = 0.8
    edge_ratio: float = 10.0
    max_refine_iterations: int = 5
    convergence_threshold: float = 0.6
    kernel_radius_sigmas: float = 3.0

    # --- static-shape capacities ------------------------------------------
    # Max extrema kept per (octave, trio). Fixed capacity + validity mask
    # replaces the reference's dynamic candidate lists (SURVEY.md §7).
    max_keypoints_per_trio: int = 1024

    # After the extrema scan, valid candidates are packed into
    # ``refine_compaction`` × (total per-octave slots) before refinement
    # (refinement cost is per SLOT; occupancy is typically well under
    # 50%). 1.0 disables compaction.
    refine_compaction: float = 0.5

    # After the first Newton iteration, still-active candidates are
    # packed into ``refine_active_compaction`` x slots for the remaining
    # iterations (most candidates finish in iteration 1). 1.0 disables.
    refine_active_compaction: float = 0.35

    # Compaction LADDER: after Newton iteration k (1-based), actives are
    # re-packed into ``schedule[k-1]`` x (original slots); the last
    # entry repeats for deeper iterations. Refinement cost is gather-
    # bound and per-slot, and the survivor fractions at the bench config
    # are 21% / 7% / 4% / 3% of VALID candidates after iterations 1-4
    # (in slot terms: 14% / 4.6% / 2.6% / 2.0% of slots), so these caps
    # carry >=2.4x headroom; actives beyond a cap keep the
    # REJECT_MAX_ITERATIONS fate they already hold (same failure
    # semantics as the single-cap knob above). Tighter ladders change
    # the output: (0.25, ...) drops 0.87% of accepted keypoints on
    # dense noise images (per-image survivor variance), and (0.35,
    # 0.10, 0.06) keeps the accepted set but changes REJECTED
    # candidates' taxonomy under load. Empty tuple = use
    # ``refine_active_compaction`` as a single-entry ladder.
    refine_compaction_schedule: tuple = (0.35, 0.15, 0.08)

    # Refine ALL octaves' candidates in ONE pass over a concatenated
    # flat DoG buffer (per-candidate octave geometry gathered from
    # lookup tables) instead of one pass per octave — 4x fewer
    # gather/compaction ops at identical numerics. Off by default;
    # requires every octave's DoG to share one dtype (else the
    # per-octave path runs regardless).
    unified_refine: bool = False

    # Cross-octave refinement POOL (unified path only): before the first
    # Newton iteration, all octaves' VALID candidates are packed into
    # ``refine_pool_compaction`` × (total slots). The static per-octave
    # capacity schedule cannot adapt to content — at the bench config
    # octave 0 fills 100 % of its slots while octave 1 sits at 3 % and
    # octave 3 at 0 % — so budgeting only the
    # cross-octave TOTAL removes the empty-slot gather cost while the
    # per-octave caps keep bounding each octave (scale diversity under
    # saturation). Overflow keeps the ladder's semantics (candidates
    # beyond the pool keep REJECT_MAX_ITERATIONS; observable via the
    # per-trio counters). 1.0 disables.
    refine_pool_compaction: float = 0.7

    # Tail-group refinement: octave 0 refines alone; octaves >= 1
    # refine as one pooled multi-octave pass (their flat-DoG concat is
    # cheap and their caps are where the empty-slot waste lives). The
    # pool only removes empty-slot gathers the ladder's level-1
    # compaction already removes after iteration 1. Default OFF; kept
    # as a knob for content with much larger high-octave tails.
    refine_tail_pool: bool = False

    # Floor for the per-octave capacity schedule (octave o gets
    # ``max(min_keypoints_per_trio, max_keypoints_per_trio >> o)`` slots:
    # octave o has 4^-o as many pixels, so equal capacity would waste
    # most refinement/descriptor work on empty slots).
    min_keypoints_per_trio: int = 64

    # --- descriptor extension (green-field; reference stops before
    # descriptors, reference/readme.md:11). Constants follow the IPOL
    # "Anatomy of the SIFT Method" paper bundled with the reference
    # (anatomy-of-the-sift-method.pdf): λ_ori, λ_descr, bin counts,
    # smoothing and peak-ratio rules. The sampling itself is redesigned
    # for static shapes: fixed G×G grid samples in (rotated) keypoint frame with
    # bilinear gradient interpolation and one-hot einsum histograms,
    # instead of data-dependent pixel windows.
    lambda_ori: float = 1.5
    lambda_descr: float = 6.0
    n_orientation_bins: int = 36
    orientation_smooth_iterations: int = 6
    orientation_peak_ratio: float = 0.8
    max_orientations_per_keypoint: int = 2
    orientation_grid_size: int = 16  # G×G samples for the ori histogram
    descriptor_n_hist: int = 4  # 4×4 spatial cells
    descriptor_n_ori: int = 8  # 8 orientation bins -> 128-D
    descriptor_grid_size: int = 16  # G×G samples for the descriptor
    descriptor_clip: float = 0.2  # component clamp before renormalize

    # Unified cross-octave describe (ops/descriptor.py::describe_compact):
    # valid keypoints are compacted into ``describe_compaction`` × (total
    # refine slots) before the per-slot sampling stages — describe cost
    # is per SLOT and valid occupancy at the bench config is ~35 %. Overflow drops trailing keypoints
    # (observable via the valid count). 1.0 ≈ no compaction.
    compact_describe: bool = True
    describe_compaction: float = 0.5
    # Valid (keypoint, orientation-peak) pairs are further compacted to
    # ``descriptor_pair_compaction`` × (describe capacity × max
    # orientations) before the descriptor pass (~75 % of valid keypoints'
    # pair slots hold a real second peak at the bench config).
    descriptor_pair_compaction: float = 0.75
    # Upright mode: skip orientation assignment, θ=0 for every keypoint.
    # For video/SLAM tracking (inter-frame rotation ≪ bin width) — the
    # orientation stage is ~40 % of describe cost. NOT rotation
    # invariant; off for general matching. Only the compacted describe
    # path implements it (validated in __post_init__).
    upright: bool = False

    def __post_init__(self):
        if self.upright and not self.compact_describe:
            raise ValueError(
                "upright=True requires compact_describe=True (the "
                "per-octave describe path has no upright mode)"
            )

    # ----------------------------------------------------------------------
    @property
    def scales_per_octave_total(self) -> int:
        """Gaussian images per octave: s+3 (reference/background.js:106)."""
        return self.scales_per_octave + 3

    @property
    def dog_per_octave(self) -> int:
        """DoG images per octave: s+2 (reference/background.js:272)."""
        return self.scales_per_octave + 2

    @property
    def trios_per_octave(self) -> int:
        """Extrema trios per octave: DoG scales 1..s (background.js:377)."""
        return self.scales_per_octave

    @property
    def k(self) -> float:
        """Scale multiplier 2^(1/n_spo) (reference/background.js:100)."""
        return math.pow(2.0, 1.0 / self.scales_per_octave)

    @property
    def contrast_threshold_scaled(self) -> float:
        """Contrast threshold rescaled for scales_per_octave.

        ``((2^(1/n) - 1) / (2^(1/3) - 1)) * 0.015``
        (reference/src/sift.js:285). Evaluation order matches JS.
        """
        return (
            (math.pow(2.0, 1.0 / self.scales_per_octave) - 1.0)
            / (math.pow(2.0, 1.0 / 3.0) - 1.0)
        ) * self.contrast_threshold

    @property
    def contrast_prefilter_threshold(self) -> float:
        """Pre-filter threshold: thr * 0.8 (reference/src/sift.js:293)."""
        return self.contrast_threshold_scaled * self.contrast_prefilter_factor

    @property
    def edge_threshold(self) -> float:
        """Edge test threshold (c+1)^2/c (reference/background.js:598)."""
        c = self.edge_ratio
        return ((c + 1.0) * (c + 1.0)) / c

    @classmethod
    def quality(cls, **overrides) -> "SiftConfig":
        """Detection-density preset — a DOCUMENTED parity divergence.

        The reference detects ~3x fewer keypoints than standard SIFT
        (37 vs 110 on the descriptor-bench textured image), and the
        dominant cause is NOT the thresholds but the blur ladder:
        ``min_blur_level = 0.8`` (reference/src/worker.js:33-37) vs the
        standard sigma0 = 1.6 (OpenCV, IPOL). DoG response amplitude
        grows ~sigma^2, so the reference's finer ladder produces ~4x
        smaller responses against the same contrast threshold —
        measured on the bench image: sigma 1.6 alone 37 -> 84
        keypoints; with OpenCV-equivalent thresholds (final 0.04/3,
        pre-filter 0.5x) 108 vs OpenCV's 110. This preset is for
        matching/SLAM workloads; the default config remains bit-parity
        with the reference.
        """
        base = dict(
            min_blur_level=1.6,  # standard SIFT sigma0 (OpenCV/IPOL)
            contrast_threshold=0.0133,  # ~OpenCV 0.04/nOctaveLayers
            contrast_prefilter_factor=0.5,
        )
        base.update(overrides)
        return cls(**base)

    def keypoints_per_trio(self, octave: int) -> int:
        """Per-trio slot capacity for one octave (shrinks 2x per octave)."""
        return max(self.min_keypoints_per_trio, self.max_keypoints_per_trio >> octave)

    def refine_capacity(self, octave: int) -> int:
        """Post-compaction candidate slots fed to refinement per octave."""
        total = self.keypoints_per_trio(octave) * self.trios_per_octave
        return min(total, max(64, int(total * self.refine_compaction)))

    def describe_capacity(self) -> int:
        """Compacted keypoint slots fed to the unified describe pass."""
        total = sum(self.refine_capacity(o) for o in range(self.num_octaves))
        return min(total, max(128, int(total * self.describe_compaction)))

    def descriptor_pair_capacity(self) -> int:
        """Compacted (keypoint, orientation) pairs in the descriptor pass."""
        if self.upright:
            return self.describe_capacity()
        full = self.describe_capacity() * self.max_orientations_per_keypoint
        return min(
            full, max(128, int(full * self.descriptor_pair_compaction))
        )

    def max_keypoints_per_octave(self) -> int:
        return self.max_keypoints_per_trio * self.trios_per_octave

    def max_keypoints_total(self) -> int:
        return self.max_keypoints_per_octave() * self.num_octaves

    # --- blur ladder -------------------------------------------------------
    def base_blur_level(self, octave: int) -> float:
        """Blur level of an octave's base image.

        Octave 0: min_blur_level (background.js:89).
        Octave o>0: inherited from the previous octave's seed scale —
        the running product 0.8 * 2^o computed exactly as the reference
        does via repeated multiplication (background.js:114-122).
        """
        b = self.min_blur_level
        for _ in range(octave):
            # seed = scale `scales_per_octave` of the previous octave:
            # blurLevel = base * k^spo, and k^spo = 2 exactly only in real
            # arithmetic; replicate the float computation.
            b = b * math.pow(self.k, self.scales_per_octave)
        return b

    def target_sigma(self, octave: int, scale: int) -> float:
        """Absolute blur of (octave, scale): base * k^scale
        (reference/background.js:157-173)."""
        return self.base_blur_level(octave) * math.pow(self.k, scale)

    def offset_sigma(self, octave: int, scale: int) -> float:
        """Incremental blur applied to the octave base image to reach the
        target blur (semigroup relation, reference/background.js:162-177).

        Octave 0 blurs from ``assumed_blur``; octaves >0 blur from the
        inherited base blur level.
        """
        target = self.target_sigma(octave, scale)
        base = self.assumed_blur if octave == 0 else self.base_blur_level(octave)
        return math.sqrt((target * target) - (base * base))
