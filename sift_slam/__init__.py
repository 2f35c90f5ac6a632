"""SIFT scale-space extrema detection and SLAM/SfM framework in JAX.

A from-scratch JAX/XLA re-design of
``bingjetli/sift-scale-space-extrema-detection`` (Gaussian scale space,
DoG, 26-neighbor extrema, quadratic keypoint refinement), extended per
BASELINE.json with descriptors, matching, RANSAC pose, bundle adjustment,
and multi-host sharding.
"""

from .config import SiftConfig
from .core.types import (
    ACCEPTED,
    NUM_REJECT_REASONS,
    REJECT_EDGE,
    REJECT_LOW_CONTRAST,
    REJECT_MAX_ITERATIONS,
    REJECT_OUT_OF_BOUNDS,
    REJECT_REASON_NAMES,
    REJECT_SINGULAR_HESSIAN,
    Extrema,
    Keypoints,
)
from .models.frontend import (
    build_dog,
    build_scale_space,
    detect,
    detect_and_describe,
    detect_and_describe_batched,
    detect_and_describe_batched_jit,
    detect_and_describe_jit,
    detect_batched,
    detect_batched_jit,
    detect_from_dog,
    detect_jit,
)
from .ops.descriptor import DescribedKeypoints
from .ops.matching import Matches, descriptor_distances, match_descriptors
from .ops.ransac import (
    EssentialResult,
    estimate_essential_ransac,
    recover_pose,
    refine_relative_pose,
    sampson_error,
)

__version__ = "0.1.0"

__all__ = [
    "SiftConfig",
    "Extrema",
    "Keypoints",
    "DescribedKeypoints",
    "Matches",
    "EssentialResult",
    "descriptor_distances",
    "match_descriptors",
    "estimate_essential_ransac",
    "recover_pose",
    "refine_relative_pose",
    "sampson_error",
    "detect_and_describe",
    "detect_and_describe_jit",
    "detect_and_describe_batched",
    "detect_and_describe_batched_jit",
    "build_scale_space",
    "build_dog",
    "detect",
    "detect_from_dog",
    "detect_batched",
    "detect_jit",
    "detect_batched_jit",
    "ACCEPTED",
    "REJECT_LOW_CONTRAST",
    "REJECT_EDGE",
    "REJECT_OUT_OF_BOUNDS",
    "REJECT_MAX_ITERATIONS",
    "REJECT_SINGULAR_HESSIAN",
    "REJECT_REASON_NAMES",
    "NUM_REJECT_REASONS",
]
