"""Observability: per-stage timing, throughput, and profiler capture.

The reference's observability is console.log of every accept/reject and
per-chunk progress messages (SURVEY.md §5.1, §5.5). Here:

- :class:`StageTimer` — wall-clock per pipeline stage, waiting for the
  stage's device work (``jax.block_until_ready``) before the clock stops.
- :func:`keypoint_stats` — structured counters mirroring the reference's
  rejection taxonomy plus occupancy/overflow of the fixed-capacity
  buffers (overflow is the one failure mode the static-shape design can
  hide; surfacing it here keeps it observable).
- :func:`trace` — context manager around ``jax.profiler`` for Perfetto
  traces of the hot kernels.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax
import numpy as np

from ..core.types import NUM_REJECT_REASONS, REJECT_REASON_NAMES


@dataclass
class StageTimer:
    """Accumulates per-stage wall-clock across repeated pipeline runs."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync_tree=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                jax.block_until_ready(holder["result"])
            elif sync_tree is not None:
                jax.block_until_ready(sync_tree)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in self.totals.items():
            n = self.counts[name]
            lines.append(f"{name}: {1e3 * total / n:.1f} ms/call ({n} calls)")
        return "\n".join(lines)


def keypoint_stats(keypoints, extrema=None) -> dict:
    """Structured counters: rejection taxonomy + buffer occupancy."""
    counts = np.asarray(keypoints.reject_counts()).reshape(-1)[
        :NUM_REJECT_REASONS
    ]
    stats = {
        name: int(c) for name, c in zip(REJECT_REASON_NAMES, counts)
    }
    stats["capacity"] = int(np.asarray(keypoints.valid).size)
    stats["occupied"] = int(np.asarray(keypoints.reject_reason >= 0).sum())
    if extrema is not None:
        total_candidates = 0
        stored = 0
        for e in extrema if isinstance(extrema, (list, tuple)) else [extrema]:
            total_candidates += int(np.asarray(e.num_candidates).sum())
            stored += int(np.asarray(e.valid).sum())
        stats["candidates_found"] = total_candidates
        stats["candidates_stored"] = stored
        stats["candidates_overflowed"] = max(0, total_candidates - stored)
    return stats


@contextlib.contextmanager
def trace(log_dir: str = "sift_trace"):
    """jax.profiler trace (view with Perfetto / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
