"""Wall-clock stage profiler for the host-orchestrated SLAM backend.

The reference has no profiling at all (SURVEY.md §5.1); this is the
device-side observability layer for the end-to-end pipeline: per-stage
wall-clock accumulators plus a device-dispatch counter, so the
"where do the ms/frame go" question (VERDICT round-3 item #1) is
answered by measurement.

Profiling SYNCS at stage boundaries (``jax.block_until_ready`` on the
stage's outputs) so each stage's time includes its own device work
instead of leaking into whichever later stage first fetches the value.
That makes profiled runs slower than production runs (each sync drains
the device queue) — use it for attribution, never for headline
throughput.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class StageProfile:
    """Accumulates wall-clock per named stage + device dispatch counts.

    Usage::

        prof = StageProfile()
        with prof.stage("pnp"):
            out = solve_pnp(...)
            prof.sync(out)        # count a device round-trip + block
        print(prof.report())
    """

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.dispatches: int = 0

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def sync(self, value) -> None:
        """Block on a device value and count one host↔device round-trip."""
        import jax

        jax.block_until_ready(value)
        self.dispatches += 1

    def count(self, n: int = 1) -> None:
        """Count device round-trips that were synced elsewhere."""
        self.dispatches += n

    def report(self, total_frames: int | None = None) -> dict:
        """Structured summary: per-stage seconds/calls, sorted by cost."""
        order = sorted(self.seconds, key=self.seconds.get, reverse=True)
        out = {
            "stages": {
                k: {
                    "s": round(self.seconds[k], 3),
                    "calls": self.calls[k],
                    "ms_per_call": round(1e3 * self.seconds[k] / self.calls[k], 2),
                }
                for k in order
            },
            "device_round_trips": self.dispatches,
            "total_s": round(sum(self.seconds.values()), 3),
        }
        if total_frames:
            out["ms_per_frame"] = {
                k: round(1e3 * self.seconds[k] / total_frames, 1) for k in order
            }
        return out
