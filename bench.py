"""Benchmark: batched SIFT detection frames/s on one GPU (BASELINE.json config[1]).

Measures steady-state throughput of the full batched detection pipeline
(Gaussian pyramid -> DoG -> extrema -> refinement, the XLA separable
path) at 640x480 with 4 octaves / 5 scales per octave over a 64-image
batch, float32, on JAX's first device, which must be a GPU.

Prints the device and the card's name and power limit, then ONE JSON
line: {"metric", "value", "unit", "vs_baseline", "keypoints_per_s",
"device"}.

Baseline: the reference publishes no numbers (readme.md:1-29; see
BASELINE.md). The recorded baseline is the measured wall-clock of this
repo's reference-exact oracle (utils/oracle.py — which replays the JS
algorithm with numpy-vectorized taps, i.e. strictly faster than the JS
per-pixel loops) on one 640x480 frame at the same 4-octave/5-scale
config on a host CPU: see ORACLE_BASELINE_FPS below.
"""

from __future__ import annotations

import json
import time

# Measured 2026-08-16 via utils/oracle.py on a 640x480 synthetic frame,
# octaves=4 spo=5 (single-core host CPU, numpy-vectorized reference
# semantics): 10.58 s/frame. The JS original (scalar per-pixel loops,
# full 2-D kernels) is strictly slower than this vectorized replay.
ORACLE_BASELINE_FPS = 0.0945


def main() -> None:
    import jax
    import jax.numpy as jnp

    from sift_slam import SiftConfig, detect_batched_jit
    from sift_slam.utils.compile_cache import enable_compile_cache
    from sift_slam.utils.device import gpu_name_and_power_limit, require_gpu
    from sift_slam.utils.synthetic import blob_frames

    dev = require_gpu()
    enable_compile_cache()
    print(f"device: {dev.device_kind} x{len(jax.devices())}, jax {jax.__version__}")
    print(f"nvidia-smi: {gpu_name_and_power_limit()}")

    batch, h, w = 64, 480, 640
    cfg = SiftConfig(
        num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512
    )
    images = jax.device_put(blob_frames(batch, h, w))

    for _ in range(2):  # compile, then one run to settle the allocator
        keypoints, _ = jax.block_until_ready(detect_batched_jit(images, cfg))

    iters = 6
    t0 = time.perf_counter()
    for _ in range(iters):
        keypoints, _ = detect_batched_jit(images, cfg)
    jax.block_until_ready(keypoints)
    fps = batch * iters / (time.perf_counter() - t0)

    n_kp = int(jnp.sum(keypoints.valid))
    print(
        json.dumps(
            {
                "metric": "sift_frontend_frames_per_s",
                "value": round(fps, 3),
                "unit": "frames/s",
                "vs_baseline": round(fps / ORACLE_BASELINE_FPS, 2),
                "keypoints_per_s": round(fps * n_kp / batch, 1),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
