"""Frontend stage timings and the pyramid's share of the bandwidth bound.

Measures on JAX's first device, which must be a GPU, at the bench
config (64 x 640x480, 4 octaves / 5 scales per octave, float32, the XLA
separable path):

1. full batched detection (pyramid -> DoG -> extrema -> refinement);
2. the pyramid + DoG + 26-neighbour extrema scan alone, against the
   least HBM traffic that stage needs (``detect_traffic_bytes``) at the
   card's peak bandwidth;
3. with ``--describe``, batched detect+describe, and the share of its
   time the describe stage takes (detect+describe minus detection).

Every time is the median of ``--iters`` runs after two warm-ups, each
ended by ``block_until_ready``. Prints the device, the card's name and
power limit, and one JSON line.

Run: ``python benchmarks/frontend_bench.py [--batch 64] [--describe]``.

Traffic model (the least any implementation must move; per octave, B
images of H x W f32, S scales): read the octave base once, write S-1
DoG planes and the next octave's seed plane, write one packed int16
plane of extrema codes (2 bits per trio) and read it back for candidate
selection. Octave o has 4^-o as many pixels; the 2x-upsampled base
doubles the octave-0 linear dims (reference/background.js:84). The XLA
path moves more: it writes every Gaussian scale and reads each DoG
plane several times in the scan.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

sys.path.insert(0, ".")

# Peak HBM bandwidth by device kind (NVIDIA H100 SXM data sheet). A
# device missing from the table is an error, not a default.
PEAK_HBM_BYTES_PER_S = {"H100": 3.35e12}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    for key, rate in PEAK_HBM_BYTES_PER_S.items():
        if key in device_kind:
            return rate
    raise KeyError(f"no peak bandwidth recorded for {device_kind!r}")


def detect_traffic_bytes(batch: int, h: int, w: int, cfg) -> int:
    """Least HBM bytes of the detect-path pyramid + DoG + extrema scan."""
    total = 0
    bh, bw = 2 * h, 2 * w  # 2x NN upsample (reference/background.js:84)
    s = cfg.scales_per_octave_total
    for _ in range(cfg.num_octaves):
        px = batch * bh * bw
        total += 4 * px  # read the octave base
        total += (s - 1) * 4 * px + 4 * px  # write S-1 DoG + seed
        total += 2 * 2 * px  # write + re-read one int16 code plane
        bh //= 2
        bw //= 2
    return total


def _median_time(fn, iters: int) -> float:
    import jax

    for _ in range(2):  # compile, then one run to settle the allocator
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument(
        "--describe",
        action="store_true",
        help="also time detect+describe and report the describe share",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sift_slam import SiftConfig
    from sift_slam.models.frontend import (
        build_dog,
        build_scale_space,
        detect_and_describe_batched_jit,
        detect_batched_jit,
    )
    from sift_slam.ops.extrema import find_extrema
    from sift_slam.utils.compile_cache import enable_compile_cache
    from sift_slam.utils.device import gpu_name_and_power_limit, require_gpu
    from sift_slam.utils.synthetic import blob_frames

    dev = require_gpu()
    enable_compile_cache()
    card = gpu_name_and_power_limit()
    print(f"device: {dev.device_kind}, jax {jax.__version__}")
    print(f"nvidia-smi: {card}", flush=True)

    batch, h, w = args.batch, 480, 640
    cfg = SiftConfig(
        num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512
    )
    images = jax.device_put(blob_frames(batch, h, w))

    kp, _ = detect_batched_jit(images, cfg)
    n_kp = int(jnp.sum(kp.valid))
    total_s = _median_time(lambda: detect_batched_jit(images, cfg), args.iters)

    @jax.jit
    def pyramid_scan(imgs):
        dogs = build_dog(build_scale_space(imgs, cfg))
        counts = [
            jax.vmap(
                lambda d, o=o: find_extrema(d, cfg, cfg.keypoints_per_trio(o))
            )(d).num_candidates.sum()
            for o, d in enumerate(dogs)
        ]
        return sum(counts)

    pyr_s = _median_time(lambda: pyramid_scan(images), args.iters)
    ideal_bytes = detect_traffic_bytes(batch, h, w, cfg)
    peak = peak_hbm_bytes_per_s(dev.device_kind)

    out = {
        "device": dev.device_kind,
        "nvidia_smi": card,
        "batch": batch,
        "detect_ms": 1e3 * total_s,
        "frames_per_s": batch / total_s,
        "keypoints_per_image": n_kp / batch,
        "pyramid_dog_scan_ms": 1e3 * pyr_s,
        "pyramid_share_of_detect": pyr_s / total_s,
        "pyramid_ideal_bytes": ideal_bytes,
        "pyramid_bound_ms": 1e3 * ideal_bytes / peak,
        "pyramid_bandwidth_share": ideal_bytes / peak / pyr_s,
    }
    if args.describe:
        desc_s = _median_time(
            lambda: detect_and_describe_batched_jit(images, cfg), args.iters
        )
        out["detect_describe_ms"] = 1e3 * desc_s
        out["describe_share"] = (desc_s - total_s) / desc_s
    print(json.dumps(out))


if __name__ == "__main__":
    main()
