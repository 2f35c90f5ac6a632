"""Smoke test on the GPU: the main path once, each phase checked.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py [--seed N]    # one card: device, detect,
                                       # describe, slam, ba
    python chip_smoke.py --devices 4   # four cards: data-parallel
                                       # frontend and landmark-sharded
                                       # BA, each against one card

Every phase drives the system through its normal entry points at a size
users run, and checks what comes out against a plain reference: the
same code on JAX's CPU device in float32, in this process (a second
process on the card would find its memory already reserved), or the
ground truth of a synthetic sequence. Inputs are generated from
``--seed``. A failed check raises, so the script exits non-zero; the
device phase refuses to run anywhere but on a GPU. The last line of
standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

# Card vs CPU float32 keypoints. Both devices run the same float32
# program, but XLA sums blur taps and reductions in another order on
# each (differences of ~3e-7 in the DoG), so a candidate whose contrast
# or extremum test sits within rounding of its threshold can flip. A
# slot agrees unless it holds a keypoint the other device lacks;
# keypoints are paired by identity, not by buffer position, because
# compaction packs candidates in order and one flipped candidate would
# shift every later slot of its octave. These bounds allow one slot in
# a thousand and sub-0.1 px drift, far below what a precision bug (TF32
# or bf16 products) produces.
MIN_SLOT_AGREEMENT = 0.999  # 1 - unpaired keypoints / slots
MAX_P99_POSITION_PX = 0.1  # over matched keypoints
MIN_DESCRIPTOR_COS = 0.999  # lowest cosine over matched keypoints
MATCH_GATE_PX = 1.0  # a pair further apart is two different keypoints
MATCH_GATE_RAD = 0.05  # orientations of one keypoint's copies differ more
# Absolute trajectory error on the 40-frame sequence, batch and
# streaming: the bound tests/test_visual_slam.py asserts for both modes.
MAX_ATE = 0.35
SLAM_MATCH_GATE_PX = 60.0  # per 640 px of frame width
# Final LM cost, card vs CPU. Both solves take the same accept/reject
# decisions while each cost change has a clear sign; their float32 sums
# over ~25k residuals differ only in order (~1e-6 relative), and near
# convergence the cost is flat, so a slightly different step moves it
# far less than this.
BA_COST_RTOL = 1e-3


class CheckFailed(AssertionError):
    """A phase's output missed its reference."""


def check(name: str, ok: bool, detail: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {detail}")


def _fields(tree, names) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in names}


def _match_frame(got: dict, ref: dict) -> tuple[np.ndarray, np.ndarray]:
    """Mutual-nearest pairs ``(i, j)`` of one frame's valid keypoints:
    same octave and scale level, orientation within MATCH_GATE_RAD,
    positions within MATCH_GATE_PX."""
    same = (got["octave"][:, None] == ref["octave"][None]) & (
        got["scale_level"][:, None] == ref["scale_level"][None]
    )
    if "theta" in got:
        dth = np.angle(np.exp(1j * (got["theta"][:, None] - ref["theta"][None])))
        same &= np.abs(dth) < MATCH_GATE_RAD
    d = np.hypot(
        got["abs_x"][:, None] - ref["abs_x"][None],
        got["abs_y"][:, None] - ref["abs_y"][None],
    )
    d = np.where(same & (d <= MATCH_GATE_PX), d, np.inf)
    if not d.size:
        return np.zeros(0, int), np.zeros(0, int)
    i = np.arange(d.shape[0])
    j = np.argmin(d, axis=1)
    ok = np.isfinite(d[i, j]) & (np.argmin(d, axis=0)[j] == i)
    return i[ok], j[ok]


def compare_keypoints(got: dict, ref: dict) -> dict:
    """Agreement of two batches of keypoint buffers, keypoint by keypoint.

    ``got``/``ref`` map ``valid``, ``octave``, ``scale_level``, ``abs_x``,
    ``abs_y`` (and optionally ``theta`` and ``descriptor``) to arrays of
    shape ``(frames, slots[, 128])``, or ``(slots[, 128])`` for one
    frame. Within each frame, valid keypoints are paired by
    :func:`_match_frame`. Returns the share of slots that agree (a slot
    disagrees when it holds a keypoint without a partner), the 99th
    percentile position difference over pairs, the counts, and, with
    descriptors, the lowest cosine between paired descriptors.
    """
    if got["valid"].ndim == 1:
        got = {k: v[None] for k, v in got.items()}
        ref = {k: v[None] for k, v in ref.items()}
    n_matched = n_all = 0
    dists, coss = [], []
    for f in range(got["valid"].shape[0]):
        g = {k: v[f][got["valid"][f]] for k, v in got.items() if k != "valid"}
        r = {k: v[f][ref["valid"][f]] for k, v in ref.items() if k != "valid"}
        i, j = _match_frame(g, r)
        n_matched += len(i)
        n_all += len(g["abs_x"]) + len(r["abs_x"]) - len(i)
        dists.append(
            np.hypot(g["abs_x"][i] - r["abs_x"][j], g["abs_y"][i] - r["abs_y"][j])
        )
        if "descriptor" in g:
            a, b = g["descriptor"][i], r["descriptor"][j]
            coss.append(
                np.sum(a * b, -1)
                / np.maximum(
                    np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12
                )
            )
    d = np.concatenate(dists)
    slots = max(got["valid"].size, ref["valid"].size)
    out = {
        "slot_agreement": 1.0 - (n_all - n_matched) / slots,
        "p99_position_px": float(np.percentile(d, 99)) if d.size else 0.0,
        "n_matched": n_matched,
        "n_unmatched": n_all - n_matched,
    }
    if coss:
        cos = np.concatenate(coss)
        out["descriptor_min_cos"] = float(cos.min()) if cos.size else 1.0
    return out


def check_keypoints(stats: dict) -> None:
    check(
        "keypoints found on both devices", stats["n_matched"] > 0,
        f"{stats['n_matched']} matched, {stats['n_unmatched']} unmatched",
    )
    check(
        "slot agreement",
        stats["slot_agreement"] >= MIN_SLOT_AGREEMENT,
        f"{stats['slot_agreement']:.6f} (bound >= {MIN_SLOT_AGREEMENT})",
    )
    check(
        "p99 position error",
        stats["p99_position_px"] < MAX_P99_POSITION_PX,
        f"{stats['p99_position_px']:.3g} px (bound < {MAX_P99_POSITION_PX})",
    )
    if "descriptor_min_cos" in stats:
        check(
            "descriptor min cosine",
            stats["descriptor_min_cos"] > MIN_DESCRIPTOR_COS,
            f"{stats['descriptor_min_cos']:.6f} (bound > {MIN_DESCRIPTOR_COS})",
        )


def _on(device, fn, *arrays):
    """``fn(*arrays)`` with the arrays and every constant on ``device``."""
    import jax

    with jax.default_device(device):
        return fn(*(jax.device_put(a, device) for a in arrays))


def phase_detect(device, ref_device, seed, batch=64, h=480, w=640, n_ref=8):
    """Batched detection (bench config) vs the CPU on the first frames."""
    import jax

    from sift_slam import SiftConfig, detect_batched_jit
    from sift_slam.utils.synthetic import blob_frames

    cfg = SiftConfig(
        num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512
    )
    images = blob_frames(batch, h, w, seed=seed)
    run = lambda x: detect_batched_jit(x, cfg)[0]  # noqa: E731
    x = jax.device_put(images, device)
    kp = jax.block_until_ready(run(x))  # compile
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        kp = jax.block_until_ready(run(x))
        times.append(time.perf_counter() - t0)
    ref = _on(ref_device, run, images[:n_ref])
    names = ("valid", "octave", "scale_level", "abs_x", "abs_y")
    got = {k: v[:n_ref] for k, v in _fields(kp, names).items()}
    stats = compare_keypoints(got, _fields(ref, names))
    stats["median_s"] = statistics.median(times)
    stats["keypoints_per_frame"] = float(np.asarray(kp.valid).sum() / batch)
    return stats


def phase_describe(device, ref_device, seed, batch=16, h=480, w=640, cfg=None):
    """Detect+describe (default config) vs the CPU, every frame."""
    from sift_slam import SiftConfig, detect_and_describe_batched_jit
    from sift_slam.utils.synthetic import textured_frames

    cfg = SiftConfig() if cfg is None else cfg
    images = textured_frames(batch, h, w, seed=seed)
    run = lambda x: detect_and_describe_batched_jit(x, cfg)  # noqa: E731
    names = (
        "valid", "octave", "scale_level", "abs_x", "abs_y", "theta",
        "descriptor",
    )
    got = _fields(_on(device, run, images), names)
    ref = _fields(_on(ref_device, run, images), names)
    return compare_keypoints(got, ref)


def phase_slam(seed, frames=40, w=640, h=480):
    """Batch and streaming SLAM on a rendered dolly; ATE vs ground truth.

    Runs on JAX's default device. Returns ``(ate_batch, ate_stream)``.
    """
    from benchmarks.slam_bench import render_sequence
    from sift_slam import SiftConfig
    from sift_slam.models.slam import (
        SlamConfig,
        evaluate_ate,
        run_slam_from_images,
    )
    from sift_slam.models.streaming import SlamSession

    images, gt_r, gt_t, k_mat = render_sequence(
        np.random.default_rng(seed), frames, w, h
    )
    # uint16 transport, as the SLAM benchmark ships frames.
    images = np.round(np.clip(images, 0.0, 1.0) * 65535.0).astype(np.uint16)
    # The SLAM benchmark's tuned settings for video: upright descriptors
    # (inter-frame rotation is far below a histogram bin), a 3-frame
    # bootstrap baseline, windowed BA every second window, and the
    # motion-prior match gate, which drops the long-range aliased
    # matches the synthetic blob texture produces. With the plain
    # defaults this sequence tracks poorly on CPU and GPU alike (ATE
    # 1.2-1.6 at seeds 0-2).
    sift_cfg = SiftConfig(
        num_octaves=3, max_keypoints_per_trio=256, upright=True
    )
    slam_cfg = SlamConfig(
        ba_interval=5, ba_window=8, ba_iterations=6, bootstrap_baseline=3,
        ba_every=2, final_ba_rounds=1,
    )
    kw = dict(reassoc_window=2, max_match_px=SLAM_MATCH_GATE_PX * w / 640)
    batch = run_slam_from_images(images, k_mat, sift_cfg, slam_cfg, **kw)
    sess = SlamSession(k_mat, sift_cfg, slam_cfg, **kw)
    for im in images:
        sess.add_frame(im)
    stream = sess.finalize()
    return evaluate_ate(batch, gt_r, gt_t), evaluate_ate(stream, gt_r, gt_t)


def _ba_problem(seed, cams, landmarks, obs_per_cam, ref_device):
    """``(state, obs, initial cost)``; the cost is taken on ``ref_device``."""
    from benchmarks.ba_bench import make_problem
    from sift_slam.sfm.ba import huber_cost, reprojection_residuals

    state, obs = make_problem(
        np.random.default_rng(seed), cams, landmarks, obs_per_cam
    )
    initial = _on(
        ref_device,
        lambda s, o: huber_cost(reprojection_residuals(s, o), None),
        state,
        obs,
    )
    return state, obs, float(initial)


def phase_ba(device, ref_device, seed, cams=50, landmarks=4096,
             obs_per_cam=512, iterations=5):
    """Dense LM bundle adjustment; final cost vs the CPU solve."""
    from sift_slam.sfm.ba import bundle_adjust

    state, obs, initial = _ba_problem(
        seed, cams, landmarks, obs_per_cam, ref_device
    )

    def solve(dev):
        solved = _on(
            dev,
            lambda s, o: bundle_adjust(s, o, num_iterations=iterations),
            state,
            obs,
        )
        return float(solved[1])

    return {"initial": initial, "gpu": solve(device), "cpu": solve(ref_device)}


def phase_multi(n_devices, seed, batch=64, h=480, w=640, cfg=None, cams=50,
                landmarks=4096, obs_per_cam=512, iterations=5):
    """Data-parallel frontend and landmark-sharded BA over ``n_devices``,
    each against the same work on the first device alone."""
    import jax

    from sift_slam import SiftConfig, detect_and_describe_batched_jit
    from sift_slam.parallel import (
        detect_and_describe_data_parallel,
        distributed_bundle_adjust,
        make_mesh,
    )
    from sift_slam.sfm.ba import bundle_adjust
    from sift_slam.utils.synthetic import textured_frames

    mesh = make_mesh(n_devices)
    first = jax.devices()[0]
    cfg = SiftConfig() if cfg is None else cfg
    images = textured_frames(batch, h, w, seed=seed)
    names = (
        "valid", "octave", "scale_level", "abs_x", "abs_y", "theta",
        "descriptor",
    )
    many = _fields(detect_and_describe_data_parallel(images, cfg, mesh), names)
    one = _fields(
        _on(first, lambda x: detect_and_describe_batched_jit(x, cfg), images),
        names,
    )
    frontend = compare_keypoints(many, one)

    state, obs, initial = _ba_problem(
        seed, cams, landmarks, obs_per_cam, first
    )
    cost_many = float(
        distributed_bundle_adjust(state, obs, mesh, num_iterations=iterations)[1]
    )
    cost_one = float(bundle_adjust(state, obs, num_iterations=iterations)[1])
    return frontend, {
        "initial": initial, "sharded": cost_many, "single": cost_one,
    }


def check_ba(name: str, cost: float, ref: float, initial: float) -> None:
    rel = abs(cost - ref) / abs(ref)
    check(
        name,
        np.isfinite(cost) and cost < initial and rel <= BA_COST_RTOL,
        f"final cost {cost!r} vs {ref!r}, relative difference {rel:.3g} "
        f"(bound <= {BA_COST_RTOL}); initial cost {initial!r}",
    )


def result_line(device, count: int) -> str:
    """The script's last line: the device that passed, as JAX reports it."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": device.platform,
                "kind": device.device_kind,
                "count": count,
            },
        }
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--devices",
        type=int,
        choices=(1, 4),
        default=1,
        help="4: run only the four-card phase and its one-card comparison",
    )
    args = ap.parse_args(argv)

    # The CPU reference runs in this process beside the card.
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    from sift_slam.utils.compile_cache import enable_compile_cache
    from sift_slam.utils.device import gpu_name_and_power_limit, require_gpu

    # --- device ---------------------------------------------------------
    dev = require_gpu()
    cpu = jax.devices("cpu")[0]
    enable_compile_cache()
    card = gpu_name_and_power_limit()
    print(
        f"device: {dev.device_kind}, {len(jax.devices())} device(s), "
        f"jax {jax.__version__}"
    )
    print(f"nvidia-smi: {card}", flush=True)

    if args.devices == 4:
        print(f"[multi] {args.devices} GPUs vs one, 64 x 480x640", flush=True)
        frontend, ba = phase_multi(args.devices, args.seed)
        check_keypoints(frontend)
        check_ba("sharded BA cost", ba["sharded"], ba["single"], ba["initial"])
        print(result_line(dev, len(jax.devices())))
        return 0

    t0 = time.perf_counter()
    print("[detect] 64 x 480x640, 4 octaves x 5 scales", flush=True)
    stats = phase_detect(dev, cpu, args.seed)
    check_keypoints(stats)
    print(
        f"  median of 3 runs {1e3 * stats['median_s']:.2f} ms/batch "
        f"({64 / stats['median_s']:.1f} frames/s, "
        f"{stats['keypoints_per_frame']:.1f} keypoints/frame) on {card} "
        "(informational)",
        flush=True,
    )

    print("[describe] 16 x 480x640, default SiftConfig", flush=True)
    check_keypoints(phase_describe(dev, cpu, args.seed))

    print("[slam] 40 x 640x480 dolly, batch and streaming", flush=True)
    ate_batch, ate_stream = phase_slam(args.seed)
    for name, ate in (("batch ATE", ate_batch), ("streaming ATE", ate_stream)):
        check(name, bool(np.isfinite(ate) and ate < MAX_ATE),
              f"{ate:.4f} (bound < {MAX_ATE})")

    print("[ba] dense LM, 50 cameras x 4096 landmarks x 25.6k obs", flush=True)
    ba = phase_ba(dev, cpu, args.seed)
    check_ba("BA cost vs CPU", ba["gpu"], ba["cpu"], ba["initial"])

    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(result_line(dev, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
