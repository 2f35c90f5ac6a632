"""End-to-end visual SLAM throughput (single chip).

BASELINE.json's end-to-end metric needs a frames/s number for the full
pipeline — images → detect+describe → track → PnP/triangulate → BA —
not just the detection frontend. Renders a synthetic blob-field dolly
sequence (the same generator the visual-SLAM tests use), runs
:func:`run_slam_from_images`, and reports frames/s, ATE, and map size.

Run: ``python benchmarks/slam_bench.py [--frames 40] [--size 640x480]``.

The host-side tracking/geometry glue is part of the measurement on
purpose: it is the production path. The frontend runs batched on
device; BA runs every ``ba_interval`` frames.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

import numpy as np

_RENDER_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".cache",
    "slam_render",
)


def _cached_render(fn, shape_name, seed, num_frames, w, h):
    """Disk-cache rendered sequences (host rendering is ~14 s each)."""
    import os as _os

    key = f"{shape_name}_s{seed}_f{num_frames}_{w}x{h}.npz"
    path = _os.path.join(_RENDER_CACHE_DIR, key)
    if _os.path.exists(path):
        d = np.load(path)
        return d["images"], d["gt_r"], d["gt_t"], d["k_mat"]
    out = fn(np.random.default_rng(seed), num_frames, w, h)
    _os.makedirs(_RENDER_CACHE_DIR, exist_ok=True)
    np.savez(path, images=out[0], gt_r=out[1], gt_t=out[2], k_mat=out[3])
    return out


def render_loop_sequence(rng, num_frames, w, h):
    """Closed-loop out-and-back dolly: A → B → A along the blob field.

    The return leg revisits the outbound viewpoints (offset by half a
    step so frames are not bit-identical), closing the loop at frame
    N-1 ≈ frame 0 — the loop-closure benchmark for ``--loop-stride`` /
    ``--pose-graph``: drift accumulated over the round trip must be
    absorbed when return frames re-associate with outbound landmarks.
    (A camera-orbit variant was tried first and REJECTED as a bench:
    9°/frame of viewpoint change around a shallow field broke tracks
    at length 1-2 — it measured descriptor viewpoint invariance, not
    loop closure.)
    """
    import jax.numpy as jnp  # noqa: F401  (parity with render_sequence)

    from sift_slam.sfm import geometry as geo
    from sift_slam.utils.synthetic import (
        render_blob_image,
        textured_blob_field,
    )

    k_mat = np.array(
        [[260.0 * w / 320, 0, w / 2], [0, 260.0 * w / 320, h / 2], [0, 0, 1.0]]
    )
    half = num_frames // 2
    x_hi = 3.5 + 0.14 * (half + 1)
    n_pts = int(160 * (x_hi + 3.5) / 7.0)
    pts = rng.uniform([-3.5, -1.8, 4.0], [x_hi, 1.8, 9.0], size=(n_pts, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    rots, ts, imgs = [], [], []
    for f in range(num_frames):
        # Outbound f = 0..half; return retraces at the same speed,
        # half-step offset. Gentle yaw wiggle keeps rotation DoF alive.
        x = 0.14 * (f if f <= half else (num_frames - f - 0.5))
        r = np.asarray(
            geo.so3_exp(jnp.asarray([0.0, 0.02 * np.sin(0.5 * f), 0.0]))
        )
        center = np.array([x, 0.0, 0.0])
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def render_orbit_sequence(rng, num_frames, w, h):
    """Orbit-lite: slow arc around the blob field's center.

    ~1.3°/frame of viewpoint change with the camera re-aimed at the
    field center each frame — rotation + translation coupling without
    the 9°/frame viewpoint slew of the rejected full orbit (which
    measured descriptor invariance, not tracking; see
    render_loop_sequence's note).
    """
    import jax.numpy as jnp  # noqa: F401

    from sift_slam.utils.synthetic import (
        render_blob_image,
        textured_blob_field,
    )

    k_mat = np.array(
        [[260.0 * w / 320, 0, w / 2], [0, 260.0 * w / 320, h / 2], [0, 0, 1.0]]
    )
    target = np.array([0.0, 0.0, 6.5])
    pts = rng.uniform([-3.0, -1.8, 4.0], [3.0, 1.8, 9.0], size=(220, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    def look_at(center):
        fwd = target - center
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        return np.stack([right, up, fwd])  # world→camera rows

    rots, ts, imgs = [], [], []
    radius = 6.5
    for f in range(num_frames):
        ang = 0.022 * f  # rad; lateral step ≈ 0.14 (the dolly's speed)
        center = target + radius * np.array(
            [np.sin(ang), 0.02 * np.sin(0.3 * f), -np.cos(ang)]
        )
        r = look_at(center)
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def render_zigzag_sequence(rng, num_frames, w, h):
    """Zigzag dolly: forward advance with alternating lateral sweeps.

    Direction reversals exercise the motion-prior gate and the PnP
    motion-model init (velocity flips sign every ~8 frames)."""
    import jax.numpy as jnp

    from sift_slam.sfm import geometry as geo
    from sift_slam.utils.synthetic import (
        render_blob_image,
        textured_blob_field,
    )

    k_mat = np.array(
        [[260.0 * w / 320, 0, w / 2], [0, 260.0 * w / 320, h / 2], [0, 0, 1.0]]
    )
    x_hi = 3.5 + 0.1 * num_frames
    n_pts = int(160 * (x_hi + 3.5) / 7.0)
    pts = rng.uniform([-3.5, -1.8, 4.0], [x_hi, 1.8, 9.0], size=(n_pts, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    rots, ts, imgs = [], [], []
    for f in range(num_frames):
        r = np.asarray(
            geo.so3_exp(jnp.asarray([0.0, 0.015 * np.sin(0.4 * f), 0.0]))
        )
        center = np.array(
            [0.1 * f, 0.35 * np.sin(0.75 * f), 0.25 * np.sin(0.35 * f)]
        )
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def render_sequence(rng, num_frames, w, h):
    import jax.numpy as jnp

    from sift_slam.sfm import geometry as geo
    from sift_slam.utils.synthetic import (
        render_blob_image,
        textured_blob_field,
    )

    # Same generator family as tests/test_visual_slam.py: textured blob
    # satellites (isotropic blobs alone are rotationally symmetric and
    # mutually identical — the ratio test kills every match), slow
    # lateral dolly.
    k_mat = np.array([[260.0 * w / 320, 0, w / 2], [0, 260.0 * w / 320, h / 2], [0, 0, 1.0]])
    # Blob field extends along the dolly path (+0.14/frame) at constant
    # density: the round-4 trajectory dumps showed the original fixed
    # [-3.5, 3.5] span ran out of the camera's FOV near frame 33 of a
    # 40-frame run — the tail frames were measuring scene exhaustion
    # (tracking loss on an empty field), not tracking quality.
    x_hi = 3.5 + 0.14 * num_frames
    n_pts = int(160 * (x_hi + 3.5) / 7.0)
    pts = rng.uniform([-3.5, -1.8, 4.0], [x_hi, 1.8, 9.0], size=(n_pts, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    rots, ts, imgs = [], [], []
    for f in range(num_frames):
        r = np.asarray(geo.so3_exp(jnp.asarray([0.004 * f, -0.01 * f, 0.002 * f])))
        center = np.array([0.14 * f, 0.01 * f, 0.0])
        t = -r @ center
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (w, h),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--blur", default="separable")
    ap.add_argument(
        "--quality",
        action="store_true",
        help="SiftConfig.quality() detection preset (sigma0 1.6 + "
        "OpenCV-equivalent thresholds; ~3x keypoint density)",
    )
    ap.add_argument(
        "--reassoc",
        type=int,
        default=2,
        help="window re-association depth (measured on this sequence: "
        "ATE 0.41 -> 0.27, landmarks 176 -> 410 at depth 2)",
    )
    ap.add_argument(
        "--match-gate",
        type=float,
        default=None,
        metavar="PX",
        help="motion-prior match gate in pixels (drops long-range "
        "aliased matches; see build_tracks_from_images)",
    )
    ap.add_argument(
        "--describe-compaction",
        type=float,
        default=0.5,
        help="describe-slot compaction fraction (bench sequence "
        "occupancy measured ~55%% of the 0.5 capacity)",
    )
    ap.add_argument(
        "--ba-iters",
        type=int,
        default=6,
        help="LM iterations per windowed BA",
    )
    ap.add_argument(
        "--final-rounds",
        type=int,
        default=2,
        help="final global BA + outlier-prune rounds",
    )
    ap.add_argument(
        "--desc-grid",
        type=int,
        default=16,
        help="descriptor G x G sample grid (12 = ~1.8x cheaper "
        "describe; ATE-gated)",
    )
    ap.add_argument(
        "--chunk",
        type=int,
        default=16,
        help="frontend batch chunk (one compiled shape; bigger chunks "
        "amortize dispatch latency, cost HBM)",
    )
    ap.add_argument(
        "--ba-interval",
        type=int,
        default=5,
        help="tracking window = BA cadence in frames (longer windows "
        "amortize the per-window host round trips over more frames)",
    )
    ap.add_argument(
        "--upright",
        action="store_true",
        help="upright descriptors (skip orientation assignment; "
        "inter-frame rotation on video is << bin width)",
    )
    ap.add_argument(
        "--bootstrap",
        type=int,
        default=1,
        metavar="K",
        help="monocular init pair = frames (0, K); wider = more "
        "parallax (robustness vs the chaotic (0,1) init)",
    )
    ap.add_argument(
        "--f32-upload",
        action="store_true",
        help="upload float32 frames instead of uint16 (A/B the upload path)",
    )
    ap.add_argument(
        "--ba-every",
        type=int,
        default=1,
        help="run windowed BA every N tracking windows "
        "(SlamConfig.ba_every; final window always runs)",
    )
    ap.add_argument(
        "--trajectory",
        choices=("dolly", "loop", "orbit", "zigzag"),
        default="dolly",
        help="dolly = lateral translation (throughput headline); "
        "loop = out-and-back (loop-closure bench); orbit = slow arc "
        "with look-at rotation; zigzag = alternating lateral sweeps",
    )
    ap.add_argument(
        "--suite",
        action="store_true",
        help="robustness matrix: every trajectory shape x --seeds "
        "seeds with the current knob set; per-run rows + "
        "median/worst summary (VERDICT r4 item 3)",
    )
    ap.add_argument(
        "--seeds",
        type=int,
        default=5,
        help="seeds per trajectory shape in --suite mode",
    )
    ap.add_argument(
        "--loop-stride",
        type=int,
        default=0,
        metavar="S",
        help="enable loop-closure data association: match each frame "
        "against every S-th old frame and merge verified tracks "
        "(models/slam.py::build_tracks_from_images)",
    )
    ap.add_argument(
        "--loop-query-stride",
        type=int,
        default=1,
        metavar="Q",
        help="query only every Q-th frame in the loop-closure pass "
        "(merges reconnect whole track chains, so coverage loss is "
        "small at a proportional cost cut)",
    )
    ap.add_argument(
        "--loop-topk",
        type=int,
        default=8,
        metavar="K",
        help="sketch-based place-recognition prune: full descriptor "
        "matching only for each query's K most similar candidates "
        "(one FxF pooled-sketch matmul ranks pairs); 0 = brute force",
    )
    ap.add_argument(
        "--pose-graph",
        action="store_true",
        help="run the measured-loop-edge pose graph before the final BA "
        "(SlamConfig.use_pose_graph)",
    )
    ap.add_argument(
        "--streaming",
        action="store_true",
        help="drive the ONLINE SlamSession (frame-by-frame ingest + "
        "finalize) instead of the batch pipeline; reports per-window "
        "provisional-pose latency alongside throughput",
    )
    ap.add_argument(
        "--breakdown",
        action="store_true",
        help="per-stage wall-clock attribution (syncs at stage "
        "boundaries — slower than the headline run; see utils/profile.py)",
    )
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    from sift_slam import SiftConfig
    from sift_slam.models.slam import (
        SlamConfig,
        evaluate_ate,
        run_slam_from_images,
    )
    from sift_slam.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    renders = {
        "dolly": render_sequence,
        "loop": render_loop_sequence,
        "orbit": render_orbit_sequence,
        "zigzag": render_zigzag_sequence,
    }
    t_render = time.perf_counter()
    render = renders[args.trajectory]
    images, gt_r, gt_t, k_mat = _cached_render(
        render, args.trajectory, 0, args.frames, w, h
    )
    t_render = time.perf_counter() - t_render
    if not args.f32_upload:
        # Ship uint16 frames (device converts /65535 — see
        # models/frontend.py::_as_unit_float), half the bytes of f32;
        # uint8 was measured and REJECTED for this bench (ATE 1.55 vs
        # 0.30 — the synthetic
        # texture's contrast is finer than 8-bit depth; real camera
        # data is uint8-native and loses nothing on that path).
        images = np.round(np.clip(images, 0.0, 1.0) * 65535.0).astype(np.uint16)

    kw_cfg = dict(
        num_octaves=3,
        max_keypoints_per_trio=256,
        upright=args.upright,
        describe_compaction=args.describe_compaction,
        descriptor_grid_size=args.desc_grid,
        orientation_grid_size=args.desc_grid,
    )
    sift_cfg = (
        SiftConfig.quality(**kw_cfg) if args.quality else SiftConfig(**kw_cfg)
    )
    slam_cfg = SlamConfig(
        ba_interval=args.ba_interval,
        ba_window=max(8, args.ba_interval),
        ba_iterations=args.ba_iters,
        final_ba_rounds=args.final_rounds,
        bootstrap_baseline=args.bootstrap,
        use_pose_graph=args.pose_graph,
        ba_every=args.ba_every,
    )
    kw = dict(
        blur=args.blur,
        reassoc_window=args.reassoc,
        max_match_px=args.match_gate,
        frontend_chunk=args.chunk,
        loop_stride=args.loop_stride,
        loop_query_stride=args.loop_query_stride,
        loop_topk=args.loop_topk,
    )

    if args.suite:
        # Robustness matrix (VERDICT r4 item 3): the single-sequence ATE
        # is a point sample of a chaotic quantity (round-5 repro: the
        # SAME code+flags that recorded 0.053 in round 4 measures 0.87
        # today) — knobs are validated against the median/worst over
        # shapes x seeds, never one run. First row per shape carries
        # compile time in its fps; the medians absorb it.
        rows = []
        for shape, rfn in renders.items():
            for seed in range(args.seeds):
                imgs_s, gr, gtt, km = _cached_render(
                    rfn, shape, seed, args.frames, w, h
                )
                if not args.f32_upload:
                    imgs_s = np.round(
                        np.clip(imgs_s, 0.0, 1.0) * 65535.0
                    ).astype(np.uint16)
                t0 = time.perf_counter()
                res = run_slam_from_images(
                    imgs_s, km, sift_cfg, slam_cfg, **kw
                )
                dtr = time.perf_counter() - t0
                ate = evaluate_ate(res, gr, gtt)
                row = {
                    "shape": shape,
                    "seed": seed,
                    "ate": round(float(ate), 4),
                    "fps": round(args.frames / dtr, 2),
                    "lm": int(res.landmark_valid.sum()),
                }
                rows.append(row)
                print(json.dumps(row), flush=True)
        summary = {}
        for shape in renders:
            ates = [r["ate"] for r in rows if r["shape"] == shape]
            fpss = [r["fps"] for r in rows if r["shape"] == shape]
            summary[shape] = {
                "ate_median": round(float(np.median(ates)), 4),
                "ate_worst": round(max(ates), 4),
                "fps_median": round(float(np.median(fpss)), 2),
            }
        all_ates = [r["ate"] for r in rows]
        print(json.dumps({
            "suite": summary,
            "frames": args.frames,
            "image": f"{w}x{h}",
            "seeds": args.seeds,
            "ate_median_all": round(float(np.median(all_ates)), 4),
            "ate_worst_all": round(max(all_ates), 4),
        }))
        return

    if args.streaming:
        from sift_slam.models.streaming import (
            SlamSession,
        )

        def run_streaming():
            sess = SlamSession(
                k_mat, sift_cfg, slam_cfg, blur=args.blur,
                reassoc_window=args.reassoc, max_match_px=args.match_gate,
            )
            lat = []
            for im in images:
                t1 = time.perf_counter()
                upd = sess.add_frame(im)
                if upd is not None:
                    lat.append(time.perf_counter() - t1)
            return sess.finalize(), lat

        t0 = time.perf_counter()
        run_streaming()  # compile pass
        t_compile_pass = time.perf_counter() - t0
        t0 = time.perf_counter()
        result, latencies = run_streaming()
        dt = time.perf_counter() - t0
        ate = evaluate_ate(result, gt_r, gt_t)
        print(json.dumps({
            "mode": "streaming",
            "frames": args.frames,
            "image": f"{w}x{h}",
            "slam_frames_per_s": round(args.frames / dt, 2),
            "total_s": round(dt, 2),
            "ate": round(ate, 4),
            "landmarks": int(result.landmark_valid.sum()),
            "window_step_ms_median": round(
                1e3 * float(np.median(latencies)), 1
            ),
            "window_step_ms_max": round(1e3 * max(latencies), 1),
            "first_pass_s": round(t_compile_pass, 2),
        }))
        return

    # Warm-up pass over the FULL sequence: the pipeline's jit shapes
    # depend on frame count / match caps / BA buckets, so a short-prefix
    # warm-up leaves the timed pass compile-dominated (measured 488 s
    # first pass vs ~10 s steady state at 40 frames). The persistent
    # compilation cache makes this cheap on repeat runs.
    t0 = time.perf_counter()
    run_slam_from_images(images, k_mat, sift_cfg, slam_cfg, **kw)
    t_compile_pass = time.perf_counter() - t0

    prof = None
    if args.breakdown:
        from sift_slam.utils.profile import (
            StageProfile,
        )

        prof = StageProfile()

    t0 = time.perf_counter()
    result = run_slam_from_images(
        images, k_mat, sift_cfg, slam_cfg, profile=prof, **kw
    )
    dt = time.perf_counter() - t0

    ate = evaluate_ate(result, gt_r, gt_t)
    import os

    dump = os.environ.get("SLAM_BENCH_DUMP")
    if dump:
        np.savez(
            dump,
            rotations=np.asarray(result.rotations),
            translations=np.asarray(result.translations),
            gt_r=gt_r,
            gt_t=gt_t,
        )
    out = {
        "frames": args.frames,
        "image": f"{w}x{h}",
        "slam_frames_per_s": round(args.frames / dt, 2),
        "total_s": round(dt, 2),
        "ate": round(ate, 4),
        "landmarks": int(result.landmark_valid.sum()),
        "observations": int(result.num_observations),
        "first_pass_s": round(t_compile_pass, 2),
        "render_s": round(t_render, 2),
    }
    if prof is not None:
        out["breakdown"] = prof.report(total_frames=args.frames)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
