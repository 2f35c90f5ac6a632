"""Dataset evaluation CLI: images → SLAM trajectory → ATE/RPE.

One command runs the full pipeline on a mounted TUM-RGBD or KITTI
odometry directory (BASELINE.json accuracy metric; VERDICT round-1
item #3): native-decode the frames, run visual SLAM
(models/slam.run_slam_from_images — SIFT frontend + descriptor tracks +
PnP + windowed/global BA), Umeyama-align against ground truth
(sfm/evaluate.py), and report ATE/RPE plus an exported TUM-format
trajectory.

Usage:
    python -m sift_slam.evaluate DIR \
        [--format tum|kitti|auto] [--sequence NN] [--max-frames N]
        [--stride K] [--out-traj est.txt] [--octaves N] [--scales N]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sift-slam-evaluate",
        description="Run visual SLAM on a TUM-RGBD/KITTI sequence and report ATE/RPE",
    )
    p.add_argument("root", help="dataset directory (TUM sequence dir or KITTI odometry root)")
    p.add_argument("--format", choices=["tum", "kitti", "auto"], default="auto")
    p.add_argument("--sequence", default="00", help="KITTI sequence id")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--out-traj", default=None, help="write estimated trajectory (TUM format)")
    p.add_argument("--octaves", type=int, default=4)
    p.add_argument("--scales", type=int, default=3)
    p.add_argument("--capacity", type=int, default=512, help="max keypoints per trio")
    p.add_argument("--match-ratio", type=float, default=0.9)
    p.add_argument("--ba-interval", type=int, default=5)
    p.add_argument(
        "--blur", default="separable",
        choices=["exact", "separable", "matmul"],
        help="blur strategy (models/frontend.py::BLUR_STRATEGIES)",
    )
    p.add_argument(
        "--upright", action="store_true",
        help="skip orientation assignment (video: inter-frame rotation "
        "<< bin width; ~2x cheaper describe)",
    )
    p.add_argument(
        "--match-gate", type=float, default=None, metavar="PX",
        help="motion-prior match gate in px/frame",
    )
    p.add_argument(
        "--reassoc", type=int, default=0,
        help="window re-association depth",
    )
    p.add_argument(
        "--bootstrap", type=int, default=1,
        help="monocular init pair = frames (0, K); wider = more parallax",
    )
    p.add_argument(
        "--ba-every", type=int, default=1,
        help="windowed BA every N tracking windows",
    )
    p.add_argument(
        "--loop-topk", type=int, default=8,
        help="place-recognition prune: full matching only for each "
        "query's K most sketch-similar candidates (0 = brute force)",
    )
    p.add_argument(
        "--loop-stride", type=int, default=0,
        help="loop-closure data association against every S-th old frame "
        "(0 = off; price O(F^2/stride))",
    )
    p.add_argument(
        "--pose-graph", action="store_true",
        help="measured-loop-edge pose graph before the final BA",
    )
    p.add_argument(
        "--no-pad",
        action="store_true",
        help="skip aligned edge padding of the frames (core/image.py)",
    )
    return p


def detect_format(root: str) -> str:
    if os.path.exists(os.path.join(root, "rgb.txt")):
        return "tum"
    if os.path.isdir(os.path.join(root, "sequences")):
        return "kitti"
    raise SystemExit(
        f"{root}: neither a TUM sequence dir (rgb.txt) nor a KITTI root (sequences/)"
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    fmt = args.format if args.format != "auto" else detect_format(args.root)

    from .data import kitti, tum, write_tum_trajectory

    t0 = time.perf_counter()
    if fmt == "tum":
        seq = tum.load_tum_sequence(
            args.root, max_frames=args.max_frames, stride=args.stride
        )
    else:
        seq = kitti.load_kitti_sequence(
            args.root,
            sequence=args.sequence,
            max_frames=args.max_frames,
            stride=args.stride,
        )
    images = seq.load_images()
    t_load = time.perf_counter() - t0
    orig_hw = images.shape[1:3]
    if not args.no_pad:
        # Real dataset dims (KITTI 1241x376) are unaligned (see
        # pad_to_aligned); bottom/right edge padding is transparent to the blur
        # (clamp-to-edge border rule) and to the intrinsics.
        from .core.image import pad_to_aligned

        images = pad_to_aligned(images)
    print(
        f"{fmt}: {len(seq.image_paths)} frames "
        f"{orig_hw[1]}x{orig_hw[0]}"
        + (
            f" (padded to {images.shape[2]}x{images.shape[1]})"
            if images.shape[1:3] != orig_hw
            else ""
        )
        + f", loaded in {t_load:.2f}s"
    )

    from . import SiftConfig
    from .models.slam import SlamConfig, run_slam_from_images

    sift_cfg = SiftConfig(
        num_octaves=args.octaves,
        scales_per_octave=args.scales,
        max_keypoints_per_trio=args.capacity,
        upright=args.upright,
    )
    slam_cfg = SlamConfig(
        ba_interval=args.ba_interval,
        bootstrap_baseline=args.bootstrap,
        ba_every=args.ba_every,
        use_pose_graph=args.pose_graph,
    )

    t1 = time.perf_counter()
    result = run_slam_from_images(
        images,
        np.asarray(seq.k_mat),
        sift_cfg,
        slam_cfg,
        match_ratio=args.match_ratio,
        blur=args.blur,
        reassoc_window=args.reassoc,
        max_match_px=args.match_gate,
        loop_stride=args.loop_stride,
        loop_topk=args.loop_topk,
    )
    t_slam = time.perf_counter() - t1
    fps = len(seq.image_paths) / t_slam
    print(f"slam: {t_slam:.2f}s ({fps:.2f} frames/s), "
          f"{int(result.landmark_valid.sum())} landmarks, "
          f"{result.num_observations} observations")

    metrics = {
        "format": fmt,
        "frames": len(seq.image_paths),
        "slam_frames_per_s": round(fps, 3),
        "landmarks": int(result.landmark_valid.sum()),
    }
    if seq.gt_rotations is not None:
        import jax.numpy as jnp

        from .sfm.evaluate import (
            absolute_trajectory_error,
            relative_pose_error,
            relative_rotation_error,
        )

        ate = float(
            absolute_trajectory_error(
                jnp.asarray(result.rotations),
                jnp.asarray(result.translations),
                jnp.asarray(seq.gt_rotations),
                jnp.asarray(seq.gt_translations),
            )
        )
        rpe = float(
            relative_pose_error(
                jnp.asarray(result.rotations),
                jnp.asarray(result.translations),
                jnp.asarray(seq.gt_rotations),
                jnp.asarray(seq.gt_translations),
            )
        )
        rre = float(
            relative_rotation_error(
                jnp.asarray(result.rotations),
                jnp.asarray(seq.gt_rotations),
            )
        )
        metrics["ate_rmse"] = round(ate, 6)
        metrics["rpe_trans_rmse"] = round(rpe, 6)
        metrics["rpe_rot_rmse_deg"] = round(np.degrees(rre), 4)
        print(
            f"ATE RMSE: {ate:.4f}  RPE trans RMSE: {rpe:.4f} (gt units)  "
            f"RPE rot RMSE: {np.degrees(rre):.3f} deg"
        )
    else:
        print("no ground truth available; skipping ATE/RPE")

    if args.out_traj:
        write_tum_trajectory(
            args.out_traj,
            seq.timestamps,
            result.rotations,
            result.translations,
        )
        print(f"trajectory → {args.out_traj}")

    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
