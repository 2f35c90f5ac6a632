"""Command-line interface: the framework's answer to the reference UI.

The reference drives its pipeline from a browser page with canvas
galleries (reference/main.js, index.html — SURVEY.md L4). Here the same
user journey is a CLI: point it at an image, get the Gaussian/DoG
galleries, candidate markers, refined-keypoint overlay, and a keypoints
JSON — plus per-stage timing and the reference's accept/reject counters
(mirroring the console.log taxonomy, background.js:581-672).

Usage:
    python -m sift_slam.cli IMAGE [-o OUTDIR]
        [--octaves N] [--scales N] [--float64] [--blur STRATEGY]
        [--descriptors] [--no-galleries]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sift-slam",
        description="SIFT scale-space extrema detection in JAX",
    )
    p.add_argument("image", help="input image (any PIL-readable format)")
    p.add_argument("-o", "--outdir", default="sift_out", help="output directory")
    p.add_argument("--octaves", type=int, default=5)
    p.add_argument("--scales", type=int, default=3, help="scales per octave")
    p.add_argument(
        "--blur",
        default="separable",
        choices=["exact", "separable", "matmul"],
        help="blur strategy (models/frontend.py::BLUR_STRATEGIES)",
    )
    p.add_argument(
        "--float64",
        action="store_true",
        help="CPU float64 (reference bit-parity mode)",
    )
    p.add_argument(
        "--descriptors",
        action="store_true",
        help="also compute orientations + 128-D descriptors",
    )
    p.add_argument(
        "--no-galleries",
        action="store_true",
        help="skip PNG gallery dumps (keypoints JSON only)",
    )
    p.add_argument("--capacity", type=int, default=1024, help="max keypoints per trio")
    p.add_argument(
        "--quality",
        action="store_true",
        help="SiftConfig.quality() detection preset: standard-SIFT "
        "sigma0 1.6 + OpenCV-equivalent thresholds (~3x keypoint "
        "density; a documented divergence from reference parity)",
    )
    p.add_argument(
        "--verbose",
        action="store_true",
        help="log every candidate's accept/reject decision "
        "(mirrors the reference's console.log, background.js:581-672)",
    )
    p.add_argument(
        "--platform",
        default="default",
        choices=["default", "cpu", "gpu"],
        help="force a JAX backend (overrides JAX_PLATFORMS)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    if args.float64:
        jax.config.update("jax_enable_x64", True)
    if args.platform != "default":
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from . import SiftConfig
    from .core.image import load_image_gray
    from .core.types import REJECT_REASON_NAMES
    from .models import frontend
    from .utils import visualize as vis

    dtype = np.float64 if args.float64 else np.float32
    gray = load_image_gray(args.image, dtype=dtype)
    print(f"loaded {args.image}: {gray.shape[1]}x{gray.shape[0]}")

    cfg_kw = dict(
        num_octaves=args.octaves,
        scales_per_octave=args.scales,
        max_keypoints_per_trio=args.capacity,
    )
    cfg = SiftConfig.quality(**cfg_kw) if args.quality else SiftConfig(**cfg_kw)
    os.makedirs(args.outdir, exist_ok=True)
    image = jnp.asarray(gray)

    t0 = time.perf_counter()
    scale_space = frontend.build_scale_space(image, cfg, args.blur)
    dog = frontend.build_dog(scale_space)
    keypoints, extrema = frontend.detect_from_dog(dog, cfg)
    described = None
    if args.descriptors:
        # Reuse the refined keypoints from detect_from_dog: re-running
        # extrema+refinement per octave here once doubled detection work.
        from .ops.descriptor import concat_described, describe_octave

        parts = []
        offset = 0
        for octave, stack in enumerate(scale_space):
            cap = cfg.refine_capacity(octave)
            seg = slice(offset, offset + cap)
            # Keypoints is a pytree: one tree.map slices every field
            # (and keeps tracking the dataclass if fields are added).
            kp_octave = jax.tree.map(lambda a: a[seg], keypoints)
            parts.append(describe_octave(stack, kp_octave, octave, cfg))
            offset += cap
        described = concat_described(parts)
        # The headline timing must include descriptor work too —
        # blocking only on keypoints let the describe kernels run past
        # the clock.
        jax.block_until_ready(described)
    jax.block_until_ready(keypoints)
    n_valid = int(np.asarray(jnp.sum(keypoints.valid)))
    t1 = time.perf_counter()
    print(f"pipeline: {1e3 * (t1 - t0):.1f} ms ({jax.default_backend()}), "
          f"{n_valid} keypoints")

    # Rejection taxonomy (reference console.log categories, SURVEY §5.5).
    counts = np.asarray(keypoints.reject_counts())
    for name, c in zip(REJECT_REASON_NAMES, counts):
        print(f"  {name}: {int(c)}")

    if args.verbose:
        # Per-candidate decision log (reference/background.js:581, :602,
        # :615, :648-663, :672). Keypoint slots per octave are aligned
        # with the refine input = compact_extrema(e, refine_capacity),
        # so each slot's initial candidate identity comes from there.
        from .ops.extrema import compact_extrema

        kp_reason = np.asarray(keypoints.reject_reason)
        kp_valid = np.asarray(keypoints.valid)
        kp_ax = np.asarray(keypoints.abs_x)
        kp_ay = np.asarray(keypoints.abs_y)
        kp_sigma = np.asarray(keypoints.abs_sigma)
        offset = 0
        for octave, e in enumerate(extrema):
            cap = cfg.refine_capacity(octave)
            sel = compact_extrema(e, cap)
            sy = np.asarray(sel.y)
            sx = np.asarray(sel.x)
            ss = np.asarray(sel.scale_level)
            sv = np.asarray(sel.valid)
            for i in range(cap):
                if not sv[i]:
                    continue
                slot = offset + i
                reason = REJECT_REASON_NAMES[int(kp_reason[slot])]
                line = (
                    f"  octave {octave} scale {int(ss[i])} "
                    f"(x={int(sx[i])}, y={int(sy[i])}): {reason}"
                )
                if kp_valid[slot]:
                    line += (
                        f" -> abs=({float(kp_ax[slot]):.2f}, "
                        f"{float(kp_ay[slot]):.2f}) "
                        f"sigma={float(kp_sigma[slot]):.3f}"
                    )
                print(line)
            offset += cap

    # Keypoints JSON with the reference record schema
    # (reference/background.js:619-628).
    valid = np.asarray(keypoints.valid)
    records = [
        {
            "octave": int(o),
            "scaleLevel": int(s),
            "localX": int(lx),
            "localY": int(ly),
            "absoluteSigma": float(sg),
            "absoluteX": float(ax),
            "absoluteY": float(ay),
            "interpolatedValue": float(v),
        }
        for o, s, lx, ly, sg, ax, ay, v in zip(
            np.asarray(keypoints.octave)[valid],
            np.asarray(keypoints.scale_level)[valid],
            np.asarray(keypoints.local_x)[valid],
            np.asarray(keypoints.local_y)[valid],
            np.asarray(keypoints.abs_sigma)[valid],
            np.asarray(keypoints.abs_x)[valid],
            np.asarray(keypoints.abs_y)[valid],
            np.asarray(keypoints.value)[valid],
        )
    ]
    with open(os.path.join(args.outdir, "keypoints.json"), "w") as f:
        json.dump({"keypoints": records, "rejectionCounts": {
            name: int(c) for name, c in zip(REJECT_REASON_NAMES, counts)
        }}, f, indent=1)

    if described is not None:
        dv = np.asarray(described.valid)
        np.savez(
            os.path.join(args.outdir, "descriptors.npz"),
            descriptor=np.asarray(described.descriptor)[dv],
            theta=np.asarray(described.theta)[dv],
            abs_x=np.asarray(described.abs_x)[dv],
            abs_y=np.asarray(described.abs_y)[dv],
            abs_sigma=np.asarray(described.abs_sigma)[dv],
        )
        print(f"descriptors: {int(dv.sum())} → descriptors.npz")

    if not args.no_galleries:
        for o, stack in enumerate(scale_space):
            vis.save_png(
                os.path.join(args.outdir, f"gaussian_octave{o}.png"),
                vis.gallery_image(np.asarray(stack)),
            )
        for o, d in enumerate(dog):
            vis.save_png(
                os.path.join(args.outdir, f"dog_octave{o}.png"),
                vis.gallery_image(np.asarray(d), normalize="sigmoid"),
            )
        # Candidate-marker galleries: yellow = candidates, translucent
        # red = low-contrast pre-filter rejects, painted onto each
        # octave's base image like the reference's third gallery
        # (reference/main.js:315-319, background.js:408-421).
        from .ops.extrema import find_low_contrast_extrema

        for o, (stack, d) in enumerate(zip(scale_space, dog)):
            low = find_low_contrast_extrema(d, cfg, cfg.keypoints_per_trio(o))
            marks = []
            for e, is_low in ((extrema[o], False), (low, True)):
                ev = np.asarray(e.valid)
                for y, x in zip(np.asarray(e.y)[ev], np.asarray(e.x)[ev]):
                    marks.append((int(y), int(x), is_low))
            vis.save_png(
                os.path.join(args.outdir, f"candidates_octave{o}.png"),
                vis.draw_candidate_markers(np.asarray(stack[0]), marks),
            )
        overlay = vis.draw_keypoints(np.asarray(gray, np.float64), keypoints)
        vis.save_png(os.path.join(args.outdir, "keypoints.png"), overlay)
        print(f"galleries + candidate markers + overlay → {args.outdir}/")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
