"""Bundle-adjustment throughput benchmark (single chip).

Measures LM iterations/s of the Schur-complement BA on a synthetic
multi-view problem at SLAM scale, with a per-stage breakdown (normal
equation assembly vs reduced solve) and a FLOP model reported against
measured time. Run::

    python benchmarks/ba_bench.py [--cams N] [--pts N] [--solver dense|cg]
    python benchmarks/ba_bench.py --large     # 1000 cams x 100k landmarks, CG

The ``--large`` config is the scale the dense coupling ``W (C, L, 6, 3)``
could never hold (7+ GB at C=10^3, L=10^5); the matrix-free CG solver
runs it in O(observations) memory.
"""

from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def make_problem(rng, c, l, opc, dtype=np.float32):
    import jax.numpy as jnp

    from sift_slam.sfm import geometry as geo
    from sift_slam.sfm.ba import (
        BAState,
        Observations,
    )

    # Camera ring orbiting the cloud (bounded poses at ANY camera count —
    # the earlier open-ended track walked cameras 100 units away at
    # c=1000, putting most points at tiny/negative depth and making the
    # problem unsolvable by construction). Observations keep only
    # positive-depth points so every residual is well-posed.
    pts = rng.uniform([-4, -4, -4], [4, 4, 4], size=(l, 3)).astype(dtype)
    k_mat = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype)
    radius = 12.0

    rots, ts, cams, lms, uvs = [], [], [], [], []
    for ci in range(c):
        ang = 2.0 * np.pi * ci / max(c, 1)
        r = np.asarray(geo.so3_exp(jnp.asarray([0.0, ang, 0.0])), dtype)
        center = radius * np.array([np.sin(ang), 0.1 * np.sin(3 * ang), -np.cos(ang)])
        t = (-r @ center).astype(dtype)
        depths = pts @ r.T[:, 2] + t[2]
        front = np.where(depths > 2.0)[0]
        sel = rng.choice(front, opc, replace=len(front) < opc)
        xc = pts[sel] @ r.T + t
        uv = xc[:, :2] / xc[:, 2:3] * 500.0 + [320, 240]
        uv += 0.5 * rng.normal(size=uv.shape)
        rots.append(r)
        ts.append(t)
        cams.append(np.full(opc, ci))
        lms.append(sel)
        uvs.append(uv)

    state = BAState(
        rotations=jnp.asarray(np.stack(rots), dtype),
        translations=jnp.asarray(np.stack(ts), dtype),
        points=jnp.asarray(pts + 0.05 * rng.normal(size=pts.shape).astype(dtype)),
        k_mat=jnp.asarray(k_mat),
    )
    obs = Observations(
        camera=jnp.asarray(np.concatenate(cams), jnp.int32),
        landmark=jnp.asarray(np.concatenate(lms), jnp.int32),
        uv=jnp.asarray(np.concatenate(uvs).astype(dtype)),
        valid=jnp.ones(c * opc, bool),
    )
    return state, obs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--pts", type=int, default=4096)
    ap.add_argument("--obs-per-cam", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--solver", choices=["dense", "cg"], default="dense")
    ap.add_argument("--cg-iters", type=int, default=32)
    ap.add_argument(
        "--large",
        action="store_true",
        help="1000 cams x 100k landmarks x 300k obs with the CG solver",
    )
    ap.add_argument(
        "--breakdown", action="store_true", help="per-stage timing (dense)"
    )
    ap.add_argument(
        "--assembly",
        choices=["sorted", "scatter"],
        default="sorted",
        help="dense-path landmark-side assembly (A/B; see sfm/ba.py)",
    )
    args = ap.parse_args()
    if args.large:
        args.cams, args.pts, args.obs_per_cam = 1000, 100_000, 300
        args.solver = "cg"

    import jax
    import jax.numpy as jnp

    from sift_slam.sfm.ba import (
        bundle_adjust,
        shard_schur_pieces,
        solve_reduced,
    )
    from sift_slam.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(0)
    c, l, opc = args.cams, args.pts, args.obs_per_cam
    state, obs = make_problem(rng, c, l, opc)
    n_obs = c * opc

    run = lambda: bundle_adjust(  # noqa: E731
        state,
        obs,
        num_iterations=args.iters,
        solver=args.solver,
        cg_iterations=args.cg_iters,
        assembly=args.assembly,
    )
    for _ in range(2):  # compile, then one run to settle the allocator
        jax.block_until_ready(run())

    t0 = time.perf_counter()
    out, cost = jax.block_until_ready(run())
    dt = time.perf_counter() - t0
    final = float(cost)

    print(
        f"BA[{args.solver}] {c} cams x {l} pts x {n_obs} obs: "
        f"{args.iters / dt:.2f} LM iters/s "
        f"({1e3 * dt / args.iters:.1f} ms/iter, final cost {final:.1f})"
    )

    if args.solver == "dense":
        # Dense-path FLOP model: Schur einsums dominate.
        flops_iter = 2 * c * l * 6 * 3 * 3 + 2 * c * c * l * 6 * 6 * 3
    else:
        # CG-path model: per CG iteration, the implicit S·x is
        # ~ 4 matvecs over observations (2x (2,6)·6 + 2x (2,3)·3) plus
        # the (L,3,3) H_ll^-1 apply; LM adds assembly (~54 n_obs).
        per_cg = n_obs * 2 * (2 * 6 * 2 + 2 * 3 * 2) + l * 2 * 9
        flops_iter = args.cg_iters * per_cg + n_obs * 2 * (36 + 18 + 12)
    print(
        f"FLOP model: {flops_iter / 1e9:.2f} GFLOP/iter -> "
        f"{flops_iter * args.iters / dt / 1e12:.3f} TFLOP/s achieved"
    )

    if args.breakdown and args.solver == "dense":
        lam = jnp.asarray(1e-4, state.points.dtype)

        reps = 10

        def sustained(thunk):
            jax.block_until_ready(thunk())  # warm-up
            t0 = time.perf_counter()
            outs = [thunk() for _ in range(reps)]
            jax.block_until_ready(outs)
            return (time.perf_counter() - t0) / reps

        assemble = jax.jit(
            lambda st, ob: shard_schur_pieces(
                st.rotations, st.translations, st.k_mat, st.points,
                ob.camera, ob.landmark, ob.uv, ob.valid, lam, c,
            )
        )
        pieces = assemble(state, obs)
        t_asm = sustained(lambda: assemble(state, obs))

        solve = jax.jit(
            lambda p: solve_reduced(p.h_cc, p.b_c, p.s_off, p.rhs_off, lam, 1)
        )
        t_slv = sustained(lambda: solve(pieces))
        print(
            f"breakdown: assembly+schur {1e3 * t_asm:.2f} ms, "
            f"reduced solve {1e3 * t_slv:.2f} ms "
            f"(LM overhead = {1e3 * (dt / args.iters - t_asm - t_slv):.2f} ms)"
        )


if __name__ == "__main__":
    main()
