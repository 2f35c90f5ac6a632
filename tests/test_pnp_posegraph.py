"""PnP and pose-graph optimization tests."""

import numpy as np
import jax.numpy as jnp

from sift_slam.sfm import geometry as geo
from sift_slam.sfm.pnp import pnp_dlt, solve_pnp
from sift_slam.sfm.pose_graph import (
    PoseGraphEdges,
    optimize_pose_graph,
    pose_graph_residuals,
)

K = jnp.asarray([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])


def _pnp_problem(rng, n=64, noise_px=0.5, outlier_frac=0.0):
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n, 3))
    r_true = np.asarray(geo.so3_exp(jnp.asarray([0.1, -0.25, 0.05])))
    t_true = np.array([0.3, -0.2, 0.5])
    xc = pts @ r_true.T + t_true
    uv = (xc[:, :2] / xc[:, 2:3]) * 500.0 + [320, 240]
    uv += noise_px * rng.normal(size=uv.shape)
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] += rng.uniform(30, 120, size=(n_out, 2))
    return (
        jnp.asarray(pts),
        jnp.asarray(uv),
        r_true,
        t_true,
    )


def _rot_err_deg(r_est, r_true):
    rr = np.asarray(r_est) @ r_true.T
    return float(np.degrees(np.arccos(np.clip((np.trace(rr) - 1) / 2, -1, 1))))


def test_pnp_dlt_clean():
    rng = np.random.default_rng(0)
    pts, uv, r_true, t_true = _pnp_problem(rng, noise_px=0.0)
    r, t = pnp_dlt(pts, uv, jnp.ones(pts.shape[0], bool), K)
    assert _rot_err_deg(r, r_true) < 0.1
    np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-3)


def test_pnp_refine_from_dlt_with_noise():
    rng = np.random.default_rng(1)
    pts, uv, r_true, t_true = _pnp_problem(rng, noise_px=0.5)
    valid = jnp.ones(pts.shape[0], bool)
    r0, t0 = pnp_dlt(pts, uv, valid, K)
    r, t, rms = solve_pnp(pts, uv, valid, K, r0, t0)
    assert _rot_err_deg(r, r_true) < 0.2
    np.testing.assert_allclose(np.asarray(t), t_true, atol=0.01)
    assert float(rms) < 1.5


def test_pnp_robust_to_outliers():
    rng = np.random.default_rng(2)
    pts, uv, r_true, t_true = _pnp_problem(rng, noise_px=0.5, outlier_frac=0.2)
    valid = jnp.ones(pts.shape[0], bool)
    # Init from a perturbed truth (sequential-SLAM motion-model setting).
    r0 = jnp.asarray(geo.so3_exp(jnp.asarray([0.03, -0.02, 0.01]))) @ jnp.asarray(r_true)
    t0 = jnp.asarray(t_true + np.array([0.1, -0.05, 0.1]))
    r, t, rms = solve_pnp(pts, uv, valid, K, r0, t0, huber_delta=2.0)
    assert _rot_err_deg(r, r_true) < 0.5
    np.testing.assert_allclose(np.asarray(t), t_true, atol=0.03)


def test_pnp_respects_validity():
    rng = np.random.default_rng(3)
    pts, uv, r_true, t_true = _pnp_problem(rng, noise_px=0.0)
    # Garbage in the masked-out tail must not change the result.
    uv2 = np.array(uv)
    uv2[-16:] += 500.0
    valid = jnp.asarray(np.arange(pts.shape[0]) < pts.shape[0] - 16)
    r0, t0 = pnp_dlt(pts, jnp.asarray(uv2), valid, K)
    r, t, rms = solve_pnp(pts, jnp.asarray(uv2), valid, K, r0, t0)
    assert _rot_err_deg(r, r_true) < 0.1
    assert float(rms) < 1e-2


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------


def _circle_graph(rng, n=12, drift=0.03):
    """Odometry chain around a circle + loop-closure edge 0→n-1."""
    rots, ts = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        r = np.asarray(geo.so3_exp(jnp.asarray([0.0, ang, 0.0])))
        c = np.array([np.cos(ang) * 5, 0.0, np.sin(ang) * 5])
        rots.append(r)
        ts.append(-r @ c)
    rots = np.stack(rots)
    ts = np.stack(ts)

    # True relative transforms for consecutive edges + the closure.
    src = np.array(list(range(n - 1)) + [n - 1])
    dst = np.array(list(range(1, n)) + [0])
    rel_r, rel_t = [], []
    for s, d in zip(src, dst):
        # T_d = T_rel ∘ T_s  →  T_rel = T_d ∘ T_s⁻¹
        rs_inv, ts_inv = np.asarray(rots[s]).T, -np.asarray(rots[s]).T @ ts[s]
        rr = rots[d] @ rs_inv
        rt = rots[d] @ ts_inv + ts[d]
        rel_r.append(rr)
        rel_t.append(rt)

    edges = PoseGraphEdges(
        src=jnp.asarray(src, jnp.int32),
        dst=jnp.asarray(dst, jnp.int32),
        rel_rotation=jnp.asarray(np.stack(rel_r)),
        rel_translation=jnp.asarray(np.stack(rel_t)),
        weight=jnp.ones(len(src)),
    )

    # Drifted initial estimates: accumulate noisy odometry.
    est_r, est_t = [rots[0]], [ts[0]]
    for i in range(1, n):
        dr = np.asarray(geo.so3_exp(jnp.asarray(drift * rng.normal(size=3))))
        est_r.append(dr @ rots[i])
        est_t.append(ts[i] + drift * 5 * rng.normal(size=3))
    return rots, ts, np.stack(est_r), np.stack(est_t), edges


def test_pose_graph_zero_residual_at_truth():
    rng = np.random.default_rng(4)
    rots, ts, _, _, edges = _circle_graph(rng)
    r = pose_graph_residuals(jnp.asarray(rots), jnp.asarray(ts), edges)
    assert float(jnp.abs(r).max()) < 1e-8


def test_pose_graph_corrects_drift():
    rng = np.random.default_rng(5)
    rots, ts, est_r, est_t, edges = _circle_graph(rng)
    r0 = pose_graph_residuals(jnp.asarray(est_r), jnp.asarray(est_t), edges)
    cost0 = float(jnp.sum(r0 * r0))
    opt_r, opt_t, cost = optimize_pose_graph(
        jnp.asarray(est_r), jnp.asarray(est_t), edges
    )
    assert float(cost) < 1e-10 * max(cost0, 1.0) + 1e-10
    # Poses match ground truth (gauge = node 0 = truth here).
    for i in range(len(rots)):
        assert _rot_err_deg(opt_r[i], rots[i]) < 0.01
    np.testing.assert_allclose(np.asarray(opt_t), ts, atol=1e-4)


def test_pose_graph_zero_weight_edges_ignored():
    rng = np.random.default_rng(6)
    rots, ts, est_r, est_t, edges = _circle_graph(rng)
    # Append a garbage edge with weight 0.
    bad = PoseGraphEdges(
        src=jnp.concatenate([edges.src, jnp.asarray([0], jnp.int32)]),
        dst=jnp.concatenate([edges.dst, jnp.asarray([5], jnp.int32)]),
        rel_rotation=jnp.concatenate(
            [edges.rel_rotation, jnp.eye(3)[None]]
        ),
        rel_translation=jnp.concatenate(
            [edges.rel_translation, jnp.asarray([[99.0, 99.0, 99.0]])]
        ),
        weight=jnp.concatenate([edges.weight, jnp.asarray([0.0])]),
    )
    opt_r, opt_t, cost = optimize_pose_graph(
        jnp.asarray(est_r), jnp.asarray(est_t), bad
    )
    np.testing.assert_allclose(np.asarray(opt_t), ts, atol=1e-4)


def test_pnp_dlt_offset_scene_float32():
    """DLT must survive a scene far from the origin in float32.

    Unnormalized DLT columns span X, 1, and x·X magnitudes; at world
    coordinates ~1e2 the float32 conditioning destroys the nullspace
    solve (round-2 review finding). The Hartley-style point
    normalization makes this work.
    """
    rng = np.random.default_rng(7)
    pts, uv, r_true, t_true = _pnp_problem(rng, noise_px=0.0)
    offset = np.array([120.0, -80.0, 250.0])
    pts_off = np.asarray(pts) + offset
    # Same pixels ↔ camera must compensate: X' = X + o ⇒ t' = t − R·o.
    t_adj = t_true - r_true @ offset
    r, t = pnp_dlt(
        jnp.asarray(pts_off, jnp.float32),
        jnp.asarray(uv, jnp.float32),
        jnp.ones(pts.shape[0], bool),
        K.astype(jnp.float32),
    )
    assert _rot_err_deg(r, r_true) < 0.5
    np.testing.assert_allclose(np.asarray(t), t_adj, rtol=2e-3, atol=5e-3)
