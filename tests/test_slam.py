"""End-to-end incremental SLAM on synthetic sequences (config[3])."""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_slam.models.slam import (
    SlamConfig,
    evaluate_ate,
    measure_loop_edge,
    run_slam,
)
from sift_slam.sfm.evaluate import (
    absolute_trajectory_error,
    umeyama_alignment,
)
from sift_slam.utils.synthetic import orbit_sequence


def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(40, 3))
    from sift_slam.sfm import geometry as geo

    r = np.asarray(geo.so3_exp(jnp.asarray([0.3, -0.5, 0.2])))
    s, t = 2.5, np.array([1.0, -2.0, 0.5])
    dst = s * src @ r.T + t
    s_e, r_e, t_e = umeyama_alignment(jnp.asarray(src), jnp.asarray(dst))
    assert abs(float(s_e) - s) < 1e-6
    np.testing.assert_allclose(np.asarray(r_e), r, atol=1e-6)
    np.testing.assert_allclose(np.asarray(t_e), t, atol=1e-6)


def test_ate_zero_for_identical_trajectories():
    rng = np.random.default_rng(1)
    seq = orbit_sequence(rng, num_frames=10, num_landmarks=50)
    ate = absolute_trajectory_error(
        jnp.asarray(seq.rotations),
        jnp.asarray(seq.translations),
        jnp.asarray(seq.rotations),
        jnp.asarray(seq.translations),
    )
    assert float(ate) < 1e-6


@pytest.mark.slow
def test_slam_50_keyframes_ate():
    """BASELINE config[3]: 50-keyframe incremental reconstruction.

    ATE bound: 1% of the trajectory radius (8.0) — i.e. 0.08 units —
    on a clean-ish sequence (0.4 px noise, 2% outliers).
    """
    rng = np.random.default_rng(2)
    seq = orbit_sequence(
        rng, num_frames=50, num_landmarks=400, noise_px=0.4, outlier_frac=0.02
    )
    result = run_slam(seq.pixels, seq.visible, seq.k_mat, SlamConfig())
    assert result.landmark_valid.sum() > 200
    ate = evaluate_ate(result, seq.rotations, seq.translations)
    assert ate < 0.08, f"ATE {ate:.4f} exceeds bound"


def test_slam_short_sequence_runs():
    rng = np.random.default_rng(3)
    seq = orbit_sequence(rng, num_frames=8, num_landmarks=150, noise_px=0.3)
    result = run_slam(seq.pixels, seq.visible, seq.k_mat, SlamConfig(ba_interval=3))
    ate = evaluate_ate(result, seq.rotations, seq.translations)
    assert ate < 0.1, f"ATE {ate:.4f}"
    assert result.num_observations > 100


def test_slam_with_pose_graph_step():
    """The pose-graph backend layer runs and does not degrade accuracy."""
    rng = np.random.default_rng(4)
    seq = orbit_sequence(rng, num_frames=12, num_landmarks=200, noise_px=0.3)
    result = run_slam(
        seq.pixels,
        seq.visible,
        seq.k_mat,
        SlamConfig(ba_interval=4, use_pose_graph=True),
    )
    ate = evaluate_ate(result, seq.rotations, seq.translations)
    assert ate < 0.1, f"ATE {ate:.4f}"


def test_loop_edge_measurement_matches_ground_truth():
    """Loop edges are measured, not copied from the estimates.

    measure_loop_edge solves a fresh essential-matrix RANSAC over the
    pair's co-observed pixels; on a near-noiseless sequence the measured
    relative rotation and translation direction must match the
    ground-truth relative pose — independent of whatever trajectory
    estimate supplies the monocular scale.
    """
    rng = np.random.default_rng(7)
    seq = orbit_sequence(rng, num_frames=12, num_landmarks=200, noise_px=0.1)
    a, b = 2, 9
    edge = measure_loop_edge(
        seq.pixels,
        seq.visible,
        seq.k_mat,
        seq.rotations,
        seq.translations,
        a,
        b,
        SlamConfig(),
    )
    assert edge is not None, "loop pair with full covisibility must measure"
    rel_r, rel_t = edge
    gt_r = seq.rotations[b] @ seq.rotations[a].T
    gt_t = seq.translations[b] - gt_r @ seq.translations[a]
    # Rotation error as an angle.
    cos_ang = (np.trace(rel_r @ gt_r.T) - 1.0) / 2.0
    ang_deg = np.degrees(np.arccos(np.clip(cos_ang, -1.0, 1.0)))
    assert ang_deg < 1.0, f"loop rotation off by {ang_deg:.2f} deg"
    # Translation: direction from the images, magnitude from the scale
    # source (here ground truth, so both should match).
    cos_dir = np.dot(rel_t, gt_t) / (
        np.linalg.norm(rel_t) * np.linalg.norm(gt_t)
    )
    assert cos_dir > 0.999, f"loop translation direction cos {cos_dir:.4f}"
    np.testing.assert_allclose(
        np.linalg.norm(rel_t), np.linalg.norm(gt_t), rtol=1e-6
    )


def test_slam_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Kill the SLAM loop mid-sequence, resume, match the full run.

    SURVEY.md §5.4 / VERDICT round-1 item #10: periodic state
    persistence + mid-sequence resume. The interrupted-then-resumed
    trajectory must equal the uninterrupted one exactly (same inputs,
    same numerics, state fully restored).
    """
    rng = np.random.default_rng(5)
    seq = orbit_sequence(rng, num_frames=16, num_landmarks=120, noise_px=0.3)
    cfg = SlamConfig(ba_interval=4)

    full = run_slam(seq.pixels, seq.visible, seq.k_mat, cfg)

    ckpt = str(tmp_path / "slam_ckpt")
    partial = run_slam(
        seq.pixels,
        seq.visible,
        seq.k_mat,
        cfg,
        checkpoint_dir=ckpt,
        checkpoint_interval=3,
        _stop_after=8,
    )
    # The aborted run stops mid-sequence: later frames untouched.
    assert np.all(partial.rotations[12] == 0)

    resumed = run_slam(
        seq.pixels,
        seq.visible,
        seq.k_mat,
        cfg,
        checkpoint_dir=ckpt,
        resume=True,
    )
    np.testing.assert_array_equal(resumed.rotations, full.rotations)
    np.testing.assert_array_equal(resumed.translations, full.translations)
    assert resumed.num_observations == full.num_observations


def test_slam_distributed_mesh_matches_single_device():
    """Composed distributed SLAM (landmark-sharded BA on an 8-device
    mesh) reproduces the single-device trajectory (config[4])."""
    import jax

    from sift_slam.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(6)
    seq = orbit_sequence(rng, num_frames=12, num_landmarks=100, noise_px=0.3)
    cfg = SlamConfig(ba_interval=4)

    single = run_slam(seq.pixels, seq.visible, seq.k_mat, cfg)
    mesh = make_mesh(8)
    dist = run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, mesh=mesh)

    ate_s = evaluate_ate(single, seq.rotations, seq.translations)
    ate_d = evaluate_ate(dist, seq.rotations, seq.translations)
    # Same algorithm, different reduction order: trajectories agree to
    # float tolerance and both meet the accuracy bound.
    np.testing.assert_allclose(
        dist.translations, single.translations, atol=5e-3
    )
    assert abs(ate_s - ate_d) < 1e-3


def test_rpe_protocol_properties():
    """TUM-protocol RPE: zero for identical trajectories, and invariant
    to a global similarity transform of the estimate (relative motions
    are unchanged by a world-frame gauge; the Umeyama scale handles the
    monocular scale factor)."""
    from sift_slam.sfm.evaluate import (
        camera_centers,
        relative_pose_error,
        relative_rotation_error,
    )
    from sift_slam.sfm import geometry as geo

    rng = np.random.default_rng(8)
    seq = orbit_sequence(rng, num_frames=10, num_landmarks=30)
    rots = jnp.asarray(seq.rotations)
    ts = jnp.asarray(seq.translations)
    assert float(relative_pose_error(rots, ts, rots, ts)) < 1e-9
    assert float(relative_rotation_error(rots, rots)) < 1e-6  # arccos ~ sqrt(eps) near 1

    # Global similarity gauge: c' = s·G·c + g, R' = R·Gᵀ.
    g_rot = jnp.asarray(geo.so3_exp(jnp.asarray([0.4, -0.2, 0.7])))
    g_t = jnp.asarray([3.0, -1.0, 2.0])
    s = 2.7
    centers = camera_centers(rots, ts)
    c_new = s * centers @ g_rot.T + g_t
    r_new = rots @ g_rot.T
    t_new = -jnp.einsum("nij,nj->ni", r_new, c_new)
    assert float(relative_pose_error(r_new, t_new, rots, ts)) < 1e-6
    assert float(relative_rotation_error(r_new, rots)) < 1e-6


def test_pose_jump_gate_rejects_catastrophic_frame():
    """A frame whose observations are consistent with a far-away camera
    (the round-4 failure mode: a PnP solution at 1e4-1e5x the median
    step on a bad landmark set) must be rejected by
    ``SlamConfig.pose_jump_gate`` — its pose held, its observations
    kept out of BA — while ``pose_jump_gate=0`` reproduces the
    unguarded behavior (the estimated center lands far away)."""
    from sift_slam.sfm import geometry as geo

    rng = np.random.default_rng(5)
    seq = orbit_sequence(rng, num_frames=16, num_landmarks=250, noise_px=0.2)
    pix = np.array(seq.pixels)
    k = 9
    # Re-project frame k's visible landmarks from a camera displaced by
    # 60 units: a self-consistent but catastrophically wrong view.
    d = np.array([60.0, 0.0, 0.0])
    t_bad = seq.translations[k] - seq.rotations[k] @ d
    cam = seq.points @ seq.rotations[k].T + t_bad
    uv_bad = np.asarray(
        geo.project(jnp.asarray(cam), jnp.asarray(seq.k_mat))
    )
    vis_k = seq.visible[k]
    pix[k, vis_k] = uv_bad[vis_k]

    gated = run_slam(pix, seq.visible, seq.k_mat, SlamConfig(ba_interval=4))
    open_cfg = SlamConfig(ba_interval=4, pose_jump_gate=0.0)
    ungated = run_slam(pix, seq.visible, seq.k_mat, open_cfg)

    def center(res, f):
        return -res.rotations[f].T @ res.translations[f]

    # Ungated: frame k's center jumps toward the displaced camera.
    jump_ungated = np.linalg.norm(center(ungated, k) - center(ungated, k - 1))
    jump_gated = np.linalg.norm(center(gated, k) - center(gated, k - 1))
    assert jump_ungated > 10.0, f"corruption did not bite ({jump_ungated:.2f})"
    assert jump_gated < 2.0, f"gate failed to hold the pose ({jump_gated:.2f})"
    # The held frame sits ~one orbit step (~2.2 units) behind its true
    # pose — the best achievable with its observations corrupted — so
    # assert the damage is contained, not absent: every OTHER frame
    # stays accurate and the global ATE beats the ungated run by a
    # wide margin.
    ate = evaluate_ate(gated, seq.rotations, seq.translations)
    ate_ungated = evaluate_ate(ungated, seq.rotations, seq.translations)
    assert ate < 0.8, f"gated ATE {ate:.4f}"
    assert ate < ate_ungated / 3, f"gated {ate:.3f} vs ungated {ate_ungated:.3f}"


def test_loop_closure_association_merges_tracks():
    """Place recognition across a featureless gap: the same texture
    reappears after 3 blank frames; ``loop_stride`` must merge the
    reappeared keypoints into the original tracks (verified by
    essential RANSAC), giving cross-gap co-observations — without it,
    consecutive+window matching structurally cannot."""
    from sift_slam import SiftConfig
    from sift_slam.models.slam import (
        build_tracks_from_images,
    )
    from sift_slam.ops.gaussian import (
        blur_separable,
    )

    rng = np.random.default_rng(7)
    tex = np.asarray(blur_separable(jnp.asarray(rng.random((200, 200))), 1.2))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    dy, dx = 4, 6
    img0 = tex[dy : dy + 160, dx : dx + 160]
    blank = np.full((160, 160), 0.5)
    img4 = tex[0:160, 0:160]
    images = np.stack([img0, blank, blank, blank, img4]).astype(np.float32)
    k_mat = np.array([[200.0, 0, 80.0], [0, 200.0, 80.0], [0, 0, 1.0]])

    cfg = SiftConfig(num_octaves=2, max_keypoints_per_trio=256)
    kw = dict(k_mat=k_mat, reassoc_window=0, loop_min_gap=3,
              loop_min_matches=8)
    _, vis_off, _ = build_tracks_from_images(images, cfg, loop_stride=0, **kw)
    _, vis_on, _ = build_tracks_from_images(images, cfg, loop_stride=1, **kw)

    assert (vis_off[0] & vis_off[4]).sum() == 0
    merged = (vis_on[0] & vis_on[4]).sum()
    assert merged >= 8, f"only {merged} merged tracks"
    assert vis_on.shape[1] < vis_off.shape[1]  # union-find compacted


def test_loop_closure_sketch_prune_still_merges():
    """Top-K sketch pruning (loop_topk) must keep the true revisit pair.

    11 frames: texture A at frame 0, eight DIFFERENT distractor
    textures, texture A again (shifted) at frame 10. With loop_topk=2
    only 2 of the 8 eligible candidates per query get full descriptor
    matching — the pooled-sketch similarity must rank frame 0 into
    that top-2 for query 10, or the merge is lost."""
    from sift_slam import SiftConfig
    from sift_slam.models.slam import (
        build_tracks_from_images,
    )
    from sift_slam.ops.gaussian import (
        blur_separable,
    )

    rng = np.random.default_rng(11)
    tex = np.asarray(blur_separable(jnp.asarray(rng.random((200, 200))), 1.2))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    img0 = tex[4:164, 6:166]
    img_last = tex[0:160, 0:160]
    frames = [img0]
    for k in range(9):
        d = np.asarray(
            blur_separable(jnp.asarray(rng.random((160, 160))), 2.0)
        )
        d = (d - d.min()) / max(d.max() - d.min(), 1e-9)
        frames.append(d)
    frames.append(img_last)
    images = np.stack(frames).astype(np.float32)
    k_mat = np.array([[200.0, 0, 80.0], [0, 200.0, 80.0], [0, 0, 1.0]])

    cfg = SiftConfig(num_octaves=2, max_keypoints_per_trio=256)
    kw = dict(k_mat=k_mat, reassoc_window=0, loop_min_gap=3,
              loop_min_matches=8, loop_stride=1)
    _, vis_pruned, _ = build_tracks_from_images(
        images, cfg, loop_topk=2, **kw
    )
    merged = (vis_pruned[0] & vis_pruned[10]).sum()
    assert merged >= 8, f"only {merged} merged tracks with topk=2"
