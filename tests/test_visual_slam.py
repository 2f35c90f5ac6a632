"""Full visual SLAM from rendered images (frontend + backend composed)."""

import numpy as np
import jax.numpy as jnp

from sift_slam import SiftConfig
from sift_slam.models.slam import (
    SlamConfig,
    evaluate_ate,
    run_slam_from_images,
)
from sift_slam.sfm import geometry as geo
from sift_slam.utils.synthetic import (
    render_blob_image,
    textured_blob_field,
)


def _render_sequence(rng, num_frames=8, w=320, h=240):
    """Slow lateral dolly past a textured blob field."""
    k_mat = np.array([[260.0, 0, w / 2], [0, 260.0, h / 2], [0, 0, 1.0]])
    pts = rng.uniform([-3.5, -1.8, 4.0], [3.5, 1.8, 9.0], size=(110, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    rots, ts, imgs = [], [], []
    for f in range(num_frames):
        w_vec = jnp.asarray([0.004 * f, -0.01 * f, 0.002 * f])
        r = np.asarray(geo.so3_exp(w_vec))
        center = np.array([0.28 * f, 0.02 * f, 0.0])
        t = -r @ center
        img = render_blob_image(
            rpts, r, t, k_mat, (w, h),
            amplitudes=amps, sigma_scales=ss,
            rng=np.random.default_rng(100 + f),
        )
        rots.append(r)
        ts.append(t)
        imgs.append(img)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def test_visual_slam_end_to_end():
    rng = np.random.default_rng(0)
    images, gt_r, gt_t, k_mat = _render_sequence(rng)

    sift_cfg = SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    result = run_slam_from_images(
        images, k_mat, sift_cfg, SlamConfig(ba_interval=3, ba_window=6)
    )
    assert result.landmark_valid.sum() > 20
    ate = evaluate_ate(result, gt_r, gt_t)
    # Pixel-level keypoints on synthetic blob texture, monocular
    # scale-aligned: ~3% of the ~2-unit trajectory extent.
    assert ate < 0.06, f"ATE {ate:.4f}" 


def test_window_reassociation_reacquires_lost_tracks():
    """A track lost in a blank middle frame is re-acquired from the
    2-frame window, and lands on the RIGHT keypoints.

    Frame 2 views the frame-0 texture shifted by (dx, dy) pixels, so
    keypoint slot order differs between the frames — a src/dst swap in
    the re-association wiring (the round-2 review finding) would attach
    re-acquired tracks to the wrong keypoints and scatter the per-track
    pixel offsets; correct wiring gives every shared track the same
    (dx, dy) offset.
    """
    from sift_slam.models.slam import (
        build_tracks_from_images,
    )
    from sift_slam.ops.gaussian import (
        blur_separable,
    )

    rng = np.random.default_rng(3)
    tex = np.asarray(blur_separable(jnp.asarray(rng.random((160, 160))), 1.5))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    dy, dx = 5, 3
    img0 = tex[dy : dy + 128, dx : dx + 128]
    img1 = np.full((128, 128), 0.5)  # featureless: every track dies here
    img2 = tex[0:128, 0:128]
    images = np.stack([img0, img1, img2]).astype(np.float32)

    cfg = SiftConfig(num_octaves=2, max_keypoints_per_trio=256)
    pixels, visible, _ = build_tracks_from_images(
        images, cfg, k_mat=None, reassoc_window=2
    )
    shared = visible[0] & visible[2] & ~visible[1]
    assert shared.sum() >= 5, f"only {shared.sum()} re-acquired tracks"
    offsets = pixels[2, shared] - pixels[0, shared]
    # Every re-acquired track must show the same content shift (the
    # texture moved by (+dx, +dy) from frame 0's crop to frame 2's).
    np.testing.assert_allclose(
        np.median(offsets, axis=0), [dx, dy], atol=0.5
    )
    spread = np.abs(offsets - [dx, dy]).max()
    assert spread < 1.0, f"re-associated offsets scattered by {spread:.2f}px"


def test_build_tracks_short_sequence_on_mesh_matches_single_device():
    """A sequence shorter than one mesh chunk must not crash on batch
    divisibility (round-2 review finding: the first chunk went to the
    data-parallel frontend unpadded) and must reproduce the
    single-device tracks."""
    import jax
    import pytest

    from sift_slam.models.slam import (
        build_tracks_from_images,
    )
    from sift_slam.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(4)
    images, _, _, k_mat = _render_sequence(rng, num_frames=6, w=96, h=64)
    cfg = SiftConfig(num_octaves=2, max_keypoints_per_trio=128)

    single = build_tracks_from_images(images, cfg, k_mat=k_mat)
    mesh = make_mesh(8)
    dist = build_tracks_from_images(images, cfg, k_mat=k_mat, mesh=mesh)
    assert dist[0].shape == single[0].shape
    np.testing.assert_array_equal(dist[1], single[1])
    np.testing.assert_allclose(dist[0], single[0], atol=1e-5)


def test_relocalization_after_blackout_via_loop_association():
    """Kidnapped-camera recovery, emergent from loop association: the
    camera dollies away, the view blacks out, and the camera reappears
    near the start. Without place recognition the reappeared frames
    hold the pre-blackout pose (wrong by the full dolly distance);
    with ``loop_stride`` their keypoints merge into the original
    tracks, the windowed PnP localizes them against the bootstrap-era
    map, and the poses land near the true (start-adjacent) location."""
    from sift_slam.models.slam import (
        build_tracks_from_images,
        run_slam,
    )

    rng = np.random.default_rng(9)
    k_mat = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    pts = rng.uniform([-3.5, -1.8, 4.0], [6.0, 1.8, 9.0], size=(140, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)

    xs_path = [0.0, 0.3, 0.6, 0.9, 1.2, 1.5, None, None, 0.15, 0.35]
    imgs, gt_centers = [], []
    for f, x in enumerate(xs_path):
        if x is None:  # blackout
            imgs.append(np.full((240, 320), 0.5))
            gt_centers.append(None)
            continue
        r = np.eye(3)
        t = -r @ np.array([x, 0.0, 0.0])
        imgs.append(
            render_blob_image(
                rpts, r, t, k_mat, (320, 240),
                amplitudes=amps, sigma_scales=ss,
                rng=np.random.default_rng(100 + f),
            )
        )
        gt_centers.append(np.array([x, 0.0, 0.0]))
    images = np.stack(imgs).astype(np.float32)

    sift_cfg = SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    slam_cfg = SlamConfig(ba_interval=3, ba_window=6, bootstrap_baseline=2)

    def centers(loop_stride):
        pixels, visible, _ = build_tracks_from_images(
            images, sift_cfg, k_mat=k_mat, reassoc_window=1,
            loop_stride=loop_stride, loop_min_gap=3, loop_min_matches=8,
        )
        res = run_slam(pixels, visible, k_mat, slam_cfg)
        return -np.einsum("nji,nj->ni", res.rotations, res.translations)

    c_loop = centers(1)
    c_none = centers(0)
    # Monocular gauge: normalize by the estimated frame-0→5 distance so
    # errors are in dolly-path units.
    scale = np.linalg.norm(c_loop[5] - c_loop[0]) / 1.5
    err_loop = np.linalg.norm(c_loop[8] / scale - gt_centers[8])
    scale_n = np.linalg.norm(c_none[5] - c_none[0]) / 1.5
    err_none = np.linalg.norm(c_none[8] / scale_n - gt_centers[8])
    assert err_none > 0.7, f"blackout did not strand the pose ({err_none:.2f})"
    assert err_loop < 0.4, f"relocalization failed ({err_loop:.2f})"


def test_streaming_session_matches_batch():
    """Online mode: frame-by-frame ingest through ``SlamSession`` must
    reproduce the batch pipeline's trajectory quality on the same
    sequence (same matcher/verifier dispatches, same backend driven
    through checkpoint/resume), emitting a provisional update per
    filled window."""
    from sift_slam.models.streaming import (
        SlamSession,
    )

    rng = np.random.default_rng(12)
    images, gt_r, gt_t, k_mat = _render_sequence(rng, num_frames=10)

    sift_cfg = SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    slam_cfg = SlamConfig(
        ba_interval=3, ba_window=6, bootstrap_baseline=2
    )
    batch = run_slam_from_images(
        images, k_mat, sift_cfg, slam_cfg, reassoc_window=2
    )
    ate_batch = evaluate_ate(batch, gt_r, gt_t)

    sess = SlamSession(
        k_mat, sift_cfg, slam_cfg, blur="separable", reassoc_window=2
    )
    updates = [sess.add_frame(im) for im in images]
    n_updates = sum(u is not None for u in updates)
    # Steps land on the backend's window grid: frames 4, 7, 10.
    assert n_updates == 3, f"{n_updates} provisional updates"
    # Provisional results cover all processed frames and are finite.
    last = [u for u in updates if u is not None][-1]
    assert last.rotations.shape[0] == 10
    assert np.isfinite(last.translations).all()

    result = sess.finalize()
    assert sess.frames_processed == 10
    ate_stream = evaluate_ate(result, gt_r, gt_t)
    # The two paths build IDENTICAL tracks, and since the round-5
    # ba_every fix pinned the windowed-BA cadence to the GLOBAL window
    # grid (models/slam.py: win_index from the grid origin, final BA
    # only at the true final window), the backend runs the same
    # programs in the same order — measured gap 0.0000 on this
    # sequence. The 0.02 headroom covers landmark-axis pow2-bucket
    # reduction-order noise on intermediate windows (streaming grows
    # its track capacity per resume; the round-4 bound was 0.15).
    assert ate_stream < 0.35, f"stream ATE {ate_stream:.4f}"
    assert ate_batch < 0.35, f"batch ATE {ate_batch:.4f}"
    assert abs(ate_stream - ate_batch) < 0.02, (
        f"stream {ate_stream:.4f} vs batch {ate_batch:.4f}"
    )
