"""Incremental SfM / SLAM driver (BASELINE.json configs[3-4]).

Monocular pipeline over a sequence of per-frame landmark measurements:

1. **Bootstrap** — RANSAC essential matrix between the first two frames,
   pose recovery, midpoint triangulation of the common landmarks (scale
   gauge: unit baseline).
2. **Tracking** — each new frame is localized against the current map by
   robust PnP (motion-model init from the previous pose), then landmarks
   that became two-view-observable are triangulated into the map.
3. **Windowed BA** — every ``ba_interval`` frames, Schur-complement
   bundle adjustment refines the trailing window (older poses frozen);
   a final global BA refines everything (first pose fixed, Huber robust).

Orchestration runs on the host (the per-frame loop is inherently
sequential); all numerics (RANSAC, PnP, triangulation, BA) are the
jitted device kernels from ops/ and sfm/. Map and observation buffers
are padded to capacity buckets so jit recompiles stay bounded.

Data association is an input (per-frame ``(landmark_id, pixel)``
pairs): with the synthetic generator it is exact; with the image
frontend it comes from descriptor matching (ops/matching.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.precision import full_precision
from ..sfm import geometry as geo
from ..sfm.ba import BAState, Observations, bundle_adjust
from ..sfm.evaluate import absolute_trajectory_error
from ..sfm.pnp import solve_pnp
from ..ops.matching import match_descriptors
from ..ops.ransac import estimate_essential_ransac


@dataclasses.dataclass
class SlamConfig:
    ba_interval: int = 5  # run windowed BA every N frames
    ba_window: int = 8  # trailing keyframes optimized in windowed BA
    ba_iterations: int = 6
    final_ba_iterations: int = 15
    final_ba_rounds: int = 2  # BA+prune rounds (2nd re-solves after prune)
    huber_px: float = 2.0
    pnp_iterations: int = 10
    ransac_hypotheses: int = 256
    ransac_threshold_px: float = 1.5
    min_triangulation_deg: float = 1.0  # parallax gate for new landmarks
    # Pose-graph step before the final BA: odometry edges between
    # consecutive frames plus loop-closure edges between distant frame
    # pairs that co-observe enough landmarks. Loop edges are MEASURED —
    # a fresh essential-matrix RANSAC over the pair's co-observed pixels
    # (see measure_loop_edge), independent of the drifting estimates
    # except for the monocular scale. Redundant when global BA is
    # affordable (our default), decisive when it is not — kept as the
    # standard SLAM backend layer (BASELINE.json config[4]).
    use_pose_graph: bool = False
    loop_min_covisible: int = 12
    loop_min_frame_gap: int = 5
    loop_max_edges: int = 16  # highest-covisibility pairs get fresh solves
    # Monocular bootstrap pair = frames (0, bootstrap_baseline). 1 =
    # consecutive (round-3 behavior). Wider baselines give
    # proportionally more parallax to the essential-matrix init — the
    # round-4 robustness probe showed the (0,1) init is chaotically
    # sensitive on slow dolly motion: input perturbations at the 1e-5
    # level (uint16 vs f32 image transport) flipped the bench ATE
    # 0.30 <-> 1.58 via a different init inlier set and scale. Frames
    # 1..k-1 are localized by the normal windowed PnP against the
    # bootstrap map (tracks must survive k consecutive matches to enter
    # the init set — an additional robustness filter).
    bootstrap_baseline: int = 1
    # Catastrophic-pose gate (standard SLAM tracking sanity check): a
    # windowed-PnP pose whose camera-center step exceeds
    # ``pose_jump_gate`` x the rolling median inter-frame step is
    # rejected — the frame holds the previous pose (the existing
    # lost-tracking fallback) and records no observations, so a garbage
    # pose can neither enter BA nor poison later triangulations. The
    # round-4 trajectory dumps showed the ATE-1.58 bench mode was
    # exactly this: 3 frames at 1e4-1e5x the median step (a PnP local
    # minimum on a depleted landmark set) dominating the Umeyama
    # alignment, while every other frame tracked cleanly. Scale-free
    # (ratio of estimated steps), so it needs no metric prior. 0
    # disables.
    pose_jump_gate: float = 25.0
    # Minimum landmark count before BA is dispatched through the
    # landmark-sharded distributed solver on a mesh (see run_slam._ba).
    dist_ba_min_landmarks: int = 4096
    # Run the windowed BA every N tracking windows (1 = every window).
    # Decouples BA cadence from the tracking-window length: windows
    # stay short (fresh PnP inits, prompt triangulation) while BA —
    # the single largest backend dispatch — runs half as often at 2.
    # The final window always runs BA.
    ba_every: int = 1


@dataclasses.dataclass
class SlamResult:
    rotations: np.ndarray  # (F, 3, 3) estimated world→camera
    translations: np.ndarray  # (F, 3)
    points: np.ndarray  # (L, 3) map landmarks (NaN where never seen)
    landmark_valid: np.ndarray  # (L,) bool
    num_observations: int


def _prof_iter(iterable, st, name):
    """Wrap each loop-body execution of ``iterable`` in a profile stage.

    The ``with`` around ``yield`` times from just before the yield until
    control re-enters the generator — exactly the caller's loop body.
    """
    for item in iterable:
        with st(name):
            yield item


def _sorted_pad(lm: np.ndarray, valid: np.ndarray | None = None) -> int:
    """Power-of-two bound on max valid observations per landmark.

    Passed as ``bundle_adjust(sorted_pad=...)`` so the sorted assembly's
    padded gather is sized to the data instead of the ``num_cameras``
    hard bound (which for the final BA is the whole trajectory length).
    Power-of-two bucketing bounds recompiles.
    """
    if valid is not None:
        lm = lm[valid]
    if len(lm) == 0:
        return 1
    m = int(np.bincount(lm).max())
    return 1 << max(0, (m - 1).bit_length())


def _pad_obs(cam, lm, uv, valid):
    """Pad observation buffers to the next power-of-two bucket."""
    n = len(cam)
    bucket = 1 << max(8, (n - 1).bit_length())
    pad = bucket - n
    return Observations(
        camera=jnp.asarray(np.pad(cam, (0, pad)), jnp.int32),
        landmark=jnp.asarray(np.pad(lm, (0, pad)), jnp.int32),
        uv=jnp.asarray(np.pad(uv, ((0, pad), (0, 0)))),
        valid=jnp.asarray(np.pad(valid, (0, pad))),
    )


def measure_loop_edge(
    pixels: np.ndarray,
    visible: np.ndarray,
    k_mat: np.ndarray,
    est_r: np.ndarray,
    est_t: np.ndarray,
    frame_a: int,
    frame_b: int,
    cfg: SlamConfig,
):
    """Fresh two-view relative-pose measurement for a loop edge a→b.

    Real loop closure re-measures the relative pose of the revisit pair
    instead of copying it from the drifted estimates: essential-matrix
    RANSAC over the pair's co-observed pixel rays yields the relative
    rotation and translation *direction* independently of the trajectory
    estimate; only the monocular scale (unobservable from two views) is
    borrowed from the current estimate's baseline. Returns
    ``(rel_r (3,3), rel_t (3,))`` in the pose-graph edge convention
    (``T_b ≈ T_ab ∘ T_a`` for world→camera poses), or ``None`` when the
    pair has too few co-observations or RANSAC support.
    """
    ids = np.where(visible[frame_a] & visible[frame_b])[0]
    min_pts = max(8, cfg.loop_min_covisible)
    if len(ids) < min_pts:
        return None
    k_jnp = jnp.asarray(k_mat)
    fx = float(k_mat[0, 0])
    rays_a = np.asarray(geo.backproject(jnp.asarray(pixels[frame_a, ids]), k_jnp))
    rays_b = np.asarray(geo.backproject(jnp.asarray(pixels[frame_b, ids]), k_jnp))
    cap = 1 << max(6, (len(ids) - 1).bit_length())
    pad = cap - len(ids)
    res = estimate_essential_ransac(
        jnp.asarray(np.pad(rays_a, ((0, pad), (0, 0))), jnp.float32),
        jnp.asarray(np.pad(rays_b, ((0, pad), (0, 0))), jnp.float32),
        jnp.asarray(np.arange(cap) < len(ids)),
        jax.random.PRNGKey(frame_a * 100_003 + frame_b),
        num_hypotheses=cfg.ransac_hypotheses,
        inlier_threshold=cfg.ransac_threshold_px / fx,
    )
    if int(res.num_inliers) < min_pts // 2:
        return None
    rel_r = np.asarray(res.rotation, np.float64)
    t_dir = np.asarray(res.translation, np.float64)
    # Monocular two-view geometry fixes only the translation direction
    # (cheirality fixes its sign); the scale comes from the estimated
    # baseline of the pair — the one quantity a loop edge cannot measure.
    rel_t_est = est_t[frame_b] - (est_r[frame_b] @ est_r[frame_a].T) @ est_t[frame_a]
    return rel_r, t_dir * float(np.linalg.norm(rel_t_est))


@full_precision
def run_slam(
    pixels: np.ndarray,
    visible: np.ndarray,
    k_mat: np.ndarray,
    cfg: SlamConfig | None = None,
    mesh=None,
    checkpoint_dir: str | None = None,
    checkpoint_interval: int = 10,
    resume: bool = False,
    _stop_after: int | None = None,
    profile=None,
) -> SlamResult:
    """Run incremental SLAM over per-frame measurements.

    ``pixels``: (F, L, 2) pixel measurement of landmark l in frame f;
    ``visible``: (F, L) bool association mask. Landmark ids are global
    (as descriptor-track ids would be after matching).

    ``mesh``: a ``jax.sharding.Mesh`` routes every bundle adjustment
    through the landmark-sharded distributed solver
    (parallel/distributed.py — BASELINE.json config[4]); ``None`` runs
    single-device BA. ``checkpoint_dir`` enables periodic persistence of
    the full SLAM state (poses, map, observations) every
    ``checkpoint_interval`` frames; ``resume=True`` restores the latest
    checkpoint and continues mid-sequence (SURVEY.md §5.4).
    ``_stop_after`` aborts after processing that frame index (fault
    injection for the resume tests); the final BA is skipped for a
    stopped run. ``profile``: an optional
    :class:`~..utils.profile.StageProfile` that records per-stage
    wall-clock (syncing at stage boundaries — attribution mode, slower
    than production).
    """
    cfg = cfg or SlamConfig()
    from contextlib import nullcontext

    def _st(name):
        return profile.stage(name) if profile is not None else nullcontext()

    def _sync(val):
        if profile is not None:
            profile.sync(val)
    num_frames, num_landmarks = visible.shape
    k_jnp = jnp.asarray(k_mat)
    fx = k_mat[0, 0]

    def _ba(state, obs, num_iterations, num_fixed_cameras, sorted_pad=0):
        # Shard the landmark block only when it is big enough to pay
        # for the Schur psum: below ``dist_ba_min_landmarks`` the
        # collective latency exceeds the sharded compute (composed
        # 8-virtual-device SLAM measured 0.47x overall with every tiny
        # windowed BA forced through the distributed path; the
        # realistic-size BA scaling row in scaling_bench keeps the
        # sharded solver honest at 32k landmarks). Standard practice:
        # shard what is large, replicate what is small.
        if mesh is not None and state.points.shape[0] >= cfg.dist_ba_min_landmarks:
            from ..parallel.distributed import distributed_bundle_adjust

            return distributed_bundle_adjust(
                state,
                obs,
                mesh,
                num_iterations=num_iterations,
                num_fixed_cameras=num_fixed_cameras,
                huber_delta=cfg.huber_px,
            )
        return bundle_adjust(
            state,
            obs,
            num_iterations=num_iterations,
            num_fixed_cameras=num_fixed_cameras,
            huber_delta=cfg.huber_px,
            sorted_pad=sorted_pad,
        )

    est_r = np.zeros((num_frames, 3, 3))
    est_t = np.zeros((num_frames, 3))
    points = np.full((num_landmarks, 3), np.nan)
    lm_valid = np.zeros(num_landmarks, bool)
    first_seen_kf = np.full(num_landmarks, -1, np.int64)

    # Observation buffers: lists of ARRAYS (one per batch append),
    # concatenated lazily — the round-3 per-int python appends measured
    # as host overhead at scale.
    obs_cam: list[np.ndarray] = []
    obs_lm: list[np.ndarray] = []
    obs_uv: list[np.ndarray] = []

    def _obs_arrays():
        if not obs_cam:
            return (
                np.zeros(0, np.int64),
                np.zeros(0, np.int64),
                np.zeros((0, 2)),
            )
        return (
            np.concatenate(obs_cam),
            np.concatenate(obs_lm),
            np.concatenate(obs_uv),
        )

    def _save_ckpt(frame: int) -> None:
        if checkpoint_dir is None:
            return
        from ..utils.checkpoint import save_checkpoint

        oc, ol, ouv = _obs_arrays()
        save_checkpoint(
            checkpoint_dir,
            {
                "frame": np.asarray(frame),
                "est_r": est_r,
                "est_t": est_t,
                "points": points,
                "lm_valid": lm_valid,
                "first_seen_kf": first_seen_kf,
                "obs_cam": oc,
                "obs_lm": ol,
                "obs_uv": ouv,
            },
            step=None,  # single rolling checkpoint
        )

    resume_frame = -1
    if resume and checkpoint_dir is not None:
        from ..utils.checkpoint import (
            checkpoint_exists,
            restore_checkpoint_flat,
        )

        state_path = checkpoint_dir.rstrip("/") + "/state"
        if checkpoint_exists(state_path):
            ck = restore_checkpoint_flat(state_path)
            resume_frame = int(ck["frame"])
            # Prefix assignment: the live arrays may be LARGER than at
            # checkpoint time — the streaming session (streaming.py)
            # appends frames and opens new tracks between resumes; ids
            # are append-only, so rows beyond the checkpoint keep their
            # init values (NaN points / invalid / unseen).
            fr = ck["est_r"].shape[0]
            est_r[:fr] = ck["est_r"]
            est_t[:fr] = ck["est_t"]
            lp = ck["points"].shape[0]
            points[:lp] = ck["points"]
            lm_valid[:lp] = ck["lm_valid"].astype(bool)
            first_seen_kf[:lp] = ck["first_seen_kf"]
            obs_cam = [np.asarray(ck["obs_cam"], np.int64)]
            obs_lm = [np.asarray(ck["obs_lm"], np.int64)]
            obs_uv = [np.asarray(ck["obs_uv"]).reshape(-1, 2)]

    def backproject(f_idx, ids):
        uv = pixels[f_idx, ids]
        return np.asarray(
            geo.backproject(jnp.asarray(uv), k_jnp)
        )

    # ---- bootstrap from frames (0, kb) (skipped on resume) -------------
    # kb = cfg.bootstrap_baseline: wider pairs carry ~kb x the parallax
    # (see SlamConfig). Frames 1..kb-1 are posed by the windowed PnP
    # below against the bootstrap map; frame kb's observations are
    # recorded by its own window pass (recording them here would
    # duplicate them when kb >= start_f).
    kb = max(1, min(cfg.bootstrap_baseline, num_frames - 1))
    if resume_frame < 1:
        common = visible[0] & visible[kb]
        ids = np.where(common)[0]
        rays1 = backproject(0, ids)
        rays2 = backproject(kb, ids)
        res = estimate_essential_ransac(
            jnp.asarray(rays1),
            jnp.asarray(rays2),
            jnp.ones(len(ids), bool),
            jax.random.PRNGKey(0),
            num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=cfg.ransac_threshold_px / fx,
        )
        est_r[0] = np.eye(3)
        est_t[0] = 0.0
        est_r[kb] = np.asarray(res.rotation)
        est_t[kb] = np.asarray(res.translation)  # unit baseline = gauge

        inl = np.asarray(res.inliers)
        tri, depths = geo.triangulate_midpoint(
            jnp.asarray(est_r[0]),
            jnp.asarray(est_t[0]),
            jnp.asarray(est_r[kb]),
            jnp.asarray(est_t[kb]),
            jnp.asarray(rays1),
            jnp.asarray(rays2),
        )
        good = inl & np.all(np.asarray(depths) > 0.1, axis=-1)
        new_ids = ids[good]
        points[new_ids] = np.asarray(tri)[good]
        lm_valid[new_ids] = True
        boot_obs_frames = (0, 1) if kb == 1 else (0,)
        for f in boot_obs_frames:
            obs_cam.append(np.full(len(new_ids), f, np.int64))
            obs_lm.append(new_ids.astype(np.int64))
            obs_uv.append(pixels[f, new_ids])
        # Every landmark seen at bootstrap records its earliest frame so its
        # first observation enters triangulation/BA later (not only the
        # frame-0 AND frame-kb common set).
        first_seen_kf[visible[0]] = 0
        if kb == 1:
            only1 = visible[1] & ~visible[0]
            first_seen_kf[only1] = 1
        # kb > 1: the window loop starts at frame 1 and stamps
        # first-seen in frame order — pre-stamping frame kb here would
        # hide earlier sightings at frames 1..kb-1 (less triangulation
        # baseline later).

    # ---- incremental tracking: WINDOWED device dispatches --------------
    # A per-frame loop is host round trips: one PnP dispatch + one
    # triangulation dispatch per frame, each synced to the host, around
    # microseconds of device compute. Frames are therefore tracked in windows of ``ba_interval`` frames
    # against a map FROZEN at the window start: ONE fused dispatch
    # (_track_and_map_window) runs the lax.scan-of-PnP for the whole
    # window (the scan carries the pose chain, so the motion-model init
    # is preserved) AND the batched triangulation of every landmark
    # that became two-view observable anywhere in the window — the
    # candidate pairs are selected on the host BEFORE the dispatch from
    # visibility bookkeeping alone; then the windowed BA runs once.
    # Device round-trips per window: 2, vs ~2 per FRAME before.
    # Freezing the map for ≤W frames delays a new landmark's first use
    # in PnP by at most one window (it still enters BA via its
    # (first-seen, last-seen) observations immediately).
    win = max(1, cfg.ba_interval)
    lm_bucket = 1 << max(6, (num_landmarks - 1).bit_length())
    lm_pad = lm_bucket - num_landmarks
    pix_pad = np.pad(pixels, ((0, 0), (0, lm_pad), (0, 0)))
    vis_pad = np.pad(visible, ((0, 0), (0, lm_pad)))

    # Rolling inter-frame camera-center steps of ACCEPTED tracked
    # frames (pose_jump_gate); seeded with the bootstrap pair's
    # per-frame step so the gate has a scale anchor from the first
    # window on. On resume, re-seeded from the checkpointed trajectory.
    recent_steps: list[float] = []
    if resume_frame < 1:
        c_kb = -est_r[kb].T @ est_t[kb]
        recent_steps.append(float(np.linalg.norm(c_kb)) / kb)
    else:
        for f in range(max(1, resume_frame - 11), resume_frame + 1):
            c0 = -est_r[f - 1].T @ est_t[f - 1]
            c1 = -est_r[f].T @ est_t[f]
            s_len = float(np.linalg.norm(c1 - c0))
            if s_len > 0.0:
                recent_steps.append(s_len)

    # With a wide bootstrap baseline, frames 1..kb-1 (and kb itself —
    # its observations are recorded here rather than at bootstrap) are
    # localized by the same windowed PnP; with kb == 1 the loop starts
    # at frame 2 as before.
    start_f = max(1 if kb > 1 else 2, resume_frame + 1)
    for base in range(start_f, num_frames, win):
        end = min(base + win, num_frames)  # exclusive
        w_act = end - base
        vis_w = visible[base:end]  # (w_act, L)

        # --- ONE fused PnP+triangulation dispatch per window -----------
        mask_w = vis_w & lm_valid[None, :]
        counts = mask_w.sum(axis=1)

        # Candidate selection BEFORE the dispatch: it needs only
        # visibility bookkeeping. A PREVIEW first-seen stamp (assuming
        # no frame gets gated) picks the pairs; the authoritative
        # update below applies gating, and candidates whose preview
        # disagrees are dropped after the fetch.
        fs_prev = first_seen_kf.copy()
        for i_f, f in enumerate(range(base, end)):
            newly = vis_w[i_f] & (fs_prev < 0)
            fs_prev[newly] = f
        any_vis_prev = vis_w.any(axis=0)
        last_prev = base + (w_act - 1) - np.argmax(vis_w[::-1], axis=0)
        cand = np.where(
            ~lm_valid
            & (fs_prev >= 0)
            & any_vis_prev
            & (last_prev > fs_prev)
        )[0]
        n_cand = len(cand)
        cap = 1 << max(5, (max(n_cand, 1) - 1).bit_length())
        f0s = fs_prev[cand]
        f1s = last_prev[cand]
        a_in_win = np.zeros(cap, bool)
        a_in_win[:n_cand] = f0s >= base
        a_idx = np.zeros(cap, np.int32)
        a_idx[:n_cand] = np.maximum(f0s - base, 0)
        b_idx = np.zeros(cap, np.int32)
        b_idx[:n_cand] = f1s - base
        r_a_ext = np.broadcast_to(np.eye(3), (cap, 3, 3)).copy()
        t_a_ext = np.zeros((cap, 3))
        ext_rows = np.where(~a_in_win[:n_cand])[0]
        r_a_ext[ext_rows] = est_r[f0s[ext_rows]]
        t_a_ext[ext_rows] = est_t[f0s[ext_rows]]
        uv_a = np.zeros((cap, 2), np.float32)
        uv_b = np.zeros((cap, 2), np.float32)
        uv_a[:n_cand] = pixels[f0s, cand]
        uv_b[:n_cand] = pixels[f1s, cand]

        with _st("pnp_tri"):
            mask_in = np.zeros((win, lm_bucket), bool)
            mask_in[:w_act] = np.pad(mask_w, ((0, 0), (0, lm_pad)))
            rs, ts, tri, depths = _track_and_map_window(
                jnp.asarray(
                    np.pad(
                        np.nan_to_num(points, nan=1.0),
                        ((0, lm_pad), (0, 0)),
                        constant_values=1.0,
                    ),
                    jnp.float32,
                ),
                jnp.asarray(pix_pad[base:base + win]
                            if end == base + win
                            else np.pad(pix_pad[base:end],
                                        ((0, win - w_act), (0, 0), (0, 0))),
                            jnp.float32),
                jnp.asarray(mask_in),
                k_jnp,
                jnp.asarray(est_r[base - 1]),
                jnp.asarray(est_t[base - 1]),
                jnp.asarray(r_a_ext, jnp.float32),
                jnp.asarray(t_a_ext, jnp.float32),
                jnp.asarray(a_in_win),
                jnp.asarray(a_idx),
                jnp.asarray(b_idx),
                jnp.asarray(uv_a),
                jnp.asarray(uv_b),
                iterations=cfg.pnp_iterations,
                huber_delta=cfg.huber_px,
            )
            r_h, t_h, p_tri, d_tri = jax.device_get((rs, ts, tri, depths))
        if profile is not None:
            profile.count()

        # --- catastrophic-pose gate (host; see SlamConfig) --------------
        # Sequential so a frame after a rejected one is judged against
        # the HELD (sane) center, not the garbage one — the device scan
        # chained its init from the garbage pose, but LM recovers when
        # the map is good, so its pose is usually acceptable.
        gated = np.zeros(w_act, bool)
        c_prev = -est_r[base - 1].T @ est_t[base - 1]
        for i_f, f in enumerate(range(base, end)):
            c_new = -r_h[i_f].T @ t_h[i_f]
            step_len = float(np.linalg.norm(c_new - c_prev))
            med = (
                float(np.median(recent_steps))
                if len(recent_steps) >= 3
                else None
            )
            if (
                cfg.pose_jump_gate > 0
                and med is not None
                and step_len > cfg.pose_jump_gate * max(med, 1e-12)
            ):
                gated[i_f] = True
                est_r[f] = est_r[f - 1]
                est_t[f] = est_t[f - 1]
            else:
                est_r[f] = r_h[i_f]
                est_t[f] = t_h[i_f]
                if counts[i_f] >= 6 and step_len > 0.0:
                    recent_steps.append(step_len)
                    del recent_steps[:-12]
                c_prev = c_new

        # Lost frames (<6 mapped landmarks: pose merely held, never
        # solved) are excluded from mapping exactly like gated ones —
        # the round-3 per-frame loop `continue`d on them before any
        # stamping, so they could never anchor a triangulation either.
        excluded = gated | (counts < 6)

        # --- record observations of mapped landmarks (vectorized) ------
        with _st("obs_record"):
            for i_f, f in enumerate(range(base, end)):
                if excluded[i_f]:
                    continue  # lost/rejected frame: pose held, no obs
                ids = np.where(mask_w[i_f])[0]
                obs_cam.append(np.full(len(ids), f, np.int64))
                obs_lm.append(ids.astype(np.int64))
                obs_uv.append(pixels[f, ids])

        # --- first-seen bookkeeping, in frame order --------------------
        # Gated/lost frames are invisible to mapping: their held pose
        # must not anchor a future triangulation (pose/pixel mismatch).
        vis_eff = vis_w if not excluded.any() else vis_w & ~excluded[:, None]
        for i_f, f in enumerate(range(base, end)):
            if excluded[i_f]:
                continue
            newly = vis_eff[i_f] & (first_seen_kf < 0)
            first_seen_kf[newly] = f

        # --- map insertion from the fused triangulation ----------------
        # Candidate = landmark not yet in the map, first seen at f0,
        # visible again at some window frame > f0; pair (f0, last
        # visible window frame) maximizes baseline. Triangulated in the
        # SAME dispatch as the PnP scan (see _track_and_map_window);
        # here only host-side gating + bookkeeping remains.
        if n_cand > 0:
            p = p_tri[:n_cand]
            depths_h = d_tri[:n_cand]
            # Drop candidates that touched a gated frame (their device
            # triangulation used the rejected pose), or whose preview
            # first-seen stamp was reverted by the authoritative
            # (gating-aware) update above.
            ok = ~excluded[f1s - base]
            inw = np.where(a_in_win[:n_cand])[0]
            ok[inw] &= ~excluded[a_idx[inw]]
            ok &= first_seen_kf[cand] == f0s
            # Parallax gate: rays must subtend enough angle.
            c_a = -np.einsum("nji,nj->ni", est_r[f0s], est_t[f0s])
            c_b = -np.einsum("nji,nj->ni", est_r[f1s], est_t[f1s])
            d_a = p - c_a
            d_b = p - c_b
            cosang = np.sum(d_a * d_b, axis=-1) / np.maximum(
                np.linalg.norm(d_a, axis=-1) * np.linalg.norm(d_b, axis=-1),
                1e-9,
            )
            ang_ok = cosang < np.cos(np.radians(cfg.min_triangulation_deg))
            good = ok & np.all(depths_h > 0.1, axis=-1) & ang_ok
            add = cand[good]
            points[add] = p[good]
            lm_valid[add] = True
            add_f0 = f0s[good]
            add_f1 = f1s[good]
            obs_cam.append(add_f0.astype(np.int64))
            obs_lm.append(add.astype(np.int64))
            obs_uv.append(pixels[add_f0, add])
            obs_cam.append(add_f1.astype(np.int64))
            obs_lm.append(add.astype(np.int64))
            obs_uv.append(pixels[add_f1, add])

        # --- windowed BA (every ``ba_every`` windows + final window) ---
        # Window index on the GLOBAL grid (first window starts at 1
        # with a wide bootstrap, else 2) so ba_every keeps the same
        # phase across checkpoint resumes — a streaming session resumes
        # every window, and indexing from start_f would fire BA every
        # step regardless of ba_every. The end-of-data window forces BA
        # only for a true final window (not a fault-injection /
        # streaming step, which stops mid-sequence by construction).
        win_index = (base - (1 if kb > 1 else 2)) // win
        ba_due = (win_index % max(1, cfg.ba_every)) == (
            max(1, cfg.ba_every) - 1
        ) or (end == num_frames and _stop_after is None)
        n_obs = sum(len(a) for a in obs_cam)
        if ba_due and n_obs > 30:
            with _st("ba_windowed"):
                f = end - 1
                fixed = max(1, f + 1 - cfg.ba_window)
                state = BAState(
                    rotations=jnp.asarray(est_r[: f + 1]),
                    translations=jnp.asarray(est_t[: f + 1]),
                    points=jnp.asarray(np.nan_to_num(points, nan=1.0)),
                    k_mat=k_jnp,
                )
                lm_cat = np.concatenate(obs_lm)
                obs = _pad_obs(
                    np.concatenate(obs_cam),
                    lm_cat,
                    np.concatenate(obs_uv),
                    np.ones(n_obs, bool),
                )
                refined, _ = _ba(
                    state, obs, cfg.ba_iterations, fixed,
                    sorted_pad=_sorted_pad(lm_cat),
                )
                r_h, t_h, upd = jax.device_get(
                    (refined.rotations, refined.translations, refined.points)
                )
                est_r[: f + 1] = r_h
                est_t[: f + 1] = t_h
                points[lm_valid] = upd[lm_valid]
            if profile is not None:
                profile.count()

        if checkpoint_dir is not None and (
            (end - 1) // checkpoint_interval > (base - 1) // checkpoint_interval
            or end == num_frames
        ):
            _save_ckpt(end - 1)
        if _stop_after is not None and end - 1 >= _stop_after:
            # Fault injection: persist and abort at the window boundary.
            _save_ckpt(end - 1)
            return SlamResult(
                rotations=est_r,
                translations=est_t,
                points=points,
                landmark_valid=lm_valid,
                num_observations=sum(len(a) for a in obs_cam),
            )

    # ---- optional pose-graph optimization -----------------------------
    if cfg.use_pose_graph and num_frames >= 3:
        from ..sfm.pose_graph import PoseGraphEdges, optimize_pose_graph

        # Odometry edges carry the BA-refined consecutive relative poses
        # (the "odometry measurement" of this pipeline). Loop edges are
        # MEASURED: the highest-covisibility distant pairs each get a
        # fresh essential-matrix RANSAC solve over their co-observed
        # pixels (measure_loop_edge) — rotation and translation
        # direction come from the images, only the monocular scale from
        # the estimate.
        src, dst, rel_r, rel_t, wgt = [], [], [], [], []

        def add_edge(a, b, weight):
            ra_inv = est_r[a].T
            ta_inv = -ra_inv @ est_t[a]
            src.append(a)
            dst.append(b)
            rel_r.append(est_r[b] @ ra_inv)
            rel_t.append(est_r[b] @ ta_inv + est_t[b])
            wgt.append(weight)

        for f in range(num_frames - 1):
            add_edge(f, f + 1, 1.0)
        covis = visible.astype(np.int32) @ visible.astype(np.int32).T
        pairs = [
            (int(covis[a, b]), a, b)
            for a in range(num_frames)
            for b in range(a + cfg.loop_min_frame_gap, num_frames)
            if covis[a, b] >= cfg.loop_min_covisible
        ]
        pairs.sort(reverse=True)
        for _, a, b in pairs[: cfg.loop_max_edges]:
            edge = measure_loop_edge(
                pixels, visible, k_mat, est_r, est_t, a, b, cfg
            )
            if edge is None:
                continue
            src.append(a)
            dst.append(b)
            rel_r.append(edge[0])
            rel_t.append(edge[1])
            wgt.append(0.5)

        edges = PoseGraphEdges(
            src=jnp.asarray(src, jnp.int32),
            dst=jnp.asarray(dst, jnp.int32),
            rel_rotation=jnp.asarray(np.stack(rel_r)),
            rel_translation=jnp.asarray(np.stack(rel_t)),
            weight=jnp.asarray(wgt),
        )
        opt_r, opt_t, _ = optimize_pose_graph(
            jnp.asarray(est_r), jnp.asarray(est_t), edges
        )
        est_r = np.asarray(opt_r)
        est_t = np.asarray(opt_t)

    # ---- final global BA with outlier pruning -------------------------
    oc, ol, ouv = _obs_arrays()
    n_obs_total = len(oc)
    if n_obs_total > 30:
        from ..sfm.ba import reprojection_residuals

        obs_valid = np.ones(n_obs_total, bool)
        for _round in _prof_iter(range(cfg.final_ba_rounds), _st, "ba_final"):
            state = BAState(
                rotations=jnp.asarray(est_r),
                translations=jnp.asarray(est_t),
                points=jnp.asarray(np.nan_to_num(points, nan=1.0)),
                k_mat=k_jnp,
            )
            obs = _pad_obs(oc, ol, ouv, obs_valid)
            refined, _ = _ba(
                state, obs, cfg.final_ba_iterations, 1,
                sorted_pad=_sorted_pad(ol, obs_valid),
            )
            est_r = np.asarray(refined.rotations)
            est_t = np.asarray(refined.translations)
            upd = np.asarray(refined.points)
            points[lm_valid] = upd[lm_valid]
            # Prune observations whose residual exceeds 3·Huber-δ —
            # Huber only downweights gross outliers, it cannot zero
            # them, and a few outlier tracks measurably inflate ATE.
            res = np.asarray(reprojection_residuals(refined, obs))
            err = np.linalg.norm(res[:n_obs_total], axis=-1)
            obs_valid = obs_valid & (err < 3.0 * cfg.huber_px)

    return SlamResult(
        rotations=est_r,
        translations=est_t,
        points=points,
        landmark_valid=lm_valid,
        num_observations=n_obs_total,
    )


@functools.partial(jax.jit, static_argnames=("iterations", "huber_delta"))
@full_precision
def _track_and_map_window(
    points,
    pix_w,
    mask_w,
    k_mat,
    r0,
    t0,
    r_a_ext,
    t_a_ext,
    a_in_win,
    a_idx,
    b_idx,
    uv_a,
    uv_b,
    iterations,
    huber_delta,
):
    """ONE dispatch per tracking window: scanned PnP + triangulation.

    PnP leg: ``points`` (L, 3) frozen map (invalid slots hold finite
    filler — masked); ``pix_w``: (W, L, 2); ``mask_w``: (W, L)
    (visible AND in-map at window start). A ``lax.scan`` chains the
    solves so each frame initializes from the previous frame's pose;
    frames with <6 associations hold the previous pose (the lost-
    tracking fallback).

    Triangulation leg, fused so the host pays ONE round-trip per
    window instead of two: candidate landmark pairs are selected on the
    HOST before the dispatch (their selection needs only visibility
    bookkeeping, not the new poses); each candidate's first-seen pose
    comes from ``r_a_ext/t_a_ext`` when the frame precedes the window
    (``a_in_win`` False) or from the freshly scanned window poses at
    ``a_idx`` otherwise; the last-seen pose is always the window pose
    at ``b_idx``. Candidates touching a frame the host-side
    catastrophic-pose gate later rejects are DISCARDED on the host
    after the fetch (the gate cannot run before the scan returns).
    Returns ``(rs, ts, tri_points, tri_depths)``.
    """

    def step(carry, inp):
        r_prev, t_prev = carry
        uv, m = inp
        r_new, t_new, _ = solve_pnp(
            points,
            uv,
            m,
            k_mat,
            r_prev,
            t_prev,
            iterations=iterations,
            huber_delta=huber_delta,
        )
        ok = jnp.sum(m) >= 6
        r_new = jnp.where(ok, r_new, r_prev)
        t_new = jnp.where(ok, t_new, t_prev)
        return (r_new, t_new), (r_new, t_new)

    (_, _), (rs, ts) = jax.lax.scan(step, (r0, t0), (pix_w, mask_w))

    w = rs.shape[0]
    a_c = jnp.clip(a_idx, 0, w - 1)
    b_c = jnp.clip(b_idx, 0, w - 1)
    r_a = jnp.where(a_in_win[:, None, None], rs[a_c], r_a_ext)
    t_a = jnp.where(a_in_win[:, None], ts[a_c], t_a_ext)
    r_b = rs[b_c]
    t_b = ts[b_c]
    rays_a = geo.backproject(uv_a, k_mat)[:, None, :]
    rays_b = geo.backproject(uv_b, k_mat)[:, None, :]
    pts, depths = geo.triangulate_midpoint(
        r_a, t_a, r_b, t_b, rays_a, rays_b
    )
    return rs, ts, pts[:, 0], depths[:, 0]


@functools.partial(jax.jit, static_argnames=("ratio",))
def _match_consecutive(desc, valid, ratio):
    """Matches for ALL consecutive frame pairs in one dispatch.

    ``desc``: (F, S, D); returns ``(index, valid)`` of shape (F-1, S)
    mapping frame f-1 slots → frame f slots. One vmapped call replaces
    F-1 per-frame ``match_descriptors`` dispatches, each with its own
    host-sync round trip.
    """

    def one(d1, v1, d2, v2):
        m = match_descriptors(d1, v1, d2, v2, ratio=ratio)
        return m.index, m.valid

    return jax.vmap(one)(desc[:-1], valid[:-1], desc[1:], valid[1:])


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
@full_precision
def _verify_pairs(uv1, uv2, mask, k_mat, keys, thr, num_hypotheses):
    """Essential-matrix RANSAC over ALL frame pairs in one dispatch.

    ``uv1``/``uv2``: (P, CAP, 2) padded per-pair correspondences;
    ``mask``: (P, CAP) validity; ``keys``: (P, 2) PRNG keys. Returns
    (P, CAP) inlier flags.
    """
    from ..sfm.geometry import backproject as geo_backproject

    def one(u1, u2, m, key):
        r1 = geo_backproject(u1, k_mat)
        r2 = geo_backproject(u2, k_mat)
        res = estimate_essential_ransac(
            r1.astype(jnp.float32),
            r2.astype(jnp.float32),
            m,
            key,
            num_hypotheses=num_hypotheses,
            inlier_threshold=thr,
        )
        return res.inliers

    return jax.vmap(one)(uv1, uv2, mask, keys)


@jax.jit
@full_precision
def _frame_sketches(desc, valid):
    """One L2-normalized 128-D place-recognition sketch per frame.

    Mean of the frame's valid (already L2-ish normalized) descriptors,
    renormalized — the classic pooled-descriptor global image vector.
    Cosine similarity between sketches ranks frame pairs for loop
    closure at one (F, 128)·(128, F) MXU matmul instead of F²/stride
    full S×S descriptor-matrix matches (green-field; the reference has
    no descriptors at all, reference/readme.md:11).
    """
    d = desc * valid[..., None]
    s = d.sum(axis=1) / jnp.maximum(
        valid.sum(axis=1, keepdims=True).astype(desc.dtype), 1.0
    )
    return s / jnp.maximum(
        jnp.linalg.norm(s, axis=-1, keepdims=True), 1e-9
    )


@functools.partial(jax.jit, static_argnames=("ratio",))
def _match_window(desc, valid, query_f, kf_table, ratio):
    """Window re-association matches for ALL frames in one dispatch.

    ``query_f``: (Q,) frame indices of the queries; ``kf_table``:
    (Q, W) keyframe indices per query (-1 = unused slot). Returns
    ``(index, valid)`` of shape (Q, W, S) mapping query slots →
    keyframe slots. Frames are processed sequentially (``lax.map``)
    so the (S, S) distance matrices of one query's window are the
    peak memory, not Q×W of them.
    """

    def per_query(args):
        qf, kfs = args
        qd = desc[qf]
        qv = valid[qf]

        def per_kf(kf):
            kd = desc[jnp.maximum(kf, 0)]
            kv = valid[jnp.maximum(kf, 0)] & (kf >= 0)
            m = match_descriptors(qd, qv, kd, kv, ratio=ratio)
            return m.index, m.valid

        return jax.vmap(per_kf)(kfs)

    return jax.lax.map(per_query, (query_f, kf_table))


def _match_window_any(desc, valid, query_f, kf_table, ratio, mesh=None):
    """:func:`_match_window`, query-sharded over a mesh when given.

    Descriptors/validity are replicated (small: (F, S, 128)); the
    query axis — embarrassingly parallel, no cross-device combine —
    is sharded, so N devices each run 1/N of the sequential
    ``lax.map``. Replaces the round-3 per-frame
    ``match_against_keyframes_sharded`` dispatches in the composed
    pipeline (one collective-free dispatch for the whole sequence vs
    one per frame; that helper remains the standalone keyframe-sharded
    matching API, exercised by tests/test_distributed.py). Queries are
    padded to the device count with kf_table = -1 rows (all-invalid
    output, dropped by the caller).
    """
    if mesh is None:
        return _match_window(desc, valid, query_f, kf_table, ratio)
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n_q = query_f.shape[0]
    pad = (-n_q) % n_dev
    if pad:
        query_f = jnp.concatenate([query_f, jnp.zeros((pad,), query_f.dtype)])
        kf_table = jnp.concatenate(
            [kf_table, jnp.full((pad, kf_table.shape[1]), -1, kf_table.dtype)]
        )
    fn = shard_map(
        functools.partial(_match_window, ratio=ratio),
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_rep=False,
    )
    idx, val = fn(desc, valid, query_f, kf_table)
    return idx[:n_q], val[:n_q]


@full_precision
def build_tracks_from_images(
    images: np.ndarray,
    sift_cfg,
    k_mat: np.ndarray | None = None,
    match_ratio: float = 0.9,
    max_tracks: int = 4096,
    blur: str = "separable",
    ransac_threshold_px: float = 2.0,
    mesh=None,
    reassoc_window: int = 0,
    frontend_chunk: int = 16,
    profile=None,
    max_match_px: float | None = None,
    loop_stride: int = 0,
    loop_min_gap: int = 10,
    loop_min_matches: int = 12,
    loop_query_stride: int = 1,
    loop_topk: int = 8,
):
    """Frontend + sequential descriptor matching → landmark tracks.

    ``images``: (F, H, W) grayscale in [0,1]. Runs detect+describe per
    frame (batched over the whole sequence in one jit), matches each
    frame against its predecessor (Lowe ratio + mutual cross-check),
    geometrically verifies each pair with essential-matrix RANSAC when
    ``k_mat`` is given (raw descriptor matches measured only ~50 %
    geometrically correct on synthetic texture — unverified tracks
    poison the map), and chains the surviving matches into tracks.
    Returns ``(pixels (F, L, 2), visible (F, L))`` ready for
    :func:`run_slam`, plus per-frame keypoint counts for diagnostics.

    ``max_match_px`` > 0 enables motion-prior gating: a consecutive-pair
    match is dropped when the keypoints are further apart than this many
    pixels (video frames move a few pixels; repetitive/noisy texture
    produces long-range aliased matches that survive the ratio test and
    poison tracks — measured on the 40-frame bench: see BASELINE.md
    round-4 SLAM paragraph). Window re-association matches get the gate
    scaled by the frame gap.

    ``reassoc_window`` > 0 additionally matches each frame against that
    many older keyframes to re-acquire tracks lost in the immediate
    predecessor (occlusion gaps). With a ``mesh`` the frontend runs
    data-parallel over the batch axis and the window matching runs
    keyframe-sharded over the mesh (parallel/distributed.py —
    BASELINE.json config[4]); results are identical to the
    single-device path.
    """
    from contextlib import nullcontext

    from .frontend import detect_and_describe_batched_jit

    def _st(name):
        return profile.stage(name) if profile is not None else nullcontext()

    # Frontend in fixed-size chunks: the describe path materializes the
    # Gaussian stacks, so a long sequence in ONE batch exceeds device
    # memory (40 frames at 480p need a 22 GB octave-0 allocation). Chunks
    # share one compiled executable; the tail chunk is padded to the
    # chunk size so no second compilation happens.
    if mesh is not None:
        from ..parallel.distributed import detect_and_describe_data_parallel

        frontend = lambda im: detect_and_describe_data_parallel(  # noqa: E731
            im, sift_cfg, mesh, blur
        )
        chunk = frontend_chunk * mesh.devices.size
    else:
        frontend = lambda im: detect_and_describe_batched_jit(  # noqa: E731
            im, sift_cfg, blur
        )
        chunk = frontend_chunk
    num_frames_total = images.shape[0]
    n_dev = mesh.devices.size if mesh is not None else 1
    parts = []
    for lo in _prof_iter(range(0, num_frames_total, chunk), _st, "frontend"):
        with _st("frontend_upload"):
            # Integer frames upload as-is (uint8: 4x, uint16: 2x fewer
            # bytes); the jitted frontend converts on device
            # (/255 resp. /65535 — models/frontend.py::_as_unit_float).
            src_dtype = np.asarray(images[lo : lo + 1]).dtype
            up_dtype = (
                src_dtype
                if src_dtype in (np.uint8, np.uint16)
                else np.float32
            )
            part = np.asarray(images[lo : lo + chunk], up_dtype)
            n_part = part.shape[0]
            if len(parts):  # tail: pad to reuse the compiled shape
                target = chunk
            else:
                # First (possibly only) chunk: no padding needed
                # off-mesh, but a mesh shards the batch axis, so it
                # must divide the device count (device_put rejects it
                # otherwise).
                target = n_part + (-n_part) % n_dev
            pad = target - n_part
            if pad:
                part = np.concatenate(
                    [part, np.zeros((pad,) + part.shape[1:], part.dtype)]
                )
            part = jax.device_put(jnp.asarray(part))
        out = frontend(part)
        if pad:
            out = jax.tree.map(lambda a: a[:n_part], out)
        if profile is not None:
            # Attribution-only sync: splits device compute out of the
            # fetch stage (production runs stay async until the fetch).
            with _st("frontend_compute"):
                profile.sync(out)
        parts.append(out)
    with _st("frontend_fetch"):
        described = (
            parts[0]
            if len(parts) == 1
            else jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)
        )
        valid = np.asarray(described.valid)
        xs = np.asarray(described.abs_x)
        ys = np.asarray(described.abs_y)
        # Descriptors stay DEVICE-RESIDENT on every path: all matching
        # (consecutive, window, loop) consumes them in batched device
        # dispatches, and fetching the (F, S, 128) f32 buffer only to
        # re-upload it would be pure transfer traffic.
    if profile is not None:
        profile.count()

    num_frames = images.shape[0]
    track_of = np.full(valid.shape, -1, np.int64)  # (F, slots)

    # Frame 0: every valid keypoint opens a track (vectorized — the
    # per-keypoint Python loops here measured as a host bottleneck).
    js = np.where(valid[0])[0][:max_tracks]
    track_of[0, js] = np.arange(len(js))
    next_track = len(js)

    # --- batched tracking dispatches ------------------------------------
    # A per-frame loop would issue one match + one RANSAC dispatch per
    # frame, each synced to host (~2F syncs per sequence). All consecutive-pair matches are independent, so: ONE
    # vmapped match over the F-1 pairs, then ONE vmapped RANSAC over the
    # padded per-pair correspondences. The host loop below only chains
    # precomputed arrays.
    with _st("match_consecutive"):
        d_all = described.descriptor
        v_all = described.valid
        cons_idx, cons_val = _match_consecutive(d_all, v_all, match_ratio)
        cons_idx = np.asarray(cons_idx)
        cons_val = np.asarray(cons_val)
        if max_match_px is not None:
            # Motion-prior gate: drop matches whose displacement exceeds
            # the per-pair budget (aliased matches on repetitive texture).
            j = np.clip(cons_idx, 0, xs.shape[1] - 1)
            dx = np.take_along_axis(xs[1:], j, axis=1) - xs[:-1]
            dy = np.take_along_axis(ys[1:], j, axis=1) - ys[:-1]
            cons_val = cons_val & (dx * dx + dy * dy <= max_match_px**2)
        pair_is = [np.where(cons_val[p])[0] for p in range(num_frames - 1)]
        pair_js = [cons_idx[p, pi] for p, pi in enumerate(pair_is)]
    if profile is not None:
        profile.count()

    if k_mat is not None and num_frames > 1:
        counts = [len(pi) for pi in pair_is]
        cap = 1 << max(6, (max(max(counts), 1) - 1).bit_length())
        n_pairs = num_frames - 1
        uv1 = np.zeros((n_pairs, cap, 2), np.float32)
        uv2 = np.zeros((n_pairs, cap, 2), np.float32)
        mask = np.zeros((n_pairs, cap), bool)
        for p, (pi, pj) in enumerate(zip(pair_is, pair_js)):
            n = len(pi)
            uv1[p, :n, 0] = xs[p, pi]
            uv1[p, :n, 1] = ys[p, pi]
            uv2[p, :n, 0] = xs[p + 1, pj]
            uv2[p, :n, 1] = ys[p + 1, pj]
            mask[p, :n] = True
        keys = np.stack(
            [np.asarray(jax.random.PRNGKey(f)) for f in range(1, num_frames)]
        )
        with _st("ransac_verify"):
            inliers = np.asarray(
                _verify_pairs(
                    jnp.asarray(uv1),
                    jnp.asarray(uv2),
                    jnp.asarray(mask),
                    jnp.asarray(k_mat, jnp.float32),
                    jnp.asarray(keys),
                    ransac_threshold_px / float(k_mat[0, 0]),
                    256,
                )
            )
        if profile is not None:
            profile.count()
        for p, n in enumerate(counts):
            if n >= 8:  # below 8 the model is underdetermined: keep all
                keep = inliers[p, :n]
                pair_is[p] = pair_is[p][keep]
                pair_js[p] = pair_js[p][keep]

    # Window re-association matches, also batched — ONE dispatch for
    # the whole sequence on device and mesh alike (query-sharded over
    # the mesh, see _match_window_any; the round-3 per-frame sharded
    # dispatches made the composed mesh path SLOWER than single-device).
    w_idx_all = w_val_all = None
    if reassoc_window > 0 and num_frames > 2:
        qf = np.arange(2, num_frames, dtype=np.int32)
        kf_table = np.full((len(qf), reassoc_window), -1, np.int32)
        for i, f in enumerate(qf):
            lo = max(0, f - 1 - reassoc_window)
            kfs = range(lo, f - 1)
            kf_table[i, : len(kfs)] = list(kfs)
        with _st("match_window"):
            w_idx_all, w_val_all = _match_window_any(
                d_all, v_all, jnp.asarray(qf), jnp.asarray(kf_table),
                match_ratio, mesh,
            )
            w_idx_all = np.asarray(w_idx_all)
            w_val_all = np.asarray(w_val_all)
        if profile is not None:
            profile.count()

    for f in _prof_iter(range(1, num_frames), _st, "chain_tracks"):
        pair_i = pair_is[f - 1]
        pair_j = pair_js[f - 1]

        # Chain matches into existing tracks (mutual cross-check makes
        # the match one-to-one, so plain fancy indexing is race-free).
        prev_t = track_of[f - 1, pair_i]
        has_track = prev_t >= 0
        track_of[f, pair_j[has_track]] = prev_t[has_track]

        # Window re-association: keypoints the predecessor match left
        # untracked are matched against up to ``reassoc_window`` older
        # frames (most recent wins) — keyframe-sharded on a mesh.
        if reassoc_window > 0 and f >= 2:
            lo = max(0, f - 1 - reassoc_window)
            kfs = list(range(lo, f - 1))  # excludes f-1 (already matched)
            if kfs:
                # Precomputed by the ONE batched _match_window_any
                # dispatch above (row i ↔ query frame i+2, slots
                # [0:len(kfs)] in the same oldest→newest order).
                w_idx = w_idx_all[f - 2, : len(kfs)]
                w_val = w_val_all[f - 2, : len(kfs)]
                # Most recent keyframe wins; only fill untracked slots.
                for wk in range(len(kfs) - 1, -1, -1):
                    kf = kfs[wk]
                    # The query is frame f, so w_idx maps frame-f slots
                    # → keyframe slots.
                    src = np.where(w_val[wk])[0]  # frame-f slots
                    dst = w_idx[wk, src]  # matched keyframe slots
                    ok = (track_of[f, src] < 0) & (track_of[kf, dst] >= 0)
                    if max_match_px is not None:
                        gate = max_match_px * (f - kf)
                        dxy = (xs[f, src] - xs[kf, dst]) ** 2 + (
                            ys[f, src] - ys[kf, dst]
                        ) ** 2
                        ok &= dxy <= gate * gate
                    track_of[f, src[ok]] = track_of[kf, dst[ok]]
        # Unmatched valid keypoints open new tracks up to capacity.
        js = np.where(valid[f] & (track_of[f] < 0))[0]
        js = js[: max(0, max_tracks - next_track)]
        track_of[f, js] = next_track + np.arange(len(js))
        next_track += len(js)

    # --- loop-closure data association (optional; green-field) ----------
    # Consecutive+window matching can never re-associate a feature with
    # a track last seen many frames ago, so co-visibility loop edges
    # (SlamConfig.use_pose_graph / measure_loop_edge) structurally
    # cannot fire on a closed loop. This pass is the missing place
    # recognition: every frame past ``loop_min_gap`` is descriptor-
    # matched (ONE batched dispatch, same kernel as the window pass)
    # against a ``loop_stride``-subsampled set of old frames; pairs with
    # enough mutual matches are essential-RANSAC verified (one batched
    # dispatch), and inlier matches MERGE the two track ids (union-
    # find). Merged tracks give the backend genuine cross-loop
    # co-observations — both global BA and the pose-graph loop edges
    # consume them with no further plumbing. ``loop_stride=0`` disables
    # (the default: brute-force place recognition over all old frames
    # is O(F²/stride) matches and is priced for loop-shaped sequences).
    if loop_stride > 0 and num_frames > loop_min_gap + 1:
        # Queries may be strided too (``loop_query_stride``): a merge
        # landing on a queried frame reconnects its whole consecutive
        # track chain, so skipping queries loses little closure power
        # at a proportional cost cut (the pass is O(F²/(stride·qstride))
        # descriptor-matrix matches).
        qf = np.arange(
            loop_min_gap, num_frames, max(1, loop_query_stride),
            dtype=np.int32,
        )
        n_full = max(1, (num_frames - loop_min_gap + loop_stride - 1) // loop_stride)
        # Compact place recognition (VERDICT r4 item 5): one 128-D
        # sketch per frame (L2-normalized mean of its valid L2-ish
        # descriptors) and ONE (F, F) cosine-similarity matmul on the
        # MXU rank every (query, old-frame) pair; only each query's
        # ``loop_topk`` most similar strided candidates get the
        # expensive full descriptor-matrix match. Brute force is
        # O(F²/stride) S×S matrix matches; the sketch pass caps it at
        # O(F·topk) — the prune that makes 200+-frame loop sequences
        # tractable. ``loop_topk=0`` restores brute force.
        n_cols = n_full if loop_topk <= 0 else min(n_full, loop_topk)
        sim = None
        if 0 < loop_topk < n_full:
            with _st("loop_sketch"):
                sk = _frame_sketches(d_all, v_all)
                sim = np.asarray(
                    jnp.einsum(
                        "fd,gd->fg", sk, sk,
                        preferred_element_type=jnp.float32,
                    )
                )
            if profile is not None:
                profile.count()
        kf_table = np.full((len(qf), n_cols), -1, np.int32)
        for i, f in enumerate(qf):
            cands = np.arange(0, f - loop_min_gap + 1, loop_stride)
            if sim is not None and len(cands) > n_cols:
                order = np.argsort(-sim[f, cands], kind="stable")[:n_cols]
                cands = np.sort(cands[order])
            kf_table[i, : min(len(cands), n_cols)] = cands[:n_cols]
        with _st("loop_match"):
            l_idx, l_val = _match_window_any(
                d_all, v_all, jnp.asarray(qf), jnp.asarray(kf_table),
                match_ratio, mesh,
            )
            l_idx = np.asarray(l_idx)
            l_val = np.asarray(l_val)
        if profile is not None:
            profile.count()
        # Candidate pairs with enough mutual matches for verification.
        cand_pairs = []  # (f, kf, src_slots, dst_slots)
        for i, f in enumerate(qf):
            for c in range(n_cols):
                kf = kf_table[i, c]
                if kf < 0:
                    continue
                src = np.where(l_val[i, c])[0]
                if len(src) >= max(8, loop_min_matches):
                    cand_pairs.append((int(f), int(kf), src, l_idx[i, c, src]))
        if cand_pairs and k_mat is not None:
            cap = 1 << max(
                6, (max(len(s) for _, _, s, _ in cand_pairs) - 1).bit_length()
            )
            n_p = len(cand_pairs)
            uv1 = np.zeros((n_p, cap, 2), np.float32)
            uv2 = np.zeros((n_p, cap, 2), np.float32)
            msk = np.zeros((n_p, cap), bool)
            for p, (f, kf, src, dst) in enumerate(cand_pairs):
                n = len(src)
                uv1[p, :n, 0] = xs[f, src]
                uv1[p, :n, 1] = ys[f, src]
                uv2[p, :n, 0] = xs[kf, dst]
                uv2[p, :n, 1] = ys[kf, dst]
                msk[p, :n] = True
            keys = np.stack(
                [
                    np.asarray(jax.random.PRNGKey(10_000 + p))
                    for p in range(n_p)
                ]
            )
            with _st("loop_verify"):
                inl = np.asarray(
                    _verify_pairs(
                        jnp.asarray(uv1),
                        jnp.asarray(uv2),
                        jnp.asarray(msk),
                        jnp.asarray(k_mat, jnp.float32),
                        jnp.asarray(keys),
                        ransac_threshold_px / float(k_mat[0, 0]),
                        256,
                    )
                )
            if profile is not None:
                profile.count()
            parent = np.arange(next_track, dtype=np.int64)

            def _find(a: int) -> int:
                while parent[a] != a:
                    parent[a] = parent[parent[a]]
                    a = parent[a]
                return a

            for p, (f, kf, src, dst) in enumerate(cand_pairs):
                keep = inl[p, : len(src)]
                # Essential-matrix verification is VACUOUS at near-zero
                # baseline — a loop closure typically REVISITS a
                # viewpoint, E → 0, and every aliased match passes
                # (measured: merging with RANSAC-only verification made
                # the 80-frame out-and-back ATE 0.44 → 1.33). Add a
                # robust displacement-consistency gate: true same-view
                # matches form a smooth, tight displacement field;
                # aliased matches scatter. Keep matches within
                # 3×MAD (+2 px floor) of the median displacement.
                if not keep.any():
                    continue  # zero RANSAC inliers: no median to gate on
                ddx = xs[f, src] - xs[kf, dst]
                ddy = ys[f, src] - ys[kf, dst]
                mdx, mdy = np.median(ddx[keep]), np.median(ddy[keep])
                dev = np.hypot(ddx - mdx, ddy - mdy)
                mad = np.median(dev[keep])
                keep = keep & (dev <= 3.0 * mad + 2.0)
                if keep.sum() < loop_min_matches:
                    continue
                for s_slot, d_slot in zip(src[keep], dst[keep]):
                    ta = track_of[f, s_slot]
                    tb = track_of[kf, d_slot]
                    if ta < 0 or tb < 0 or ta == tb:
                        continue
                    ra, rb = _find(int(ta)), _find(int(tb))
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
            roots = np.array([_find(t) for t in range(next_track)], np.int64)
            uniq, remap = np.unique(roots, return_inverse=True)
            live = track_of >= 0
            track_of[live] = remap[roots[track_of[live]]]
            next_track = len(uniq)

    n_tracks = next_track
    pixels = np.zeros((num_frames, n_tracks, 2))
    visible = np.zeros((num_frames, n_tracks), bool)
    f_idx, j_idx = np.where(track_of >= 0)
    t_idx = track_of[f_idx, j_idx]
    pixels[f_idx, t_idx, 0] = xs[f_idx, j_idx]
    pixels[f_idx, t_idx, 1] = ys[f_idx, j_idx]
    visible[f_idx, t_idx] = True
    return pixels, visible, valid.sum(axis=-1)


def run_slam_from_images(
    images: np.ndarray,
    k_mat: np.ndarray,
    sift_cfg,
    slam_cfg: SlamConfig | None = None,
    match_ratio: float = 0.9,
    mesh=None,
    reassoc_window: int = 0,
    blur: str = "separable",
    frontend_chunk: int = 16,
    profile=None,
    max_match_px: float | None = None,
    loop_stride: int = 0,
    loop_query_stride: int = 1,
    loop_topk: int = 8,
    **slam_kwargs,
) -> SlamResult:
    """Full visual SLAM: pixels in → trajectory + map out.

    Composes the SIFT frontend (detect+describe, batched), sequential
    descriptor tracking, and the incremental geometric backend
    (:func:`run_slam`). With ``mesh`` the whole pipeline runs sharded:
    data-parallel frontend, keyframe-sharded window matching, and
    landmark-sharded distributed BA (BASELINE.json config[4]).
    ``slam_kwargs`` forward to :func:`run_slam` (checkpointing etc.).
    """
    pixels, visible, _ = build_tracks_from_images(
        images, sift_cfg, k_mat=k_mat, match_ratio=match_ratio,
        mesh=mesh, reassoc_window=reassoc_window, blur=blur,
        frontend_chunk=frontend_chunk, profile=profile,
        max_match_px=max_match_px, loop_stride=loop_stride,
        loop_query_stride=loop_query_stride, loop_topk=loop_topk,
    )
    return run_slam(
        pixels, visible, k_mat, slam_cfg, mesh=mesh, profile=profile,
        **slam_kwargs,
    )


@full_precision
def evaluate_ate(result: SlamResult, gt_rotations, gt_translations) -> float:
    """Monocular ATE RMSE (Umeyama-aligned) vs ground truth."""
    return float(
        absolute_trajectory_error(
            jnp.asarray(result.rotations),
            jnp.asarray(result.translations),
            jnp.asarray(gt_rotations),
            jnp.asarray(gt_translations),
        )
    )
