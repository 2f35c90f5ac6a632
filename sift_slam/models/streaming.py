"""Online (streaming) visual SLAM session.

The batch pipeline (:func:`~.slam.run_slam_from_images`) ingests the
whole sequence up front — the right shape for datasets and benchmarks,
the wrong one for a live camera. :class:`SlamSession` is the online
mode: feed frames one at a time; every ``SlamConfig.ba_interval``
frames the session runs ONE incremental step — batched
detect+describe on the buffered window, incremental descriptor
tracking (the same matcher/verifier dispatches as the batch path),
and the geometric backend's windowed PnP+triangulation+BA — and
returns the provisional trajectory. ``finalize()`` runs the global
final BA (+ optional pose graph) and returns the definitive result.

Design: the backend is NOT reimplemented. The session drives
:func:`~.slam.run_slam` through its checkpoint/resume machinery — each
step resumes from the previous step's persisted state, processes
exactly the new window (``_stop_after`` skips the final BA), and
persists again. The state arrays grow between resumes (new frames,
new tracks); ids are append-only, so the prefix-restore in
``run_slam`` is exact. Track building reuses the batch path's
primitives (``_match_consecutive``, ``_match_window_any``,
``_verify_pairs``) one window at a time, so the association logic and
its device dispatch shapes match the batch pipeline.

Streaming loop-closure association is not implemented (the batch
``loop_stride`` pass remaps track ids globally, which would invalidate
the append-only resume contract); run the batch pipeline for
loop-shaped sequences.

Green-field extension (the reference is a single-image browser demo,
reference/readme.md:7); completes the production-serving story of
BASELINE.json configs[3-4].
"""

from __future__ import annotations

import uuid

import numpy as np
import jax
import jax.numpy as jnp

from ..core.precision import full_precision
from .slam import (
    SlamConfig,
    SlamResult,
    _match_consecutive,
    _match_window_any,
    _verify_pairs,
    run_slam,
)


class SlamSession:
    """Incremental monocular SLAM over a live frame stream.

    Usage::

        sess = SlamSession(k_mat, sift_cfg, slam_cfg)
        for frame in camera:                 # (H, W) grayscale
            update = sess.add_frame(frame)   # SlamResult every window,
            if update is not None:           # None in between
                use(update.rotations, update.translations)
        result = sess.finalize()             # global BA (+ pose graph)
    """

    def __init__(
        self,
        k_mat: np.ndarray,
        sift_cfg=None,
        slam_cfg: SlamConfig | None = None,
        *,
        blur: str = "separable",
        match_ratio: float = 0.9,
        max_tracks: int = 4096,
        reassoc_window: int = 2,
        max_match_px: float | None = None,
        ransac_threshold_px: float = 2.0,
        workdir: str | None = None,
        mesh=None,
    ):
        from .. import SiftConfig

        self.k_mat = np.asarray(k_mat)
        self.sift_cfg = sift_cfg or SiftConfig()
        self.slam_cfg = slam_cfg or SlamConfig()
        self.blur = blur
        self.match_ratio = match_ratio
        self.max_tracks = max_tracks
        self.reassoc_window = reassoc_window
        self.max_match_px = max_match_px
        self.ransac_threshold_px = ransac_threshold_px
        self.mesh = mesh
        self.window = max(1, self.slam_cfg.ba_interval)
        # Default state store is IN-MEMORY (mem:// scheme,
        # utils/checkpoint.py): the per-step disk checkpoint round-trip
        # measured as pure overhead in the online step latency. Pass a
        # real directory to survive process death mid-stream.
        self._owns_workdir = workdir is None
        self._workdir = workdir or f"mem://slam_session_{uuid.uuid4().hex}"

        # First backend window starts at this frame (run_slam: 1 with a
        # wide bootstrap, else 2); step boundaries must land on the
        # window grid start_f0 + k*win or each resume would RE-PHASE
        # the backend's windows vs the batch pipeline (measured: same
        # tracks, ATE 0.216 vs 0.03 from phasing alone).
        self._start_f0 = 1 if self.slam_cfg.bootstrap_baseline > 1 else 2
        self._buf: list[np.ndarray] = []
        # Device descriptor buffer holds only the matching horizon (the
        # last reassoc_window+1 processed frames) plus the new window:
        # nothing older is ever matched in streaming mode, and keeping
        # the full history made the matcher's frame axis grow every
        # step — one retrace/recompile per window and unbounded device
        # memory. With the horizon buffer the dispatch shapes are
        # constant from the second step on (one trace, reused forever).
        self._desc = None  # (H, S, D) device array, frames >= _dev_base
        self._valid = None  # (H, S) device array
        self._dev_base = 0  # global frame index of _desc[0]
        self._xs = None  # (F, S) host
        self._ys = None
        self._track_of = None  # (F, S) host, -1 = untracked
        self._next_track = 0
        self._frames_done = 0
        self._started = False
        self._last: SlamResult | None = None

    # -- public API ----------------------------------------------------

    @full_precision
    def add_frame(self, image: np.ndarray) -> SlamResult | None:
        """Buffer one frame; step the pipeline when the window fills.

        Returns the provisional :class:`SlamResult` after a step, else
        ``None``. Provisional = no final BA / pose graph yet.
        """
        self._buf.append(np.asarray(image))
        total = self._frames_done + len(self._buf)
        if (
            total >= self._start_f0 + self.window
            and (total - self._start_f0) % self.window == 0
        ):
            return self._step()
        return None

    @full_precision
    def finalize(self) -> SlamResult:
        """Flush any partial window, run the global final BA, return."""
        if self._buf:
            self._step()
        if self._frames_done < 2:
            raise ValueError("need at least 2 processed frames")
        pixels, visible = self._tracks_to_arrays()
        result = run_slam(
            pixels,
            visible,
            self.k_mat,
            self.slam_cfg,
            mesh=self.mesh,
            checkpoint_dir=self._workdir,
            checkpoint_interval=self.window,
            resume=True,
        )
        if self._owns_workdir:
            # Evict the session's rolling state from the mem:// store —
            # without this every finished session leaks its final pose +
            # observation buffers in a module global for the process
            # lifetime (a user-provided workdir is the user's to keep).
            from ..utils.checkpoint import remove_checkpoint

            remove_checkpoint(self._workdir)
        return result

    @property
    def frames_processed(self) -> int:
        return self._frames_done

    # -- internals -----------------------------------------------------

    def _step(self) -> SlamResult:
        frames = np.stack(self._buf)
        self._buf.clear()
        self._extend_tracks(frames)
        pixels, visible = self._tracks_to_arrays()
        result = run_slam(
            pixels,
            visible,
            self.k_mat,
            self.slam_cfg,
            mesh=self.mesh,
            checkpoint_dir=self._workdir,
            checkpoint_interval=self.window,
            resume=self._started,
            _stop_after=self._frames_done - 1,
        )
        self._started = True
        self._last = result
        return result

    def _extend_tracks(self, frames: np.ndarray) -> None:
        """Detect+describe the new frames and chain them into tracks.

        Same association rules (and the same jitted dispatches) as
        :func:`~.slam.build_tracks_from_images`, applied to the new
        frames only: consecutive mutual-ratio matches, optional
        motion-prior gate, essential-RANSAC pair verification (same
        per-pair PRNG keys), window re-association, then new-track
        opening up to capacity.
        """
        from .frontend import detect_and_describe_batched_jit

        described = detect_and_describe_batched_jit(
            jnp.asarray(frames), self.sift_cfg, self.blur
        )
        n_new = frames.shape[0]
        f0 = self._frames_done  # global index of first new frame
        valid_new = np.asarray(described.valid)
        xs_new = np.asarray(described.abs_x)
        ys_new = np.asarray(described.abs_y)

        if self._desc is None:
            self._desc = described.descriptor
            self._valid = described.valid
            self._dev_base = 0
            self._xs, self._ys = xs_new, ys_new
            self._track_of = np.full(valid_new.shape, -1, np.int64)
            js = np.where(valid_new[0])[0][: self.max_tracks]
            self._track_of[0, js] = np.arange(len(js))
            self._next_track = len(js)
            start = 1
        else:
            self._desc = jnp.concatenate([self._desc, described.descriptor])
            self._valid = jnp.concatenate([self._valid, described.valid])
            self._xs = np.concatenate([self._xs, xs_new])
            self._ys = np.concatenate([self._ys, ys_new])
            self._track_of = np.concatenate(
                [self._track_of, np.full(valid_new.shape, -1, np.int64)]
            )
            start = f0
        num_frames = f0 + n_new
        xs, ys = self._xs, self._ys
        dev_base = self._dev_base

        if start >= num_frames:
            self._frames_done = num_frames
            return

        # Consecutive matches for the new pairs (start-1, start) ..
        # (num_frames-2, num_frames-1): one dispatch over the slice.
        lo = start - 1
        cons_idx, cons_val = _match_consecutive(
            self._desc[lo - dev_base : num_frames - dev_base],
            self._valid[lo - dev_base : num_frames - dev_base],
            self.match_ratio,
        )
        cons_idx = np.asarray(cons_idx)
        cons_val = np.asarray(cons_val)
        if self.max_match_px is not None:
            j = np.clip(cons_idx, 0, xs.shape[1] - 1)
            dx = np.take_along_axis(xs[lo + 1 : num_frames], j, axis=1) - xs[
                lo : num_frames - 1
            ]
            dy = np.take_along_axis(ys[lo + 1 : num_frames], j, axis=1) - ys[
                lo : num_frames - 1
            ]
            cons_val = cons_val & (
                dx * dx + dy * dy <= self.max_match_px**2
            )
        pair_is = [np.where(cons_val[p])[0] for p in range(num_frames - lo - 1)]
        pair_js = [cons_idx[p, pi] for p, pi in enumerate(pair_is)]

        if self.k_mat is not None and len(pair_is):
            counts = [len(pi) for pi in pair_is]
            cap = 1 << max(6, (max(max(counts), 1) - 1).bit_length())
            n_pairs = len(pair_is)
            uv1 = np.zeros((n_pairs, cap, 2), np.float32)
            uv2 = np.zeros((n_pairs, cap, 2), np.float32)
            mask = np.zeros((n_pairs, cap), bool)
            for p, (pi, pj) in enumerate(zip(pair_is, pair_js)):
                n = len(pi)
                uv1[p, :n, 0] = xs[lo + p, pi]
                uv1[p, :n, 1] = ys[lo + p, pi]
                uv2[p, :n, 0] = xs[lo + p + 1, pj]
                uv2[p, :n, 1] = ys[lo + p + 1, pj]
                mask[p, :n] = True
            keys = np.stack(
                [
                    np.asarray(jax.random.PRNGKey(f))
                    for f in range(lo + 1, num_frames)
                ]
            )
            inliers = np.asarray(
                _verify_pairs(
                    jnp.asarray(uv1),
                    jnp.asarray(uv2),
                    jnp.asarray(mask),
                    jnp.asarray(self.k_mat, jnp.float32),
                    jnp.asarray(keys),
                    self.ransac_threshold_px / float(self.k_mat[0, 0]),
                    256,
                )
            )
            for p, n in enumerate(counts):
                if n >= 8:
                    keep = inliers[p, :n]
                    pair_is[p] = pair_is[p][keep]
                    pair_js[p] = pair_js[p][keep]

        # Window re-association for the new frames.
        w_idx_all = w_val_all = None
        qf = np.array(
            [f for f in range(max(2, start), num_frames)], np.int32
        )
        if self.reassoc_window > 0 and len(qf):
            kf_table = np.full((len(qf), self.reassoc_window), -1, np.int32)
            for i, f in enumerate(qf):
                lo_k = max(0, f - 1 - self.reassoc_window)
                kfs = range(lo_k, f - 1)
                kf_table[i, : len(kfs)] = list(kfs)
            # Device-local frame indices (the buffer starts at dev_base;
            # every reassoc keyframe is >= start-1-reassoc_window, which
            # the horizon trim below guarantees is still resident).
            kf_local = np.where(kf_table >= 0, kf_table - dev_base, -1)
            w_idx_all, w_val_all = _match_window_any(
                self._desc, self._valid, jnp.asarray(qf - dev_base),
                jnp.asarray(kf_local.astype(np.int32)),
                self.match_ratio, self.mesh,
            )
            w_idx_all = np.asarray(w_idx_all)
            w_val_all = np.asarray(w_val_all)

        track_of = self._track_of
        for f in range(start, num_frames):
            pair_i = pair_is[f - 1 - lo]
            pair_j = pair_js[f - 1 - lo]
            prev_t = track_of[f - 1, pair_i]
            has_track = prev_t >= 0
            track_of[f, pair_j[has_track]] = prev_t[has_track]

            if self.reassoc_window > 0 and f >= 2:
                lo_k = max(0, f - 1 - self.reassoc_window)
                kfs = list(range(lo_k, f - 1))
                if kfs:
                    qi = f - max(2, start)
                    w_idx = w_idx_all[qi, : len(kfs)]
                    w_val = w_val_all[qi, : len(kfs)]
                    for wk in range(len(kfs) - 1, -1, -1):
                        kf = kfs[wk]
                        src = np.where(w_val[wk])[0]
                        dst = w_idx[wk, src]
                        ok = (track_of[f, src] < 0) & (track_of[kf, dst] >= 0)
                        if self.max_match_px is not None:
                            gate = self.max_match_px * (f - kf)
                            dxy = (xs[f, src] - xs[kf, dst]) ** 2 + (
                                ys[f, src] - ys[kf, dst]
                            ) ** 2
                            ok &= dxy <= gate * gate
                        track_of[f, src[ok]] = track_of[kf, dst[ok]]

            valid_f = np.asarray(self._valid[f - dev_base])
            js = np.where(valid_f & (track_of[f] < 0))[0]
            js = js[: max(0, self.max_tracks - self._next_track)]
            track_of[f, js] = self._next_track + np.arange(len(js))
            self._next_track += len(js)

        # Trim the device buffer to the matching horizon: the next step
        # matches frames >= num_frames - 1 - reassoc_window only.
        h = self.reassoc_window + 1
        n_dev = num_frames - dev_base
        if n_dev > h:
            self._desc = self._desc[n_dev - h :]
            self._valid = self._valid[n_dev - h :]
            self._dev_base = num_frames - h

        self._frames_done = num_frames

    def _tracks_to_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        n_tracks = max(self._next_track, 8)
        num_frames = self._frames_done
        pixels = np.zeros((num_frames, n_tracks, 2))
        visible = np.zeros((num_frames, n_tracks), bool)
        f_idx, j_idx = np.where(self._track_of[:num_frames] >= 0)
        t_idx = self._track_of[f_idx, j_idx]
        pixels[f_idx, t_idx, 0] = self._xs[f_idx, j_idx]
        pixels[f_idx, t_idx, 1] = self._ys[f_idx, j_idx]
        visible[f_idx, t_idx] = True
        return pixels, visible
