"""Multi-device execution: data-parallel frontend + landmark-sharded BA.

Accelerator replacement for the reference's 2-thread postMessage model
(SURVEY.md §5.8): the only inter-participant channel here is XLA
collectives over the device mesh (``psum`` over NVLink on GPUs), driven
by ``shard_map``. The cards of one host are joined all to all, so the
mesh is a plain 1-D axis.

Sharding layout (BASELINE.json config[4]):

- **Frontend**: images are data-parallel — batch axis sharded over the
  mesh; the whole detect+describe pipeline runs independently per shard.
- **Bundle adjustment**: the landmark block is the big axis, so
  landmarks (and their normal-equation blocks ``H_ll``, ``W``, ``b_l``)
  are sharded; every device computes the Schur contribution of ITS
  landmarks and one ``psum`` produces the reduced camera system, which
  is solved replicated (cameras are small). Landmark updates
  back-substitute locally — no gather of the landmark block ever
  materializes on one device.

Observation buffers are sharded by the landmark owner: host-side
grouping places each observation on the device that holds its landmark,
so the per-observation work (residuals, Jacobians, Schur assembly — the
dominant cost) is divided, not replicated, and psum'd camera-side sums
count every observation exactly once. (The earlier replicated-buffer +
ownership-mask layout made every device walk ALL observations: 8-device
BA measured ~0.1 parallel efficiency — slower than one device.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SiftConfig
from ..core.precision import full_precision
from ..models.frontend import detect_and_describe_batched
from ..sfm.ba import (
    BAState,
    Observations,
    _obs_terms,
    backsub_landmarks,
    huber_cost,
    huber_weights,
    shard_schur_pieces,
    solve_reduced,
)
from ..sfm.geometry import so3_exp


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default).

    Raises ``ValueError`` when the default backend has fewer devices than
    asked for: a mesh never silently moves to another backend.
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh: {n_devices} devices requested, but the "
                f"{jax.default_backend()} backend has {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=(axis,))


def detect_and_describe_data_parallel(
    images: jax.Array, cfg: SiftConfig, mesh: Mesh, blur: str = "separable"
):
    """Batched frontend with the batch axis sharded over the mesh.

    Runs through ``shard_map`` (not jit+in_shardings): each device
    executes the WHOLE per-shard program on its local batch slice. DP
    frontend has no cross-shard communication, so the semantics are
    identical to the single-device frontend.
    """
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    images = jax.device_put(images, sharding)
    fn = shard_map(
        functools.partial(detect_and_describe_batched, cfg=cfg, blur=blur),
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)(images)


def match_against_keyframes_sharded(
    query_desc: jax.Array,
    query_valid: jax.Array,
    keyframe_desc: jax.Array,
    keyframe_valid: jax.Array,
    mesh: Mesh,
    ratio: float = 0.8,
):
    """Match one query set against many keyframes, sharded by keyframe.

    BASELINE.json config[4]: "batched keypoint matching sharded by
    keyframe". ``keyframe_desc``: ``(K, M, 128)`` with K a multiple of
    the mesh size (pad with invalid keyframes otherwise). The query is
    replicated; each device runs the distance matmul + ratio/mutual
    test for its keyframe slice — no collectives needed, results come
    back keyframe-sharded.

    Returns ``(index (K, N), distance (K, N), valid (K, N))``.
    """
    from ..ops.matching import match_descriptors

    axis = mesh.axis_names[0]

    def local(q_desc, q_valid, kf_d, kf_v):
        def one(kd, kv):
            m = match_descriptors(q_desc, q_valid, kd, kv, ratio=ratio)
            return m.index, m.distance, m.valid

        return jax.vmap(one)(kf_d, kf_v)

    sharded = P(axis)
    rep = P()
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(rep, rep, sharded, sharded),
        out_specs=(sharded, sharded, sharded),
    )
    return jax.jit(fn)(query_desc, query_valid, keyframe_desc, keyframe_valid)


def _pad_landmarks(state: BAState, n_shards: int) -> tuple[BAState, int]:
    """Pad the landmark axis to a multiple of the mesh size."""
    l = state.points.shape[0]
    pad = (-l) % n_shards
    if pad:
        state = state.replace(
            points=jnp.concatenate(
                [state.points, jnp.zeros((pad, 3), state.points.dtype)]
            )
        )
    return state, l + pad


@functools.lru_cache(maxsize=64)
def _ba_program(
    mesh: Mesh,
    axis: str,
    num_iterations: int,
    num_fixed_cameras: int,
    huber_delta: float | None,
):
    """Cached jitted landmark-sharded LM program for one static config.

    One program per (mesh, iteration/gauge/robust config); geometric
    sizes (cameras, landmarks-per-shard, observations-per-shard) are
    derived from traced shapes, so jit's own shape cache handles those —
    combined with the caller's power-of-two observation bucketing this
    bounds compile count over a whole SLAM run (previously every call
    built a fresh ``jax.jit`` and recompiled the unrolled LM loop).
    """

    def local_residuals(rots, ts, kmat, points_local, cam, lm_local, uv, own):
        l_local = points_local.shape[0]
        x = points_local[jnp.clip(lm_local, 0, l_local - 1)]
        res, _, _ = _obs_terms(rots, ts, kmat, x, cam, uv, own)
        return res

    def step(points_local, rots, ts, kmat, cam, lm, uv, valid, lam, cost):
        l_local = points_local.shape[0]
        num_cameras = rots.shape[0]
        shard = jax.lax.axis_index(axis)
        offset = shard * l_local
        lm_local = lm - offset
        own = valid & (lm_local >= 0) & (lm_local < l_local)

        # Shared BA core (sfm/ba.py) computes this shard's contribution;
        # camera-side pieces are partial sums over locally-owned
        # observations → one psum each produces the replicated reduced
        # system, solved identically on every device.
        res_cur = local_residuals(
            rots, ts, kmat, points_local, cam, lm_local, uv, own
        )
        pieces = shard_schur_pieces(
            rots, ts, kmat, points_local, cam, lm_local, uv, own, lam,
            num_cameras,
            huber_weights(res_cur, huber_delta, points_local.dtype),
        )
        h_cc = jax.lax.psum(pieces.h_cc, axis)
        b_c = jax.lax.psum(pieces.b_c, axis)
        s_off = jax.lax.psum(pieces.s_off, axis)
        rhs_off = jax.lax.psum(pieces.rhs_off, axis)
        delta_c = solve_reduced(
            h_cc, b_c, s_off, rhs_off, lam, num_fixed_cameras
        )
        delta_l = backsub_landmarks(pieces, delta_c)

        rots_new = so3_exp(delta_c[:, :3]) @ rots
        ts_new = ts + delta_c[:, 3:]
        points_new = points_local + delta_l

        # New cost (local residuals → psum). Must be the same robust
        # cost as the single-device accept test (sfm/ba.py uses the
        # shared huber_cost too), else the two solvers diverge on which
        # LM steps they accept.
        res_new = local_residuals(
            rots_new, ts_new, kmat, points_new, cam, lm_local, uv, own
        )
        cost_new = jax.lax.psum(huber_cost(res_new, huber_delta), axis)

        accept = cost_new < cost
        rots = jnp.where(accept, rots_new, rots)
        ts = jnp.where(accept, ts_new, ts)
        points_local = jnp.where(accept, points_new, points_local)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.clip(
            jnp.where(accept, lam * 0.3, lam * 6.0), 1e-9, 1e5
        )
        return points_local, rots, ts, lam, cost

    def run(points, rots, ts, kmat, cam, lm, uv, valid):
        # Each device's observation block arrives as (1, n_max, ...).
        cam, lm, uv, valid = cam[0], lm[0], uv[0], valid[0]
        l_local = points.shape[0]
        # Initial cost.
        shard = jax.lax.axis_index(axis)
        offset = shard * l_local
        lm_local = lm - offset
        own = valid & (lm_local >= 0) & (lm_local < l_local)
        res0 = local_residuals(rots, ts, kmat, points, cam, lm_local, uv, own)
        cost = jax.lax.psum(huber_cost(res0, huber_delta), axis)
        lam = jnp.asarray(1e-4, points.dtype)
        for _ in range(num_iterations):
            points, rots, ts, lam, cost = step(
                points, rots, ts, kmat, cam, lm, uv, valid, lam, cost
            )
        return points, rots, ts, cost

    sharded = P(axis)
    rep = P()
    return jax.jit(
        shard_map(
            run,
            mesh=mesh,
            in_specs=(
                sharded, rep, rep, rep, sharded, sharded, sharded, sharded,
            ),
            out_specs=(sharded, rep, rep, rep),
        )
    )


@full_precision
def distributed_bundle_adjust(
    state: BAState,
    obs: Observations,
    mesh: Mesh,
    num_iterations: int = 10,
    num_fixed_cameras: int = 1,
    huber_delta: float | None = None,
) -> tuple[BAState, jax.Array]:
    """Landmark-sharded LM bundle adjustment over a device mesh.

    Semantics match :func:`..sfm.ba.bundle_adjust` (including IRLS Huber
    weighting via ``huber_delta``); the Schur reduction of the landmark
    block is a ``psum`` over the mesh axis. Returns (refined state,
    final cost).
    """
    axis = mesh.axis_names[0]
    n_shards = mesh.shape[axis]
    orig_l = state.points.shape[0]
    state, l_padded = _pad_landmarks(state, n_shards)
    l_local = l_padded // n_shards

    # Group observations by owning landmark shard (host-side, eager):
    # row s of the (n_shards, n_max) buffers holds exactly the
    # observations whose landmark lives on shard s, padded with
    # valid=False slots. Deterministic numpy, so every process of a
    # multi-host run builds identical buffers.
    lm_np = np.asarray(obs.landmark)
    cam_np = np.asarray(obs.camera)
    uv_np = np.asarray(obs.uv)
    valid_np = np.asarray(obs.valid)
    owner = np.clip(lm_np // l_local, 0, n_shards - 1)
    counts = np.bincount(owner[valid_np], minlength=n_shards)
    # Power-of-two bucket: a SLAM run calls this every ba_interval frames
    # with a slowly growing observation set; bucketing bounds the number
    # of distinct shapes the cached program compiles for (the raw
    # counts.max() gave a fresh shape — and a full recompile of the
    # unrolled LM loop — on nearly every call).
    n_max = 1 << max(3, (max(int(counts.max()), 1) - 1).bit_length())
    cam_s = np.zeros((n_shards, n_max), cam_np.dtype)
    # Padding slots point at the shard's own first landmark so
    # lm_local stays in range (they are masked by valid anyway).
    lm_s = np.broadcast_to(
        (np.arange(n_shards, dtype=lm_np.dtype) * l_local)[:, None],
        (n_shards, n_max),
    ).copy()
    uv_s = np.zeros((n_shards, n_max) + uv_np.shape[1:], uv_np.dtype)
    valid_s = np.zeros((n_shards, n_max), bool)
    for s_idx in range(n_shards):
        idx = np.where(valid_np & (owner == s_idx))[0]
        cam_s[s_idx, : len(idx)] = cam_np[idx]
        lm_s[s_idx, : len(idx)] = lm_np[idx]
        uv_s[s_idx, : len(idx)] = uv_np[idx]
        valid_s[s_idx, : len(idx)] = True
    if jax.process_count() > 1:
        from .multihost import put_global

        cam_s, lm_s, uv_s, valid_s = (
            put_global(a, mesh, P(axis)) for a in (cam_s, lm_s, uv_s, valid_s)
        )

    program = _ba_program(
        mesh, axis, num_iterations, num_fixed_cameras, huber_delta
    )
    points, rots, ts, cost = program(
        state.points,
        state.rotations,
        state.translations,
        state.k_mat,
        cam_s,
        lm_s,
        uv_s,
        valid_s,
    )
    out_state = BAState(
        rotations=rots,
        translations=ts,
        # Eager slicing of a multi-process global array is illegal; skip
        # the crop when no padding was added (multi-host callers pad
        # landmarks to a mesh multiple themselves).
        points=points if orig_l == l_padded else points[:orig_l],
        k_mat=state.k_mat,
    )
    return out_state, cost
