"""Bundle adjustment with landmark-block Schur complement.

Green-field extension (BASELINE.json config[3]). Classic sparse BA
builds CSR Jacobians and runs sparse Cholesky on the host; none of that
maps to a jitted static-shape program. This design is dense-blocked and
fixed-capacity throughout:

- Observations live in a struct-of-arrays buffer ``(O,)`` with
  ``(camera index, landmark index, pixel, valid)`` — masked, static
  shape, vmap-friendly.
- Per-observation 2×6 / 2×3 Jacobians are closed-form (the pinhole
  projection chain rule — see :func:`_obs_terms`), verified in tests
  against ``jax.jacfwd`` of the residual. The forward-mode version
  (9 tangents through ``so3_exp`` per observation) does ~3× the
  assembly work of the closed form.
- The normal equations are assembled with ``segment_sum`` into dense
  per-camera ``(C, 6, 6)`` and per-landmark ``(L, 3, 3)`` blocks.
- Two Schur solvers:

  * ``solver="dense"`` — materializes the camera-landmark coupling
    ``W (C, L, 6, 3)`` and flattens the reduction
    ``S = H_cc − W·H_ll⁻¹·Wᵀ`` into one (6C × 3L)·(3L × 6C) matmul;
    the reduced 6C × 6C system is solved directly. Right at SLAM
    window scales (C ≲ 10², L ≲ 10⁴).
  * ``solver="cg"`` — never materializes ``W``: preconditioned CG on
    the reduced camera system with the Schur product applied
    **matrix-free** through per-observation gathers
    (``S·x = H_cc·x − W H_ll⁻¹ Wᵀ x`` where ``Wᵀx`` is two tiny
    einsums + a ``segment_sum`` over observations). O(O) memory —
    this is the path that scales to KITTI-length maps
    (10³ cameras × 10⁵ landmarks; the dense ``W`` would be 7+ GB).

- Levenberg-Marquardt: branchless accept/reject with adaptive λ.

**Sharding (parallel/distributed.py).** Every per-shard quantity below
is computed by :func:`shard_schur_pieces` parameterized by the landmark
slice a device owns; the single-device path is the 1-shard case of the
same function, and the distributed path ``psum``s the returned
camera-side pieces over the mesh — one implementation, two callers.

Gauge: the first ``num_fixed_cameras`` poses are frozen (their δ is
zeroed) — the standard gauge fix for monocular BA.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import pytree
from ..core.precision import full_precision

from .geometry import so3_exp


@pytree.dataclass
class Observations:
    """Fixed-capacity reprojection observations."""

    camera: jax.Array  # (O,) int32
    landmark: jax.Array  # (O,) int32
    uv: jax.Array  # (O, 2) float pixels
    valid: jax.Array  # (O,) bool

    @property
    def capacity(self) -> int:
        return self.camera.shape[-1]


@pytree.dataclass
class BAState:
    """Poses (world→camera), landmarks, and intrinsics."""

    rotations: jax.Array  # (C, 3, 3)
    translations: jax.Array  # (C, 3)
    points: jax.Array  # (L, 3)
    k_mat: jax.Array  # (3, 3) shared intrinsics


def reprojection_residuals(
    state: BAState, obs: Observations
) -> jax.Array:
    """Masked residuals ``(O, 2)``: predicted − observed pixels.

    Points behind a camera get their residual zeroed via the valid mask
    only if marked; callers should pre-filter cheirality.
    """
    r = state.rotations[obs.camera]  # (O, 3, 3)
    t = state.translations[obs.camera]  # (O, 3)
    x = state.points[obs.landmark]  # (O, 3)
    xc = jnp.einsum("oij,oj->oi", r, x) + t
    z = jnp.where(jnp.abs(xc[:, 2:3]) < 1e-6, 1e-6, xc[:, 2:3])
    fx = state.k_mat[0, 0]
    fy = state.k_mat[1, 1]
    cx = state.k_mat[0, 2]
    cy = state.k_mat[1, 2]
    u = fx * xc[:, 0] / z[:, 0] + cx
    v = fy * xc[:, 1] / z[:, 0] + cy
    res = jnp.stack([u, v], axis=-1) - obs.uv
    return res * obs.valid[:, None]


def _per_obs_residual(rot, t, point, uv, k_mat, dc, dl):
    """Residual of ONE observation under pose increment dc=(ω,v) and
    landmark increment dl — kept as the autodiff oracle the closed-form
    Jacobians are tested against (tests/test_ba.py)."""
    r_new = so3_exp(dc[:3]) @ rot
    t_new = t + dc[3:]
    x = point + dl
    xc = r_new @ x + t_new
    z = jnp.where(jnp.abs(xc[2]) < 1e-6, 1e-6, xc[2])
    u = k_mat[0, 0] * xc[0] / z + k_mat[0, 2]
    v = k_mat[1, 1] * xc[1] / z + k_mat[1, 2]
    return jnp.stack([u - uv[0], v - uv[1]])


def _obs_terms(rots, ts, kmat, x, cam, uv, mask):
    """Closed-form residuals + Jacobians for all observations, masked.

    ``x`` is the (O, 3) gathered landmark positions. For the
    left-multiplicative pose increment ``R ← exp(ω)·R, t ← t + v`` and
    landmark increment ``X ← X + δ``:

        xc = exp(ω)·R·(X+δ) + t + v
        ∂xc/∂ω = −[R·X]×   ∂xc/∂v = I   ∂xc/∂δ = R
        ∂(u,v)/∂xc = [[fx/z, 0, −fx·x/z²], [0, fy/z, −fy·y/z²]]

    Returns ``(res (O,2), jc (O,2,6), jl (O,2,3))``.
    """
    dtype = x.dtype
    r = rots[cam]  # (O, 3, 3)
    t = ts[cam]  # (O, 3)
    y = jnp.einsum("oij,oj->oi", r, x)  # R·X
    xc = y + t
    z = jnp.where(jnp.abs(xc[:, 2]) < 1e-6, 1e-6, xc[:, 2])
    fx = kmat[0, 0]
    fy = kmat[1, 1]
    u = fx * xc[:, 0] / z + kmat[0, 2]
    v = fy * xc[:, 1] / z + kmat[1, 2]
    res = jnp.stack([u, v], axis=-1) - uv

    zero = jnp.zeros_like(z)
    inv_z = 1.0 / z
    # dp/dxc (O, 2, 3)
    dp = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * xc[:, 0] * inv_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * xc[:, 1] * inv_z * inv_z], -1),
        ],
        axis=-2,
    )
    # −[y]× (O, 3, 3)
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    zo = jnp.zeros_like(y0)
    neg_hat = jnp.stack(
        [
            jnp.stack([zo, y2, -y1], -1),
            jnp.stack([-y2, zo, y0], -1),
            jnp.stack([y1, -y0, zo], -1),
        ],
        axis=-2,
    )
    jc = jnp.concatenate(
        [jnp.einsum("okj,oji->oki", dp, neg_hat), dp], axis=-1
    )  # (O, 2, 6)
    jl = jnp.einsum("okj,oji->oki", dp, r)  # (O, 2, 3)

    m = mask.astype(dtype)[:, None]
    return res * m, jc * m[..., None], jl * m[..., None]


def _damp(h, eye, lam):
    """LM damping: multiplicative on diagonals + small absolute floor."""
    diag = jnp.diagonal(h, axis1=-2, axis2=-1)
    d = lam * jnp.maximum(diag, 1e-8) + 1e-8
    return h + d[..., :, None] * eye


def huber_cost(res: jax.Array, delta: float | None) -> jax.Array:
    """Total (optionally Huber-robust) cost of masked residuals (O, 2).

    THE cost definition for every BA solver in the repo — the
    single-device and distributed LM accept tests compare costs computed
    on different devices and must agree bit-for-bit, so this lives in
    exactly one place. ``delta=None`` is plain least squares.
    """
    if delta is None:
        return 0.5 * jnp.sum(res * res)
    nrm = jnp.sqrt(jnp.sum(res * res, axis=-1) + 1e-12)
    quad = 0.5 * nrm * nrm
    lin = delta * (nrm - 0.5 * delta)
    return jnp.sum(jnp.where(nrm <= delta, quad, lin))


def huber_weights(res: jax.Array, delta: float | None, dtype):
    """Per-observation IRLS weights for :func:`huber_cost`'s loss.

    ``None`` when ``delta`` is None (callers skip weighting entirely).
    """
    if delta is None:
        return None
    nrm = jnp.sqrt(jnp.sum(res * res, axis=-1) + 1e-12)
    return jnp.where(nrm <= delta, 1.0, delta / nrm).astype(dtype)


def _apply_sqrt_weight(res, jc, jl, obs_weight):
    """Scale residuals/Jacobians by √w (IRLS); no-op when weight is None."""
    if obs_weight is None:
        return res, jc, jl
    sw = jnp.sqrt(obs_weight)[:, None]
    return res * sw, jc * sw[..., None], jl * sw[..., None]


# One-hot matrices above this size would dominate memory traffic; below
# it the matmul segment-sum is cheap.
_ONEHOT_BYTES_CAP = 64 * 1024 * 1024


def _segment_sum_fast(data, seg, num_segments: int):
    """``segment_sum`` that routes small segment counts through a matmul.

    ``jax.ops.segment_sum`` lowers to scatter-add; the camera-side
    normal blocks alone scatter O(observations × 42) elements. For small
    segment counts the same reduction is a one-hot ``(S, O)`` matmul:
    exact 0/1 rows, f32 HIGHEST, so the only difference from the
    scatter is fp summation order. Falls back to scatter when the
    one-hot would exceed ``_ONEHOT_BYTES_CAP`` (e.g. the 1000-camera
    ``--large`` problem at 300k observations).
    """
    o = data.shape[0]
    if num_segments * o * 4 > _ONEHOT_BYTES_CAP:
        return jax.ops.segment_sum(data, seg, num_segments)
    flat = data.reshape(o, -1)
    onehot = (
        seg[None, :] == jnp.arange(num_segments, dtype=seg.dtype)[:, None]
    ).astype(flat.dtype)
    out = jnp.dot(
        onehot,
        flat,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=flat.dtype,
    )
    return out.reshape((num_segments,) + data.shape[1:])


def _build_sorted_tables(camera, landmark, valid, num_landmarks, pad_m):
    """Sort-by-landmark index tables for the gather-side assembly.

    Everything here is state-independent (ids/validity only), so a
    solver computes it ONCE per solve and reuses it every LM iteration.
    Invalid observations sort to a sentinel bucket past the last
    landmark and never enter any run. Returns ``(order (O,), pad_idx
    (L, pad_m) indices into the SORTED rows, pad_mask (L, pad_m) bool,
    cam_pad (L, pad_m) int32)``.

    ``pad_m`` must bound the max valid observations of one landmark;
    ``num_cameras`` is a hard bound under the one-observation-per-
    (camera, landmark) contract every caller in this repo satisfies.
    """
    o = camera.shape[0]
    key = jnp.where(valid, landmark, num_landmarks).astype(jnp.int32)
    order = jnp.argsort(key)
    key_sorted = key[order]
    lids = jnp.arange(num_landmarks, dtype=jnp.int32)
    starts = jnp.searchsorted(key_sorted, lids, side="left")
    ends = jnp.searchsorted(key_sorted, lids, side="right")
    counts = ends - starts
    m = jnp.arange(pad_m, dtype=jnp.int32)
    pad_idx = jnp.clip(starts[:, None] + m[None, :], 0, o - 1)
    pad_mask = m[None, :] < counts[:, None]
    cam_pad = camera[order][pad_idx]
    return order, pad_idx, pad_mask, cam_pad


# Padded per-landmark rows are gathered at width 32: the row-gather
# engine runs at ~10-17 ns per ROW nearly independent of width (probe
# 2026-08-21: w12 0.9 ns/el, w32 0.33 ns/el, but w18 was 2.7x slower
# per row than w32 - non-tile-friendly widths pay), so one 32-wide
# gather feeds all three landmark-side reductions.
_SORTED_ROW_W = 32


def _schur_pieces_sorted(
    rots,
    ts,
    kmat,
    points,
    cam,
    lm,
    uv,
    valid,
    lam,
    num_cameras: int,
    tables,
    obs_weight=None,
) -> SchurPieces:
    """Dense-path Schur pieces with gather-side landmark reductions.

    The scatter-add ``segment_sum``s of :func:`shard_schur_pieces` are
    replaced by one padded row-gather of the sorted per-observation
    rows followed by dense masked reductions, and the W coupling by a
    one-hot slot einsum.
    Inputs must already be in sorted-by-landmark order (apply
    ``tables.order`` to the observation buffer first); ``tables`` is the
    :func:`_build_sorted_tables` result.
    """
    dtype = points.dtype
    _, pad_idx, pad_mask, cam_pad = tables
    l_total = points.shape[0]
    pad_m = pad_idx.shape[1]
    o = cam.shape[0]

    x = points[jnp.clip(lm, 0, l_total - 1)]
    res, jc, jl = _obs_terms(rots, ts, kmat, x, cam, uv, valid)
    res, jc, jl = _apply_sqrt_weight(res, jc, jl, obs_weight)

    # Camera side: already a one-hot matmul (cameras are few).
    h_cc = _segment_sum_fast(
        jnp.einsum("oki,okj->oij", jc, jc), cam, num_cameras
    )
    b_c = _segment_sum_fast(
        -jnp.einsum("oki,ok->oi", jc, res), cam, num_cameras
    )

    # Landmark side: ONE padded row gather feeds h_ll, b_l and W.
    row = jnp.concatenate(
        [jl.reshape(o, 6), res, jc.reshape(o, 12)], axis=1
    )
    row = jnp.pad(row, ((0, 0), (0, _SORTED_ROW_W - row.shape[1])))
    g = jnp.take(row, pad_idx.reshape(-1), axis=0).reshape(
        l_total, pad_m, _SORTED_ROW_W
    )
    g = g * pad_mask[:, :, None].astype(dtype)
    jl_p = g[..., :6].reshape(l_total, pad_m, 2, 3)
    res_p = g[..., 6:8]
    jc_p = g[..., 8:20].reshape(l_total, pad_m, 2, 6)

    hp = jax.lax.Precision.HIGHEST
    h_ll = jnp.einsum("lmki,lmkj->lij", jl_p, jl_p, precision=hp)
    b_l = -jnp.einsum("lmki,lmk->li", jl_p, res_p, precision=hp)

    # W via one-hot slot einsum, one-hot built fused from cam_pad (a
    # materialized (L, M, C) one-hot would be read back from memory).
    wblk = jnp.einsum("lmki,lmkj->lmij", jc_p, jl_p, precision=hp)
    onehot = (
        cam_pad[:, :, None]
        == jnp.arange(num_cameras, dtype=jnp.int32)[None, None, :]
    ).astype(dtype)
    w = jnp.einsum(
        "lmc,lmij->clij",
        onehot,
        wblk,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=dtype,
    )

    h_ll_inv = jnp.linalg.inv(_damp(h_ll, jnp.eye(3, dtype=dtype), lam))
    w_hinv = jnp.einsum("clij,ljk->clik", w, h_ll_inv)
    c = num_cameras
    w2 = jnp.transpose(w, (0, 2, 1, 3)).reshape(c * 6, l_total * 3)
    wh2 = jnp.transpose(w_hinv, (0, 2, 1, 3)).reshape(c * 6, l_total * 3)
    s_off = jnp.dot(
        wh2,
        w2.T,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=dtype,
    ).reshape(c, 6, c, 6)
    rhs_off = (wh2 @ b_l.reshape(l_total * 3)).reshape(c, 6)
    return SchurPieces(h_cc, b_c, s_off, rhs_off, w2, h_ll_inv, b_l)


def _normal_blocks(res, jc, jl, cam, num_cameras, seg, num_segments):
    """Camera/landmark normal-equation blocks via segment reduction.

    Shared by the dense Schur path (:func:`shard_schur_pieces`, which
    segments into ``l_local + 1`` with an overflow bucket for un-owned
    rows) and the matrix-free CG path (which segments by raw landmark
    id). Returns ``(h_cc (C,6,6), b_c (C,6), h_ll (S,3,3), b_l (S,3))``.
    """
    h_cc = _segment_sum_fast(
        jnp.einsum("oki,okj->oij", jc, jc), cam, num_cameras
    )
    b_c = _segment_sum_fast(
        -jnp.einsum("oki,ok->oi", jc, res), cam, num_cameras
    )
    h_ll = _segment_sum_fast(
        jnp.einsum("oki,okj->oij", jl, jl), seg, num_segments
    )
    b_l = _segment_sum_fast(
        -jnp.einsum("oki,ok->oi", jl, res), seg, num_segments
    )
    return h_cc, b_c, h_ll, b_l


class SchurPieces(NamedTuple):
    """Per-shard normal-equation/Schur contributions.

    ``h_cc, b_c, s_off, rhs_off`` are partial sums over the shard's
    observations — a caller spanning multiple shards must ``psum`` them
    before :func:`solve_reduced`. ``w2 (6C, 3L_local)``, ``h_ll_inv
    (L_local, 3, 3)`` and ``b_l (L_local, 3)`` stay local and feed
    :func:`backsub_landmarks`.
    """

    h_cc: jax.Array  # (C, 6, 6)
    b_c: jax.Array  # (C, 6)
    s_off: jax.Array  # (C, 6, C, 6)   W·H_ll⁻¹·Wᵀ contribution
    rhs_off: jax.Array  # (C, 6)       W·H_ll⁻¹·b_l contribution
    w2: jax.Array  # (6C, 3L_local)
    h_ll_inv: jax.Array  # (L_local, 3, 3)
    b_l: jax.Array  # (L_local, 3)


def shard_schur_pieces(
    rots,
    ts,
    kmat,
    points_local,
    cam,
    lm_local,
    uv,
    own,
    lam,
    num_cameras: int,
    obs_weight=None,
) -> SchurPieces:
    """Schur contribution of ONE landmark shard (the shared BA core).

    ``points_local (L_local, 3)`` is the shard's landmark slice;
    ``lm_local (O,)`` indexes into it (any value for un-owned rows);
    ``own (O,)`` marks observations whose landmark lives on this shard.
    The single-device solver is the 1-shard call (``own = valid``,
    ``lm_local = landmark``); parallel/distributed.py calls it per mesh
    shard and ``psum``s the camera-side outputs.
    """
    dtype = points_local.dtype
    l_local = points_local.shape[0]
    x = points_local[jnp.clip(lm_local, 0, l_local - 1)]
    res, jc, jl = _obs_terms(rots, ts, kmat, x, cam, uv, own)
    res, jc, jl = _apply_sqrt_weight(res, jc, jl, obs_weight)

    seg = jnp.where(own, lm_local, l_local)  # overflow bucket for un-owned
    h_cc, b_c, h_ll, b_l = _normal_blocks(
        res, jc, jl, cam, num_cameras, seg, l_local + 1
    )
    h_ll = h_ll[:l_local]
    b_l = b_l[:l_local]

    # Dense coupling W: one scatter-add of per-observation (6,3) blocks
    # into the flattened (C·L_local) pair axis.
    pair = cam * (l_local + 1) + seg
    w = jax.ops.segment_sum(
        jnp.einsum("oki,okj->oij", jc, jl),
        pair,
        num_cameras * (l_local + 1),
    ).reshape(num_cameras, l_local + 1, 6, 3)[:, :l_local]

    h_ll_inv = jnp.linalg.inv(_damp(h_ll, jnp.eye(3, dtype=dtype), lam))

    # Schur reduction flattened to ONE (6C × 3L)·(3L × 6C) matmul: a
    # block einsum over (6,3) tiles is many tiny products; the flattened
    # form is one large matmul.
    w_hinv = jnp.einsum("clij,ljk->clik", w, h_ll_inv)  # (C, L, 6, 3)
    c = num_cameras
    w2 = jnp.transpose(w, (0, 2, 1, 3)).reshape(c * 6, l_local * 3)
    wh2 = jnp.transpose(w_hinv, (0, 2, 1, 3)).reshape(c * 6, l_local * 3)
    s_off = jnp.dot(
        wh2,
        w2.T,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=dtype,
    ).reshape(c, 6, c, 6)
    rhs_off = (wh2 @ b_l.reshape(l_local * 3)).reshape(c, 6)
    return SchurPieces(h_cc, b_c, s_off, rhs_off, w2, h_ll_inv, b_l)


def solve_reduced(
    h_cc, b_c, s_off, rhs_off, lam, num_fixed_cameras: int
) -> jax.Array:
    """Solve the reduced (gauge-fixed, damped) camera system → δc (C, 6)."""
    c = h_cc.shape[0]
    dtype = h_cc.dtype
    eye6 = jnp.eye(6, dtype=dtype)
    cam_ids = jnp.arange(c)
    h_cc_d = _damp(h_cc, eye6, lam)

    s_mat = -s_off
    s_mat = s_mat.at[cam_ids, :, cam_ids, :].add(h_cc_d)
    rhs = b_c - rhs_off

    free = (cam_ids >= num_fixed_cameras).astype(dtype)
    mask = free[:, None, None, None] * free[None, None, :, None]
    s_mat = s_mat * mask
    s_mat = s_mat.at[cam_ids, :, cam_ids, :].add(
        (1.0 - free)[:, None, None] * eye6
    )
    rhs = rhs * free[:, None]

    delta_c = jnp.linalg.solve(
        s_mat.reshape(c * 6, c * 6), rhs.reshape(c * 6)
    ).reshape(c, 6)
    return delta_c * free[:, None]


def backsub_landmarks(pieces: SchurPieces, delta_c) -> jax.Array:
    """Back-substitute the shard's landmarks: δl = H_ll⁻¹ (b_l − Wᵀ δc)."""
    c6 = delta_c.shape[0] * 6
    l_local = pieces.b_l.shape[0]
    wt_dc = (pieces.w2.T @ delta_c.reshape(c6)).reshape(l_local, 3)
    return jnp.einsum("lij,lj->li", pieces.h_ll_inv, pieces.b_l - wt_dc)


def apply_step(state: BAState, delta_c, delta_l) -> BAState:
    rot_new = so3_exp(delta_c[:, :3]) @ state.rotations
    return state.replace(
        rotations=rot_new,
        translations=state.translations + delta_c[:, 3:],
        points=state.points + delta_l,
    )


# --- matrix-free (CG) Schur path --------------------------------------


def _cg_delta(
    state: BAState,
    obs: Observations,
    lam,
    num_fixed_cameras: int,
    cg_iterations: int,
    obs_weight=None,
):
    """One damped LM step via matrix-free PCG on the reduced system.

    Never materializes ``W``: every ``S·x`` product routes through the
    observation buffer (two small einsums + segment_sums), so memory is
    O(O + C·36 + L·9) and the arithmetic rides the VPU. Block-Jacobi
    preconditioner from the damped ``H_cc`` diagonal blocks.
    """
    num_cameras = state.rotations.shape[0]
    num_points = state.points.shape[0]
    dtype = state.points.dtype
    cam = obs.camera
    lm = obs.landmark
    x = state.points[lm]
    res, jc, jl = _obs_terms(
        state.rotations, state.translations, state.k_mat, x, cam, obs.uv,
        obs.valid,
    )
    res, jc, jl = _apply_sqrt_weight(res, jc, jl, obs_weight)
    h_cc, b_c, h_ll, b_l = _normal_blocks(
        res, jc, jl, cam, num_cameras, lm, num_points
    )

    eye6 = jnp.eye(6, dtype=dtype)
    h_cc_d = _damp(h_cc, eye6, lam)
    h_ll_inv = jnp.linalg.inv(_damp(h_ll, jnp.eye(3, dtype=dtype), lam))

    cam_ids = jnp.arange(num_cameras)
    free = (cam_ids >= num_fixed_cameras).astype(dtype)

    def wt_x(xc):  # Wᵀ·x : (C,6) → (L,3)
        tmp = jnp.einsum("oki,oi->ok", jc, xc[cam])  # (O, 2)
        q = jnp.einsum("oki,ok->oi", jl, tmp)  # (O, 3)
        return jax.ops.segment_sum(q, lm, num_points)

    def w_y(y):  # W·y : (L,3) → (C,6)
        tmp = jnp.einsum("oki,oi->ok", jl, y[lm])  # (O, 2)
        s = jnp.einsum("oki,ok->oi", jc, tmp)  # (O, 6)
        return jax.ops.segment_sum(s, cam, num_cameras)

    def hinv_l(y):  # H_ll⁻¹·y
        return jnp.einsum("lij,lj->li", h_ll_inv, y)

    def schur_mv(xc):  # gauge-projected S·x, identity on frozen cameras
        xm = xc * free[:, None]
        sx = jnp.einsum("cij,cj->ci", h_cc_d, xm) - w_y(hinv_l(wt_x(xm)))
        return sx * free[:, None] + xc * (1.0 - free)[:, None]

    rhs = (b_c - w_y(hinv_l(b_l))) * free[:, None]

    # Block-Jacobi preconditioner (frozen cameras already identity-safe:
    # their damped diagonal block is well-conditioned and their residual
    # is zero throughout).
    m_inv = jnp.linalg.inv(h_cc_d)

    def precond(r):
        return jnp.einsum("cij,cj->ci", m_inv, r)

    def dot(a, b):
        return jnp.sum(a * b)

    eps = jnp.asarray(1e-30, dtype)
    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)

    def body(_, carry):
        xk, rk, pk, rzk = carry
        sp = schur_mv(pk)
        alpha = rzk / (dot(pk, sp) + eps)
        xk = xk + alpha * pk
        rk = rk - alpha * sp
        zk = precond(rk)
        rzk1 = dot(rk, zk)
        beta = rzk1 / (rzk + eps)
        pk = zk + beta * pk
        return xk, rk, pk, rzk1

    delta_c, _, _, _ = jax.lax.fori_loop(
        0, cg_iterations, body, (x0, r0, p0, rz0)
    )
    delta_c = delta_c * free[:, None]
    delta_l = hinv_l(b_l - wt_x(delta_c))
    return delta_c, delta_l


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_iterations",
        "num_fixed_cameras",
        "solver",
        "cg_iterations",
        "assembly",
        "sorted_pad",
    ),
)
@full_precision
def bundle_adjust(
    state: BAState,
    obs: Observations,
    num_iterations: int = 10,
    num_fixed_cameras: int = 1,
    huber_delta: float | None = None,
    solver: str = "dense",
    cg_iterations: int = 32,
    assembly: str = "sorted",
    sorted_pad: int = 0,
) -> tuple[BAState, jax.Array]:
    """Levenberg-Marquardt BA. Returns (refined state, final cost).

    ``huber_delta`` (pixels) enables IRLS robust weighting of
    observations; ``None`` is plain least squares. ``solver="dense"``
    materializes the coupling block (fast at SLAM-window scale);
    ``solver="cg"`` is the matrix-free path for large maps.

    ``assembly``: ``"sorted"`` (default; dense solver only) sorts the
    observation buffer by landmark once per solve and runs the
    landmark-side reductions gather-side (:func:`_schur_pieces_sorted`:
    row gathers in place of scatter-adds);
    ``"scatter"`` is the ``segment_sum`` path (also what the
    distributed solver uses per shard). ``sorted_pad`` bounds the max
    observations of one landmark (0 → ``num_cameras``, the hard bound
    under the one-obs-per-(camera, landmark) contract; pass the true
    host-known max to shrink the padded gather).
    """
    num_cameras = state.rotations.shape[0]
    dtype = state.points.dtype

    def cost_of(s):
        return huber_cost(reprojection_residuals(s, obs), huber_delta)

    def weights_of(s):
        if huber_delta is None:
            return None
        return huber_weights(
            reprojection_residuals(s, obs), huber_delta, dtype
        )

    use_sorted = assembly == "sorted" and solver == "dense"
    if use_sorted:
        pad_m = sorted_pad if sorted_pad > 0 else num_cameras
        pad_m = min(pad_m, obs.capacity)
        tables = _build_sorted_tables(
            obs.camera, obs.landmark, obs.valid,
            state.points.shape[0], pad_m,
        )
        order = tables[0]
        obs = Observations(
            camera=obs.camera[order],
            landmark=obs.landmark[order],
            uv=obs.uv[order],
            valid=obs.valid[order],
        )

    lam = jnp.asarray(1e-4, dtype)
    cost = cost_of(state)
    for _ in range(num_iterations):
        if solver == "cg":
            delta_c, delta_l = _cg_delta(
                state, obs, lam, num_fixed_cameras, cg_iterations,
                weights_of(state),
            )
        elif use_sorted:
            pieces = _schur_pieces_sorted(
                state.rotations,
                state.translations,
                state.k_mat,
                state.points,
                obs.camera,
                obs.landmark,
                obs.uv,
                obs.valid,
                lam,
                num_cameras,
                tables,
                weights_of(state),
            )
        else:
            pieces = shard_schur_pieces(
                state.rotations,
                state.translations,
                state.k_mat,
                state.points,
                obs.camera,
                obs.landmark,
                obs.uv,
                obs.valid,
                lam,
                num_cameras,
                weights_of(state),
            )
        if solver != "cg":
            delta_c = solve_reduced(
                pieces.h_cc,
                pieces.b_c,
                pieces.s_off,
                pieces.rhs_off,
                lam,
                num_fixed_cameras,
            )
            delta_l = backsub_landmarks(pieces, delta_c)
        cand = apply_step(state, delta_c, delta_l)
        cand_cost = cost_of(cand)
        accept = cand_cost < cost
        state = jax.tree.map(
            lambda new, old: jnp.where(accept, new, old), cand, state
        )
        cost = jnp.where(accept, cand_cost, cost)
        lam = jnp.clip(
            jnp.where(accept, lam * 0.3, lam * 6.0), 1e-9, 1e5
        )
    return state, cost
