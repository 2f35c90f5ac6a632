"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Green-field extension (incremental SfM, BASELINE.json config[3]).
Static-shape design: a linear DLT initialization (12-unknown SVD, batched-friendly)
plus a branchless Levenberg-Marquardt reprojection refinement with
optional Huber IRLS — all fixed-shape masked ops. In a sequential SLAM
loop the previous keyframe's pose is the natural init and DLT is only
needed for relocalization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.precision import full_precision
from .geometry import so3_exp


def pnp_dlt(
    points: jax.Array, uv: jax.Array, valid: jax.Array, k_mat: jax.Array
):
    """Linear PnP: fit P = K[R|t] by SVD, orthogonalize R.

    ``points``: (N, 3) world; ``uv``: (N, 2) pixels; masked by ``valid``.
    Returns (R, t). Needs ≥6 well-spread correspondences; refine with
    :func:`solve_pnp` afterwards.
    """
    dtype = points.dtype
    # Normalized image coords.
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    cx, cy = k_mat[0, 2], k_mat[1, 2]
    x = (uv[:, 0] - cx) / fx
    y = (uv[:, 1] - cy) / fy

    n = points.shape[0]
    wv = valid.astype(dtype)
    # Hartley-style normalization of the 3D points (center + scale to
    # mean norm √3): the raw DLT columns span X, 1, and x·X magnitudes,
    # and this module's essential-matrix solver documents that
    # unnormalized float32 minimal fits fail outright on conditioning
    # (ops/ransac.py) — the same hazard applies here for scenes offset
    # from the origin. P is denormalized afterwards.
    n_valid = jnp.maximum(jnp.sum(wv), 1.0)
    centroid = jnp.sum(points * wv[:, None], axis=0) / n_valid
    centered = points - centroid
    mean_norm = jnp.sum(
        jnp.linalg.norm(centered, axis=-1) * wv
    ) / n_valid
    norm_scale = jnp.sqrt(jnp.asarray(3.0, dtype)) / jnp.maximum(
        mean_norm, 1e-12
    )
    pts_n = centered * norm_scale

    ones = jnp.ones((n,), dtype)
    zeros = jnp.zeros((n, 4), dtype)
    xh = jnp.concatenate([pts_n, ones[:, None]], axis=-1)  # (N, 4)
    w = wv[:, None]
    rows_u = jnp.concatenate([xh, zeros, -x[:, None] * xh], axis=-1) * w
    rows_v = jnp.concatenate([zeros, xh, -y[:, None] * xh], axis=-1) * w
    a = jnp.concatenate([rows_u, rows_v], axis=0)  # (2N, 12)

    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    p_n = vt[-1].reshape(3, 4)
    # Denormalize: x ~ P_n·(T·X_h) with T = [[s·I, −s·c], [0, 1]].
    t_mat = jnp.concatenate(
        [
            norm_scale * jnp.eye(3, dtype=dtype),
            (-norm_scale * centroid)[:, None],
        ],
        axis=-1,
    )
    t_mat = jnp.concatenate(
        [t_mat, jnp.asarray([[0.0, 0.0, 0.0, 1.0]], dtype)], axis=0
    )
    p = p_n @ t_mat

    xh_raw = jnp.concatenate([points, ones[:, None]], axis=-1)
    m = p[:, :3]
    # Sign: points must have positive depth on average (a total choice —
    # sign() could return 0 on exact cancellation and zero the pose).
    depth_sum = jnp.sum((xh_raw @ p[2]) * wv)
    depth_sign = jnp.where(depth_sum >= 0, 1.0, -1.0).astype(dtype)
    m = m * depth_sign
    t_raw = p[:, 3] * depth_sign

    # Orthogonalize: R = UVᵀ of M; scale t by the mean singular value.
    u, s, vt2 = jnp.linalg.svd(m)
    rot = u @ vt2
    rot = rot * jnp.sign(jnp.linalg.det(rot))
    scale = jnp.mean(s)
    t = t_raw / jnp.maximum(scale, 1e-12)
    return rot, t


@functools.partial(
    jax.jit, static_argnames=("iterations", "huber_delta")
)
@full_precision
def solve_pnp(
    points: jax.Array,
    uv: jax.Array,
    valid: jax.Array,
    k_mat: jax.Array,
    init_rotation: jax.Array,
    init_translation: jax.Array,
    iterations: int = 10,
    huber_delta: float | None = 2.0,
):
    """LM reprojection refinement of a camera pose (world→camera).

    Branchless accept/reject LM (see ops/ransac.refine_relative_pose for
    why plain GN is not enough). ``huber_delta`` in pixels enables IRLS
    robust weighting; None = plain least squares. Returns
    ``(R, t, rms)`` with rms over valid observations.

    Jitted at definition (callers pad to pow2 buckets): eagerly, the
    ~30 unrolled LM iterations would dispatch hundreds of individual
    ops per call.
    """
    dtype = points.dtype
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    cx, cy = k_mat[0, 2], k_mat[1, 2]
    wv = valid.astype(dtype)

    def residuals(params, rot, t, weights):
        r_new = so3_exp(params[:3]) @ rot
        t_new = t + params[3:]
        xc = points @ r_new.T + t_new
        # Sign-preserving depth clamp (matches geometry.project): a
        # point marginally behind the camera must NOT be projected as
        # if in front — that flips the residual's sign and injects a
        # wrong-direction row into JᵀJ.
        z = jnp.where(
            jnp.abs(xc[:, 2]) < 1e-6,
            jnp.where(xc[:, 2] < 0, -1e-6, 1e-6),
            xc[:, 2],
        )
        u = fx * xc[:, 0] / z + cx
        v = fy * xc[:, 1] / z + cy
        res = jnp.stack([u - uv[:, 0], v - uv[:, 1]], axis=-1)
        return (res * weights[:, None]).reshape(-1)

    def irls_weights(rot, t):
        if huber_delta is None:
            return wv
        res = residuals(jnp.zeros(6, dtype), rot, t, wv).reshape(-1, 2)
        nrm = jnp.sqrt(jnp.sum(res * res, axis=-1) + 1e-12)
        return wv * jnp.sqrt(
            jnp.where(nrm <= huber_delta, 1.0, huber_delta / nrm)
        )

    zero6 = jnp.zeros(6, dtype)

    def lm_rounds(rot, t, weight_fn, n_iter):
        lam = jnp.asarray(1e-3, dtype)
        for _ in range(n_iter):
            weights = weight_fn(rot, t)
            res = residuals(zero6, rot, t, weights)
            # Reference cost under the SAME weights as the proposal's —
            # comparing against a cost carried over from the previous
            # iteration's weights made the accept test inconsistent
            # once IRLS re-weighting kicked in (shrinking residuals
            # raise the weights, so a genuinely improving step could
            # fail against the stale smaller reference and stall LM).
            cost = jnp.sum(res * res)
            jac = jax.jacfwd(residuals)(zero6, rot, t, weights)
            jtj = jac.T @ jac
            jtj_d = jtj + lam * jnp.diag(
                jnp.maximum(jnp.diagonal(jtj), 1e-8)
            ) + 1e-9 * jnp.eye(6, dtype=dtype)
            step = -jnp.linalg.solve(jtj_d, jac.T @ res)
            rot_new = so3_exp(step[:3]) @ rot
            t_new = t + step[3:]
            cost_new = jnp.sum(residuals(zero6, rot_new, t_new, weights) ** 2)
            accept = cost_new < cost
            rot = jnp.where(accept, rot_new, rot)
            t = jnp.where(accept, t_new, t)
            lam = jnp.clip(jnp.where(accept, lam * 0.33, lam * 8.0), 1e-9, 1e6)
        return rot, t

    rot, t = lm_rounds(init_rotation, init_translation, irls_weights, iterations)

    if huber_delta is not None:
        # Second phase: hard-gate outliers (> 3·δ px) to weight 0 and
        # re-polish — IRLS alone leaves a residual bias from downweighted
        # but nonzero outlier pull.
        res0 = residuals(zero6, rot, t, wv).reshape(-1, 2)
        nrm = jnp.sqrt(jnp.sum(res0 * res0, axis=-1) + 1e-12)
        gate = wv * (nrm < 3.0 * huber_delta)
        rot, t = lm_rounds(rot, t, lambda *_: gate, max(iterations // 2, 3))

    res = residuals(zero6, rot, t, wv).reshape(-1, 2)
    n_valid = jnp.maximum(jnp.sum(wv), 1.0)
    rms = jnp.sqrt(jnp.sum(res * res) / n_valid)
    return rot, t, rms
