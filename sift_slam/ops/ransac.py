"""Vectorized RANSAC essential-matrix estimation + pose recovery.

Green-field extension (BASELINE.json config[2]; the reference has no
geometry stage). Static-shape design: instead of the classic sequential
hypothesize-and-verify loop, ALL hypotheses are processed as one batch —

- sample ``(H, 8)`` DISTINCT correspondence indices via top_k over
  per-hypothesis random keys,
- solve all 8-point problems with one batched SVD (Hartley-normalized),
- score every hypothesis against every correspondence with a single
  einsum (Sampson error, ``(H, N)``),
- polish the top-K hypotheses in one vmap (pose recovery + annealed
  IRLS Levenberg-Marquardt on the essential manifold) and keep the
  winner by final inlier count.

Inputs are normalized camera rays (pixels through K⁻¹,
:func:`..sfm.geometry.backproject`), so thresholds are in normalized
image units (pixel_thresh / focal_length).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import pytree
from ..core.precision import full_precision

from ..sfm.geometry import hat, so3_exp, triangulate_midpoint


@pytree.dataclass
class EssentialResult:
    e_mat: jax.Array  # (3, 3) best essential matrix (refit on inliers)
    inliers: jax.Array  # (N,) bool
    num_inliers: jax.Array  # () int32
    rotation: jax.Array  # (3, 3) world->cam2 rotation (cam1 = identity)
    translation: jax.Array  # (3,) unit-norm translation


def _eight_point_nullvec(a_rows: jax.Array) -> jax.Array:
    """Least-squares null vector of batched ``(..., K, 9)`` constraint rows.

    Uses the right-singular vector of A directly (batched SVD), NOT the
    smallest eigenvector of AᵀA: squaring doubles the condition number's
    exponent, which in float32 turned minimal-sample fits into noise
    (κ(A)≈3e2 → κ(AᵀA)≈1e5 ≫ 1/eps_f32 margin).
    """
    # full_matrices=True is load-bearing: an 8×9 minimal system's null
    # vector is the 9th right-singular vector, which the reduced SVD
    # (8 rows of Vᵀ) silently drops.
    _, _, vt = jnp.linalg.svd(a_rows, full_matrices=True)
    return vt[..., -1, :]


def _project_to_essential(e_mat: jax.Array) -> jax.Array:
    """Nearest essential matrix: SVD with singular values (1, 1, 0)."""
    u, _, vt = jnp.linalg.svd(e_mat)
    s = jnp.asarray([1.0, 1.0, 0.0], e_mat.dtype)
    return u @ (s[..., :, None] * vt)


def _epipolar_rows(rays1: jax.Array, rays2: jax.Array) -> jax.Array:
    """Constraint rows ``kron(ray2, ray1)``: ``(..., N, 9)``.

    Row·vec(E) = ray2ᵀ E ray1 with E flattened row-major.
    """
    return (rays2[..., :, None] * rays1[..., None, :]).reshape(
        rays1.shape[:-1] + (9,)
    )


def _normalizing_transform(rays: jax.Array, weight: jax.Array) -> jax.Array:
    """Hartley normalization: similarity T centering weighted (x, y) at 0
    with RMS radius √2. Essential for float32: even with the direct-SVD
    nullspace solve (:func:`_eight_point_nullvec`), unnormalized
    float32 minimal fits were observed to fail outright on
    conditioning — κ(A) of raw-ray constraint rows exceeds the usable
    float32 margin.
    """
    dtype = rays.dtype
    wsum = jnp.maximum(jnp.sum(weight), 1.0)
    mean = jnp.sum(rays[:, :2] * weight[:, None], axis=0) / wsum
    d2 = jnp.sum((rays[:, :2] - mean) ** 2, axis=-1)
    rms = jnp.sqrt(jnp.maximum(jnp.sum(d2 * weight) / wsum, 1e-12))
    s = jnp.sqrt(jnp.asarray(2.0, dtype)) / rms
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    return jnp.array(
        [
            [s, zero, -s * mean[0]],
            [zero, s, -s * mean[1]],
            [zero, zero, one],
        ]
    )


def sampson_error(e_mat: jax.Array, rays1: jax.Array, rays2: jax.Array):
    """First-order epipolar (Sampson) error, broadcast over hypotheses.

    ``e_mat``: ``(..., 3, 3)``; rays ``(N, 3)``. Returns ``(..., N)``.
    """
    er1 = jnp.einsum("...ij,nj->...ni", e_mat, rays1)
    etr2 = jnp.einsum("...ji,nj->...ni", e_mat, rays2)
    num = jnp.sum(rays2 * er1, axis=-1) ** 2
    den = (
        er1[..., 0] ** 2
        + er1[..., 1] ** 2
        + etr2[..., 0] ** 2
        + etr2[..., 1] ** 2
    )
    return num / jnp.maximum(den, 1e-12)


def decompose_essential(e_mat: jax.Array):
    """E → four (R, t) candidates: (R1, ±t), (R2, ±t)."""
    u, _, vt = jnp.linalg.svd(e_mat)
    # Enforce proper rotations (sign factors broadcast over any leading
    # hypothesis batch: det is (...,), the matrices (..., 3, 3)).
    u = u * jnp.sign(jnp.linalg.det(u))[..., None, None]
    vt = vt * jnp.sign(jnp.linalg.det(vt))[..., None, None]
    w = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], e_mat.dtype)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[..., :, 2]
    return (r1, r2), t


def recover_pose(
    e_mat: jax.Array,
    rays1: jax.Array,
    rays2: jax.Array,
    weight: jax.Array,
):
    """Choose the (R, t) decomposition with maximal positive-depth support.

    ``weight``: per-correspondence float mask. Returns ``(R, t)`` of the
    world→camera-2 pose with camera 1 at identity, ``t`` unit norm.
    """
    (r1, r2), t = decompose_essential(e_mat)
    eye = jnp.eye(3, dtype=e_mat.dtype)
    zero = jnp.zeros(3, dtype=e_mat.dtype)

    def support(r, tt):
        _, depths = triangulate_midpoint(eye, zero, r, tt, rays1, rays2)
        good = (depths[..., 0] > 0) & (depths[..., 1] > 0)
        return jnp.sum(good * weight, axis=-1)

    cands_r = jnp.stack([r1, r1, r2, r2])
    cands_t = jnp.stack([t, -t, t, -t])
    scores = jax.vmap(support)(cands_r, cands_t)
    best = jnp.argmax(scores)
    return cands_r[best], cands_t[best]


def refine_relative_pose(
    rot: jax.Array,
    t: jax.Array,
    rays1: jax.Array,
    rays2: jax.Array,
    weight: jax.Array,
    iterations: int = 8,
    damping: float = 1e-6,
):
    """Gauss-Newton polish of (R, t) minimizing weighted Sampson error.

    The linear 8-point fit minimizes *algebraic* error, which at realistic
    keypoint noise (≈1e-3 normalized ≈ 0.5 px) lands far from the Sampson
    optimum — measured: an algebraic fit on 180 clean correspondences
    kept only ~50 of them within a 3e-3 Sampson gate, while the true
    model kept 181. This GN loop on the essential manifold closes that
    gap. Parameterization: left-multiplicative so3 increment on R, free
    3-vector on t renormalized each step (scale is unobservable; the
    normalization removes the gauge direction up to GN damping).
    """
    dtype = rays1.dtype

    def residuals(params, r0, t0):
        w_inc, dt_ = params[:3], params[3:]
        r_cur = so3_exp(w_inc) @ r0
        t_cur = t0 + dt_
        t_cur = t_cur / jnp.sqrt(jnp.sum(t_cur * t_cur) + 1e-12)
        e_cur = hat(t_cur) @ r_cur
        # Signed Sampson residual (r2ᵀ·E·r1)/√den — smooth everywhere;
        # √(sampson_error) would have a gradient singularity at zero
        # residual that lets perfectly-fit points dominate JᵀJ.
        er1 = jnp.einsum("ij,nj->ni", e_cur, rays1)
        etr2 = jnp.einsum("ji,nj->ni", e_cur, rays2)
        num = jnp.sum(rays2 * er1, axis=-1)
        den = (
            er1[..., 0] ** 2
            + er1[..., 1] ** 2
            + etr2[..., 0] ** 2
            + etr2[..., 1] ** 2
        )
        return (num / jnp.sqrt(den + 1e-12)) * weight

    # Branchless Levenberg-Marquardt: plain GN with fixed tiny damping was
    # observed to DIVERGE on small inlier sets (112° rotation drift from a
    # ground-truth start on 54 points). Each iteration computes the step
    # at the current damping, accepts it only if the cost drops, and
    # adapts damping — all with jnp.where, no host control flow.
    zero6 = jnp.zeros(6, dtype)
    lam = jnp.asarray(1e-3, dtype)
    cost = jnp.sum(residuals(zero6, rot, t) ** 2)
    for _ in range(iterations):
        res = residuals(zero6, rot, t)
        jac = jax.jacfwd(residuals)(zero6, rot, t)  # (N, 6)
        jtj = jac.T @ jac
        diag = jnp.diagonal(jtj)
        jtj_damped = jtj + lam * jnp.diag(jnp.maximum(diag, 1e-9)) + damping * jnp.eye(6, dtype=dtype)
        step = -jnp.linalg.solve(jtj_damped, jac.T @ res)
        rot_new = so3_exp(step[:3]) @ rot
        t_new = t + step[3:]
        t_new = t_new / jnp.sqrt(jnp.sum(t_new * t_new) + 1e-12)
        cost_new = jnp.sum(residuals(zero6, rot_new, t_new) ** 2)
        accept = cost_new < cost
        rot = jnp.where(accept, rot_new, rot)
        t = jnp.where(accept, t_new, t)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.where(accept, lam * 0.33, lam * 8.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
    return rot, t


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
@full_precision
def estimate_essential_ransac(
    rays1: jax.Array,
    rays2: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 512,
    inlier_threshold: float = 2e-3,
) -> EssentialResult:
    """Batched-hypothesis RANSAC over fixed-capacity correspondence slots.

    Jitted at definition (eager execution would dispatch each of the
    hypothesis pipeline's ops individually); ``inlier_threshold`` stays
    dynamic so per-camera thresholds don't recompile.

    ``rays1``/``rays2``: ``(N, 3)`` normalized rays; ``valid``: ``(N,)``.
    ``inlier_threshold`` is on the SQUARE ROOT of the Sampson error, in
    normalized units (≈ pixel_threshold / focal_px).
    """
    dtype = rays1.dtype
    w = valid.astype(dtype)

    # Hartley-normalize both views (conditioning for the float32 eigs);
    # fitted Ê relates normalized rays, E = T2ᵀ·Ê·T1 undoes it.
    t1 = _normalizing_transform(rays1, w)
    t2 = _normalizing_transform(rays2, w)
    nrays1 = rays1 @ t1.T
    nrays2 = rays2 @ t2.T

    # Sample 8 DISTINCT valid correspondences per hypothesis: top_k over
    # per-hypothesis random keys (categorical sampling WITH replacement
    # made ~a third of hypotheses rank-deficient at N≈64 — a duplicated
    # row leaves a 2-D nullspace and the SVD returns garbage).
    u = jax.random.uniform(key, (num_hypotheses, rays1.shape[0]))
    u = jnp.where(valid[None, :], u, -1.0)
    _, idx = jax.lax.top_k(u, 8)  # (H, 8) distinct valid slots

    rows_all = _epipolar_rows(nrays1, nrays2)  # (N, 9)
    a = rows_all[idx]  # (H, 8, 9)
    e_flat = _eight_point_nullvec(a)  # (H, 9)
    e_h = t2.T @ e_flat.reshape(-1, 3, 3) @ t1
    e_h = _project_to_essential(e_h)  # (H, 3, 3)

    err = sampson_error(e_h, rays1, rays2)  # (H, N)
    thr2 = inlier_threshold * inlier_threshold
    inlier_mat = (err < thr2) & valid[None, :]
    counts = jnp.sum(inlier_mat, axis=-1)

    # Local optimization (batched LO-RANSAC): minimal/algebraic fits
    # plateau far below the true inlier count at realistic noise (see
    # refine_relative_pose), and the single best hypothesis can sit in a
    # degenerate basin — so polish the TOP-K hypotheses in one vmap
    # (recover pose → IRLS Gauss-Newton with Cauchy weights over all
    # correspondences) and keep the winner by final inlier count.
    top_k = min(8, num_hypotheses)
    _, cand_idx = jax.lax.top_k(counts, top_k)

    def polish(h):
        e0 = e_h[h]
        w0 = inlier_mat[h].astype(dtype)
        rot, t = recover_pose(e0, rays1, rays2, w0)
        # Graduated non-convexity: start the Cauchy scale wide so points
        # the bad initial model misses still pull, then tighten. A fixed
        # scale of thr² was observed to freeze every hypothesis in its
        # initial basin (true inliers all downweighted).
        for scale in (100.0, 25.0, 5.0, 1.0):
            e_cur = hat(t) @ rot
            err_c = sampson_error(e_cur, rays1, rays2)
            w_irls = w * (1.0 / (1.0 + err_c / (scale * thr2)))
            rot, t = refine_relative_pose(
                rot, t, rays1, rays2, w_irls, iterations=4
            )
        e_fin = hat(t) @ rot
        n_in = jnp.sum((sampson_error(e_fin, rays1, rays2) < thr2) & valid)
        return rot, t, n_in

    rots, ts, n_ins = jax.vmap(polish)(cand_idx)
    win = jnp.argmax(n_ins)
    rot, t = rots[win], ts[win]
    e_best = hat(t) @ rot
    err_ref = sampson_error(e_best, rays1, rays2)
    inliers = (err_ref < thr2) & valid

    # Final cheirality re-validation: Sampson error is invariant to the
    # sign of t and to the twisted pair, so the GNC/LM polish can drift
    # onto a decomposition branch whose depths are negative even though
    # the INITIAL pose was depth-checked. Re-pick the positive-depth
    # decomposition of the final E over the final inliers (same E, so
    # e_mat/inliers are unchanged).
    rot, t = recover_pose(e_best, rays1, rays2, inliers.astype(dtype))

    # With fewer than 8 valid correspondences the distinct-sample trick
    # selects invalid (tied-at -1) slots and the 8-point system is
    # underdetermined — every output would be noise. Report zero
    # inliers so callers take their too-few-points path instead of
    # consuming a garbage pose.
    enough = jnp.sum(valid) >= 8
    inliers = inliers & enough

    return EssentialResult(
        e_mat=e_best,
        inliers=inliers,
        num_inliers=jnp.sum(inliers).astype(jnp.int32),
        rotation=rot,
        translation=t,
    )
