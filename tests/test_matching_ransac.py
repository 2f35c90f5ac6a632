"""Matching + RANSAC + geometry tests on synthetic two-view problems."""

import numpy as np
import jax
import jax.numpy as jnp

from sift_slam.ops.matching import (
    descriptor_distances,
    match_descriptors,
)
from sift_slam.ops.ransac import (
    estimate_essential_ransac,
    sampson_error,
)
from sift_slam.sfm import geometry as geo


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 3))
    # Keep θ < π: beyond that the log returns the equivalent shorter
    # rotation (aliasing), so direct w comparison is only defined below π.
    norms = np.linalg.norm(w, axis=1, keepdims=True)
    w = jnp.asarray(w / norms * rng.uniform(0.01, 3.0, size=norms.shape))
    r = geo.so3_exp(w)
    # Orthonormal, det=1.
    eye = jnp.einsum("nij,nkj->nik", r, r)
    np.testing.assert_allclose(
        np.asarray(eye), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(jnp.linalg.det(r)), 1.0, atol=1e-6)
    w2 = geo.so3_log(r)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-4)
    # exp∘log is identity on SO(3) regardless of the branch.
    r2 = geo.so3_exp(w2)
    np.testing.assert_allclose(np.asarray(r2), np.asarray(r), atol=1e-5)


def test_so3_exp_zero():
    r = geo.so3_exp(jnp.zeros(3))
    np.testing.assert_allclose(np.asarray(r), np.eye(3), atol=1e-7)
    # Gradient finite at zero.
    g = jax.jacobian(lambda w: geo.so3_exp(w).sum())(jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(g)))


def test_se3_exp_pure_translation():
    xi = jnp.asarray([0.0, 0.0, 0.0, 1.0, 2.0, 3.0])
    r, t = geo.se3_exp(xi)
    np.testing.assert_allclose(np.asarray(r), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(np.asarray(t), [1.0, 2.0, 3.0], atol=1e-6)


def test_project_backproject_roundtrip():
    rng = np.random.default_rng(1)
    k_mat = jnp.asarray([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    pts = jnp.asarray(rng.uniform([-2, -2, 2], [2, 2, 8], size=(64, 3)))
    uv = geo.project(pts, k_mat)
    rays = geo.backproject(uv, k_mat)
    # Rays are proportional to the points.
    ratio = np.asarray(pts / rays)
    np.testing.assert_allclose(
        ratio, np.broadcast_to(ratio[..., 2:3], ratio.shape), rtol=1e-5
    )


def test_triangulate_midpoint_exact():
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 10], size=(50, 3)))
    r1, t1 = jnp.eye(3), jnp.zeros(3)
    r2 = geo.so3_exp(jnp.asarray([0.02, -0.3, 0.01]))
    t2 = jnp.asarray([-0.8, 0.05, 0.1])
    rays1 = geo.transform(r1, t1, pts)
    rays2 = geo.transform(r2, t2, pts)
    rec, depths = geo.triangulate_midpoint(r1, t1, r2, t2, rays1, rays2)
    np.testing.assert_allclose(np.asarray(rec), np.asarray(pts), atol=1e-4)
    assert np.all(np.asarray(depths) > 0)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------


def _unit(rng, n, d=128):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_distances_match_numpy():
    rng = np.random.default_rng(3)
    a, b = _unit(rng, 40), _unit(rng, 30)
    d = np.asarray(descriptor_distances(jnp.asarray(a), jnp.asarray(b)))
    ref = ((a[:, None] - b[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d, ref, atol=1e-4)


def test_match_descriptors_permutation():
    """B is a noisy permutation of A: matches must recover the permutation."""
    rng = np.random.default_rng(4)
    a = _unit(rng, 64)
    perm = rng.permutation(64)
    b = a[perm] + 0.05 * rng.normal(size=a.shape).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)

    ok = jnp.ones(64, bool)
    m = match_descriptors(jnp.asarray(a), ok, jnp.asarray(b), ok)
    valid = np.asarray(m.valid)
    assert valid.sum() > 55  # near-all matched despite noise
    inv = np.argsort(perm)
    np.testing.assert_array_equal(np.asarray(m.index)[valid], inv[valid])


def test_match_respects_validity_and_ratio():
    rng = np.random.default_rng(5)
    a = _unit(rng, 16)
    # B contains each A descriptor TWICE (exact copies): d1 == d2 == 0,
    # so the strict ratio test d1 < r²·d2 must kill everything.
    b = np.concatenate([a, a])
    m = match_descriptors(
        jnp.asarray(a),
        jnp.ones(16, bool),
        jnp.asarray(b),
        jnp.ones(32, bool),
    )
    assert int(m.valid.sum()) == 0
    # Masking the duplicates out restores the matches.
    valid_b = jnp.asarray(np.arange(32) < 16)
    m2 = match_descriptors(
        jnp.asarray(a), jnp.ones(16, bool), jnp.asarray(b), valid_b
    )
    assert int(m2.valid.sum()) == 16


# ---------------------------------------------------------------------------
# RANSAC essential + pose
# ---------------------------------------------------------------------------


def _two_view(rng, n=256, outlier_frac=0.3, noise=1e-3):
    pts = rng.uniform([-2, -2, 4], [2, 2, 12], size=(n, 3))
    r = np.asarray(geo.so3_exp(jnp.asarray([0.05, -0.2, 0.03])))
    t = np.array([-1.0, 0.1, 0.15])
    t /= np.linalg.norm(t)
    cam1 = pts
    cam2 = pts @ r.T + t
    rays1 = cam1 / cam1[:, 2:3]
    rays2 = cam2 / cam2[:, 2:3]
    rays1[:, :2] += noise * rng.normal(size=(n, 2))
    rays2[:, :2] += noise * rng.normal(size=(n, 2))
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, n_out, replace=False)
    rays2[out_idx, :2] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
    is_inlier = np.ones(n, bool)
    is_inlier[out_idx] = False
    return (
        jnp.asarray(rays1, jnp.float32),
        jnp.asarray(rays2, jnp.float32),
        r,
        t,
        is_inlier,
    )


def test_ransac_recovers_pose_with_outliers():
    rng = np.random.default_rng(6)
    rays1, rays2, r_true, t_true, is_inlier = _two_view(rng)
    res = estimate_essential_ransac(
        rays1,
        rays2,
        jnp.ones(rays1.shape[0], bool),
        jax.random.PRNGKey(0),
        num_hypotheses=256,
        inlier_threshold=3e-3,
    )
    inl = np.asarray(res.inliers)
    # Recovered inlier set should mostly agree with ground truth.
    assert (inl & is_inlier).sum() > 0.85 * is_inlier.sum()
    assert (inl & ~is_inlier).sum() < 0.1 * (~is_inlier).sum() + 3

    r_err = np.asarray(res.rotation) @ r_true.T
    angle = np.arccos(np.clip((np.trace(r_err) - 1) / 2, -1, 1))
    assert angle < 0.02, f"rotation error {np.degrees(angle):.2f} deg"
    t_est = np.asarray(res.translation)
    cos_t = abs(float(t_est @ t_true))
    assert cos_t > 0.995, f"translation direction cos {cos_t:.4f}"


def test_ransac_respects_validity_mask():
    """Invalid slots carry garbage; they must not poison the estimate."""
    rng = np.random.default_rng(7)
    rays1, rays2, r_true, t_true, _ = _two_view(rng, outlier_frac=0.0)
    n = rays1.shape[0]
    # Append 64 garbage slots marked invalid.
    junk1 = jnp.asarray(rng.uniform(-1, 1, size=(64, 3)), jnp.float32)
    junk2 = jnp.asarray(rng.uniform(-1, 1, size=(64, 3)), jnp.float32)
    rays1 = jnp.concatenate([rays1, junk1])
    rays2 = jnp.concatenate([rays2, junk2])
    valid = jnp.asarray(np.arange(n + 64) < n)
    res = estimate_essential_ransac(
        rays1, rays2, valid, jax.random.PRNGKey(1), num_hypotheses=128
    )
    assert not bool(jnp.any(res.inliers[n:]))
    r_err = np.asarray(res.rotation) @ r_true.T
    angle = np.arccos(np.clip((np.trace(r_err) - 1) / 2, -1, 1))
    assert angle < 0.02


def test_sampson_zero_for_exact_correspondences():
    rng = np.random.default_rng(8)
    rays1, rays2, r, t, _ = _two_view(rng, outlier_frac=0.0, noise=0.0)
    e_true = np.asarray(geo.hat(jnp.asarray(t))) @ r
    err = np.asarray(
        sampson_error(jnp.asarray(e_true, jnp.float32), rays1, rays2)
    )
    assert err.max() < 1e-8


def test_ransac_too_few_valid_reports_zero_inliers():
    """<8 valid correspondences: the 8-point system is underdetermined;
    the result must say so (zero inliers) instead of returning a noise
    pose with a plausible-looking inlier set (round-2 review finding)."""
    import jax

    from sift_slam.ops.ransac import (
        estimate_essential_ransac,
    )

    rng = np.random.default_rng(11)
    rays1 = jnp.asarray(rng.normal(size=(16, 3)).astype(np.float32))
    rays2 = jnp.asarray(rng.normal(size=(16, 3)).astype(np.float32))
    valid = jnp.asarray(np.arange(16) < 5)
    res = estimate_essential_ransac(
        rays1, rays2, valid, jax.random.PRNGKey(0), num_hypotheses=32
    )
    assert int(res.num_inliers) == 0
    assert not bool(jnp.any(res.inliers))


def test_decompose_essential_batched_proper_rotations():
    """decompose_essential advertises (..., 3, 3) support; the
    determinant sign fix must broadcast over a hypothesis batch
    (round-2 review finding: it only worked unbatched)."""
    from sift_slam.ops.ransac import (
        decompose_essential,
    )
    from sift_slam.sfm.geometry import hat, so3_exp

    rng = np.random.default_rng(12)
    e_batch = []
    for i in range(5):
        r = so3_exp(jnp.asarray(rng.normal(size=3) * 0.4))
        t = rng.normal(size=3)
        t = t / np.linalg.norm(t)
        e_batch.append(np.asarray(hat(jnp.asarray(t)) @ r))
    e_batch = jnp.asarray(np.stack(e_batch))
    (r1, r2), t = decompose_essential(e_batch)
    assert r1.shape == (5, 3, 3) and t.shape == (5, 3)
    for rs in (r1, r2):
        dets = np.linalg.det(np.asarray(rs))
        np.testing.assert_allclose(dets, 1.0, atol=1e-5)
        for r in np.asarray(rs):
            np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
