"""Bundle adjustment tests on synthetic multi-view scenes."""

import numpy as np
import jax
import jax.numpy as jnp

from sift_slam.sfm import geometry as geo
from sift_slam.sfm.ba import (
    BAState,
    Observations,
    bundle_adjust,
    reprojection_residuals,
)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])


def make_scene(rng, n_cams=6, n_pts=120, noise_px=0.3, dtype=np.float64):
    """Cameras on an arc looking at a point cloud; full visibility."""
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], size=(n_pts, 3))
    rots, ts = [], []
    for c in range(n_cams):
        angle = 0.08 * (c - n_cams / 2)
        r = np.asarray(geo.so3_exp(jnp.asarray([0.0, angle, 0.0])))
        center = np.array([1.5 * angle * 4, 0.1 * c, -0.2 * c])
        t = -r @ center
        rots.append(r)
        ts.append(t)
    rots = np.stack(rots)
    ts = np.stack(ts)

    cams, lms, uvs = [], [], []
    for c in range(n_cams):
        xc = pts @ rots[c].T + ts[c]
        uv = (xc[:, :2] / xc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        uv += noise_px * rng.normal(size=uv.shape)
        cams.append(np.full(n_pts, c))
        lms.append(np.arange(n_pts))
        uvs.append(uv)

    obs = Observations(
        camera=jnp.asarray(np.concatenate(cams), jnp.int32),
        landmark=jnp.asarray(np.concatenate(lms), jnp.int32),
        uv=jnp.asarray(np.concatenate(uvs), dtype),
        valid=jnp.ones(n_cams * n_pts, bool),
    )
    truth = BAState(
        rotations=jnp.asarray(rots, dtype),
        translations=jnp.asarray(ts, dtype),
        points=jnp.asarray(pts, dtype),
        k_mat=jnp.asarray(K, dtype),
    )
    return truth, obs


def perturb(rng, truth, rot_sigma=0.01, t_sigma=0.05, pt_sigma=0.1):
    n_cams = truth.rotations.shape[0]
    n_pts = truth.points.shape[0]
    dr = rot_sigma * rng.normal(size=(n_cams, 3))
    dr[0] = 0  # keep gauge camera at truth
    dt = t_sigma * rng.normal(size=(n_cams, 3))
    dt[0] = 0
    dp = pt_sigma * rng.normal(size=(n_pts, 3))
    return truth.replace(
        rotations=geo.so3_exp(jnp.asarray(dr)) @ truth.rotations,
        translations=truth.translations + jnp.asarray(dt),
        points=truth.points + jnp.asarray(dp),
    )


def rms_residual(state, obs):
    r = np.asarray(reprojection_residuals(state, obs))
    return float(np.sqrt((r**2).sum(-1).mean()))


def test_ba_converges_to_truth():
    rng = np.random.default_rng(0)
    truth, obs = make_scene(rng, noise_px=0.0)
    init = perturb(rng, truth)
    assert rms_residual(init, obs) > 5.0

    refined, cost = bundle_adjust(init, obs, num_iterations=15)
    assert rms_residual(refined, obs) < 1e-3
    # Poses recover the truth (gauge anchored at camera 0).
    for c in range(truth.rotations.shape[0]):
        rerr = np.asarray(refined.rotations[c]) @ np.asarray(truth.rotations[c]).T
        ang = np.degrees(np.arccos(np.clip((np.trace(rerr) - 1) / 2, -1, 1)))
        assert ang < 0.05, f"camera {c}: {ang:.3f} deg"
    np.testing.assert_allclose(
        np.asarray(refined.translations),
        np.asarray(truth.translations),
        atol=5e-3,
    )


def test_ba_noisy_observations():
    rng = np.random.default_rng(1)
    truth, obs = make_scene(rng, noise_px=0.5)
    init = perturb(rng, truth)
    refined, cost = bundle_adjust(init, obs, num_iterations=15)
    # Residual should come down to the noise floor (~0.5 px RMS over 2 dims).
    assert rms_residual(refined, obs) < 1.0
    # And not overfit wildly: poses near truth.
    t_err = np.abs(
        np.asarray(refined.translations) - np.asarray(truth.translations)
    ).max()
    assert t_err < 0.05, t_err


def test_ba_respects_validity_mask():
    rng = np.random.default_rng(2)
    truth, obs = make_scene(rng, noise_px=0.0)
    # Corrupt 25% of observations but mark them invalid.
    n = obs.capacity
    bad = rng.choice(n, n // 4, replace=False)
    uv = np.array(obs.uv)
    uv[bad] += rng.uniform(50, 200, size=(len(bad), 2))
    valid = np.ones(n, bool)
    valid[bad] = False
    obs2 = obs.replace(uv=jnp.asarray(uv), valid=jnp.asarray(valid))

    init = perturb(rng, truth)
    refined, _ = bundle_adjust(init, obs2, num_iterations=15)
    r = np.asarray(reprojection_residuals(refined, obs2))
    rms_valid = np.sqrt((r[valid] ** 2).sum(-1).mean())
    assert rms_valid < 1e-3


def test_ba_huber_downweights_outliers():
    rng = np.random.default_rng(3)
    truth, obs = make_scene(rng, noise_px=0.3)
    # Corrupt 10% of observations and leave them VALID.
    n = obs.capacity
    bad = rng.choice(n, n // 10, replace=False)
    uv = np.array(obs.uv)
    uv[bad] += rng.uniform(20, 80, size=(len(bad), 2)) * rng.choice(
        [-1, 1], size=(len(bad), 2)
    )
    obs2 = obs.replace(uv=jnp.asarray(uv))

    init = perturb(rng, truth)
    plain, _ = bundle_adjust(init, obs2, num_iterations=15)
    robust, _ = bundle_adjust(init, obs2, num_iterations=15, huber_delta=2.0)

    def pose_err(s):
        return float(
            jnp.abs(s.translations - truth.translations).max()
        )

    assert pose_err(robust) < pose_err(plain)
    assert pose_err(robust) < 0.05


def test_ba_fixed_cameras_stay_fixed():
    rng = np.random.default_rng(4)
    truth, obs = make_scene(rng, noise_px=0.2)
    init = perturb(rng, truth)
    refined, _ = bundle_adjust(
        init, obs, num_iterations=8, num_fixed_cameras=2
    )
    np.testing.assert_array_equal(
        np.asarray(refined.rotations[:2]), np.asarray(init.rotations[:2])
    )
    np.testing.assert_array_equal(
        np.asarray(refined.translations[:2]), np.asarray(init.translations[:2])
    )


def test_closed_form_jacobians_match_autodiff():
    """_obs_terms' hand-derived Jacobians == jacfwd of the residual."""
    from sift_slam.sfm.ba import (
        _obs_terms,
        _per_obs_residual,
    )

    rng = np.random.default_rng(5)
    truth, obs = make_scene(rng, n_cams=3, n_pts=20, noise_px=0.4)
    x = truth.points[obs.landmark]
    res, jc, jl = _obs_terms(
        truth.rotations, truth.translations, truth.k_mat, x,
        obs.camera, obs.uv, obs.valid,
    )
    z6 = jnp.zeros(6, jnp.float64)
    z3 = jnp.zeros(3, jnp.float64)
    for o in range(0, obs.capacity, 7):
        c = int(obs.camera[o])
        l = int(obs.landmark[o])
        args = (truth.rotations[c], truth.translations[c], truth.points[l],
                obs.uv[o], truth.k_mat, z6, z3)
        res_ref = _per_obs_residual(*args)
        jc_ref = jax.jacfwd(_per_obs_residual, argnums=5)(*args)
        jl_ref = jax.jacfwd(_per_obs_residual, argnums=6)(*args)
        np.testing.assert_allclose(res[o], res_ref, atol=1e-9)
        np.testing.assert_allclose(jc[o], jc_ref, atol=1e-8, rtol=1e-8)
        np.testing.assert_allclose(jl[o], jl_ref, atol=1e-8, rtol=1e-8)


def test_ba_cg_solver_matches_dense():
    """Matrix-free CG path converges to the same solution as dense Schur."""
    rng = np.random.default_rng(6)
    truth, obs = make_scene(rng, noise_px=0.2)
    init = perturb(rng, truth)
    dense, cost_d = bundle_adjust(init, obs, num_iterations=12)
    cg, cost_c = bundle_adjust(
        init, obs, num_iterations=12, solver="cg", cg_iterations=40
    )
    assert rms_residual(cg, obs) < 1.0
    np.testing.assert_allclose(
        np.asarray(cg.translations), np.asarray(dense.translations), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(cg.points), np.asarray(dense.points), atol=5e-3
    )


def test_ba_cg_huber():
    """CG path supports IRLS Huber weighting like the dense path."""
    rng = np.random.default_rng(7)
    truth, obs = make_scene(rng, noise_px=0.3)
    n = obs.capacity
    bad = rng.choice(n, n // 10, replace=False)
    uv = np.array(obs.uv)
    uv[bad] += rng.uniform(20, 80, size=(len(bad), 2))
    obs2 = obs.replace(uv=jnp.asarray(uv))
    init = perturb(rng, truth)
    robust, _ = bundle_adjust(
        init, obs2, num_iterations=15, huber_delta=2.0, solver="cg",
        cg_iterations=40,
    )
    dense, _ = bundle_adjust(
        init, obs2, num_iterations=15, huber_delta=2.0
    )
    cg_err = float(jnp.abs(robust.translations - truth.translations).max())
    dense_err = float(jnp.abs(dense.translations - truth.translations).max())
    # The two solvers downweight the (one-sided) outliers equally well.
    assert abs(cg_err - dense_err) < 0.02
    assert cg_err < 0.1


def test_sorted_assembly_matches_scatter():
    """Gather-side assembly == scatter assembly (round-5 adoption).

    Mixed validity + a sorted_pad below num_cameras (but >= the true max
    run length) exercise the sentinel bucket and the padded index
    tables; x64 makes reorder drift ~1e-12.
    """
    rng = np.random.default_rng(7)
    truth, obs = make_scene(rng, n_cams=7, n_pts=90, noise_px=0.4)
    # Knock out ~20% of observations, scattered arbitrarily.
    valid = np.asarray(obs.valid).copy()
    valid[rng.random(valid.shape) < 0.2] = False
    obs = Observations(
        camera=obs.camera, landmark=obs.landmark, uv=obs.uv,
        valid=jnp.asarray(valid),
    )
    init = perturb(rng, truth)

    ref, cost_ref = bundle_adjust(
        init, obs, num_iterations=6, assembly="scatter"
    )
    for pad in (0, 8):  # 0 -> num_cameras hard bound; 8 >= max count 7
        got, cost_got = bundle_adjust(
            init, obs, num_iterations=6, assembly="sorted", sorted_pad=pad
        )
        np.testing.assert_allclose(
            np.asarray(got.translations),
            np.asarray(ref.translations),
            atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(got.points), np.asarray(ref.points), atol=1e-7
        )
        assert abs(float(cost_got) - float(cost_ref)) < 1e-7 * max(
            1.0, float(cost_ref)
        )


def test_sorted_assembly_huber_matches_scatter():
    rng = np.random.default_rng(11)
    truth, obs = make_scene(rng, n_cams=5, n_pts=70, noise_px=0.3)
    init = perturb(rng, truth)
    ref, _ = bundle_adjust(
        init, obs, num_iterations=5, huber_delta=2.0, assembly="scatter"
    )
    got, _ = bundle_adjust(
        init, obs, num_iterations=5, huber_delta=2.0, assembly="sorted"
    )
    np.testing.assert_allclose(
        np.asarray(got.translations), np.asarray(ref.translations),
        atol=1e-8,
    )
