"""Distributed execution tests on the 8-virtual-device CPU mesh.

The conftest forces ``xla_force_host_platform_device_count=8`` so these
tests exercise real shard_map + psum lowering without accelerator hardware
(SURVEY.md §4 fake-cluster strategy).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sift_slam import SiftConfig
from sift_slam.models.frontend import (
    detect_and_describe_batched,
)
from sift_slam.parallel import (
    detect_and_describe_data_parallel,
    distributed_bundle_adjust,
    make_mesh,
)
from sift_slam.sfm.ba import bundle_adjust

from test_ba import make_scene, perturb, rms_residual


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_distributed_ba_matches_single_device(mesh):
    rng = np.random.default_rng(0)
    truth, obs = make_scene(rng, n_cams=5, n_pts=100, noise_px=0.3)
    init = perturb(rng, truth)

    single, cost_s = bundle_adjust(init, obs, num_iterations=10)
    dist, cost_d = distributed_bundle_adjust(
        init, obs, mesh, num_iterations=10
    )

    # Same algorithm, same damping schedule → near-identical results
    # (float reassociation across shards allows tiny drift).
    np.testing.assert_allclose(
        np.asarray(dist.translations),
        np.asarray(single.translations),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(dist.points), np.asarray(single.points), atol=1e-5
    )
    assert abs(float(cost_d) - float(cost_s)) < 1e-6 * max(1.0, float(cost_s))


def test_distributed_ba_huber_matches_single_device(mesh):
    """Robust (Huber) path: same IRLS weights AND same accept-test cost.

    The LM accept test must compare Huber costs on both solvers — a
    plain-squared accept test on the distributed side accepted
    different step sequences and diverged from the single-device
    result.
    """
    rng = np.random.default_rng(4)
    truth, obs = make_scene(rng, n_cams=5, n_pts=96, noise_px=0.3)
    # Inject gross outliers so the robust weighting actually matters.
    uv = np.array(obs.uv)
    n_out = 40
    sel = rng.choice(np.flatnonzero(np.asarray(obs.valid)), n_out, False)
    uv[sel] += rng.normal(0, 40.0, size=(n_out, 2))
    obs = obs.replace(uv=jnp.asarray(uv))
    init = perturb(rng, truth)

    single, cost_s = bundle_adjust(
        init, obs, num_iterations=10, huber_delta=2.0
    )
    dist, cost_d = distributed_bundle_adjust(
        init, obs, mesh, num_iterations=10, huber_delta=2.0
    )
    np.testing.assert_allclose(
        np.asarray(dist.translations),
        np.asarray(single.translations),
        atol=1e-5,
    )
    assert abs(float(cost_d) - float(cost_s)) < 1e-5 * max(1.0, float(cost_s))


def test_distributed_ba_converges(mesh):
    rng = np.random.default_rng(1)
    truth, obs = make_scene(rng, n_cams=6, n_pts=120, noise_px=0.0)
    init = perturb(rng, truth)
    refined, cost = distributed_bundle_adjust(init, obs, mesh, num_iterations=15)
    assert rms_residual(refined, obs) < 1e-3


def test_distributed_ba_landmarks_not_multiple_of_mesh(mesh):
    """Landmark count not divisible by 8 exercises the padding path."""
    rng = np.random.default_rng(2)
    truth, obs = make_scene(rng, n_cams=4, n_pts=93, noise_px=0.2)
    init = perturb(rng, truth)
    refined, cost = distributed_bundle_adjust(init, obs, mesh, num_iterations=10)
    assert refined.points.shape[0] == 93
    assert rms_residual(refined, obs) < 1.0


def test_data_parallel_frontend_matches_single(mesh):
    rng = np.random.default_rng(3)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 0.4 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    imgs = base[None] + 0.05 * rng.standard_normal((8, h, w))
    imgs = (np.round(np.clip(imgs, 0, 1) * 255) / 255).astype(np.float32)
    images = jnp.asarray(imgs)

    cfg = SiftConfig(num_octaves=2, max_keypoints_per_trio=64)
    ref = detect_and_describe_batched(images, cfg)
    par = detect_and_describe_data_parallel(images, cfg, mesh)

    np.testing.assert_array_equal(np.asarray(par.valid), np.asarray(ref.valid))
    # Partitioned compilation reassociates floats; the descriptor chain
    # has discontinuous steps (peak picks, bin boundaries) that can move
    # a handful of elements. Require per-keypoint cosine agreement.
    valid = np.asarray(ref.valid)
    d_ref = np.asarray(ref.descriptor)[valid]
    d_par = np.asarray(par.descriptor)[valid]
    norms = np.linalg.norm(d_ref, axis=1) * np.linalg.norm(d_par, axis=1)
    ok = norms > 1e-6
    cos = (d_ref[ok] * d_par[ok]).sum(1) / norms[ok]
    assert (cos > 0.999).mean() > 0.98, (cos.min(), (cos > 0.999).mean())


def test_sharded_keyframe_matching_matches_vmap(mesh):
    from sift_slam.ops.matching import (
        match_descriptors,
    )
    from sift_slam.parallel import (
        match_against_keyframes_sharded,
    )

    rng = np.random.default_rng(4)

    def unit(n):
        v = rng.normal(size=(n, 128)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    q = jnp.asarray(unit(64))
    qv = jnp.asarray(np.arange(64) < 48)
    kf = jnp.asarray(np.stack([unit(96) for _ in range(8)]))
    kfv = jnp.asarray(np.tile(np.arange(96) < 80, (8, 1)))

    idx, dist, valid = match_against_keyframes_sharded(q, qv, kf, kfv, mesh)

    for k in range(8):
        ref = match_descriptors(q, qv, kf[k], kfv[k])
        np.testing.assert_array_equal(np.asarray(valid[k]), np.asarray(ref.valid))
        v = np.asarray(ref.valid)
        np.testing.assert_array_equal(
            np.asarray(idx[k])[v], np.asarray(ref.index)[v]
        )
