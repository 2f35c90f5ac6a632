"""Checkpoint, metrics, visualization, and CLI tests."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from sift_slam import SiftConfig, detect
from sift_slam.sfm.ba import BAState
from sift_slam.utils.checkpoint import (
    checkpoint_exists,
    remove_checkpoint,
    restore_checkpoint,
    restore_checkpoint_flat,
    save_checkpoint,
)
from sift_slam.utils.metrics import (
    StageTimer,
    keypoint_stats,
)
from sift_slam.utils import visualize as vis


def test_checkpoint_roundtrip(tmp_path):
    state = BAState(
        rotations=jnp.tile(jnp.eye(3), (4, 1, 1)),
        translations=jnp.arange(12.0).reshape(4, 3),
        points=jnp.arange(30.0).reshape(10, 3),
        k_mat=jnp.eye(3),
    )
    path = save_checkpoint(str(tmp_path / "ckpt"), state, step=7)
    template = jax.tree.map(jnp.zeros_like, state)
    restored = restore_checkpoint(path, template)
    np.testing.assert_array_equal(
        np.asarray(restored.translations), np.asarray(state.translations)
    )
    np.testing.assert_array_equal(
        np.asarray(restored.points), np.asarray(state.points)
    )


def test_keypoint_stats(test_image):
    cfg = SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    keypoints, extrema = detect(jnp.asarray(test_image), cfg)
    stats = keypoint_stats(keypoints, extrema)
    assert stats["accepted"] > 0
    assert stats["occupied"] <= stats["capacity"]
    assert stats["candidates_found"] >= stats["accepted"]
    assert stats["candidates_overflowed"] == 0
    assert set(
        ["low_contrast", "edge", "out_of_bounds", "max_iterations"]
    ) <= set(stats)


def test_stage_timer():
    timer = StageTimer()
    with timer.stage("stage_a") as h:
        h["result"] = jnp.ones(8)
    with timer.stage("stage_a"):
        pass
    assert timer.counts["stage_a"] == 2
    assert "stage_a" in timer.report()


def test_gallery_and_overlay(test_image):
    stack = np.stack([test_image] * 3)
    img = vis.gallery_image(stack, normalize="sigmoid")
    assert img.dtype == np.uint8
    assert img.shape[0] == test_image.shape[0]

    cfg = SiftConfig(num_octaves=3, max_keypoints_per_trio=128)
    keypoints, _ = detect(jnp.asarray(test_image), cfg)
    rgb = vis.draw_keypoints(test_image, keypoints)
    assert rgb.shape == test_image.shape + (3,)
    # Some green circle pixels must exist.
    green = (rgb[..., 1] == 255) & (rgb[..., 0] == 0)
    assert green.sum() > 0


def test_cli_end_to_end(tmp_path, test_image):
    from PIL import Image

    from sift_slam.cli import main

    img_path = str(tmp_path / "in.png")
    Image.fromarray((test_image * 255).astype(np.uint8)).save(img_path)
    out = str(tmp_path / "out")
    rc = main(
        [img_path, "-o", out, "--octaves", "3", "--capacity", "128"]
    )
    assert rc == 0
    with open(os.path.join(out, "keypoints.json")) as f:
        data = json.load(f)
    assert len(data["keypoints"]) > 0
    assert {"octave", "scaleLevel", "absoluteSigma", "absoluteX"} <= set(
        data["keypoints"][0]
    )
    assert os.path.exists(os.path.join(out, "gaussian_octave0.png"))
    assert os.path.exists(os.path.join(out, "dog_octave2.png"))
    assert os.path.exists(os.path.join(out, "keypoints.png"))


def test_checked_catches_nan():
    import pytest as _pytest

    from sift_slam.utils.debug import checked

    def bad(x):
        return jnp.log(x)  # NaN for negative input

    f = checked(jax.jit(bad))
    np.testing.assert_allclose(np.asarray(f(jnp.asarray(4.0))), np.log(4.0))
    with _pytest.raises(Exception):
        f(jnp.asarray(-1.0))


def test_assert_finite():
    import pytest as _pytest

    from sift_slam.utils.debug import (
        assert_finite,
    )

    assert_finite({"a": jnp.ones(3), "b": jnp.arange(4)})
    with _pytest.raises(FloatingPointError, match="non-finite"):
        assert_finite({"a": jnp.asarray([1.0, np.nan])}, name="state")


def test_quality_preset_detects_denser():
    """SiftConfig.quality() (sigma0 1.6 + OpenCV-equivalent thresholds)
    must detect strictly more keypoints than reference parity on a
    textured image — the documented density divergence it exists for."""
    import jax.numpy as jnp
    import numpy as np

    from sift_slam import (
        SiftConfig,
        detect_and_describe_jit,
    )

    import sys as _sys

    _sys.path.insert(0, "benchmarks")
    import descriptor_bench as dbench

    # The preset is calibrated on the descriptor-bench conditions
    # (240x320, 3 octaves: 37 -> 108 keypoints, OpenCV 110); tiny
    # 2-octave crops can invert the comparison because the sigma-1.6
    # ladder moves detections to coarser scales.
    img = jnp.asarray(
        dbench.textured_image(np.random.default_rng(7)).astype(np.float32)
    )
    kw = dict(num_octaves=3, max_keypoints_per_trio=256)
    n_parity = int(
        np.asarray(detect_and_describe_jit(img, SiftConfig(**kw)).valid).sum()
    )
    n_quality = int(
        np.asarray(
            detect_and_describe_jit(img, SiftConfig.quality(**kw)).valid
        ).sum()
    )
    assert n_quality >= 2 * n_parity, (n_parity, n_quality)


def test_remove_checkpoint_mem_and_disk(tmp_path):
    """remove_checkpoint evicts mem:// prefixes and deletes disk files."""
    tree = {"a": np.arange(4.0), "frame": np.int64(3)}
    mem = "mem://unit_test_sess"
    save_checkpoint(mem, tree, step=1)
    save_checkpoint(mem, tree, step=2)
    assert checkpoint_exists(mem + "/step_2")
    remove_checkpoint(mem)
    assert not checkpoint_exists(mem + "/step_1")
    assert not checkpoint_exists(mem + "/step_2")

    path = save_checkpoint(str(tmp_path / "d"), tree, step=1)
    assert restore_checkpoint_flat(path)["frame"] == 3
    remove_checkpoint(path)
    assert not checkpoint_exists(path)
