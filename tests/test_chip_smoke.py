"""chip_smoke.py on the CPU: its checks, its refusal to run without a
GPU, its last line, and each phase at a tiny size with two CPU devices
standing in for the card and the reference."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import jax
import pytest

import chip_smoke as smoke
from sift_slam import SiftConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = SiftConfig(num_octaves=3, max_keypoints_per_trio=64)


def _keypoints(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    desc = rng.random((n, 128)).astype(np.float32)
    return {
        "valid": rng.random(n) < 0.5,
        "octave": rng.integers(0, 4, n),
        "scale_level": rng.integers(1, 4, n),
        "abs_x": rng.uniform(0, 640, n),
        "abs_y": rng.uniform(0, 480, n),
        "descriptor": desc / np.linalg.norm(desc, axis=-1, keepdims=True),
    }


def _shift(k, px):
    return dict(k, abs_x=k["abs_x"] + px)


def _flip(k, n):
    valid = k["valid"].copy()
    valid[:n] = ~valid[:n]
    return dict(k, valid=valid)


def _drop_one(k):
    """The first valid keypoint missing, every later slot moved up one:
    what one flipped candidate does to a compacted buffer."""
    first = np.flatnonzero(k["valid"])[0]
    out = {}
    for key, v in k.items():
        moved = np.concatenate([v[:first], v[first + 1:], v[-1:]])
        out[key] = moved
    out["valid"] = out["valid"].copy()
    out["valid"][-1] = False
    return out


def _tilt(k, slots, amount):
    desc = k["descriptor"].copy()
    desc[slots] = np.roll(desc[slots], 1, axis=-1) * amount + desc[slots]
    return dict(k, descriptor=desc)


@pytest.mark.parametrize(
    "perturb,passes",
    [
        (lambda k: k, True),
        (lambda k: _shift(k, 0.05), True),
        (lambda k: _shift(k, 0.2), False),
        (lambda k: _flip(k, 5), True),  # 5 of 5000 slots: 0.999
        (lambda k: _flip(k, 6), False),
        (_drop_one, True),
        (lambda k: _tilt(k, slice(None), 1e-3), True),
        (lambda k: _tilt(k, np.flatnonzero(k["valid"])[:1], 1.0), False),
    ],
    ids=["same", "drift_0.05px", "drift_0.2px", "five_flips", "six_flips",
         "shifted_slots", "descriptor_noise", "descriptor_changed"],
)
def test_keypoint_checks(perturb, passes):
    ref = _keypoints()
    stats = smoke.compare_keypoints(perturb(ref), ref)
    if passes:
        smoke.check_keypoints(stats)
    else:
        with pytest.raises(smoke.CheckFailed):
            smoke.check_keypoints(stats)


@pytest.mark.parametrize(
    "cost,ref,initial,passes",
    [
        (100.05, 100.0, 5e4, True),
        (100.2, 100.0, 5e4, False),  # 2e-3 relative
        (100.0, 100.0, 90.0, False),  # did not descend
        (float("nan"), 100.0, 5e4, False),
    ],
    ids=["close", "far", "no_descent", "nan"],
)
def test_ba_check(cost, ref, initial, passes):
    if passes:
        smoke.check_ba("ba", cost, ref, initial)
    else:
        with pytest.raises(smoke.CheckFailed):
            smoke.check_ba("ba", cost, ref, initial)


def test_result_line_format():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = smoke.result_line(dev, 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_refuses_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory without the rest of the repo, the
    script exits non-zero and prints no result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_detect_phase_tiny():
    cpu0, cpu1 = jax.devices()[:2]
    stats = smoke.phase_detect(cpu0, cpu1, seed=0, batch=4, h=64, w=96, n_ref=2)
    smoke.check_keypoints(stats)
    assert stats["n_matched"] > 0 and stats["median_s"] > 0


def test_describe_phase_tiny():
    cpu0, cpu1 = jax.devices()[:2]
    stats = smoke.phase_describe(cpu0, cpu1, seed=0, batch=2, h=64, w=96, cfg=TINY_CFG)
    smoke.check_keypoints(stats)
    assert "descriptor_min_cos" in stats


def test_ba_phase_tiny():
    cpu0, cpu1 = jax.devices()[:2]
    ba = smoke.phase_ba(cpu0, cpu1, seed=0, cams=6, landmarks=64,
                        obs_per_cam=32, iterations=3)
    smoke.check_ba("ba", ba["gpu"], ba["cpu"], ba["initial"])


def test_multi_device_phase_tiny():
    frontend, ba = smoke.phase_multi(
        4, seed=0, batch=4, h=64, w=96, cfg=TINY_CFG, cams=6, landmarks=64,
        obs_per_cam=32, iterations=3,
    )
    smoke.check_keypoints(frontend)
    smoke.check_ba("sharded", ba["sharded"], ba["single"], ba["initial"])
