"""Test configuration.

Tests run on CPU with 8 virtual devices (the standard JAX fake-cluster
trick, SURVEY.md §4) and float64 enabled so the parity path can bit-match
the reference oracle. Must run before any jax import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from sift_slam.utils.compile_cache import (  # noqa: E402
    CACHE_DIR,
    enable_compile_cache,
)

# Persistent compilation cache, shared across xdist workers and across
# suite runs. The heavy SLAM/visual-SLAM tests are compile-dominated
# (pow2 observation buckets recompile BA/PnP at several sizes each), and
# the xdist workers otherwise each recompile identical programs.
enable_compile_cache(min_compile_time_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests"
    )


@pytest.fixture(scope="session")
def test_image():
    """Deterministic synthetic grayscale test image in [0,1], float64.

    Smooth blobs + gradient + noise: produces a healthy keypoint
    population across octaves at a size small enough for the exact-order
    oracle to run the full 5-octave pipeline quickly.
    """
    rng = np.random.default_rng(42)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.4 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    for cy, cx, r, a in [(12, 16, 3.0, 0.5), (30, 40, 5.0, -0.35), (20, 52, 2.0, 0.45), (38, 10, 4.0, 0.3)]:
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    img += 0.05 * rng.standard_normal((h, w))
    img = np.clip(img, 0.0, 1.0)
    # Quantize to 8-bit-like levels as a real image load would.
    img = np.round(img * 255.0) / 255.0
    return img


@pytest.fixture(scope="session")
def oracle_result(test_image):
    """Full reference-oracle pipeline output, disk-cached.

    The oracle is pure deterministic numpy (minutes on one core) and
    xdist workers cannot share session fixtures, so each worker used to
    recompute it — the single largest block of suite wall-clock. Cache
    key: the image bytes + the oracle module source, so any oracle
    change invalidates the cache. It sits beside the compile cache,
    inside the checkout.
    """
    import hashlib
    import pickle

    from sift_slam.utils import oracle

    with open(oracle.__file__, "rb") as f:
        src = f.read()
    key = hashlib.sha256(test_image.tobytes() + src).hexdigest()[:24]
    cache = CACHE_DIR.parent / "sift_oracle"
    cache.mkdir(parents=True, exist_ok=True)
    path = cache / f"oracle_{key}.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    result = oracle.detect(test_image)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    tmp.replace(path)  # atomic: concurrent xdist workers race benignly
    return result
