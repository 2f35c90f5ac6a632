"""Native C++ batch loader tests (compiles on first use)."""

import numpy as np
import pytest

from sift_slam.core import native_io
from sift_slam.core.image import rgb_to_gray


pytestmark = pytest.mark.skipif(
    not native_io.native_available(), reason="no C++ toolchain"
)


def _write_ppm(path, rgb):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.astype(np.uint8).tobytes())


def _write_pgm(path, gray):
    h, w = gray.shape
    with open(path, "wb") as f:
        f.write(f"P5\n# comment\n{w} {h}\n255\n".encode())
        f.write(gray.astype(np.uint8).tobytes())


def test_probe_and_load_ppm_matches_reference_gray(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
    p = str(tmp_path / "a.ppm")
    _write_ppm(p, rgb)

    assert native_io.probe(p) == (32, 24)
    out = native_io.load_batch_gray([p], fallback=False)
    ref = rgb_to_gray(rgb, dtype=np.float32)
    np.testing.assert_allclose(out[0], ref, atol=1e-6)


def test_batch_load_pgm_multithreaded(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    grays = []
    for i in range(16):
        g = rng.integers(0, 256, size=(16, 20), dtype=np.uint8)
        p = str(tmp_path / f"g{i}.pgm")
        _write_pgm(p, g)
        paths.append(p)
        grays.append(g / 255.0)
    out = native_io.load_batch_gray(paths, threads=4, fallback=False)
    np.testing.assert_allclose(out, np.stack(grays), atol=1e-6)


def test_size_mismatch_rejected(tmp_path):
    rng = np.random.default_rng(2)
    p1 = str(tmp_path / "a.pgm")
    p2 = str(tmp_path / "b.pgm")
    _write_pgm(p1, rng.integers(0, 256, size=(8, 8), dtype=np.uint8))
    _write_pgm(p2, rng.integers(0, 256, size=(9, 8), dtype=np.uint8))
    with pytest.raises(native_io.NativeIOError):
        native_io.load_batch_gray([p1, p2], fallback=False)


def test_fallback_to_pil_for_png(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, size=(12, 14, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(rgb).save(p)
    out = native_io.load_batch_gray([p])  # native can't decode PNG → PIL
    ref = rgb_to_gray(rgb, dtype=np.float32)
    np.testing.assert_allclose(out[0], ref, atol=1e-6)


def test_missing_file_error(tmp_path):
    with pytest.raises(native_io.NativeIOError):
        native_io.load_batch_gray([str(tmp_path / "nope.pgm")], fallback=False)


def test_pgm_nonstandard_maxval(tmp_path):
    """PNM maxval != 255 must scale intensities by the file's maxval."""
    g = np.array([[0, 31, 63], [63, 15, 0]], dtype=np.uint8)
    p = str(tmp_path / "m.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n3 2\n63\n")
        f.write(g.tobytes())
    out = native_io.load_batch_gray([p], fallback=False)
    np.testing.assert_allclose(out[0], g / 63.0, atol=1e-6)


def test_sequence_prefetcher_streams_in_order(tmp_path):
    """Prefetcher yields every frame, in order, equal to the batch load.

    depth < n forces ring-slot reuse; threads > 1 exercises the
    producer ordering under contention."""
    rng = np.random.default_rng(5)
    paths, grays = [], []
    for i in range(23):
        g = rng.integers(0, 256, size=(12, 16), dtype=np.uint8)
        p = str(tmp_path / f"s{i:03d}.pgm")
        _write_pgm(p, g)
        paths.append(p)
        grays.append(g / 255.0)
    got = list(native_io.SequencePrefetcher(paths, threads=3, depth=4))
    assert len(got) == 23
    np.testing.assert_allclose(np.stack(got), np.stack(grays), atol=1e-6)


def test_sequence_prefetcher_early_close(tmp_path):
    """Closing mid-stream must not deadlock or leak worker threads."""
    rng = np.random.default_rng(6)
    paths = []
    for i in range(12):
        p = str(tmp_path / f"e{i}.pgm")
        _write_pgm(p, rng.integers(0, 256, size=(10, 10), dtype=np.uint8))
        paths.append(p)
    pf = native_io.SequencePrefetcher(paths, threads=2, depth=3)
    it = iter(pf)
    next(it)
    next(it)
    pf.close()  # workers must join despite 10 undelivered frames
    pf.close()  # idempotent
