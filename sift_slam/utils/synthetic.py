"""Synthetic SLAM sequences: scenes, trajectories, and measurements.

This environment has no network access, so TUM-RGBD/KITTI sequences
cannot be downloaded; the SLAM stack is validated on synthetic sequences
with known ground truth instead (BASELINE.json configs[3-4] ATE bounds
are asserted against these). The generator mimics the relevant dataset
properties: smooth 6-DOF trajectories, bounded-FOV visibility, pixel
noise, outlier matches, and landmark churn.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticSequence:
    rotations: np.ndarray  # (F, 3, 3) world→camera
    translations: np.ndarray  # (F, 3)
    points: np.ndarray  # (L, 3) world landmarks
    k_mat: np.ndarray  # (3, 3)
    # Per frame: (L,) visibility mask + (L, 2) pixel measurements
    visible: np.ndarray  # (F, L) bool
    pixels: np.ndarray  # (F, L, 2)
    is_outlier: np.ndarray  # (F, L) bool (measurement corrupted)


def render_blob_image(
    points: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    k_mat: np.ndarray,
    image_size: tuple[int, int],
    blob_sigma_at_unit_depth: float = 12.0,
    amplitudes: np.ndarray | None = None,
    sigma_scales: np.ndarray | None = None,
    background: float = 0.35,
    noise: float = 0.01,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Render a grayscale view of a 3-D Gaussian-blob field.

    Each world point becomes an isotropic blob at its projection with
    radius scaled by 1/depth — enough photometric structure for the SIFT
    frontend to detect and match across views with real parallax, without
    needing a full renderer. Returns ``(H, W)`` float in [0, 1].
    """
    w, h = image_size
    xc = points @ rotation.T + translation
    z = xc[:, 2]
    vis = z > 0.2
    uv = np.empty((len(points), 2))
    np.divide(xc[:, 0], z, out=uv[:, 0], where=z != 0)
    np.divide(xc[:, 1], z, out=uv[:, 1], where=z != 0)
    uv = uv * [k_mat[0, 0], k_mat[1, 1]] + [k_mat[0, 2], k_mat[1, 2]]

    if amplitudes is None:
        amplitudes = 0.45 * np.where(np.arange(len(points)) % 2 == 0, 1.0, -1.0)
    if sigma_scales is None:
        sigma_scales = np.ones(len(points))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.full((h, w), background)
    for i in np.where(vis)[0]:
        cx, cy = uv[i]
        if cx < -20 or cx > w + 20 or cy < -20 or cy > h + 20:
            continue
        s = sigma_scales[i] * blob_sigma_at_unit_depth / z[i]
        if s < 0.8:
            continue
        r = int(3 * s) + 1
        x0, x1 = max(0, int(cx) - r), min(w, int(cx) + r + 1)
        y0, y1 = max(0, int(cy) - r), min(h, int(cy) + r + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        patch_y = yy[y0:y1, x0:x1]
        patch_x = xx[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += amplitudes[i] * np.exp(
            -((patch_y - cy) ** 2 + (patch_x - cx) ** 2) / (2 * s * s)
        )
    if rng is not None and noise > 0:
        img = img + noise * rng.standard_normal(img.shape)
    img = np.clip(img, 0.0, 1.0)
    return np.round(img * 255.0) / 255.0


def textured_blob_field(
    rng: np.random.Generator,
    points: np.ndarray,
    satellites_per_point: int = 3,
    satellite_spread: float = 0.35,
):
    """Expand landmarks into distinctive local 3-D texture.

    Isotropic blobs are rotationally symmetric AND mutually identical —
    SIFT orientations become unstable and the ratio test kills every
    match. Each landmark gets ``satellites_per_point`` smaller off-center
    blobs at fixed 3-D offsets, giving every landmark a unique,
    view-consistent local pattern (real parallax included).

    Returns ``(render_points, amplitudes, sigma_scales)`` for
    :func:`render_blob_image`.
    """
    n = len(points)
    parent_amp = 0.5 * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    parts = [points]
    amps = [parent_amp]
    sscale = [np.ones(n)]
    # One DOMINANT satellite close-in with sign opposite the parent: a
    # symmetric parent blob alone has no repeatable gradient direction
    # (measured: median orientation delta ~0.94 rad between views), which
    # destroys descriptor matching; a single strong off-center structure
    # pins the orientation.
    # Satellites sit at (nearly) the SAME depth as their parent: a depth
    # offset inside the texture patch creates intra-patch parallax that
    # legitimately deforms the pattern between views (measured: several
    # px at realistic baselines), destroying descriptor repeatability —
    # real-world surface texture is locally coplanar for the same reason.
    ang = rng.uniform(0, 2 * np.pi, n)
    dom = 0.6 * satellite_spread * np.stack(
        [np.cos(ang), np.sin(ang), rng.uniform(-0.08, 0.08, n)], axis=-1
    )
    parts.append(points + dom)
    amps.append(-0.9 * parent_amp)
    sscale.append(np.full(n, 0.6))
    for _ in range(max(0, satellites_per_point - 1)):
        offs = rng.uniform(-satellite_spread, satellite_spread, size=(n, 3))
        offs[:, 2] *= 0.1
        parts.append(points + offs)
        amps.append(rng.uniform(0.15, 0.3, n) * rng.choice([-1.0, 1.0], n))
        sscale.append(rng.uniform(0.35, 0.55, n))
    return (
        np.concatenate(parts),
        np.concatenate(amps),
        np.concatenate(sscale),
    )


def orbit_sequence(
    rng: np.random.Generator,
    num_frames: int = 50,
    num_landmarks: int = 400,
    radius: float = 8.0,
    noise_px: float = 0.4,
    outlier_frac: float = 0.02,
    image_size: tuple[int, int] = (640, 480),
    focal: float = 500.0,
) -> SyntheticSequence:
    """Camera orbiting a point cloud, always looking at the origin."""
    w, h = image_size
    k_mat = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    pts = rng.uniform([-3, -3, -3], [3, 3, 3], size=(num_landmarks, 3))

    rots, ts = [], []
    for f in range(num_frames):
        ang = 0.7 * 2 * np.pi * f / num_frames
        center = np.array(
            [
                radius * np.sin(ang),
                1.5 * np.sin(2.2 * ang),
                -radius * np.cos(ang),
            ]
        )
        # Look-at: camera z-axis toward origin.
        fwd = -center / np.linalg.norm(center)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        r = np.stack([right, up2, fwd])  # rows = camera axes
        t = -r @ center
        rots.append(r)
        ts.append(t)
    rots = np.stack(rots)
    ts = np.stack(ts)

    visible = np.zeros((num_frames, num_landmarks), bool)
    pixels = np.zeros((num_frames, num_landmarks, 2))
    is_outlier = np.zeros((num_frames, num_landmarks), bool)
    for f in range(num_frames):
        xc = pts @ rots[f].T + ts[f]
        z = xc[:, 2]
        uv = np.empty((num_landmarks, 2))
        np.divide(xc[:, 0], z, out=uv[:, 0], where=z != 0)
        np.divide(xc[:, 1], z, out=uv[:, 1], where=z != 0)
        uv = uv * focal + [w / 2, h / 2]
        ok = (z > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        uv = uv + noise_px * rng.normal(size=uv.shape)
        out_mask = ok & (rng.random(num_landmarks) < outlier_frac)
        uv[out_mask] = rng.uniform([0, 0], [w, h], size=(out_mask.sum(), 2))
        visible[f] = ok
        pixels[f] = uv
        is_outlier[f] = out_mask

    return SyntheticSequence(
        rotations=rots,
        translations=ts,
        points=pts,
        k_mat=k_mat,
        visible=visible,
        pixels=pixels,
        is_outlier=is_outlier,
    )


def blob_frames(batch: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """``(batch, h, w)`` float32 frames: four fixed blobs on a smooth
    ripple plus per-frame Gaussian noise, quantized to 8-bit levels.

    The detection benchmark's input (``bench.py``). The blob positions
    are laid out for 640×480.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 0.4 + 0.2 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
    for cy, cx, r, a in [
        (120, 160, 6.0, 0.5),
        (300, 400, 10.0, -0.35),
        (200, 520, 4.0, 0.45),
        (380, 100, 8.0, 0.3),
    ]:
        base = base + a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    imgs = base[None] + 0.05 * rng.standard_normal((batch, h, w))
    return (np.round(np.clip(imgs, 0.0, 1.0) * 255.0) / 255.0).astype(np.float32)


def textured_frames(batch: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """``(batch, h, w)`` float32 frames, each a ripple plus 120 random
    Gaussian blobs of both signs: dense keypoints at every scale, for
    detect+describe parity checks."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for k in range(batch):
        r = np.random.default_rng(seed * 1000 + k)
        img = 0.5 + 0.1 * np.sin(xx / 6.0 + k) * np.cos(yy / 8.0)
        for _ in range(120):
            cy, cx = r.uniform(8, h - 8), r.uniform(8, w - 8)
            s = r.uniform(1.5, 6.0)
            img += r.uniform(-0.35, 0.35) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)
            )
        imgs.append(np.clip(img, 0.0, 1.0))
    return np.stack(imgs).astype(np.float32)
