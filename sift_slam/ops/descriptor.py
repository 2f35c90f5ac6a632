"""Orientation assignment and 128-D SIFT descriptors.

Green-field extension: the reference implements neither orientations nor
descriptors (reference/readme.md:11); BASELINE.json config[2] requires
them. Algorithm constants follow the IPOL *Anatomy of the SIFT Method*
paper bundled with the reference (λ_ori=1.5, λ_descr=6, 36 ori bins,
4×4×8 histograms, 0.8 peak ratio, 0.2 descriptor clamp).

Static-shape design (instead of the paper's data-dependent pixel windows):

- Every keypoint samples a **fixed G×G grid** in its (rotated, σ-scaled)
  local frame via bilinear interpolation of the octave gradient maps —
  static shapes, pure gathers, vmap over fixed-capacity keypoint slots.
- Histograms are built as **one-hot einsums** (sample → bin soft
  assignments contracted as matrix products), not scatter-adds. They
  run at full float32 precision: a TF32 histogram moves orientation
  peaks across the 0.8 peak-ratio test.
- Orientation peaks use masked ``top_k`` over the smoothed histogram with
  parabolic interpolation — up to ``max_orientations_per_keypoint``
  oriented copies per keypoint slot, each a fixed output slot.

Geometry notes: the octave's inter-pixel distance is ``δ_o = 2^(o-1)``
(reference/background.js:610-614); a keypoint's octave-local position is
``abs/δ_o`` and its octave-local scale ``σ_loc = abs_sigma/δ_o``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from ..core import pytree
from ..core.types import Keypoints
from .sampling import bilinear_sample, scale_space_gradients

TWO_PI = 2.0 * math.pi


@pytree.dataclass
class DescribedKeypoints:
    """Oriented keypoints + descriptors, fixed capacity struct-of-arrays.

    One slot per (keypoint slot, orientation peak); capacity is
    ``kp_capacity * max_orientations_per_keypoint``.
    """

    octave: jax.Array  # (N,) int32
    scale_level: jax.Array  # (N,) int32
    abs_y: jax.Array  # (N,) float
    abs_x: jax.Array  # (N,) float
    abs_sigma: jax.Array  # (N,) float
    theta: jax.Array  # (N,) float orientation in [0, 2π)
    descriptor: jax.Array  # (N, 128) float32, L2-ish normalized
    valid: jax.Array  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.octave.shape[-1]


def concat_described(parts: list[DescribedKeypoints]) -> DescribedKeypoints:
    return jax.tree.map(
        lambda *xs: jnp.concatenate(xs, axis=-2 if xs[0].ndim > 1 else -1),
        *parts,
    )


def _keypoint_gradient_samples(
    gy_stack: jax.Array,
    gx_stack: jax.Array,
    scale_level: jax.Array,
    ys: jax.Array,
    xs: jax.Array,
):
    """Bilinear gradient samples at float positions on one scale plane.

    The plane is selected by FLAT-INDEX arithmetic into the reshaped
    ``(S·H, W)`` stack instead of ``dynamic_index_in_dim`` + sample: the
    per-keypoint plane selection under ``vmap`` can make XLA
    materialize a (keypoints, H, W) copy of the gradient stack, tens of
    GB at 16 frames of 480p.
    Bilinear corners never cross a row boundary (ys is clamped to the
    plane interior by the callers' masks; the sample itself clamps),
    so sampling the row-stacked image at ``y + scale·H`` is exact.
    """
    s, h, w = gy_stack.shape
    base = (scale_level * h).astype(ys.dtype)
    ys_flat = jnp.clip(ys, 0.0, h - 1.0) + base
    return (
        bilinear_sample(gy_stack.reshape(s * h, w), ys_flat, xs),
        bilinear_sample(gx_stack.reshape(s * h, w), ys_flat, xs),
    )


def _inbounds_mask(ys, xs, h, w):
    """Interior mask: gradients need one pixel margin (central diffs)."""
    return (ys >= 1.0) & (ys <= h - 2.0) & (xs >= 1.0) & (xs <= w - 2.0)


# ---------------------------------------------------------------------------
# Orientation assignment
# ---------------------------------------------------------------------------


def _orientation_coords(dtype, y_loc, x_loc, sigma_loc, cfg: SiftConfig):
    """Sample coordinates of the orientation grid.

    ``y_loc``/``x_loc``/``sigma_loc``: scalars or (...,) arrays.
    Returns ``(ys, xs, d2)`` of shape ``(..., G²)`` — identical float
    ops (and therefore bits) to the original fused core for any batch
    shape. The grid is ALWAYS axis-aligned (outer product of one 1-D
    ruler with itself).
    """
    g = cfg.orientation_grid_size
    radius = jnp.asarray(sigma_loc, dtype) * (3.0 * cfg.lambda_ori)
    u = jnp.linspace(-1.0, 1.0, g, dtype=dtype)
    uy = jnp.broadcast_to(u[:, None], (g, g)).reshape(-1)  # (G²,)
    ux = jnp.broadcast_to(u[None, :], (g, g)).reshape(-1)
    dy = uy * radius[..., None]
    dx = ux * radius[..., None]
    ys = jnp.asarray(y_loc, dtype)[..., None] + dy
    xs = jnp.asarray(x_loc, dtype)[..., None] + dx
    return ys, xs, dy * dy + dx * dx


def _orientation_post(
    gy, gx, ys, xs, d2, h, w, dtype, sigma_loc, cfg: SiftConfig
):
    """Histogram accumulation from gradient samples (batch-shaped)."""
    nbins = cfg.n_orientation_bins
    radius = jnp.asarray(sigma_loc, dtype) * (3.0 * cfg.lambda_ori)
    mag = jnp.sqrt(gy * gy + gx * gx)
    theta = jnp.arctan2(gy, gx) % TWO_PI

    sig2 = 2.0 * (cfg.lambda_ori * jnp.asarray(sigma_loc, dtype)) ** 2
    weight = jnp.exp(-d2 / sig2[..., None]) * mag
    weight = jnp.where(d2 <= (radius * radius)[..., None], weight, 0.0)
    weight = jnp.where(_inbounds_mask(ys, xs, h, w), weight, 0.0)

    bin_idx = jnp.floor(theta / TWO_PI * nbins).astype(jnp.int32) % nbins
    onehot = jax.nn.one_hot(bin_idx, nbins, dtype=dtype)  # (..., G², nbins)
    return jnp.einsum(
        "...s,...sb->...b", weight, onehot,
        precision=jax.lax.Precision.HIGHEST,
    )


def _orientation_histogram_core(
    sample_fn, h, w, dtype, y_loc, x_loc, sigma_loc, cfg: SiftConfig
):
    """36-bin orientation histogram math, sampler-agnostic.

    ``sample_fn(ys, xs) -> (gy, gx)`` hides WHERE the gradients live
    (per-octave (S·H, W) stacks or the packed cross-octave flat buffer);
    ``h``/``w`` are the plane dims for the interior mask (static ints or
    traced scalars).
    """
    ys, xs, d2 = _orientation_coords(dtype, y_loc, x_loc, sigma_loc, cfg)
    gy, gx = sample_fn(ys, xs)
    return _orientation_post(
        gy, gx, ys, xs, d2, h, w, dtype, sigma_loc, cfg
    )


def _orientation_histogram_one(
    gy_stack, gx_stack, y_loc, x_loc, sigma_loc, scale_level, cfg: SiftConfig
):
    """36-bin orientation histogram for one keypoint (fixed G×G samples)."""
    h, w = gy_stack.shape[-2], gy_stack.shape[-1]

    def sample_fn(ys, xs):
        return _keypoint_gradient_samples(
            gy_stack, gx_stack, scale_level, ys, xs
        )

    return _orientation_histogram_core(
        sample_fn, h, w, gy_stack.dtype, y_loc, x_loc, sigma_loc, cfg
    )


def _smooth_circular(hist: jax.Array, iterations: int) -> jax.Array:
    """IPOL smoothing: circular [1,1,1]/3 box filter applied N times."""
    for _ in range(iterations):
        hist = (
            jnp.roll(hist, 1, axis=-1) + hist + jnp.roll(hist, -1, axis=-1)
        ) / 3.0
    return hist


def _extract_peaks(hist: jax.Array, cfg: SiftConfig):
    """Top-K orientation peaks with parabolic interpolation.

    A bin is a peak iff it strictly exceeds both circular neighbors and
    reaches ``peak_ratio * max`` (IPOL §4.1). Returns ``(theta, valid)``
    of shape ``(max_orientations,)``.
    """
    nbins = cfg.n_orientation_bins
    prev = jnp.roll(hist, 1, axis=-1)
    nxt = jnp.roll(hist, -1, axis=-1)
    is_peak = (hist > prev) & (hist > nxt)
    is_peak &= hist >= cfg.orientation_peak_ratio * jnp.max(
        hist, axis=-1, keepdims=True
    )

    score = jnp.where(is_peak, hist, -jnp.inf)
    top_vals, top_idx = jax.lax.top_k(score, cfg.max_orientations_per_keypoint)
    valid = jnp.isfinite(top_vals) & (top_vals > 0.0)

    hk = jnp.take_along_axis(hist, top_idx, axis=-1)
    hp = jnp.take_along_axis(prev, top_idx, axis=-1)
    hn = jnp.take_along_axis(nxt, top_idx, axis=-1)
    denom = hp - 2.0 * hk + hn
    offset = jnp.where(
        jnp.abs(denom) > 1e-12, (hp - hn) / (2.0 * denom), 0.0
    )
    theta = ((top_idx.astype(hist.dtype) + 0.5 + offset) / nbins) * TWO_PI
    return theta % TWO_PI, valid


def assign_orientations(
    octave_stack: jax.Array,
    keypoints: Keypoints,
    octave: int,
    cfg: SiftConfig,
    grads: tuple[jax.Array, jax.Array] | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Orientations for all keypoint slots of one octave.

    ``octave_stack``: Gaussian images ``(S, H, W)``. Returns
    ``(theta, valid)`` shaped ``(N, max_orientations)``; ``valid`` is
    ANDed with the keypoint slot validity. ``grads`` lets the caller
    share the stack gradients with the descriptor stage.
    """
    gy, gx = grads if grads is not None else scale_space_gradients(octave_stack)
    delta = 2.0 ** (octave - 1)

    def one(kp_y, kp_x, kp_sigma, s, ok):
        hist = _orientation_histogram_one(
            gy, gx, kp_y / delta, kp_x / delta, kp_sigma / delta, s, cfg
        )
        hist = _smooth_circular(hist, cfg.orientation_smooth_iterations)
        theta, valid = _extract_peaks(hist, cfg)
        return theta, valid & ok

    return jax.vmap(one)(
        keypoints.abs_y,
        keypoints.abs_x,
        keypoints.abs_sigma,
        keypoints.scale_level,
        keypoints.valid,
    )


# ---------------------------------------------------------------------------
# 128-D descriptor
# ---------------------------------------------------------------------------


def _descriptor_grid(dtype, cfg: SiftConfig):
    """Keypoint-independent grid constants ``(yhat, xhat)`` of (G²,)."""
    g = cfg.descriptor_grid_size
    nh = cfg.descriptor_n_hist
    # Normalized sample coordinates x̂,ŷ ∈ [-r̂, r̂], r̂ = λ·(nh+1)/nh
    # (the (nh+1)/nh margin feeds the outer cells' bilinear support).
    rhat = cfg.lambda_descr * (nh + 1.0) / nh
    u = jnp.linspace(-rhat, rhat, g, dtype=dtype)
    yhat = jnp.broadcast_to(u[:, None], (g, g)).reshape(-1)
    xhat = jnp.broadcast_to(u[None, :], (g, g)).reshape(-1)
    return yhat, xhat


def _descriptor_coords(dtype, y_loc, x_loc, sigma_loc, theta, cfg):
    """Rotated, σ-scaled sample coordinates, batch-shaped ``(..., G²)``."""
    yhat, xhat = _descriptor_grid(dtype, cfg)
    ct = jnp.cos(jnp.asarray(theta, dtype))[..., None]
    st = jnp.sin(jnp.asarray(theta, dtype))[..., None]
    sig = jnp.asarray(sigma_loc, dtype)[..., None]
    ys = jnp.asarray(y_loc, dtype)[..., None] + sig * (st * xhat + ct * yhat)
    xs = jnp.asarray(x_loc, dtype)[..., None] + sig * (ct * xhat - st * yhat)
    return ys, xs


def _descriptor_post(gy, gx, ys, xs, h, w, dtype, theta, cfg: SiftConfig):
    """4×4×8 histograms + normalization from gradient samples."""
    nh = cfg.descriptor_n_hist
    no = cfg.descriptor_n_ori
    lam = cfg.lambda_descr
    yhat, xhat = _descriptor_grid(dtype, cfg)
    theta = jnp.asarray(theta, dtype)

    mag = jnp.sqrt(gy * gy + gx * gx)
    ang = (jnp.arctan2(gy, gx) - theta[..., None]) % TWO_PI

    d2 = yhat * yhat + xhat * xhat
    weight = jnp.exp(-d2 / (2.0 * lam * lam)) * mag
    weight = jnp.where(_inbounds_mask(ys, xs, h, w), weight, 0.0)

    # Spatial bilinear soft assignment to nh cells per axis. Cell centers
    # sit at ĉ_i = (i - (nh-1)/2) * (2λ/nh); cell coordinate:
    a_y = yhat * nh / (2.0 * lam) + (nh - 1.0) / 2.0
    a_x = xhat * nh / (2.0 * lam) + (nh - 1.0) / 2.0

    def bilinear_onehot(a, n):
        i0 = jnp.floor(a)
        f = a - i0
        i0i = i0.astype(jnp.int32)
        w0 = jnp.where((i0i >= 0) & (i0i < n), 1.0 - f, 0.0)
        w1 = jnp.where((i0i + 1 >= 0) & (i0i + 1 < n), f, 0.0)
        oh0 = jax.nn.one_hot(jnp.clip(i0i, 0, n - 1), n, dtype=dtype) * w0[:, None]
        oh1 = (
            jax.nn.one_hot(jnp.clip(i0i + 1, 0, n - 1), n, dtype=dtype)
            * w1[:, None]
        )
        return oh0 + oh1  # (G², n)

    wy = bilinear_onehot(a_y, nh)
    wx = bilinear_onehot(a_x, nh)

    # Circular linear assignment over orientation bins.
    b = ang / TWO_PI * no
    b0 = jnp.floor(b)
    fb = b - b0
    b0i = b0.astype(jnp.int32) % no
    b1i = (b0i + 1) % no
    wo = (
        jax.nn.one_hot(b0i, no, dtype=dtype) * (1.0 - fb)[..., None]
        + jax.nn.one_hot(b1i, no, dtype=dtype) * fb[..., None]
    )

    desc = jnp.einsum(
        "...p,py,px,...po->...yxo",
        weight,
        wy,
        wx,
        wo,
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    desc = desc.reshape(desc.shape[:-3] + (nh * nh * no,))

    # Normalize, clamp at 0.2·‖d‖, renormalize (Lowe/IPOL).
    norm = jnp.sqrt(jnp.sum(desc * desc, axis=-1, keepdims=True) + 1e-12)
    desc = jnp.minimum(desc, cfg.descriptor_clip * norm)
    norm2 = jnp.sqrt(jnp.sum(desc * desc, axis=-1, keepdims=True) + 1e-12)
    return desc / norm2


def _descriptor_core(
    sample_fn, h, w, dtype, y_loc, x_loc, sigma_loc, theta, cfg: SiftConfig
):
    """4×4×8 descriptor math, sampler-agnostic (see orientation core)."""
    ys, xs = _descriptor_coords(dtype, y_loc, x_loc, sigma_loc, theta, cfg)
    gy, gx = sample_fn(ys, xs)
    return _descriptor_post(gy, gx, ys, xs, h, w, dtype, theta, cfg)


def _descriptor_one(
    gy_stack, gx_stack, y_loc, x_loc, sigma_loc, theta, scale_level, cfg: SiftConfig
):
    """One 4×4×8 descriptor via fixed-grid sampling in the rotated frame."""
    h, w = gy_stack.shape[-2], gy_stack.shape[-1]

    def sample_fn(ys, xs):
        return _keypoint_gradient_samples(
            gy_stack, gx_stack, scale_level, ys, xs
        )

    return _descriptor_core(
        sample_fn, h, w, gy_stack.dtype, y_loc, x_loc, sigma_loc, theta, cfg
    )


def compute_descriptors(
    octave_stack: jax.Array,
    keypoints: Keypoints,
    theta: jax.Array,
    ori_valid: jax.Array,
    octave: int,
    cfg: SiftConfig,
    grads: tuple[jax.Array, jax.Array] | None = None,
) -> DescribedKeypoints:
    """Descriptors for one octave's keypoints × orientation peaks.

    ``theta``/``ori_valid``: ``(N, max_orientations)`` from
    :func:`assign_orientations`. Output capacity ``N * max_orientations``.
    """
    gy, gx = grads if grads is not None else scale_space_gradients(octave_stack)
    delta = 2.0 ** (octave - 1)
    n_ori = cfg.max_orientations_per_keypoint

    def one(kp_y, kp_x, kp_sigma, s, th):
        return _descriptor_one(
            gy, gx, kp_y / delta, kp_x / delta, kp_sigma / delta, th, s, cfg
        )

    # vmap over (slot, orientation) pairs.
    flat_theta = theta.reshape(-1)
    rep = lambda v: jnp.repeat(v, n_ori, axis=0)
    desc = jax.vmap(one)(
        rep(keypoints.abs_y),
        rep(keypoints.abs_x),
        rep(keypoints.abs_sigma),
        rep(keypoints.scale_level),
        flat_theta,
    )
    valid = ori_valid.reshape(-1)

    return DescribedKeypoints(
        octave=rep(keypoints.octave),
        scale_level=rep(keypoints.scale_level),
        abs_y=rep(keypoints.abs_y),
        abs_x=rep(keypoints.abs_x),
        abs_sigma=rep(keypoints.abs_sigma),
        theta=flat_theta,
        descriptor=desc.astype(jnp.float32),
        valid=valid,
    )


def describe_octave(
    octave_stack: jax.Array, keypoints: Keypoints, octave: int, cfg: SiftConfig
) -> DescribedKeypoints:
    """Orientation assignment + descriptors for one octave.

    The stack gradients are computed once and shared by both stages.
    """
    grads = scale_space_gradients(octave_stack)
    theta, ori_valid = assign_orientations(
        octave_stack, keypoints, octave, cfg, grads=grads
    )
    return compute_descriptors(
        octave_stack, keypoints, theta, ori_valid, octave, cfg, grads=grads
    )


# ---------------------------------------------------------------------------
# Unified cross-octave describe with valid-slot compaction
# ---------------------------------------------------------------------------


def describe_compact(
    stacks: list[jax.Array],
    keypoints_list: list[Keypoints],
    cfg: SiftConfig,
) -> DescribedKeypoints:
    """ONE describe pass over all octaves, on compacted VALID keypoints.

    The per-octave path pays the per-slot sampling cost for every
    refine-capacity slot, but only ~35 % of slots hold valid keypoints
    at the bench config — and descriptor
    slots are further diluted by invalid orientation peaks (26 %
    occupancy). This path:

    1. packs every octave's gradients into one flat interleaved buffer
       (:func:`~..ops.sampling.pack_gradients_flat`: one 4-element
       contiguous gather per bilinear sample),
    2. compacts valid keypoints across octaves into
       ``cfg.describe_capacity()`` slots (hierarchical prefix-sum
       selection, no sort),
    3. runs orientation on compacted slots only,
    4. compacts valid (slot, orientation-peak) pairs into
       ``cfg.descriptor_pair_capacity()`` slots and runs the descriptor
       pass on those.

    Per kept keypoint the float math is identical to
    :func:`describe_octave` (same cores, same sample coordinates);
    keypoints are lost only to capacity overflow (observable: valid
    count vs capacity). With ``cfg.upright`` the orientation stage is
    skipped entirely and θ=0 for every keypoint — a documented mode for
    video/SLAM tracking where inter-frame rotation is small and the
    orientation stage is ~40 % of describe cost.
    """
    from .extrema import first_k_set_indices
    from .sampling import bilinear_sample_pair_flat, pack_gradients_flat

    # Keypoints can only hold scale_level ∈ [1, spo] (the Newton step
    # clamps s to [1, n_dog-2], ops/refine.py), so only those planes'
    # gradients are ever sampled — pack spo planes per octave instead
    # of spo+3 (the sampler shifts the scale index by the slice start).
    s_lo, s_hi = 1, cfg.scales_per_octave + 1
    flat, base_lut, h_lut, w_lut = pack_gradients_flat(
        [st[s_lo:s_hi] for st in stacks]
    )
    dtype = flat.dtype
    n_ori = cfg.max_orientations_per_keypoint

    def cat(field):
        return jnp.concatenate(
            [getattr(k, field) for k in keypoints_list], axis=-1
        )

    all_valid = cat("valid")
    cap = cfg.describe_capacity()
    idx, ok, _ = first_k_set_indices(all_valid, cap)

    def take(a):
        return a[idx]

    oct_id = take(cat("octave"))
    scale_lv = take(cat("scale_level"))
    abs_y = take(cat("abs_y"))
    abs_x = take(cat("abs_x"))
    abs_sigma = take(cat("abs_sigma"))
    kvalid = ok & take(all_valid)

    delta = jnp.exp2((oct_id - 1).astype(dtype))
    base = base_lut[oct_id]
    hh = h_lut[oct_id]
    ww = w_lut[oct_id]
    y_loc = abs_y / delta
    x_loc = abs_x / delta
    sig_loc = abs_sigma / delta

    def sampler(b, h_, w_, s_):
        hf = h_.astype(dtype)

        def sample_fn(ys, xs):
            # Same coordinate handling as _keypoint_gradient_samples:
            # clamp y to the plane, offset by scale_level·H, THEN shift
            # by the slice start (the flat buffer holds planes
            # [s_lo, s_hi) only). The add-then-subtract order replicates
            # the unsliced path's f32 rounding bit-for-bit (computing
            # (s−s_lo)·H directly yields a different fractional part at
            # the last bit, which moved orientations by ~1e-6 rad);
            # subtracting the integer s_lo·H from the rounded sum is
            # exact at these magnitudes.
            ys_flat = (
                jnp.clip(ys, 0.0, hf - 1.0) + s_.astype(dtype) * hf
            ) - (s_lo * 1.0) * hf
            return bilinear_sample_pair_flat(flat, b, w_, ys_flat, xs)

        return sample_fn

    if cfg.upright:
        theta_pairs = jnp.zeros(cap, dtype)
        pair_valid = kvalid
        p_oct, p_scale = oct_id, scale_lv
        p_y, p_x, p_sig = abs_y, abs_x, abs_sigma
        p_base, p_h, p_w = base, hh, ww
        p_yl, p_xl, p_sl = y_loc, x_loc, sig_loc
    else:

        def ori_one(b, h_, w_, s_, yl, xl, sgl):
            hist = _orientation_histogram_core(
                sampler(b, h_, w_, s_), h_, w_, dtype, yl, xl, sgl, cfg
            )
            hist = _smooth_circular(hist, cfg.orientation_smooth_iterations)
            return _extract_peaks(hist, cfg)

        theta, ori_valid = jax.vmap(ori_one)(
            base, hh, ww, scale_lv, y_loc, x_loc, sig_loc
        )
        ori_valid &= kvalid[:, None]

        pcap = cfg.descriptor_pair_capacity()
        pidx, pok, _ = first_k_set_indices(ori_valid.reshape(-1), pcap)
        slot = pidx // n_ori

        theta_pairs = theta.reshape(-1)[pidx]
        pair_valid = pok & ori_valid.reshape(-1)[pidx]
        p_oct, p_scale = oct_id[slot], scale_lv[slot]
        p_y, p_x, p_sig = abs_y[slot], abs_x[slot], abs_sigma[slot]
        p_base, p_h, p_w = base[slot], hh[slot], ww[slot]
        p_yl, p_xl, p_sl = y_loc[slot], x_loc[slot], sig_loc[slot]

    def desc_one(b, h_, w_, s_, yl, xl, sgl, th):
        return _descriptor_core(
            sampler(b, h_, w_, s_), h_, w_, dtype, yl, xl, sgl, th, cfg
        )

    desc = jax.vmap(desc_one)(
        p_base, p_h, p_w, p_scale, p_yl, p_xl, p_sl, theta_pairs
    )

    return DescribedKeypoints(
        octave=p_oct,
        scale_level=p_scale,
        abs_y=p_y,
        abs_x=p_x,
        abs_sigma=p_sig,
        theta=theta_pairs,
        descriptor=desc.astype(jnp.float32),
        valid=pair_valid,
    )
