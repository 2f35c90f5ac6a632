"""Quadratic keypoint refinement (Newton iteration on the DoG cube).

Static-shape rewrite of the reference's per-keypoint scalar loop
(reference/background.js:455-685): plain array code over all
fixed-capacity candidate slots at once with masked state updates and
statically unrolled iterations. Each iteration gathers the 19 used points of the
3×3×3 DoG neighborhood (corners are dead) as one flat ``jnp.take``,
forms the gradient/Hessian by central differences
(reference/src/sift.js:333-446), solves ``α = -H⁻¹ g`` via the closed-form
adjugate inverse (reference/src/matrix2d.js:464-509) with the exact same
floating-point evaluation order, and applies the reference's
accept/reject ladder:

- convergence: all ``|α_i| < 0.6`` (background.js:558)
- contrast: ``|ω| < thr`` rejects, ω = value + ½·αᵀg (background.js:565-583)
- edge: tr²/det of the spatial sub-Hessian > (c+1)²/c (background.js:589-604)
- non-converged: step to ``round((s,m,n)+α)`` (JS round = floor(x+.5)) and
  reject on leaving the valid interior (background.js:638-664)
- singular Hessian: |det| < 2⁻⁵² — the reference returns null and crashes
  (matrix2d.js:482); we reject with REJECT_SINGULAR_HESSIAN instead.

ω uses the *original* extremum value even after the point moves — a
reference quirk (background.js:565 reads ``extrema.value``) replicated
here for parity.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from .extrema import first_k_set_indices
from ..core.types import (
    ACCEPTED,
    REJECT_EDGE,
    REJECT_LOW_CONTRAST,
    REJECT_MAX_ITERATIONS,
    REJECT_OUT_OF_BOUNDS,
    REJECT_SINGULAR_HESSIAN,
    Extrema,
    Keypoints,
)

JS_EPSILON = 2.0 ** -52  # Number.EPSILON


def _refine_core(
    dog_flat: jax.Array,
    d_scales: int,
    h,
    w,
    base_off,
    delta,
    sigma_coeff,
    s0: jax.Array,
    m0: jax.Array,
    n0: jax.Array,
    value: jax.Array,
    valid: jax.Array,
    cfg: SiftConfig,
    tile_h=None,
    pool_cap: int | None = None,
):
    """Vectorized Newton refinement over all candidate slots at once.

    Structured as plain array code over ``(N,)`` state with ONE flat
    19-element gather per iteration (``jnp.take`` on the flattened DoG
    volume) rather than a per-keypoint ``dynamic_slice`` under ``vmap``
    — the latter can lower to one gather per keypoint and plane.
    Iterations unroll
    statically (``max_refine_iterations`` = 5). Float op order per
    element matches the reference exactly (see module docstring).

    ``h``/``w``/``base_off``/``delta``/``sigma_coeff`` may be scalars
    (single-octave callers) or per-slot ``(N,)`` arrays: the unified
    path (:func:`refine_keypoints_multi`) concatenates every octave's
    candidates over one flat multi-octave DoG buffer and supplies each
    slot's octave geometry — the elementwise math is identical either
    way, so the two paths produce bit-equal results.
    """
    # Newton math always runs at >= f32: the bf16-compressed DoG mode
    # (ops/pallas/octave.py dog_dtype) quantizes only the STORED planes;
    # gathered neighborhoods are widened right after the gather.
    dtype = jnp.float32 if dog_flat.dtype == jnp.bfloat16 else dog_flat.dtype
    thr = cfg.contrast_threshold_scaled
    edge_thr = cfg.edge_threshold
    n_slots = s0.shape[0]

    # Geometry lives in the iteration state as (N,) arrays so the
    # active-set compaction below gathers it alongside the positions.
    # ``tile`` is the DoG storage stripe height (ops/pallas/octave.py
    # flat_detect): the plane layout is the tile_h == h special case of
    # the same flat-index formula (ops/extrema.py::dog_flat_index), so
    # there is exactly one addressing path. h stays the LOGICAL image
    # height (the reference's bounds checks use it; the stripe-major
    # buffer's pad rows are never addressed because positions stay in
    # the interior).
    if tile_h is None:
        tile_h = h
    geom = dict(
        h=jnp.broadcast_to(jnp.asarray(h, jnp.int32), (n_slots,)),
        w=jnp.broadcast_to(jnp.asarray(w, jnp.int32), (n_slots,)),
        off=jnp.broadcast_to(jnp.asarray(base_off, jnp.int32), (n_slots,)),
        tile=jnp.broadcast_to(jnp.asarray(tile_h, jnp.int32), (n_slots,)),
        delta=jnp.broadcast_to(jnp.asarray(delta, dtype), (n_slots,)),
        sigc=jnp.broadcast_to(jnp.asarray(sigma_coeff, dtype), (n_slots,)),
    )

    # Gradient + Hessian touch only 19 of the 27 cube points — the 8
    # corners (|ds|+|dm|+|dn| == 3) never appear in the central
    # differences (reference/src/sift.js:333-446); this stage's cost is
    # its gathers, so skipping the 8 dead lanes saves 30% of them.
    pts = [
        (a, b, c)
        for a in (-1, 0, 1)
        for b in (-1, 0, 1)
        for c in (-1, 0, 1)
        if abs(a) + abs(b) + abs(c) < 3
    ]
    col = {p: i for i, p in enumerate(pts)}
    ds_ = jnp.asarray([p[0] for p in pts], jnp.int32)
    dm_ = jnp.asarray([p[1] for p in pts], jnp.int32)
    dn_ = jnp.asarray([p[2] for p in pts], jnp.int32)

    def flat_index(sc, mc, nc, off, ww, tile, d_s, d_m, d_n):
        """Per-slot flat addresses of points (sc+d_s, mc+d_m, nc+d_n).

        ``d_*`` are (K,) constant offset vectors; returns (N, K). One
        formula for both DoG layouts (ops/extrema.py::dog_flat_index);
        ``tile`` is the per-slot storage stripe height (== h for the
        plane layout, where blk degenerates to 0).
        """
        mm = mc[:, None] + d_m[None, :]
        tt = tile[:, None]
        blk = mm // tt
        return (
            off[:, None]
            + (
                (blk * d_scales + sc[:, None] + d_s[None, :]) * tt
                + (mm - blk * tt)
            )
            * ww[:, None]
            + nc[:, None]
            + d_n[None, :]
        )

    if dog_flat.ndim == 2:
        dog_flat = dog_flat.reshape(-1)

    def gather_cube(sc, mc, nc, off, ww, tile):
        """(v accessor) for the 19 points around each slot's position."""
        idx = flat_index(sc, mc, nc, off, ww, tile, ds_, dm_, dn_)
        cube = jnp.take(dog_flat, idx, axis=0).astype(dtype)
        return lambda a, b, cc: cube[:, col[(a - 1, b - 1, cc - 1)]]

    zero = jnp.zeros((n_slots,), dtype)
    state = dict(
        s=s0.astype(jnp.int32),
        m=m0.astype(jnp.int32),
        n=n0.astype(jnp.int32),
        value=value.astype(dtype),
        done=~valid,
        reason=jnp.where(valid, REJECT_MAX_ITERATIONS, -1).astype(jnp.int32),
        abs_y=zero,
        abs_x=zero,
        abs_sigma=zero,
        omega=zero,
        **geom,
    )

    def step(c):
        s, m, n = c["s"], c["m"], c["n"]
        value = c["value"]
        hh, ww, off = c["h"], c["w"], c["off"]

        # Positions are always within the valid interior while active
        # (enforced by the out-of-bounds test); clip for the masked-off
        # lanes so indices stay legal. One flat 19-element ``jnp.take``
        # per step (see gather_cube).
        sc = jnp.clip(s, 1, d_scales - 2)
        mc = jnp.clip(m, 1, hh - 2)
        nc = jnp.clip(n, 1, ww - 2)
        v = gather_cube(sc, mc, nc, off, ww, c["tile"])

        ctr = v(1, 1, 1)
        g0 = (v(2, 1, 1) - v(0, 1, 1)) / 2
        g1 = (v(1, 2, 1) - v(1, 0, 1)) / 2
        g2 = (v(1, 1, 2) - v(1, 1, 0)) / 2
        h11 = v(2, 1, 1) + v(0, 1, 1) - (2 * ctr)
        h22 = v(1, 2, 1) + v(1, 0, 1) - (2 * ctr)
        h33 = v(1, 1, 2) + v(1, 1, 0) - (2 * ctr)
        h12 = (v(2, 2, 1) - v(2, 0, 1) - v(0, 2, 1) + v(0, 0, 1)) / 4
        h13 = (v(2, 1, 2) - v(2, 1, 0) - v(0, 1, 2) + v(0, 1, 0)) / 4
        h23 = (v(1, 2, 2) - v(1, 2, 0) - v(1, 0, 2) + v(1, 0, 0)) / 4

        m00 = (h22 * h33) - (h23 * h23)
        m01 = (h12 * h33) - (h23 * h13)
        m02 = (h12 * h23) - (h22 * h13)
        m10 = (h12 * h33) - (h13 * h23)
        m11 = (h11 * h33) - (h13 * h13)
        m12 = (h11 * h23) - (h12 * h13)
        m20 = (h12 * h23) - (h13 * h22)
        m21 = (h11 * h23) - (h13 * h12)
        m22 = (h11 * h22) - (h12 * h12)
        det = (h11 * m00) - (h12 * m01) + (h13 * m02)

        singular = jnp.abs(det) < jnp.asarray(JS_EPSILON, dtype)
        det_safe = jnp.where(singular, jnp.asarray(1.0, dtype), det)

        i00 = m00 / det_safe
        i01 = -(m10 / det_safe)
        i02 = m20 / det_safe
        i10 = -(m01 / det_safe)
        i11 = m11 / det_safe
        i12 = -(m21 / det_safe)
        i20 = m02 / det_safe
        i21 = -(m12 / det_safe)
        i22 = m22 / det_safe
        a0 = ((-i00) * g0) + ((-i01) * g1) + ((-i02) * g2)
        a1 = ((-i10) * g0) + ((-i11) * g1) + ((-i12) * g2)
        a2 = ((-i20) * g0) + ((-i21) * g1) + ((-i22) * g2)

        lim = jnp.asarray(cfg.convergence_threshold, dtype)
        converged = (jnp.abs(a0) < lim) & (jnp.abs(a1) < lim) & (jnp.abs(a2) < lim)

        omega = value + (
            ((0.5 * a0) * g0) + ((0.5 * a1) * g1) + ((0.5 * a2) * g2)
        )
        contrast_fail = jnp.abs(omega) < jnp.asarray(thr, dtype)

        tr = h22 + h33
        det2 = (h22 * h33) - (h23 * h23)
        edgeness = (tr * tr) / det2
        edge_fail = edgeness > jnp.asarray(edge_thr, dtype)

        accepted = converged & ~contrast_fail & ~edge_fail

        sf = s.astype(dtype)
        mf = m.astype(dtype)
        nf = n.astype(dtype)
        new_s = jnp.floor((sf + a0) + 0.5).astype(jnp.int32)
        new_m = jnp.floor((mf + a1) + 0.5).astype(jnp.int32)
        new_n = jnp.floor((nf + a2) + 0.5).astype(jnp.int32)
        oob = (
            (new_s < 1)
            | (new_s >= d_scales - 1)
            | (new_m < 1)
            | (new_m >= hh - 1)
            | (new_n < 1)
            | (new_n >= ww - 1)
        )

        active = ~c["done"]
        finish_singular = active & singular
        finish_converged = active & ~singular & converged
        stepping = active & ~singular & ~converged
        finish_oob = stepping & oob

        reason = c["reason"]
        reason = jnp.where(finish_singular, REJECT_SINGULAR_HESSIAN, reason)
        reason = jnp.where(
            finish_converged,
            jnp.where(
                contrast_fail,
                REJECT_LOW_CONTRAST,
                jnp.where(edge_fail, REJECT_EDGE, ACCEPTED),
            ),
            reason,
        )
        reason = jnp.where(finish_oob, REJECT_OUT_OF_BOUNDS, reason)

        record = finish_converged & accepted
        abs_y = jnp.where(record, c["delta"] * (a1 + mf), c["abs_y"])
        abs_x = jnp.where(record, c["delta"] * (a2 + nf), c["abs_x"])
        abs_sigma = jnp.where(
            record,
            c["sigc"] * jnp.exp2((a0 + sf) / cfg.scales_per_octave),
            c["abs_sigma"],
        )
        omega_out = jnp.where(record, omega, c["omega"])

        advance = stepping & ~oob
        out = dict(c)
        out.update(
            s=jnp.where(advance, new_s, s),
            m=jnp.where(advance, new_m, m),
            n=jnp.where(advance, new_n, n),
            done=c["done"] | finish_singular | finish_converged | finish_oob,
            reason=reason,
            abs_y=abs_y,
            abs_x=abs_x,
            abs_sigma=abs_sigma,
            omega=omega_out,
        )
        return out

    remaining = cfg.max_refine_iterations - 1
    schedule = tuple(cfg.refine_compaction_schedule) or (
        cfg.refine_active_compaction,
    )
    # Compaction ladder: most candidates finish in the first Newton
    # iteration (converge, reject, or leave the volume) and the active
    # set keeps shrinking, so before each remaining iteration the
    # still-active slots are packed into ``schedule[i] * n_slots``
    # (their octave geometry travels with them); results scatter back
    # up the ladder at the end. Actives beyond a cap simply keep the
    # REJECT_MAX_ITERATIONS fate they already hold (caps carry >=1.6x
    # headroom over measured survivor fractions — see config).
    # Padding lanes reuse slot 0 and are marked done, so the write-back
    # stores unchanged values for them.
    # State diet (round 4): lanes selected by the compaction are ACTIVE
    # (done=False), and active lanes provably hold the init values
    # abs_y = abs_x = abs_sigma = omega = 0 and
    # reason = REJECT_MAX_ITERATIONS (those fields are only written when
    # a lane finishes, which also sets done) — so those 5 arrays are
    # rebuilt as constants instead of gathered. Conversely ``value`` and
    # the 6 geometry arrays never change inside ``step``, so they skip
    # the write-back scatter. Bit-identical output, ~40% fewer
    # gather/scatter passes per ladder level.
    _CONST_ON_ACTIVE = ("abs_y", "abs_x", "abs_sigma", "omega")
    _STEP_IMMUTABLE = ("value", "h", "w", "off", "tile", "delta", "sigc")

    def _compact_level(cur, cap, levels):
        sel_read, ok, _ = first_k_set_indices(~cur["done"], cap)
        sub = {
            k: cur[k][sel_read]
            for k in cur
            if k not in _CONST_ON_ACTIVE and k not in ("done", "reason")
        }
        zero_c = jnp.zeros((cap,), cur["abs_y"].dtype)
        for k in _CONST_ON_ACTIVE:
            sub[k] = zero_c
        sub["reason"] = jnp.full((cap,), REJECT_MAX_ITERATIONS, jnp.int32)
        sub["done"] = ~ok
        levels.append((cur, sel_read, ok))
        return sub

    levels = []  # (parent_state, sel_read, ok) per compaction taken
    cur = state
    # Cross-octave POOL compaction before the FIRST iteration (round 4,
    # multi-octave path only): the static per-octave capacity schedule
    # cannot adapt to content (bench batch: octave 0 saturated at 100 %
    # occupancy while octave 1 sits at 3 % and octave 3 at 0 %), so the
    # multi path packs all octaves' VALID candidates into
    # ``pool_cap`` slots before the gather-bound iterations — per-octave
    # caps still bound each octave (scale diversity under saturation);
    # only the cross-octave total is budgeted. Candidates beyond the
    # pool keep the REJECT_MAX_ITERATIONS fate (same overflow semantics
    # as the ladder caps; observable via the per-trio counters).
    if pool_cap is not None and pool_cap < n_slots:
        cur = _compact_level(cur, pool_cap, levels)
    cur = step(cur)  # iteration 1 (on pooled slots when pool_cap is set)
    for i in range(remaining):
        frac = schedule[min(i, len(schedule) - 1)]
        cap = max(64, int(n_slots * frac))
        if cap < cur["done"].shape[0]:
            cur = _compact_level(cur, cap, levels)
        cur = step(cur)
    for parent, sel_read, ok in reversed(levels):
        # Write-back: padding lanes get an out-of-range index and are
        # DROPPED — a clamped/aliased index could race a real lane's
        # update for the same slot. Step-immutable fields keep the
        # parent's copy (identical values; no scatter).
        sel_write = jnp.where(ok, sel_read, parent["done"].shape[0])
        cur = {
            k: (
                parent[k]
                if k in _STEP_IMMUTABLE
                else parent[k].at[sel_write].set(cur[k], mode="drop")
            )
            for k in parent
        }
    return cur


def _octave_geometry(octave: int, cfg: SiftConfig):
    """(delta, sigma_coeff) for an octave (reference/background.js:610-614)."""
    delta = math.pow(2.0, octave - 1)
    return delta, (delta / cfg.min_interpixel_distance) * cfg.min_blur_level


def _keypoints_from_state(refined, octave) -> Keypoints:
    reason = refined["reason"]
    return Keypoints(
        octave=(
            jnp.full_like(reason, octave)
            if isinstance(octave, int)
            else octave.astype(reason.dtype)
        ),
        scale_level=refined["s"],
        local_y=refined["m"],
        local_x=refined["n"],
        abs_y=refined["abs_y"],
        abs_x=refined["abs_x"],
        abs_sigma=refined["abs_sigma"],
        value=refined["omega"],
        valid=reason == ACCEPTED,
        reject_reason=reason,
    )


def _dog_dims(dog: jax.Array, image_h: int | None):
    """(d_scales, h, w, tile_h) for either DoG storage layout."""
    if dog.ndim == 4:  # stripe-major (n_stripes, D, tile_h, W)
        _, d_scales, tile_h, w = dog.shape
        assert image_h is not None, "stripe-major DoG needs image_h"
        return d_scales, image_h, w, tile_h
    d_scales, h, w = dog.shape
    return d_scales, h, w, h


def refine_keypoints(
    dog: jax.Array,
    extrema: Extrema,
    octave: int,
    cfg: SiftConfig,
    image_h: int | None = None,
) -> Keypoints:
    """Refine all candidate slots of one octave.

    ``dog``: ``(D, H, W)`` plane-major, or ``(n_stripes, D, tile_h, W)``
    stripe-major (the layout a fused octave kernel writes, see
    ops/extrema.py::dog_flat_index) — in which case ``image_h`` must
    supply the logical image height (the buffer keeps pad rows).
    """
    d_scales, h, w, tile_h = _dog_dims(dog, image_h)
    delta, sigma_coeff = _octave_geometry(octave, cfg)
    refined = _refine_core(
        dog.reshape(-1, dog.shape[-1]),
        d_scales,
        h,
        w,
        0,
        delta,
        sigma_coeff,
        extrema.scale_level,
        extrema.y,
        extrema.x,
        extrema.value,
        extrema.valid,
        cfg,
        tile_h=tile_h,
    )
    return _keypoints_from_state(refined, octave)


def refine_keypoints_multi(
    dogs: list[jax.Array],
    extrema_list: list[Extrema],
    cfg: SiftConfig,
    image_hs: list[int | None] | None = None,
    octave_offset: int = 0,
) -> Keypoints:
    """ONE refinement pass over every octave's candidates.

    Concatenates the flattened per-octave DoG volumes into a single
    buffer and all octaves' candidate slots into one state vector whose
    per-slot octave geometry (plane dims, flat offset, coordinate
    scale) is gathered from tables — 1/num_octaves the gather and
    compaction op count of the per-octave path at bit-identical
    numerics (same elementwise ops per slot). Requires every octave's
    DoG to share one dtype. Slot order equals
    ``concat_keypoints([refine_keypoints(o) for o])``.
    """
    assert len({d.dtype for d in dogs}) == 1, "mixed DoG dtypes"
    if image_hs is None:
        image_hs = [None] * len(dogs)
    dims = [_dog_dims(d, ih) for d, ih in zip(dogs, image_hs)]
    d_scales = dims[0][0]
    dog_cat = jnp.concatenate([d.reshape(-1) for d in dogs])
    dtype = (
        jnp.float32 if dogs[0].dtype == jnp.bfloat16 else dogs[0].dtype
    )

    hs, ws, offs, tiles, deltas, sigcs, octs = [], [], [], [], [], [], []
    flat_off = 0
    for oct_i, (d, e) in enumerate(zip(dogs, extrema_list)):
        octave = oct_i + octave_offset
        _, h, w, tile = dims[oct_i]
        n = e.y.shape[0]
        delta, sigc = _octave_geometry(octave, cfg)
        hs.append(jnp.full((n,), h, jnp.int32))
        ws.append(jnp.full((n,), w, jnp.int32))
        offs.append(jnp.full((n,), flat_off, jnp.int32))
        tiles.append(jnp.full((n,), tile, jnp.int32))
        deltas.append(jnp.full((n,), delta, dtype))
        sigcs.append(jnp.full((n,), sigc, dtype))
        octs.append(jnp.full((n,), octave, jnp.int32))
        flat_off += int(np.prod(d.shape))

    total = sum(e.y.shape[0] for e in extrema_list)
    pool_cap = min(total, max(256, int(total * cfg.refine_pool_compaction)))
    refined = _refine_core(
        dog_cat,
        d_scales,
        jnp.concatenate(hs),
        jnp.concatenate(ws),
        jnp.concatenate(offs),
        jnp.concatenate(deltas),
        jnp.concatenate(sigcs),
        jnp.concatenate([e.scale_level for e in extrema_list]),
        jnp.concatenate([e.y for e in extrema_list]),
        jnp.concatenate([e.x for e in extrema_list]),
        jnp.concatenate(
            [e.value.astype(dtype) for e in extrema_list]
        ),
        jnp.concatenate([e.valid for e in extrema_list]),
        cfg,
        tile_h=jnp.concatenate(tiles),
        pool_cap=pool_cap,
    )
    return _keypoints_from_state(refined, jnp.concatenate(octs))
