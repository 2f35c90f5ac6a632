"""Vectorized 26-neighbor scale-space extrema detection.

The reference scans interior pixels of each DoG trio with a scalar loop
and strict comparisons against all 26 neighbors, plus a contrast
pre-filter (reference/src/sift.js:212-316, background.js:359-450). Here
the scan is a dense masked computation over the whole ``(D, H, W)`` DoG
stack — shifted slices, a min/max reduction over the 26 neighbors, and a
sort-based compaction into a fixed-capacity candidate buffer whose slot
order matches the reference's row-major emission order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from ..core.types import Extrema


def _neighborhood_min_max(dog: jax.Array):
    """Per-plane separable 3×3 min/max over the interior, shared by trios.

    Each DoG plane's 3×3-neighborhood extrema are computed ONCE with two
    separable passes (rows then columns) and reused by every trio that
    touches the plane — the naive per-trio version re-sliced 26
    neighbors per trio (130 slice-ops per octave vs ~30 here).
    Returns ``(min3, max3)`` of shape ``(D, H-2, W-2)``.
    """
    h, w = dog.shape[-2], dog.shape[-1]
    a = dog[:, :, 0 : w - 2]
    b = dog[:, :, 1 : w - 1]
    c = dog[:, :, 2:w]
    row_min = jnp.minimum(jnp.minimum(a, b), c)
    row_max = jnp.maximum(jnp.maximum(a, b), c)
    min3 = jnp.minimum(
        jnp.minimum(row_min[:, 0 : h - 2], row_min[:, 1 : h - 1]),
        row_min[:, 2:h],
    )
    max3 = jnp.maximum(
        jnp.maximum(row_max[:, 0 : h - 2], row_max[:, 1 : h - 1]),
        row_max[:, 2:h],
    )
    return min3, max3


def _trio_masks(dog: jax.Array, min3: jax.Array, max3: jax.Array, s: int, cfg: SiftConfig):
    """Candidate / low-contrast masks for the trio centered at DoG scale s.

    Returns boolean masks of shape (H-2, W-2) over interior pixels.
    Strict extremality: center > max(26 neighbors) or < min(26) — ties and
    plateaus rejected, matching ``Array.every`` with strict comparisons
    (reference/src/sift.js:261-266). The adjacent planes use the shared
    full-3×3 ``min3``/``max3``; the center plane needs its own 8-neighbor
    RING min/max (center excluded — the full 3×3 would include the center
    and break strictness), assembled from the same separable row pieces.
    """
    h, w = dog.shape[-2], dog.shape[-1]
    center = dog[s, 1 : h - 1, 1 : w - 1]
    plane = dog[s]

    # Ring (8-neighbor) min/max of the center plane: top and bottom rows
    # via the separable row min/max, the middle row from the two lateral
    # neighbors only (center excluded).
    a = plane[:, 0 : w - 2]
    b = plane[:, 1 : w - 1]
    c = plane[:, 2:w]
    row_min = jnp.minimum(jnp.minimum(a, b), c)
    row_max = jnp.maximum(jnp.maximum(a, b), c)
    mid_min = jnp.minimum(a, c)[1 : h - 1]
    mid_max = jnp.maximum(a, c)[1 : h - 1]
    ring_min = jnp.minimum(
        jnp.minimum(row_min[0 : h - 2], row_min[2:h]), mid_min
    )
    ring_max = jnp.maximum(
        jnp.maximum(row_max[0 : h - 2], row_max[2:h]), mid_max
    )

    neighbor_min = jnp.minimum(jnp.minimum(min3[s - 1], min3[s + 1]), ring_min)
    neighbor_max = jnp.maximum(jnp.maximum(max3[s - 1], max3[s + 1]), ring_max)

    is_extremum = (center > neighbor_max) | (center < neighbor_min)
    passes = jnp.abs(center) >= jnp.asarray(
        cfg.contrast_prefilter_threshold, dog.dtype
    )
    return is_extremum & passes, is_extremum & ~passes


def _select_by_rank(row_counts: jax.Array, capacity: int, row_bits_of):
    """First-``capacity`` selection over 128-lane rows by rank query.

    The shared core of the sort-free selection (an exact ``lax.top_k``
    over every pixel of the plane is a sort): given per-row set-bit
    counts ``row_counts (rows,)``,
    prefix-sum them at two levels (rows grouped into ``(S, G)``), then
    locate each output slot ``j`` with three tiny rank queries
    (``sum(prefix <= j)`` over S, over G, and over the selected row's
    lane cumsum). All dense vector ops on int32 — no sort, no scatter,
    no float keys. ``row_bits_of`` maps the selected (clipped) global
    row indices ``(capacity,)`` to their ``(capacity, 128)`` bool lane
    bits — callers can decode them from a packed representation without
    ever materializing the full bit plane.

    Returns ``(row (capacity,), lane (capacity,), valid, total)``.
    """
    rows = row_counts.shape[0]
    g = min(rows, max(8, 1 << (max(rows, 1) - 1).bit_length() // 2))
    s = -(-rows // g)
    pad = s * g - rows
    lane_count = jnp.pad(row_counts, (0, pad)) if pad else row_counts
    lane_count = lane_count.reshape(s, g)
    g_incl = jnp.cumsum(lane_count, axis=1)  # (S, G) inclusive
    s_total = g_incl[:, -1]  # (S,)
    s_incl = jnp.cumsum(s_total)  # (S,)
    s_excl = s_incl - s_total
    total = s_incl[-1]

    j = jax.lax.broadcasted_iota(jnp.int32, (capacity, 1), 0).squeeze(-1)
    valid = j < total

    # Superrow of slot j: first s with inclusive prefix > j.
    s_j = jnp.sum(s_incl[None, :] <= j[:, None], axis=1, dtype=jnp.int32)
    s_safe = jnp.minimum(s_j, s - 1)
    local_j = j - s_excl[s_safe]
    # Row within the superrow.
    g_rows = g_incl[s_safe]  # (capacity, G)
    g_j = jnp.sum(g_rows <= local_j[:, None], axis=1, dtype=jnp.int32)
    g_safe = jnp.minimum(g_j, g - 1)
    row_excl = g_rows[jnp.arange(capacity), g_safe] - lane_count[s_safe, g_safe]
    lane_j = local_j - row_excl
    # Lane within the row (padded rows count 0, so the clip is safe:
    # only invalid slots can land there and callers mask them).
    r_glob = jnp.minimum(s_safe * g + g_safe, rows - 1)
    row_bits = row_bits_of(r_glob)  # (capacity, 128)
    lane_incl = jnp.cumsum(row_bits.astype(jnp.int32), axis=1)
    lane = jnp.sum(lane_incl <= lane_j[:, None], axis=1, dtype=jnp.int32)
    lane = jnp.minimum(lane, 127)
    return r_glob, lane, valid, total


def first_k_set_indices(flat_mask: jax.Array, capacity: int):
    """Indices of the first ``capacity`` set bits of a flat mask, in order.

    Thin wrapper over :func:`_select_by_rank` with the mask reshaped to
    128-lane rows. Returns ``(idx (capacity,) int32, valid (capacity,)
    bool, total)`` where ``total`` is the full set-bit count (before
    capacity clipping); invalid slots hold index 0.
    """
    n = flat_mask.shape[0]
    lanes = 128
    rows = -(-n // lanes)
    pad = rows * lanes - n
    m = jnp.pad(flat_mask, (0, pad)) if pad else flat_mask
    bits = m.reshape(rows, lanes)
    row_counts = jnp.sum(bits, axis=-1, dtype=jnp.int32)
    r_glob, lane, valid, total = _select_by_rank(
        row_counts, capacity, lambda r: bits[r]
    )
    idx = r_glob * lanes + lane
    return jnp.where(valid, idx, 0), valid, total


def _compact(mask: jax.Array, values: jax.Array, capacity: int, offset: int = 1):
    """Compact a 2-D mask into (y, x, value, valid) buffers.

    Slot order is row-major — identical to the reference's scan order
    (src/sift.js:221-222) — via the hierarchical prefix-sum selection of
    :func:`first_k_set_indices`. ``offset`` maps mask coordinates to
    image coordinates (1 for interior-cropped masks, 0 for full-plane
    masks with a pre-zeroed border). Candidates are only lost to
    capacity overflow itself (still counted by the per-trio
    ``num_candidates`` counter, so it stays observable). Also returns
    the total mask count.
    """
    hh, ww = mask.shape
    safe, valid, total = first_k_set_indices(mask.reshape(-1), capacity)
    if offset == 0:
        # Park invalid slots at pixel (1, 1) so the emitted buffers are
        # bit-identical to the interior-cropped path (whose slot 0 is
        # interior pixel (1, 1)).
        safe = jnp.where(valid, safe, ww + 1)
    y = safe // ww + offset
    x = safe % ww + offset
    value = values.reshape(-1)[safe]
    return y.astype(jnp.int32), x.astype(jnp.int32), value, valid, total


def compact_extrema(extrema: Extrema, capacity: int) -> Extrema:
    """Squeeze valid candidate slots into a smaller buffer.

    The per-trio buffers are sized for worst-case density, so after the
    scan most slots are invalid — but refinement pays per SLOT (its
    gathers dominate the frontend). One more in-order selection over
    slot indices packs the valid candidates (order preserved: ascending
    slot = the reference's trio-major, row-major emission order) into
    ``capacity`` slots. Overflow drops trailing candidates; the per-trio
    ``num_candidates`` counters still count everything, so it stays
    observable.
    """
    n = extrema.y.shape[0]
    if capacity >= n:
        return extrema
    slot, ok, _ = first_k_set_indices(extrema.valid, capacity)
    return Extrema(
        y=extrema.y[slot],
        x=extrema.x[slot],
        scale_level=extrema.scale_level[slot],
        value=extrema.value[slot],
        valid=ok & extrema.valid[slot],
        num_candidates=extrema.num_candidates,
        num_low_contrast=extrema.num_low_contrast,
    )


def unpack_mask_codes(packed: jax.Array, n_trios: int) -> jax.Array:
    """``(H, W)`` int32 packed 2-bit trio codes → ``(T, H, W)`` int32 0/1/2.

    Inverse of a fused octave kernel's packing: trio ``t`` owns bits
    ``[2t, 2t+2)``.
    """
    shifts = (2 * jnp.arange(n_trios, dtype=jnp.int32))[:, None, None]
    return (packed[None, :, :] >> shifts) & 3


def find_extrema_from_masks(
    packed: jax.Array,
    dog: jax.Array,
    cfg: SiftConfig,
    capacity: int | None = None,
) -> Extrema:
    """Extrema from a kernel-emitted packed mask plane.

    ``packed``: ``(H, W)`` int32 — trio ``t`` owns bits ``[2t, 2t+2)``
    with code 0 = none, 1 = candidate, 2 = low-contrast reject, border
    pre-zeroed in-kernel — as produced by a fused octave kernel's
    on-chip 26-neighbor scan; ``dog``: ``(D, H, W)``. Produces the same
    ``Extrema`` layout as :func:`find_extrema` (same slot order, same
    counters) without re-reading the DoG stack for the neighbor scan —
    and without the interior slice: selection runs over the full
    plane, whose border the kernel already zeroed.
    """
    cap = cfg.max_keypoints_per_trio if capacity is None else capacity
    ys, xs, scale_levels, vals, valids = [], [], [], [], []
    n_cand, n_low = [], []
    for s in range(1, cfg.dog_per_octave - 1):
        code = (packed >> (2 * (s - 1))) & 3
        cand_mask = code == 1
        y, x, value, valid, total = _compact(cand_mask, dog[s], cap, offset=0)
        ys.append(y)
        xs.append(x)
        scale_levels.append(jnp.full((cap,), s, jnp.int32))
        vals.append(value)
        valids.append(valid)
        n_cand.append(total)
        n_low.append(jnp.sum(code == 2, dtype=jnp.int32))

    return Extrema(
        y=jnp.concatenate(ys),
        x=jnp.concatenate(xs),
        scale_level=jnp.concatenate(scale_levels),
        value=jnp.concatenate(vals),
        valid=jnp.concatenate(valids),
        num_candidates=jnp.stack(n_cand),
        num_low_contrast=jnp.stack(n_low),
    )


def _first_k_candidates_packed(
    packed: jax.Array, n_trios: int, capacity: int
):
    """First-k candidate selection directly from the packed mask plane.

    Equivalent to :func:`first_k_set_indices` over the flattened
    unpacked ``(T, H, W)`` candidate mask, but never materializes the
    bool volume: per-row set-bit counts come from a fused decode+reduce
    over the packed plane, and the final lane query gathers 128-lane
    rows of the packed plane itself and decodes them in-register.
    Requires ``128 | H*W`` (every 128-lane row then lies inside one
    trio). Returns ``(idx, valid, n_cand (T,), n_low (T,))`` — the
    per-trio candidate/low-contrast counters are free by-products of
    the same counting pass.
    """
    h, w = packed.shape
    hw = h * w
    lanes = 128
    r_plane = hw // lanes
    pk = packed.reshape(r_plane, lanes)
    shifts = (2 * jnp.arange(n_trios, dtype=jnp.int32))[:, None, None]
    # (T, R, 128) decode fuses into the two reductions below — nothing
    # T*H*W-sized is written to HBM.
    codes = (pk[None] >> shifts) & 3
    cand_rows = jnp.sum(codes == 1, axis=-1, dtype=jnp.int32)  # (T, R)
    low_rows = jnp.sum(codes == 2, axis=-1, dtype=jnp.int32)
    n_cand = jnp.sum(cand_rows, axis=-1)
    n_low = jnp.sum(low_rows, axis=-1)

    # Shared hierarchical rank-query core, with the row dimension
    # spanning all trios: global row r = trio * R + plane_row, so
    # ascending r IS the (trio-major, row-major) reference emission
    # order. The selected rows' lane bits decode from the packed plane
    # in-register.
    def row_bits_of(r_glob):
        trio = r_glob // r_plane
        prow = r_glob - trio * r_plane
        return ((pk[prow] >> (2 * trio)[:, None]) & 3) == 1

    r_glob, lane, valid, _ = _select_by_rank(
        cand_rows.reshape(-1), capacity, row_bits_of
    )
    idx = r_glob * lanes + lane
    return jnp.where(valid, idx, 0), valid, n_cand, n_low


def dog_flat_index(scale, m, n, d: int, w, tile_h):
    """Flat index into a DoG volume in either storage layout.

    Plane-major ``(D, H, W)``: pass ``tile_h = H`` — the formula
    degenerates to ``(scale·H + m)·W + n`` exactly. Stripe-major
    ``(n_stripes, D, tile_h, W)`` (one contiguous chunk per stripe, the
    layout a fused octave kernel writes): pass the stripe height. ``m``/``n``/
    ``scale`` may be arrays; ``tile_h`` may be a per-slot array (the
    unified multi-octave refine path).
    """
    blk = m // tile_h
    return ((blk * d + scale) * tile_h + (m - blk * tile_h)) * w + n


def select_refine_candidates(
    packed: jax.Array, dog: jax.Array, cfg: SiftConfig, capacity: int
) -> Extrema:
    """One cross-trio selection of refinement candidates from the packed
    mask plane.

    The per-trio :func:`find_extrema_from_masks` buffers exist for
    stage-3 introspection/parity; refinement only needs the first
    ``capacity`` candidates in (trio-major, row-major) order — which is
    exactly row-major order over the unpacked ``(T, H, W)`` mask
    volume. Selecting them in ONE :func:`first_k_set_indices` pass
    replaces the per-trio compaction + slot re-gather
    (``compact_extrema``) the refine path used to pay for. Semantics
    differ from the old chain only under per-trio capacity overflow
    (the old path clipped each trio before compacting; this one applies
    the global budget directly — strictly closer to the reference,
    which never drops candidates, reference/background.js:433-436).
    """
    h, w = packed.shape
    t = cfg.dog_per_octave - 2
    plane = h * w
    if plane % 128 == 0:
        # Fast path: select straight from the packed plane (no unpacked
        # bool volume in HBM); counters fall out of the same pass.
        idx, valid, n_cand, n_low = _first_k_candidates_packed(
            packed, t, capacity
        )
    else:
        codes = unpack_mask_codes(packed, t)
        idx, valid, _ = first_k_set_indices(
            (codes == 1).reshape(-1), capacity
        )
        n_cand = jnp.sum(codes == 1, axis=(1, 2), dtype=jnp.int32)
        n_low = jnp.sum(codes == 2, axis=(1, 2), dtype=jnp.int32)
    trio = idx // plane
    rem = idx - trio * plane
    y = rem // w
    x = rem - y * w
    scale_level = trio + 1
    # Park invalid slots at trio 0, pixel (1, 1) (matches _compact).
    y = jnp.where(valid, y, 1)
    x = jnp.where(valid, x, 1)
    scale_level = jnp.where(valid, scale_level, 1)
    if dog.ndim == 4:  # stripe-major (n_stripes, D, tile_h, W)
        d_planes, tile_h = dog.shape[1], dog.shape[2]
    else:  # plane-major (D, H, W)
        d_planes, tile_h = dog.shape[0], dog.shape[1]
    value = dog.reshape(-1)[
        dog_flat_index(scale_level, y, x, d_planes, w, tile_h)
    ]
    # The per-trio counters mirror the reference's accounting
    # (reference/background.js:433-436; SURVEY.md §5.5) — candidates
    # beyond capacity stay observable through them.
    return Extrema(
        y=y.astype(jnp.int32),
        x=x.astype(jnp.int32),
        scale_level=scale_level.astype(jnp.int32),
        value=value,
        valid=valid,
        num_candidates=n_cand,
        num_low_contrast=n_low,
    )


def find_low_contrast_extrema(
    dog: jax.Array, cfg: SiftConfig, capacity: int | None = None
) -> Extrema:
    """Positions of the low-contrast pre-filter rejects, per trio.

    The reference keeps rejected low-contrast extrema as first-class
    records (reference/src/sift.js:296-307, background.js:408-421) and
    paints them red in the candidate gallery (main.js:315-319). The hot
    path keeps only their per-trio counts; this diagnostic/display
    function compacts their positions with the same slot ordering as
    :func:`find_extrema`. ``num_candidates`` here counts the low-contrast
    rejects (the buffer's own occupancy accounting); ``num_low_contrast``
    matches it.
    """
    h, w = dog.shape[-2], dog.shape[-1]
    cap = cfg.max_keypoints_per_trio if capacity is None else capacity
    min3, max3 = _neighborhood_min_max(dog)
    ys, xs, scale_levels, vals, valids = [], [], [], [], []
    n_low = []
    for s in range(1, cfg.dog_per_octave - 1):
        _, low_mask = _trio_masks(dog, min3, max3, s, cfg)
        center = dog[s, 1 : h - 1, 1 : w - 1]
        y, x, value, valid, total = _compact(low_mask, center, cap)
        ys.append(y)
        xs.append(x)
        scale_levels.append(jnp.full((cap,), s, jnp.int32))
        vals.append(value)
        valids.append(valid)
        n_low.append(total)

    return Extrema(
        y=jnp.concatenate(ys),
        x=jnp.concatenate(xs),
        scale_level=jnp.concatenate(scale_levels),
        value=jnp.concatenate(vals),
        valid=jnp.concatenate(valids),
        num_candidates=jnp.stack(n_low),
        num_low_contrast=jnp.stack(n_low),
    )


def find_extrema(
    dog: jax.Array, cfg: SiftConfig, capacity: int | None = None
) -> Extrema:
    """Candidate extrema for one octave's DoG stack ``(D, H, W)``.

    Trios are centered at DoG scales ``1..D-2`` (background.js:377); the
    output buffer concatenates per-trio compactions so the global slot
    order matches the reference's (trio, row-major) iteration order used
    later by refinement (background.js:468-479). ``capacity`` overrides
    the per-trio slot count (upper octaves have 4x fewer pixels per
    octave, so callers shrink it — see SiftConfig.keypoints_per_trio).
    """
    h, w = dog.shape[-2], dog.shape[-1]
    cap = cfg.max_keypoints_per_trio if capacity is None else capacity
    min3, max3 = _neighborhood_min_max(dog)
    ys, xs, scale_levels, vals, valids = [], [], [], [], []
    n_cand, n_low = [], []
    for s in range(1, cfg.dog_per_octave - 1):
        cand_mask, low_mask = _trio_masks(dog, min3, max3, s, cfg)
        center = dog[s, 1 : h - 1, 1 : w - 1]
        y, x, value, valid, total = _compact(cand_mask, center, cap)
        ys.append(y)
        xs.append(x)
        scale_levels.append(jnp.full((cap,), s, jnp.int32))
        vals.append(value)
        valids.append(valid)
        n_cand.append(total)
        n_low.append(jnp.sum(low_mask, dtype=jnp.int32))

    return Extrema(
        y=jnp.concatenate(ys),
        x=jnp.concatenate(xs),
        scale_level=jnp.concatenate(scale_levels),
        value=jnp.concatenate(vals),
        valid=jnp.concatenate(valids),
        num_candidates=jnp.stack(n_cand),
        num_low_contrast=jnp.stack(n_low),
    )
