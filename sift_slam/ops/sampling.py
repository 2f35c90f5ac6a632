"""Bilinear sampling and scale-space gradients.

Building blocks for the descriptor extension (green-field: the reference
stops before orientation/descriptors, reference/readme.md:11). Gradients
follow the IPOL Anatomy-of-SIFT convention: central differences on the
Gaussian scale-space images, matching the reference's own gradient
operator used in refinement (reference/src/sift.js:333-353).

All functions are shape-polymorphic over leading batch dims and
jit/vmap-friendly; samplers clamp to the image border (the reference's
clamp-to-edge rule, reference/src/sift.js:116-119).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def scale_space_gradients(stack: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-pixel central-difference gradients of a scale-space stack.

    ``stack``: ``(..., H, W)``. Returns ``(gy, gx)`` with the same shape;
    border rows/columns are exactly zero. (An earlier jnp.roll version
    wrapped around the border, silently mixing opposite image edges —
    masked out by callers today, but a trap for any future caller
    sampling within one pixel of the border.)
    """
    zero = jnp.zeros_like(stack)
    gy = zero.at[..., 1:-1, :].set(
        (stack[..., 2:, :] - stack[..., :-2, :]) / 2.0
    )
    gx = zero.at[..., 1:-1].set(
        (stack[..., 2:] - stack[..., :-2]) / 2.0
    )
    return gy, gx


def pack_gradients_flat(stacks: list[jax.Array]):
    """All octaves' gradient maps in ONE flat interleaved buffer.

    ``stacks``: per-octave Gaussian stacks ``(S, H_o, W_o)`` (unbatched —
    call under vmap for a batch). Computes central-difference gradients
    per octave and packs them channel-interleaved —
    ``flat[((s·H_o + y)·W_o + x)·2 + c]`` is gy (c=0) / gx (c=1) of
    octave-plane pixel ``(s, y, x)`` — then concatenates octaves.

    Why: the descriptor stages sample gy AND gx at the same bilinear
    corners; with the channel pair adjacent, one 4-element contiguous
    gather per corner row fetches {gy, gx} × {x0, x0+1} in place of 8
    scalar gathers, and a single buffer lets ONE describe pass serve
    every octave (cross-octave keypoint compaction).

    Returns ``(flat, base_lut, h_lut, w_lut)``: the flat buffer plus
    per-octave PIXEL base offsets and plane dims (int32 arrays, length
    n_octaves) for index arithmetic.
    """
    parts = []
    bases, hs, ws = [], [], []
    offset = 0
    for stack in stacks:
        s, h, w = stack.shape
        gy, gx = scale_space_gradients(stack)
        parts.append(jnp.stack([gy, gx], axis=-1).reshape(-1))
        bases.append(offset)
        hs.append(h)
        ws.append(w)
        offset += s * h * w
    return (
        jnp.concatenate(parts),
        jnp.asarray(bases, jnp.int32),
        jnp.asarray(hs, jnp.int32),
        jnp.asarray(ws, jnp.int32),
    )


def bilinear_sample_pair_flat(
    flat: jax.Array,
    base_px: jax.Array,
    w: jax.Array,
    ys_flat: jax.Array,
    xs: jax.Array,
):
    """Bilinear (gy, gx) samples from a packed flat gradient buffer.

    ``flat``: interleaved buffer from :func:`pack_gradients_flat`;
    ``base_px``: the octave's pixel base offset (scalar, traced);
    ``w``: the octave's row length; ``ys_flat``: y already offset by
    ``scale_level · H`` and clamped to the plane (the caller replicates
    :func:`_keypoint_gradient_samples`' coordinate handling); ``xs``:
    raw x, clamped here. Returns ``(gy, gx)`` shaped like ``ys_flat``.

    Bit-identical to two :func:`bilinear_sample` calls on the (S·H, W)
    reshaped gy/gx stacks for every sample whose weight is nonzero
    (out-of-interior samples are zero-weighted by the callers; their
    clamped corners may differ but never contribute).
    """
    from jax import lax

    wf = w.astype(ys_flat.dtype)
    xs = jnp.clip(xs, 0.0, wf - 1.0)
    y0 = jnp.floor(ys_flat)
    x0 = jnp.floor(xs)
    fy = ys_flat - y0
    fx = xs - x0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    base_idx = (base_px + y0.astype(jnp.int32) * w + x0i) * 2
    dn = lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
    )

    def pair4(start):
        # (N, 4): gy(x0), gx(x0), gy(x0+1), gx(x0+1) — one contiguous
        # 4-element slice per corner row (CLIP keeps the slice in-buffer).
        return lax.gather(
            flat,
            start[:, None],
            dn,
            slice_sizes=(4,),
            mode=lax.GatherScatterMode.CLIP,
        )

    vtop = pair4(base_idx)
    vbot = pair4(base_idx + 2 * w)
    # x0 == w-1 only for zero-weighted (clamped) samples: mirror the
    # clamp-to-edge semantics there by collapsing the x1 corner onto x0.
    fx = jnp.where(x0i >= w - 1, 0.0, fx)
    out = []
    for c in range(2):
        top = vtop[:, c] * (1.0 - fx) + vtop[:, c + 2] * fx
        bot = vbot[:, c] * (1.0 - fx) + vbot[:, c + 2] * fx
        out.append(top * (1.0 - fy) + bot * fy)
    return out[0], out[1]


def bilinear_sample(image: jax.Array, ys: jax.Array, xs: jax.Array) -> jax.Array:
    """Bilinearly sample ``image`` (H, W) at float positions (ys, xs).

    Positions outside the image are clamped to the border (clamp-to-edge,
    consistent with the reference border rule). ``ys``/``xs`` may have any
    broadcastable shape; returns samples of that shape.
    """
    h, w = image.shape[-2], image.shape[-1]
    # Clamp the COORDINATES, not just the integer corners: clipping
    # corners after taking the fractional part left fy/fx nonzero for
    # negative positions, blending border and interior pixels instead
    # of returning the border value (asymmetric with the positive side,
    # which saturated correctly).
    ys = jnp.clip(ys, 0.0, h - 1.0)
    xs = jnp.clip(xs, 0.0, w - 1.0)
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = ys - y0
    fx = xs - x0

    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)

    v00 = image[y0i, x0i]
    v01 = image[y0i, x1i]
    v10 = image[y1i, x0i]
    v11 = image[y1i, x1i]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy
