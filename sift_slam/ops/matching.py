"""Descriptor matching: batched distances as one matrix product + ratio/mutual tests.

Green-field extension (the reference implements no matching,
reference/readme.md:11; required by BASELINE.json config[2]).

Static-shape design: all-pairs squared-L2 distances are computed as
``‖a‖² + ‖b‖² − 2·a@bᵀ`` with the cross term as a single matmul; the
two-nearest-neighbor reduction and Lowe ratio test are masked
dense reductions over fixed-capacity descriptor buffers — no dynamic
shapes anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import pytree

BIG = np.float32(3.4e38)  # plain numpy: a module-level jnp call would initialize the backend at import (breaks jax.distributed.initialize)


@pytree.dataclass
class Matches:
    """Fixed-capacity match set from image A slots to image B slots.

    ``index[i]`` is the matched B slot for A slot ``i`` (0 when invalid);
    ``distance`` is the squared descriptor L2 distance.
    """

    index: jax.Array  # (N,) int32
    distance: jax.Array  # (N,) float32
    valid: jax.Array  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.index.shape[-1]


def descriptor_distances(
    desc_a: jax.Array, desc_b: jax.Array
) -> jax.Array:
    """All-pairs squared L2 distances ``(N, M)``; cross term as one matmul."""
    sq_a = jnp.sum(desc_a * desc_a, axis=-1, keepdims=True)
    sq_b = jnp.sum(desc_b * desc_b, axis=-1, keepdims=True)
    cross = jnp.dot(
        desc_a,
        desc_b.T,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    d = sq_a + sq_b.T - 2.0 * cross
    return jnp.maximum(d, 0.0)


def match_descriptors(
    desc_a: jax.Array,
    valid_a: jax.Array,
    desc_b: jax.Array,
    valid_b: jax.Array,
    ratio: float = 0.8,
    mutual: bool = True,
) -> Matches:
    """Lowe-ratio matches A→B over fixed-capacity descriptor buffers.

    A slot matches iff its nearest valid B descriptor beats the second
    nearest by the ratio test ``d1 < ratio²·d2`` (squared distances) and,
    with ``mutual=True``, the B slot's nearest valid A descriptor is that
    same A slot (cross-check).
    """
    d = descriptor_distances(desc_a, desc_b)
    d = jnp.where(valid_a[:, None] & valid_b[None, :], d, BIG)

    neg_top2, idx_top2 = jax.lax.top_k(-d, 2)  # two smallest per row
    d1 = -neg_top2[:, 0]
    d2 = -neg_top2[:, 1]
    best = idx_top2[:, 0]

    # d2 == BIG means B had fewer than two valid descriptors — without
    # a genuine second neighbor the ratio test is vacuous, so reject.
    ok = valid_a & (d1 < BIG) & (d2 < BIG) & (d1 < (ratio * ratio) * d2)

    if mutual:
        back = jnp.argmin(d, axis=0)  # best A slot for each B slot
        ok &= back[best] == jnp.arange(d.shape[0])

    return Matches(
        index=best.astype(jnp.int32),
        distance=d1.astype(jnp.float32),
        valid=ok,
    )
