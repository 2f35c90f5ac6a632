"""Pose-graph optimization over SE(3).

Green-field extension (BASELINE.json configs[3-4]): the SLAM backend's
loop-closure layer. Nodes are world→camera poses; edges carry measured
relative transforms ``T_ij`` (pose of frame j expressed from frame i:
``T_j ≈ T_ij ∘ T_i``) with per-edge weights. Residual per edge is the
se(3) log of the loop discrepancy.

Static-shape design: edges live in a fixed-capacity masked buffer; per-edge
6×12 Jacobians come from ``jax.jacfwd`` vmapped over the buffer; the
(6N × 6N) normal system is assembled with ``segment_sum`` of dense
blocks and solved densely — at keyframe-graph scales (N ≲ 10³) a dense
solve needs no sparse machinery. Branchless LM, node
0 gauge-fixed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import pytree
from ..core.precision import full_precision

from .geometry import se3_exp, se3_log


@pytree.dataclass
class PoseGraphEdges:
    """Fixed-capacity relative-pose constraints ``i → j``."""

    src: jax.Array  # (E,) int32 node i
    dst: jax.Array  # (E,) int32 node j
    rel_rotation: jax.Array  # (E, 3, 3) measured R_ij
    rel_translation: jax.Array  # (E, 3) measured t_ij
    weight: jax.Array  # (E,) float (0 = invalid)

    @property
    def capacity(self) -> int:
        return self.src.shape[-1]


def _edge_residual(xi_i, xi_j, rot_i, t_i, rot_j, t_j, rel_r, rel_t):
    """se3 residual of one edge under increments (ξ_i, ξ_j)."""
    dri, dti = se3_exp(xi_i)
    drj, dtj = se3_exp(xi_j)
    ri = dri @ rot_i
    ti = jnp.einsum("ij,j->i", dri, t_i) + dti
    rj = drj @ rot_j
    tj = jnp.einsum("ij,j->i", drj, t_j) + dtj
    # Predicted T_j' = T_ij ∘ T_i ; residual = log(T_j'⁻¹... expressed as
    # log of  T_err = (T_ij ∘ T_i) ∘ T_j⁻¹.
    pr = rel_r @ ri
    pt = jnp.einsum("ij,j->i", rel_r, ti) + rel_t
    rj_inv = rj.T
    tj_inv = -jnp.einsum("ij,j->i", rj_inv, tj)
    err_r = pr @ rj_inv
    err_t = jnp.einsum("ij,j->i", pr, tj_inv) + pt
    return se3_log(err_r, err_t)


def pose_graph_residuals(
    rotations: jax.Array, translations: jax.Array, edges: PoseGraphEdges
) -> jax.Array:
    """Weighted residuals ``(E, 6)``."""
    zero6 = jnp.zeros((6,), translations.dtype)

    def one(s, d, rr, rt, w):
        r = _edge_residual(
            zero6,
            zero6,
            rotations[s],
            translations[s],
            rotations[d],
            translations[d],
            rr,
            rt,
        )
        return r * w

    return jax.vmap(one)(
        edges.src, edges.dst, edges.rel_rotation, edges.rel_translation, edges.weight
    )


@functools.partial(jax.jit, static_argnames=("num_iterations",))
@full_precision
def optimize_pose_graph(
    rotations: jax.Array,
    translations: jax.Array,
    edges: PoseGraphEdges,
    num_iterations: int = 20,
):
    """LM pose-graph optimization; node 0 is the gauge anchor.

    Returns ``(rotations, translations, final_cost)``.
    """
    n = rotations.shape[0]
    dtype = translations.dtype
    zero6 = jnp.zeros((6,), dtype)

    def cost_of(rots, ts):
        r = pose_graph_residuals(rots, ts, edges)
        return 0.5 * jnp.sum(r * r)

    def build_system(rots, ts):
        def one(s, d, rr, rt, w):
            res = _edge_residual(
                zero6, zero6, rots[s], ts[s], rots[d], ts[d], rr, rt
            )
            # One jacfwd call yields both block Jacobians (a separate
            # call per argnum re-evaluated the residual chain twice).
            ji, jj = jax.jacfwd(_edge_residual, argnums=(0, 1))(
                zero6, zero6, rots[s], ts[s], rots[d], ts[d], rr, rt
            )
            return res * w, ji * w, jj * w

        res, ji, jj = jax.vmap(one)(
            edges.src,
            edges.dst,
            edges.rel_rotation,
            edges.rel_translation,
            edges.weight,
        )  # (E,6) (E,6,6) (E,6,6)

        h_ii = jax.ops.segment_sum(
            jnp.einsum("eki,ekj->eij", ji, ji), edges.src, n
        )
        h_jj = jax.ops.segment_sum(
            jnp.einsum("eki,ekj->eij", jj, jj), edges.dst, n
        )
        b = jax.ops.segment_sum(
            -jnp.einsum("eki,ek->ei", ji, res), edges.src, n
        ) + jax.ops.segment_sum(
            -jnp.einsum("eki,ek->ei", jj, res), edges.dst, n
        )
        # Off-diagonal blocks scatter-added straight into the dense
        # (N,6,N,6) Hessian (duplicate (src,dst) pairs accumulate) —
        # the segment_sum-over-pair formulation materialized an
        # (N², 6, 6) intermediate, 36·N² floats per LM iteration.
        h_ij = jnp.einsum("eki,ekj->eij", ji, jj)  # (E, 6, 6)
        h = jnp.zeros((n, 6, n, 6), dtype)
        h = h.at[jnp.arange(n), :, jnp.arange(n), :].add(h_ii + h_jj)
        h = h.at[edges.src, :, edges.dst, :].add(h_ij)
        h = h.at[edges.dst, :, edges.src, :].add(
            jnp.transpose(h_ij, (0, 2, 1))
        )
        return h, b

    lam0 = jnp.asarray(1e-4, dtype)
    cost0 = cost_of(rotations, translations)
    eye6 = jnp.eye(6, dtype=dtype)
    free = (jnp.arange(n) >= 1).astype(dtype)

    # lax.fori_loop, not an unrolled Python loop: the body (vmapped
    # jacfwd + dense solve) is shape-invariant, and unrolling compiled
    # num_iterations copies of it into one XLA program.
    def lm_step(_, carry):
        rotations, translations, cost, lam = carry
        h, b = build_system(rotations, translations)
        diag = jnp.diagonal(
            h[jnp.arange(n), :, jnp.arange(n), :], axis1=-2, axis2=-1
        )
        h = h.at[jnp.arange(n), :, jnp.arange(n), :].add(
            (lam * jnp.maximum(diag, 1e-8) + 1e-8)[..., :, None] * eye6
        )
        # Gauge fix node 0.
        mask = free[:, None, None, None] * free[None, None, :, None]
        h = h * mask
        h = h.at[jnp.arange(n), :, jnp.arange(n), :].add(
            (1.0 - free)[:, None, None] * eye6
        )
        b = b * free[:, None]

        delta = jnp.linalg.solve(
            h.reshape(n * 6, n * 6), b.reshape(n * 6)
        ).reshape(n, 6)
        delta = delta * free[:, None]

        dr, dt = se3_exp(delta)
        rot_new = dr @ rotations
        t_new = jnp.einsum("nij,nj->ni", dr, translations) + dt
        cost_new = cost_of(rot_new, t_new)
        accept = cost_new < cost
        rotations = jnp.where(accept, rot_new, rotations)
        translations = jnp.where(accept, t_new, translations)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.clip(jnp.where(accept, lam * 0.3, lam * 6.0), 1e-9, 1e5)
        return rotations, translations, cost, lam

    rotations, translations, cost, _ = jax.lax.fori_loop(
        0, num_iterations, lm_step, (rotations, translations, cost0, lam0)
    )
    return rotations, translations, cost
