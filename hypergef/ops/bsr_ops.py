"""Block-sparse matmul aggregation ops.

Each direction: gather source block-rows (large rows → gather latency
amortized), batched 128×128 bf16 matmuls (f32 accumulation),
block-row combine via the reduction tree at block granularity.  Custom
VJP swaps the two directions' stages — the adjoint of the V→E BSR
product is the E→V BSR product (transposed blocks), so no scatter
appears in any derivative order (same principle as
:func:`hypergef.ops.tree.tree_matvec`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hypergef.sparse.bsr import BLOCK
from hypergef.ops.tree import _apply_stage


def _apply_bsr_stage(x, stage):
    """stage = (blocks [NB,B,B] bf16, bcol [NB], combine_tree) device pytree.

    x: [num_cols, F] f32 → y: [num_row_blocks*B, F] f32.
    """
    blocks, bcol, combine = stage
    f = x.shape[1]
    pad = (-x.shape[0]) % BLOCK
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    xb = xp.reshape(-1, BLOCK, f)  # [ncb, B, F]
    gathered = jnp.take(xb, bcol, axis=0)  # [NB, B, F] — 16-64KB rows
    partial = jax.lax.dot_general(
        blocks,
        gathered.astype(jnp.bfloat16),
        (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [NB, B, F]
    nb = partial.shape[0]
    flat = partial.reshape(nb, BLOCK * f)
    combined = _apply_stage(flat, combine)  # [num_row_blocks, B*F]
    return combined.reshape(-1, f)  # [num_row_blocks*B, F]


import functools


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def bsr_matvec(x, fwd_stage, bwd_stage, num_rows):
    """y = M x via BSR; bwd_stage encodes Mᵀ for the adjoint.
    ``num_rows`` is static (slice bound)."""
    y = _apply_bsr_stage(x, fwd_stage)
    return y[:num_rows]


def _bm_fwd(x, fwd_stage, bwd_stage, num_rows):
    return bsr_matvec(x, fwd_stage, bwd_stage, num_rows), (
        fwd_stage,
        bwd_stage,
        x.shape[0],
    )


def _bm_bwd(num_rows, res, g):
    fwd_stage, bwd_stage, n_in = res
    dx = bsr_matvec(g, bwd_stage, fwd_stage, n_in)
    return dx, None, None


bsr_matvec.defvjp(_bm_fwd, _bm_bwd)


def _permute(x, perm):
    return x if perm is None else jnp.take(x, perm, axis=0)


def _row_bounds(plan):
    """True output row counts from a BsrPlan or a DevBsrPlan."""
    e_rows = getattr(plan, "e_rows", None)
    if e_rows is not None:
        return e_rows, plan.v_rows
    return plan.edge_stage.num_rows, plan.vertex_stage.num_rows


def hgnn_aggregate_bsr(hgd, x, wdiag, first_aggr, plan):
    """HGNN aggregation over a BsrPlan (sum/mean)."""
    e_stage, v_stage, vp, vinv, ep = plan.device()
    e_rows, v_rows = _row_bounds(plan)
    xp = _permute(x, vp)  # into permuted vertex space
    xe = bsr_matvec(xp, e_stage, v_stage, e_rows)
    # per-edge scalings live in the *original* edge ids — permute them once
    degE = _permute(hgd.degE, ep)
    if first_aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).astype(x.dtype)
        xe = xe / jnp.maximum(_permute(cnt[:, None], ep), 1.0)
    xe = xe * degE
    if wdiag is not None:
        xe = xe * _permute(wdiag, ep)
    xv = bsr_matvec(xe, v_stage, e_stage, v_rows)
    xv = xv * _permute(hgd.degV, vp)
    return _permute(xv, vinv)  # back to original vertex order


def unignn_aggregate_bsr(hgd, x, use_deg, plan):
    e_stage, v_stage, vp, vinv, ep = plan.device()
    e_rows, v_rows = _row_bounds(plan)
    xp = _permute(x, vp)
    xe = bsr_matvec(xp, e_stage, v_stage, e_rows)
    if use_deg:
        xe = xe * _permute(hgd.degE, ep)
    xv = bsr_matvec(xe, v_stage, e_stage, v_rows)
    if use_deg:
        xv = xv * _permute(hgd.degV, vp)
    return _permute(xv, vinv)
