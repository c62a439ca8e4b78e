"""Fused two-stage aggregation: backend dispatch.

Backends (the analogue of the reference's kernel-strategy dispatch,
``include/hgnnAgg.cuh:1138-1157`` auto-select and the heuristic at
``hgnnaggr_cuda.cu:381-397``):

* ``"xla"``      — pure-jnp sorted segment reductions over nnz (the
  oracle, :mod:`hypergef.ops.refops`): nnz-sized gathered
  intermediates and scatter-add segment sums.
* ``"cumsum"``   — scatter-free sorted segment sums (gather → cumsum →
  boundary-diff, :mod:`hypergef.ops.segments`), with a custom VJP
  whose adjoint is the same op over the transposed CSR.
* ``"ell"``      — padded ELL chunk tables: masked [C, ngs, F] gather +
  in-chunk reduction + sorted segment combine.
* ``"tree"``     — fixed-fan gather reduction trees (:mod:`.tree`).
* ``"dense"``    — two bf16 matmuls against the int8 (or packed int4)
  incidence table.
* ``"precomp"``  — one matmul against the precomputed propagation matrix.
* ``"bsr"``      — block-sparse matmuls over a reordered incidence.
* ``"multihot"`` / ``"aligned"`` — tree plans whose stages are tile-local
  multihot or segment-aligned band matmuls.
* ``"auto"``     — the plan's ``preferred_backend``.

The default backend is process-global and overridable per call.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from hypergef.sparse.hypergraph import HypergraphData
from hypergef.ops import refops, segments

_DEFAULT_BACKEND = "cumsum"
_VALID = (
    "auto", "xla", "cumsum", "ell", "tree", "dense", "bsr", "precomp",
    "multihot", "aligned",
)


def set_default_backend(name: str) -> None:
    global _DEFAULT_BACKEND
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}")
    _DEFAULT_BACKEND = name


def get_default_backend() -> str:
    return _DEFAULT_BACKEND


# nnz above which the cumsum backend's prefix-difference error
# (~eps · |running prefix|, i.e. growing with graph size) is no longer
# acceptable: auto-route to the tree backend (direct per-segment sums)
# when a plan is available, warn once otherwise.
_CUMSUM_NNZ_GUARD = 1 << 20
_warned_cumsum = False


def _resolve(backend: Optional[str], plan, nnz: Optional[int] = None) -> str:
    b = backend or _DEFAULT_BACKEND
    if b == "auto":
        b = getattr(plan, "preferred_backend", None) or "cumsum"
    if b == "cumsum" and nnz is not None and nnz > _CUMSUM_NNZ_GUARD:
        if plan is not None and getattr(plan, "tree", None) is not None:
            b = "tree"
        else:
            global _warned_cumsum
            if not _warned_cumsum:
                import warnings

                warnings.warn(
                    f"cumsum backend at nnz={nnz} > {_CUMSUM_NNZ_GUARD}: "
                    "prefix-difference segment sums lose precision with the "
                    "running-prefix magnitude; pass a plan so the tree "
                    "backend (direct per-segment sums) can take over.",
                    stacklevel=3,
                )
                _warned_cumsum = True
    if b not in _VALID or b == "auto":
        raise ValueError(f"backend must be one of {_VALID}, got {b!r}")
    if b in ("ell", "tree", "dense", "bsr", "precomp", "multihot",
             "aligned") and plan is None:
        raise ValueError(f"backend {b!r} requires a plan (pass plan=...)")
    return b


def _get(plan, attr):
    """Accept an AggregationPlan or a raw per-backend plan object."""
    sub = getattr(plan, attr, None)
    if sub is not None:
        return sub
    return plan  # assume a raw TreePlan / TilePlan / DenseIncidence


# ----------------------------------------------------------------------
# dense backend: two bf16 matmuls with f32 accumulation.  H is stored as
# int8 counts (or a packed-int4 nibble carrier, DenseIncidence.packed)
# and cast at the dot, so XLA can fuse the convert into the operand read
# and the table streams at its storage byte size.  The dots are wrapped
# in *inline* jits so the S4 re-view of a packed table always happens
# under a trace; inside a caller's jit the wrapper is a no-op.
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnums=(2, 3, 4, 5), inline=True)
def _dense_dot(h, x, n, e, packed, contract_left):
    if packed:  # int8 nibble carrier [N, ceil(E/2)] → S4 [N, E]
        # Barrier BEFORE the bitcast: XLA constant-folds the S4 bitcast
        # of a closure-captured carrier incorrectly (wrong nibble values,
        # observed on CPU; argument-passed carriers are fine).  Barrier
        # AFTER: the S4 table is materialized once instead of being
        # re-unpacked inside each dot's operand read.
        h = jax.lax.optimization_barrier(h)
        h = jax.lax.bitcast_convert_type(h, jnp.int4).reshape(n, -1)
        h = jax.lax.optimization_barrier(h)[:, :e]
    dim = 0 if contract_left else 1
    return jax.lax.dot_general(
        h.astype(jnp.bfloat16), x.astype(jnp.bfloat16),
        (((dim,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _dense_v2e(dense, x, aggr, hgd):
    # Hᵀ X : [E, F]
    xe = _dense_dot(dense.h, x, dense.num_nodes, dense.num_edges,
                    getattr(dense, "packed", False), True)
    if aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).astype(jnp.float32)
        xe = xe / jnp.maximum(cnt, 1.0)[:, None]
    return xe


def _dense_e2v(dense, xe):
    # H Xe : [N, F]
    return _dense_dot(dense.h, xe, dense.num_nodes, dense.num_edges,
                      getattr(dense, "packed", False), False)


# ----------------------------------------------------------------------
# cumsum backend building blocks (scatter-free sorted segment sums)
# ----------------------------------------------------------------------
def _cumsum_v2e(hgd: HypergraphData, x, aggr: str):
    xe = segments.incidence_gather_sum(
        x, hgd.ht_vertex, hgd.ht_indptr, hgd.h_edge, hgd.h_indptr
    )
    if aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).astype(x.dtype)
        xe = xe / jnp.maximum(cnt, 1.0)[:, None]
    return xe


def _cumsum_e2v(hgd: HypergraphData, xe):
    return segments.incidence_gather_sum(
        xe, hgd.h_edge, hgd.h_indptr, hgd.ht_vertex, hgd.ht_indptr
    )


# ----------------------------------------------------------------------
# ELL backend building blocks
# ----------------------------------------------------------------------
def _ell_stage(gather_idx, mask, seg_ids, num_segments, x, aggr="sum"):
    """One aggregation direction over a padded ELL chunk table.

    y[s] = reduce over chunks c with seg_ids[c]==s of
           reduce over live slots k of x[gather_idx[c, k]].
    Padded chunks carry seg_id == num_segments and are dropped by the
    out-of-range scatter semantics of ``segment_sum``.
    """
    c, ngs = gather_idx.shape
    gathered = jnp.take(x, gather_idx.reshape(-1), axis=0).reshape(c, ngs, -1)
    if aggr in ("sum", "mean"):
        partial = jnp.sum(gathered * mask[:, :, None], axis=1)
        y = jax.ops.segment_sum(
            partial, seg_ids, num_segments=num_segments, indices_are_sorted=True
        )
        if aggr == "mean":
            cnt = jax.ops.segment_sum(
                jnp.sum(mask, axis=1), seg_ids, num_segments=num_segments,
                indices_are_sorted=True,
            )
            y = y / jnp.maximum(cnt, 1.0)[:, None]
        return y
    raise ValueError(f"ELL backend does not implement first_aggr={aggr!r}")


# ----------------------------------------------------------------------
# fast max first-aggregation (argmax-carrying tree + exact VJP)
# ----------------------------------------------------------------------
def _hgnn_aggregate_max(hgd, x, wdiag, plan, b):
    """Max V→E via the argmax-carrying tree (ops/maxops) when the plan
    has a plain tree stage, the masked argmax over the band when it is a
    raw aligned plan; then the requested backend's E→V sum stage.  Falls
    back to the nnz oracle when no plan form supports the record table."""
    from hypergef.ops import maxops
    from hypergef.ops.tree import (
        AlignedStageBDev, AlignedStageDev, TiledStageDev,
    )
    from hypergef.ops import tree as tree_ops

    tree_plan = getattr(plan, "tree", None) or plan
    dev = getattr(tree_plan, "device", None)
    if dev is None:
        return refops.hgnn_aggregate_ref(hgd, x, wdiag, "max")
    e_stage, v_stage = tree_plan.device()
    aligned_kinds = (AlignedStageDev, AlignedStageBDev)
    if not isinstance(e_stage, aligned_kinds + (TiledStageDev,)):
        # preferred V→E max: the tree touches only live entries, while
        # the band form pays for every slot of a mostly-dead plane
        xe = maxops.v2e_max_tree(
            x, e_stage, hgd.h_edge, hgd.h_segids, hgd.h_indptr
        )
    elif isinstance(e_stage, aligned_kinds):
        # raw aligned TreePlan (no argmax tree available)
        xe = maxops.v2e_max_aligned(x, e_stage)
    else:
        # tiled multihot stages carry no argmax — exact oracle path
        return refops.hgnn_aggregate_ref(hgd, x, wdiag, "max")
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    if b == "dense" and getattr(plan, "dense", None) is not None:
        xv = _dense_e2v(plan.dense, xe)
    elif b in ("aligned", "multihot"):
        # the E→V stage is a plain SUM — ride the backend's own
        # matmul-form stage (gather-free band/multihot matmuls) instead
        # of the gather tree; only the argmax V→E above is tree-bound.
        # tree_matvec's VJP swaps to the paired stage, so gradients stay
        # exact.  Fall back to the plain tree when the fast plan is
        # absent (raw TreePlan callers).
        fast = getattr(plan, b, None)
        if fast is not None and hasattr(fast, "device"):
            fe_stage, fv_stage = fast.device()
            xv = tree_ops.tree_matvec(xe, fv_stage, fe_stage)
        else:
            xv = tree_ops.tree_matvec(xe, v_stage, e_stage)
    elif b == "cumsum":
        xv = _cumsum_e2v(hgd, xe)
    elif isinstance(v_stage, TiledStageDev):
        xv = _cumsum_e2v(hgd, xe)
    else:
        xv = tree_ops.tree_matvec(xe, v_stage, e_stage)
    return xv * hgd.degV


# ----------------------------------------------------------------------
# public fused ops
# ----------------------------------------------------------------------
def hgnn_aggregate(
    hgd: HypergraphData,
    x,
    wdiag=None,
    first_aggr: str = "sum",
    plan=None,
    backend: Optional[str] = None,
):
    """Fused HGNNConv aggregation (SURVEY.md §0):
    ``out = diag(degV) · H · diag(Wdiag·degE) · Hᵀ · X``  with
    first-stage reduce ∈ {sum, mean, max}.
    """
    b = _resolve(backend, plan, nnz=int(hgd.h_edge.shape[0]))
    if b == "xla":
        return refops.hgnn_aggregate_ref(hgd, x, wdiag, first_aggr)
    if first_aggr == "max":
        # fast max: argmax-carrying tree V→E (record_table analogue of
        # hgnnaggr_cuda.cu:144-208) + the backend's E→V sum stage; exact
        # scatter-free VJP (ops/maxops.py).  Oracle fallback without a plan.
        if plan is None:
            return refops.hgnn_aggregate_ref(hgd, x, wdiag, first_aggr)
        return _hgnn_aggregate_max(hgd, x, wdiag, plan, b)
    if b == "cumsum":
        xe = _cumsum_v2e(hgd, x, first_aggr)
        xe = xe * hgd.degE
        if wdiag is not None:
            xe = xe * wdiag
        xv = _cumsum_e2v(hgd, xe)
        return xv * hgd.degV
    if b == "precomp":
        # valid only for sum aggregation with frozen (ones) Wdiag — the
        # whole fused op is ONE matmul against the precomputed
        # propagation matrix (the reference's SpGEMM-precompute
        # strategy, spgemm.cuh, made a dense matmul).
        pre = getattr(plan, "precomp", None) or plan
        if wdiag is None and first_aggr == "sum" and pre is not None and hasattr(pre, "a"):
            return jax.lax.dot_general(
                pre.a, x.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        # fall through to the next-best backend
        fallback = "dense" if getattr(plan, "dense", None) is not None else "tree"
        return hgnn_aggregate(hgd, x, wdiag, first_aggr, plan, fallback)
    if b == "bsr":
        from hypergef.ops import bsr_ops

        return bsr_ops.hgnn_aggregate_bsr(hgd, x, wdiag, first_aggr, _get(plan, "bsr"))
    if b == "tree":
        from hypergef.ops import tree as tree_ops

        return tree_ops.hgnn_aggregate_tree(hgd, x, wdiag, first_aggr, _get(plan, "tree"))
    if b == "multihot":
        from hypergef.ops import tree as tree_ops

        mh = getattr(plan, "multihot", None)
        if mh is None:
            mh = plan  # raw multihot TreePlan passed directly
        return tree_ops.hgnn_aggregate_tree(hgd, x, wdiag, first_aggr, mh)
    if b == "aligned":
        from hypergef.ops import tree as tree_ops

        al = getattr(plan, "aligned", None)
        if al is None:
            al = plan  # raw aligned TreePlan passed directly
        return tree_ops.hgnn_aggregate_tree(hgd, x, wdiag, first_aggr, al)
    if b == "dense":
        dense = _get(plan, "dense")
        xe = _dense_v2e(dense, x, first_aggr, hgd)
        xe = xe * hgd.degE
        if wdiag is not None:
            xe = xe * wdiag
        return _dense_e2v(dense, xe) * hgd.degV
    if b == "ell":
        pd = _get(plan, "tile").device()
        xe = _ell_stage(
            pd.e_gather_idx, pd.e_mask, pd.e_seg_ids, hgd.num_edges, x, first_aggr
        )
        xe = xe * hgd.degE
        if wdiag is not None:
            xe = xe * wdiag
        xv = _ell_stage(
            pd.v_gather_idx, pd.v_mask, pd.v_seg_ids, hgd.num_nodes, xe, "sum"
        )
        return xv * hgd.degV
    raise AssertionError(b)


def unignn_aggregate(
    hgd: HypergraphData,
    x,
    use_deg: bool = False,
    plan=None,
    backend: Optional[str] = None,
):
    """Fused UniGNN aggregation: ``H Hᵀ X`` or degree-scaled variant."""
    b = _resolve(backend, plan, nnz=int(hgd.h_edge.shape[0]))
    if b == "xla":
        return refops.unignn_aggregate_ref(hgd, x, use_deg)
    if b == "cumsum":
        xe = _cumsum_v2e(hgd, x, "sum")
        if use_deg:
            xe = xe * hgd.degE
        xv = _cumsum_e2v(hgd, xe)
        if use_deg:
            xv = xv * hgd.degV
        return xv
    if b == "precomp":
        pre = getattr(plan, "precomp", None) or plan
        if use_deg and pre is not None and hasattr(pre, "a"):
            # degree-scaled UniGNN propagation == the HGNN A matrix
            return jax.lax.dot_general(
                pre.a, x.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        fallback = "dense" if getattr(plan, "dense", None) is not None else "tree"
        return unignn_aggregate(hgd, x, use_deg, plan, fallback)
    if b == "bsr":
        from hypergef.ops import bsr_ops

        return bsr_ops.unignn_aggregate_bsr(hgd, x, use_deg, _get(plan, "bsr"))
    if b == "tree":
        from hypergef.ops import tree as tree_ops

        return tree_ops.unignn_aggregate_tree(hgd, x, use_deg, _get(plan, "tree"))
    if b == "multihot":
        from hypergef.ops import tree as tree_ops

        mh = getattr(plan, "multihot", None)
        if mh is None:
            mh = plan
        return tree_ops.unignn_aggregate_tree(hgd, x, use_deg, mh)
    if b == "aligned":
        from hypergef.ops import tree as tree_ops

        al = getattr(plan, "aligned", None)
        if al is None:
            al = plan
        return tree_ops.unignn_aggregate_tree(hgd, x, use_deg, al)
    if b == "dense":
        dense = _get(plan, "dense")
        xe = _dense_v2e(dense, x, "sum", hgd)
        if use_deg:
            xe = xe * hgd.degE
        xv = _dense_e2v(dense, xe)
        if use_deg:
            xv = xv * hgd.degV
        return xv
    if b == "ell":
        pd = _get(plan, "tile").device()
        xe = _ell_stage(
            pd.e_gather_idx, pd.e_mask, pd.e_seg_ids, hgd.num_edges, x, "sum"
        )
        if use_deg:
            xe = xe * hgd.degE
        xv = _ell_stage(
            pd.v_gather_idx, pd.v_mask, pd.v_seg_ids, hgd.num_nodes, xe, "sum"
        )
        if use_deg:
            xv = xv * hgd.degV
        return xv
    raise AssertionError(b)
