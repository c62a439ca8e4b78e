"""Reference (oracle) incidence-aggregation ops in pure jnp.

These implement exactly the semantics of SURVEY.md §0 — the single-degV
HGNN form shared by the reference's fused and PyG backends
(``model/pygnn/hgnn.py:25-38``, ``source/hgnnaggr/hgnnaggr_cuda.cu:14-47``)
and the UniGNN forms (``model/pygnn/unigin.py:17-26``,
``model/pygnn/unigcnii.py:23-36``) — as sorted segment reductions over the
nnz of the incidence matrix.  They are:

* the correctness oracle for every other backend (role of the
  reference's CPU host checks, ``include/util/check.cuh:83-115``),
* a fully working fallback backend on any device, and
* exactly differentiable (JAX autodiff; no symmetric-backward
  approximation — see SURVEY.md §0 on ``hgnnaggr.cc:51-64``).

Both segment reductions see *sorted* segment ids because the hypergraph
carries nnz in both hyperedge-major and vertex-major order
(:class:`hypergef.sparse.hypergraph.HypergraphData`).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from hypergef.sparse.hypergraph import HypergraphData

Array = jax.Array


def _segment_sum(vals, seg_ids, num_segments):
    return jax.ops.segment_sum(
        vals, seg_ids, num_segments=num_segments, indices_are_sorted=True
    )


def v2e_aggregate(hgd: HypergraphData, x: Array, aggr: str = "sum") -> Array:
    """V→E stage: per-hyperedge reduction over member vertices.

    ``Xe[e] = reduce_{v ∈ e} X[v]`` with ``reduce`` ∈ {sum, mean, max}
    (the reference's ``first_aggr``, ``hgsys.py:35``).
    """
    gathered = jnp.take(x, hgd.ht_vertex, axis=0)  # [nnz, F]
    if aggr == "sum":
        return _segment_sum(gathered, hgd.ht_segids, hgd.num_edges)
    if aggr == "mean":
        s = _segment_sum(gathered, hgd.ht_segids, hgd.num_edges)
        cnt = _segment_sum(
            jnp.ones((gathered.shape[0], 1), dtype=x.dtype),
            hgd.ht_segids,
            hgd.num_edges,
        )
        return s / jnp.maximum(cnt, 1.0)
    if aggr == "max":
        return segment_max_gather(x, hgd.ht_vertex, hgd.ht_segids, hgd.num_edges)
    raise ValueError(f"unknown first_aggr {aggr!r}")


def e2v_sum(hgd: HypergraphData, xe: Array) -> Array:
    """E→V stage: per-vertex sum over incident hyperedges."""
    gathered = jnp.take(xe, hgd.h_edge, axis=0)  # [nnz, F]
    return _segment_sum(gathered, hgd.h_segids, hgd.num_nodes)


# ----------------------------------------------------------------------
# max first-aggregation with an exact, reference-parity VJP
# ----------------------------------------------------------------------
@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def segment_max_gather(x, gather_ids, seg_ids, num_segments):
    """``y[s] = max_{k: seg[k]=s} x[gather_ids[k]]`` (empty segments → 0).

    The VJP routes each output's cotangent to exactly one argmax member
    (the first in CSR order), matching the reference's ``record_table``
    backward (``hgnnaggr_cuda.cu:144-208``: strict ``>`` comparison keeps
    the first maximal member) — but computed exactly, not re-applying the
    forward kernel.  Empty segments contribute 0 like the reference's
    zero-initialized output.
    """
    y, _ = _segment_max_fwd_impl(x, gather_ids, seg_ids, num_segments)
    return y


def _segment_max_fwd_impl(x, gather_ids, seg_ids, num_segments):
    gathered = jnp.take(x, gather_ids, axis=0)  # [nnz, F]
    neg = jnp.finfo(x.dtype).min
    y = jax.ops.segment_max(
        gathered,
        seg_ids,
        num_segments=num_segments,
        indices_are_sorted=True,
    )
    # segment_max fills empty segments with -inf/min; zero them (reference
    # kernels leave untouched zero-initialized rows for empty hyperedges).
    cnt = jax.ops.segment_sum(
        jnp.ones((gathered.shape[0],), dtype=jnp.int32),
        seg_ids,
        num_segments=num_segments,
        indices_are_sorted=True,
    )
    y = jnp.where((cnt == 0)[:, None] | (y <= neg), 0.0, y)
    # argmax member per (segment, feature): first k achieving the max.
    is_max = gathered == jnp.take(y, seg_ids, axis=0)
    nnz = gathered.shape[0]
    k_ids = jax.lax.broadcasted_iota(jnp.int32, is_max.shape, 0)
    cand = jnp.where(is_max, k_ids, nnz)
    argmax_k = jax.ops.segment_min(
        cand, seg_ids, num_segments=num_segments, indices_are_sorted=True
    )  # [S, F], nnz where empty
    return y, argmax_k


def _segment_max_fwd(x, gather_ids, seg_ids, num_segments):
    y, argmax_k = _segment_max_fwd_impl(x, gather_ids, seg_ids, num_segments)
    return y, (x, gather_ids, argmax_k)


def _segment_max_bwd(num_segments, res, g):
    x, gather_ids, argmax_k = res
    x_shape, x_dtype = x.shape, x.dtype
    nnz = gather_ids.shape[0]
    # route g[s, f] to nnz slot argmax_k[s, f], then to x row gather_ids[k].
    # scatter via one extra (dropped) slot for empty segments.
    safe_k = jnp.minimum(argmax_k, nnz - 1)
    valid = (argmax_k < nnz).astype(g.dtype)
    contrib = g * valid  # [S, F]
    # accumulate into nnz slots: dimension-wise scatter-add.
    f = g.shape[1]
    col = jax.lax.broadcasted_iota(jnp.int32, (contrib.shape[0], f), 1)
    flat_idx = safe_k * f + col.astype(jnp.int32)
    grad_nnz = jnp.zeros((nnz * f,), dtype=g.dtype).at[flat_idx.reshape(-1)].add(
        contrib.reshape(-1)
    ).reshape(nnz, f)
    # nnz → x rows (unsorted scatter-add over gather_ids)
    gx = jax.ops.segment_sum(grad_nnz, gather_ids, num_segments=x_shape[0])
    return gx.astype(x_dtype), None, None


segment_max_gather.defvjp(_segment_max_fwd, _segment_max_bwd)


# ----------------------------------------------------------------------
# full fused-op semantics (oracle form)
# ----------------------------------------------------------------------
def hgnn_aggregate_ref(
    hgd: HypergraphData,
    x: Array,
    wdiag: Optional[Array] = None,
    first_aggr: str = "sum",
) -> Array:
    """HGNNConv aggregation: ``diag(degV) · H · diag(Wdiag·degE) · Hᵀ · X``.

    ``x`` is the already-projected feature matrix (the reference applies
    ``X = XW`` before calling the fused op, ``model/ugsys/hgnn.py:21-24``).
    degV is applied once, on the output side only (SURVEY.md §0).
    """
    xe = v2e_aggregate(hgd, x, first_aggr)
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    xv = e2v_sum(hgd, xe)
    return xv * hgd.degV


def unignn_aggregate_ref(
    hgd: HypergraphData, x: Array, use_deg: bool = False
) -> Array:
    """UniGNN aggregation: ``H Hᵀ X`` (plain) or ``diag(degV)·H·diag(degE)·Hᵀ·X``.

    The plain form feeds UniGIN (``model/pygnn/unigin.py:17-26``); the
    degree-scaled form feeds UniGCNII (``model/pygnn/unigcnii.py:23-36``).
    Note: the reference's fused deg variant has an indexing bug
    (``unignnaggr_cuda.cu:41``, SURVEY.md §2.8-3) — we implement the
    correct ``degV[v]`` semantics.
    """
    xe = v2e_aggregate(hgd, x, "sum")
    if use_deg:
        xe = xe * hgd.degE
    xv = e2v_sum(hgd, xe)
    if use_deg:
        xv = xv * hgd.degV
    return xv
