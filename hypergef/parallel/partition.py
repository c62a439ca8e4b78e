"""Hyperedge-contiguous graph partitioning for multi-chip execution.

The reference's intra-GPU balancer chops each hyperedge's nnz into
bounded chunks (``balancer_kernel.cuh:229-259``); the same decomposition
generalizes across chips (SURVEY.md §2.9): the top-level cut is a
*hyperedge-contiguous, nnz-balanced* 1-D partition of Hᵀ, so the
``degE·Wdiag`` scaling stays device-local and only vertex-side partials
cross devices (combined with a single ``psum``/``psum_scatter`` — the
multi-device replacement for the reference's atomicAdd "communication").

Each shard gets its own reduction-tree plan (over its local sub-CSR);
plans are padded to common shapes and stacked along a leading device
axis so one SPMD program serves every device under ``shard_map``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from hypergef.sparse.hypergraph import Hypergraph
from hypergef.sparse.planner import TreeLevel, TreeStage, plan_tree


def edge_partition_bounds(hg: Hypergraph, n_shards: int) -> np.ndarray:
    """Contiguous hyperedge ranges with balanced nnz: returns [n+1] cuts.

    Balanced by nnz (not edge count) because work ∝ nnz — the cross-chip
    generalization of the balancer's equal-chunk principle.
    """
    total = hg.nnz
    targets = (np.arange(1, n_shards) * total) / n_shards
    cuts = np.searchsorted(hg.ht_indptr, targets, side="left")
    return np.concatenate([[0], cuts, [hg.num_edges]]).astype(np.int64)


def _local_subgraph(hg: Hypergraph, e0: int, e1: int) -> Hypergraph:
    """Sub-hypergraph of hyperedges [e0, e1): local edge ids, global
    vertex ids (H is |V|×E_local)."""
    lo, hi = int(hg.ht_indptr[e0]), int(hg.ht_indptr[e1])
    sizes = np.diff(hg.ht_indptr[e0 : e1 + 1])
    v = hg.ht_indices[lo:hi].astype(np.int64)
    e = np.repeat(np.arange(e1 - e0, dtype=np.int64), sizes)
    return Hypergraph.from_coo(
        v, e, num_nodes=hg.num_nodes, num_edges=max(e1 - e0, 1),
        name=f"{hg.name}[{e0}:{e1}]", dedup=False,
    )


def _identity_level(rows: int, fan: int) -> TreeLevel:
    g = np.zeros((max(rows, 1), fan), dtype=np.int32)
    g[:, 0] = np.arange(max(rows, 1), dtype=np.int32)
    m = np.zeros((max(rows, 1), fan), dtype=np.float32)
    m[:, 0] = 1.0
    return TreeLevel(gather_idx=g, mask=m)


def _pad_level(lvl: TreeLevel, c_to: int) -> TreeLevel:
    c = lvl.gather_idx.shape[0]
    if c == c_to:
        return lvl
    g = np.zeros((c_to, lvl.gather_idx.shape[1]), dtype=np.int32)
    m = np.zeros((c_to, lvl.mask.shape[1]), dtype=np.float32)
    g[:c] = lvl.gather_idx
    m[:c] = lvl.mask
    return TreeLevel(gather_idx=g, mask=m)


def _unify_stages(stages: List[TreeStage], seg_to: int, fan: int):
    """Pad a list of per-shard stages to identical shapes; returns
    stacked numpy arrays with a leading shard axis."""
    depth = max(len(s.levels) for s in stages)
    per_shard_levels = []
    for s in stages:
        lvls = list(s.levels)
        # rows after the last existing level
        rows_after = (
            int(np.asarray(s.final_idx).max()) + 1 if len(s.final_idx) else 1
        )
        rows_after = max(rows_after, 1)
        # actual row count after last level:
        last_c = lvls[-1].gather_idx.shape[0] if lvls else 1
        while len(lvls) < depth:
            lvls.append(_identity_level(last_c, fan))
        per_shard_levels.append(lvls)
    stacked_levels = []
    for li in range(depth):
        c_max = max(ls[li].gather_idx.shape[0] for ls in per_shard_levels)
        gs = np.stack([_pad_level(ls[li], c_max).gather_idx for ls in per_shard_levels])
        ms = np.stack([_pad_level(ls[li], c_max).mask for ls in per_shard_levels])
        stacked_levels.append((gs, ms))
    fi = np.zeros((len(stages), seg_to), dtype=np.int32)
    fm = np.zeros((len(stages), seg_to), dtype=np.float32)
    cn = np.zeros((len(stages), seg_to), dtype=np.float32)
    for d, s in enumerate(stages):
        k = s.final_idx.shape[0]
        fi[d, :k] = s.final_idx
        fm[d, :k] = s.final_mask
        cn[d, :k] = s.counts
    return stacked_levels, fi, fm, cn


@dataclasses.dataclass
class ShardedAggPlan:
    """SPMD aggregation plan: per-device reduction trees, stacked.

    All arrays carry a leading device axis of size ``n_shards`` and are
    sharded along the mesh's edge axis under ``shard_map``.
    """

    n_shards: int
    num_nodes: int
    num_edges: int
    e_pad: int  # padded local edge count (uniform across shards)
    edge_bounds: np.ndarray  # [n_shards+1] global hyperedge cuts
    # stacked edge-stage (V→E_local): levels [(g [D,C,fan], m), ...]
    e_levels: list
    e_final_idx: np.ndarray  # [D, e_pad]
    e_final_mask: np.ndarray
    e_counts: np.ndarray  # [D, e_pad]
    # stacked vertex-stage (E_local→V, partial): same structure
    v_levels: list
    v_final_idx: np.ndarray  # [D, N]
    v_final_mask: np.ndarray
    degE: np.ndarray  # [D, e_pad, 1]
    # vertex-major CSR of each local sub-H (LOCAL edge ids), padded to a
    # common nnz — consumed only by the exact max-VJP (record-table
    # backward, ops/maxops); shipped to device lazily via max_device()
    # so sum/mean calls pay nothing.
    h_indptr: Optional[np.ndarray] = None  # [D, N+1] int32
    h_edge: Optional[np.ndarray] = None  # [D, nnz_pad] int32
    h_segids: Optional[np.ndarray] = None  # [D, nnz_pad] int32
    _device: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _max_device: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def device(self):
        if self._device is None:
            import jax
            import jax.numpy as jnp

            # build cache eagerly even if first called inside a trace:
            # traced constants cached here would leak out of the
            # transformation scope (observed via scan-traced max paths)
            with jax.ensure_compile_time_eval():
                self._device = (
                    tuple((jnp.asarray(g), jnp.asarray(m))
                          for g, m in self.e_levels),
                    jnp.asarray(self.e_final_idx),
                    jnp.asarray(self.e_final_mask),
                    jnp.asarray(self.e_counts),
                    tuple((jnp.asarray(g), jnp.asarray(m))
                          for g, m in self.v_levels),
                    jnp.asarray(self.v_final_idx),
                    jnp.asarray(self.v_final_mask),
                    jnp.asarray(self.degE),
                )
        return self._device

    def max_device(self):
        """Device tuple (h_indptr, h_edge, h_segids) for the max path."""
        if self.h_indptr is None:
            raise ValueError(
                "plan was built without max-backward CSR arrays "
                "(plan_sharded_aggregation(with_max=...))"
            )
        if self._max_device is None:
            import jax
            import jax.numpy as jnp

            # eager build — see device(); first call may be inside a
            # scan/jit trace (observed: chained-epoch max training)
            with jax.ensure_compile_time_eval():
                self._max_device = (
                    jnp.asarray(self.h_indptr),
                    jnp.asarray(self.h_edge),
                    jnp.asarray(self.h_segids),
                )
        return self._max_device

    def shard_edge_vector(self, vec: np.ndarray) -> np.ndarray:
        """Scatter a global per-hyperedge vector [E, 1] into the padded
        stacked layout [D, e_pad, 1] (for Wdiag etc.)."""
        vec = np.asarray(vec)
        out = np.zeros((self.n_shards, self.e_pad, vec.shape[1]), dtype=vec.dtype)
        for d in range(self.n_shards):
            e0, e1 = int(self.edge_bounds[d]), int(self.edge_bounds[d + 1])
            out[d, : e1 - e0] = vec[e0:e1]
        return out


def plan_sharded_aggregation(
    hg: Hypergraph,
    n_shards: int,
    ngs: Optional[int] = None,
    fan: int = 8,
    with_max: bool = True,
) -> ShardedAggPlan:
    """Build the stacked SPMD plan for an ``n_shards``-way edge partition.

    ``with_max`` additionally stacks each shard's vertex-major local CSR
    (host numpy only — transferred on first ``max`` call), enabling
    ``first_aggr="max"`` with the exact record-table VJP on the
    distributed path (the reference's max kernel semantics,
    ``hgnnaggr_cuda.cu:144-208``, which it never had multi-device).
    """
    bounds = edge_partition_bounds(hg, n_shards)
    e_stages, v_stages = [], []
    subs = []
    e_pad = int((bounds[1:] - bounds[:-1]).max())
    if ngs is None:
        # one global chunk width: per-shard choices would give levels of
        # different widths, which cannot stack into one SPMD program
        from hypergef.sparse.planner import choose_ngs

        ngs = choose_ngs(hg.edge_sizes(), min_ngs=4, max_ngs=64, step=4)
    ngs_v = choose_ngs(hg.vertex_degrees(), min_ngs=4, max_ngs=64, step=4)
    for d in range(n_shards):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        sub = _local_subgraph(hg, e0, e1)
        subs.append(sub)
        sub_plan = plan_tree(sub, ngs=ngs, ngs_vertex=ngs_v, fan=fan)
        e_stages.append(sub_plan.edge_stage)
        v_stages.append(sub_plan.vertex_stage)
    e_levels, e_fi, e_fm, e_cn = _unify_stages(e_stages, e_pad, fan)
    v_levels, v_fi, v_fm, _ = _unify_stages(v_stages, hg.num_nodes, fan)
    degE = np.zeros((n_shards, e_pad, 1), dtype=np.float32)
    for d in range(n_shards):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        degE[d, : e1 - e0] = hg.degE[e0:e1]
    h_ip = h_ed = h_sg = None
    if with_max:
        # stacked vertex-major local CSRs; padding rows live PAST
        # indptr[-1], so the differenced-cumsum segment sum never reads
        # them (ops/segments.segment_sum_sorted)
        nnz_pad = max(int(s.nnz) for s in subs)
        h_ip = np.zeros((n_shards, hg.num_nodes + 1), np.int32)
        h_ed = np.zeros((n_shards, nnz_pad), np.int32)
        h_sg = np.zeros((n_shards, nnz_pad), np.int32)
        for d, sub in enumerate(subs):
            h_ip[d] = sub.h_indptr.astype(np.int32)
            h_ed[d, : sub.nnz] = sub.h_indices.astype(np.int32)
            h_sg[d, : sub.nnz] = np.repeat(
                np.arange(hg.num_nodes, dtype=np.int32),
                np.diff(sub.h_indptr).astype(np.int64),
            )
    plan = ShardedAggPlan(
        n_shards=n_shards,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
        e_pad=e_pad,
        edge_bounds=bounds,
        e_levels=e_levels,
        e_final_idx=e_fi,
        e_final_mask=e_fm,
        e_counts=e_cn,
        v_levels=v_levels,
        v_final_idx=v_fi,
        v_final_mask=v_fm,
        degE=degE,
        h_indptr=h_ip,
        h_edge=h_ed,
        h_segids=h_sg,
    )
    plan.device()
    return plan
