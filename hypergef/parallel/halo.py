"""Boundary (halo) exchange planning for fully-sharded aggregation.

The scalable multi-chip design (BASELINE.json north star: "edge
partitioning … exchanging boundary vertex features via all-to-all"):

* hyperedges are partitioned contiguously by nnz (as in
  :mod:`hypergef.parallel.partition`);
* vertices get *owners*: contiguous equal blocks of ⌈N/D⌉;
* shard d's local hyperedges split into **interior** (every member
  vertex owned by d — their V→E stage reads the owned block directly
  and needs NO communication) and **boundary** edges, whose touched set
  T_d = members ∩ non-local drives the halo exchange;
* boundary sets  S[d][d'] = T_d ∩ owned(d')  drive BOTH directions:

      halo:    owner d' sends X rows S[d][d'] to worker d   (features in)
      return:  worker d sends partial rows R[d][d'] to owner d' (partials out)

  so per-layer communication is ∝ the cut, not |V|.

The interior/boundary split exists for **collective/compute overlap**:
in the emitted program the interior V→E reduction tree has no data
dependence on the halo ``all_to_all``, so XLA's latency-hiding scheduler
can run it between the collective's start/done pair.  On community-
sorted graphs the interior fraction is large (most of stage-1 compute
hides the halo latency); ``HaloPlan.interior_fraction`` reports it.
It also SHRINKS the halo direction: vertices touched only by interior
edges are no longer exchanged at all.

Every structure is padded to static shapes and stacked on a leading
device axis; the owner-side accumulation of incoming partials is — like
everything else in this framework — a scatter-free reduction tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from hypergef.parallel.partition import edge_partition_bounds
from hypergef.sparse.planner import (
    aligned_spill_stats, build_aligned_stage, build_tree, choose_ngs)


def _round_up(x, m):
    return -(-x // m) * m


def _median_sort_interior(I, sizes, e_of, sel_i, loc, ne):
    """Sort interior edge ids by median owned-local member id (the
    aligned form's window-quality key — see reorder.apply_vertex_order).
    Returns (I_sorted, ptr, idx): the interior CSR in sorted order."""
    if len(I) == 0:
        return I, np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int32)
    e_ent = e_of[sel_i]  # original local edge id per interior entry
    order0 = np.lexsort((loc, e_ent))
    loc_s, e_s = loc[order0], e_ent[order0]
    cnt = np.zeros(ne + 1, dtype=np.int64)
    np.add.at(cnt, e_s + 1, 1)
    start = np.cumsum(cnt)[:-1]
    med = np.zeros(ne, dtype=np.int64)
    nz = np.nonzero(cnt[1:])[0]  # edges with ≥1 interior entry
    med[nz] = loc_s[start[nz] + (cnt[1:][nz] // 2)]
    perm = np.argsort(med[I], kind="stable")
    I_sorted = I[perm]
    rank = np.full(ne, -1, dtype=np.int64)
    rank[I_sorted] = np.arange(len(I))
    ent_order = np.argsort(rank[e_ent], kind="stable")
    idx = loc[ent_order].astype(np.int32)
    ptr = np.zeros(len(I) + 1, dtype=np.int64)
    np.cumsum(sizes[I_sorted], out=ptr[1:])
    return I_sorted, ptr, idx


def _transpose_csr(ptr, idx, num_segments_out):
    """(edge → vertex) CSR → (vertex → edge-rank) CSR."""
    S = len(ptr) - 1
    seg = np.repeat(np.arange(S, dtype=np.int64), np.diff(ptr))
    v = np.asarray(idx, dtype=np.int64)
    order = np.lexsort((seg, v))
    t_idx = seg[order].astype(np.int32)
    t_ptr = np.zeros(num_segments_out + 1, dtype=np.int64)
    np.add.at(t_ptr, v + 1, 1)
    np.cumsum(t_ptr, out=t_ptr)
    return t_ptr, t_idx


def _choose_wb(csrs, num_inputs, max_spill=0.15, hard=0.25):
    """Smallest common window width whose worst-shard spill is ≤
    max_spill; falls back to 8 if ≤ hard; None otherwise."""
    worst = 0.0
    for wb in (2, 4, 6, 8):
        worst = max(
            (aligned_spill_stats(p, i, num_inputs, 128, wb)
             if len(i) else 0.0)
            for p, i in csrs
        )
        if worst <= max_spill:
            return wb
    return 8 if worst <= hard else None


def _stack_aligned(stages, n_groups_c, num_inputs):
    """Pad per-shard uniform AlignedStages to common shapes and stack
    on a leading device axis. Returns dict of [D, ...] arrays."""
    G = stages[0].b_dense.shape[1]
    W = stages[0].b_dense.shape[2]
    sw_c = max(st.spill_src.shape[1] for st in stages)
    bd, wbk, ss, bs = [], [], [], []
    for st in stages:
        ng, _, _ = st.b_dense.shape
        sw = st.spill_src.shape[1]
        bd.append(np.pad(st.b_dense, ((0, n_groups_c - ng), (0, 0), (0, 0))))
        wbk.append(np.pad(st.win_block, ((0, n_groups_c - ng), (0, 0))))
        ss.append(np.pad(
            st.spill_src, ((0, n_groups_c - ng), (0, sw_c - sw)),
            constant_values=num_inputs,
        ))
        bs.append(np.pad(
            st.b_spill, ((0, n_groups_c - ng), (0, 0), (0, sw_c - sw))))
    return {
        "b_dense": np.stack(bd),       # [D, ng, G, W] int8
        "win_block": np.stack(wbk),    # [D, ng, wb] int32
        "spill_src": np.stack(ss),     # [D, ng, sw] int32
        "b_spill": np.stack(bs),       # [D, ng, G, sw] int8
    }


def _stack_stages(stages, seg_to, fan):
    from hypergef.parallel.partition import _unify_stages

    return _unify_stages(stages, seg_to, fan)


@dataclasses.dataclass
class HaloPlan:
    """Static SPMD plan for fully-sharded halo aggregation."""

    n_shards: int
    num_nodes: int
    num_edges: int
    n_own: int  # owned vertices per shard (= ceil(N/D), padded)
    t_max: int  # max full touched-set size (return direction)
    t_bnd_max: int  # max boundary touched-set size (halo direction)
    b_cap: int  # return capacity per (src, dst) pair
    b_cap_h: int  # halo capacity per (src, dst) pair
    e_pad: int  # padded local edge count
    e_int_pad: int  # padded interior edge count
    e_bnd_pad: int  # padded boundary edge count
    edge_bounds: np.ndarray
    # interior edge-stage: inputs = owned X rows [n_own] — independent of
    # the halo all_to_all (the overlap workload)
    int_levels: list
    int_final_idx: np.ndarray  # [D, e_int_pad]
    int_final_mask: np.ndarray
    # boundary edge-stage: inputs = compact boundary-touched rows [t_bnd_max]
    bnd_levels: list
    bnd_final_idx: np.ndarray  # [D, e_bnd_pad]
    bnd_final_mask: np.ndarray
    # assembly: local edge slot -> row of concat([xe_int, xe_bnd, 0-row])
    asm_idx: np.ndarray  # [D, e_pad] int32
    e_counts: np.ndarray  # [D, e_pad] f32 — members per local edge (mean)
    # local vertex-stage: rows = compact FULL touched ids, inputs = local edges
    v_levels: list
    v_final_idx: np.ndarray  # [D, t_max]
    v_final_mask: np.ndarray
    # exchange maps
    send_slot: np.ndarray  # [D, D, b_cap] int32 — compact T index to send to dst
    send_mask: np.ndarray  # [D, D, b_cap] f32
    halo_send_slot: np.ndarray  # [D, D, b_cap_h] int32 — owner-local X row for dst
    halo_mask: np.ndarray  # [D, D, b_cap_h] f32 — live halo slots
    halo_idx: np.ndarray  # [D, t_bnd_max] int32 — flat recv slot per compact id
    # owner-side combine: inputs = flat [D*b_cap] received partial slots
    own_levels: list
    own_final_idx: np.ndarray  # [D, n_own]
    own_final_mask: np.ndarray
    degE: np.ndarray  # [D, e_pad, 1]
    degV_own: np.ndarray  # [D, n_own, 1]
    n_interior: np.ndarray  # [D] int64 — true interior edge counts
    n_local_edges: np.ndarray  # [D] int64
    # interior stage form: "tree" (gather levels) or "aligned" (banded
    # matmuls — community-sorted graphs; int_aligned holds the
    # stacked fwd (V→E over owned block) and bwd (its transpose, the
    # exact-VJP stage) uniform aligned tables)
    local_form: str = "tree"
    int_aligned: Optional[dict] = None  # {"fwd": {...}, "bwd": {...}, "wb_f", "wb_b"}
    _device: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def device(self):
        if self._device is None:
            import jax
            import jax.numpy as jnp

            # eager build even under a trace (see ShardedAggPlan.device)
            with jax.ensure_compile_time_eval():
                return self._build_device(jnp)
        return self._device

    def _build_device(self, jnp):
        j = jnp.asarray
        aligned = ()
        if self.local_form == "aligned":
            al = self.int_aligned
            aligned = tuple(
                j(al[leg][k])
                for leg in ("fwd", "bwd")
                for k in ("b_dense", "win_block", "spill_src", "b_spill")
            )
        self._device = (
            tuple((j(g), j(m)) for g, m in self.int_levels),
            j(self.int_final_idx), j(self.int_final_mask),
            tuple((j(g), j(m)) for g, m in self.bnd_levels),
            j(self.bnd_final_idx), j(self.bnd_final_mask),
            j(self.asm_idx), j(self.e_counts),
            tuple((j(g), j(m)) for g, m in self.v_levels),
            j(self.v_final_idx), j(self.v_final_mask),
            j(self.send_slot), j(self.send_mask),
            j(self.halo_send_slot), j(self.halo_idx),
            tuple((j(g), j(m)) for g, m in self.own_levels),
            j(self.own_final_idx), j(self.own_final_mask),
            j(self.degE), j(self.degV_own),
            aligned,
        )
        return self._device

    def comm_fraction(self) -> float:
        """Return-direction traffic / full-replication traffic."""
        boundary = float(self.send_mask.sum())
        return boundary / max(self.n_shards * self.num_nodes, 1)

    def halo_comm_fraction(self) -> float:
        """Halo-direction traffic / full-replication traffic (smaller
        than comm_fraction: interior-only vertices are never sent)."""
        return float(self.halo_mask.sum()) / max(
            self.n_shards * self.num_nodes, 1
        )

    def interior_fraction(self) -> float:
        """Fraction of local hyperedges whose V→E compute is independent
        of the halo all_to_all (the overlap workload)."""
        return float(self.n_interior.sum()) / max(
            float(self.n_local_edges.sum()), 1.0
        )


def plan_halo(hg, n_shards: int, fan: int = 8,
              local_form: str = "tree", first_aggr: str = "sum",
              aligned_spill_limit: int = 1 << 28) -> HaloPlan:
    """``local_form="aligned"`` builds the interior V→E stage as banded
    matmuls (uniform :class:`planner.AlignedStage`, stacked across
    shards) instead of gather trees — the sparse fast path for
    community-sorted graphs, composed into the distributed program.
    Falls back to trees when any shard's interior would spill >25%.

    ``local_form="auto"`` consults the persisted single-chip autotune
    record for this graph (sparse/autotune.py — the measured
    partition_dict analogue): a graph whose measured-best single-chip
    backend is ``aligned`` gets the aligned interior; anything else (or
    no record yet) gets trees.  No fresh measurement happens here.
    Pass the intended ``first_aggr`` so auto can pick the right form:
    with ``"max"`` the aligned interior runs a masked argmax over every
    slot of a mostly-dead band plane, while the argmax tree touches
    only live entries — auto therefore keeps TREE interiors for max."""
    if local_form == "auto":
        if first_aggr == "max":
            local_form = "tree"
        else:
            from hypergef.sparse import autotune as _at

            rec = _at.load_cached(_at.graph_key(hg, 32))
            local_form = (
                "aligned" if rec is not None and rec.get("backend") == "aligned"
                else "tree"
            )
    D = n_shards
    bounds = edge_partition_bounds(hg, D)
    n_own = _round_up(hg.num_nodes, D) // D
    ngs = choose_ngs(hg.edge_sizes(), min_ngs=4, max_ngs=64, step=4)
    ngs_v = choose_ngs(hg.vertex_degrees(), min_ngs=4, max_ngs=64, step=4)

    touched = []  # per shard: sorted global FULL touched vertex ids
    touched_bnd = []  # per shard: sorted touched ids of boundary edges
    int_stages, bnd_stages, v_stages = [], [], []
    int_csrs = []  # per shard: (ptr, idx) of the (sorted) interior CSR
    n_interior = np.zeros(D, dtype=np.int64)
    n_local = np.zeros(D, dtype=np.int64)
    e_pad = int((bounds[1:] - bounds[:-1]).max())
    int_counts, bnd_ids = [], []  # per shard: interior edge ids, boundary ids
    for d in range(D):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        ne = e1 - e0
        lo, hi = int(hg.ht_indptr[e0]), int(hg.ht_indptr[e1])
        members = hg.ht_indices[lo:hi].astype(np.int64)
        sizes = np.diff(hg.ht_indptr[e0 : e1 + 1]).astype(np.int64)
        n_local[d] = ne
        own_lo, own_hi = d * n_own, (d + 1) * n_own
        e_of = np.repeat(np.arange(ne, dtype=np.int64), sizes)
        is_owned = (members >= own_lo) & (members < own_hi)
        owned_per_e = np.zeros(max(ne, 1), dtype=np.int64)
        np.add.at(owned_per_e, e_of, is_owned.astype(np.int64))
        interior = owned_per_e[:ne] == sizes
        I = np.nonzero(interior)[0]
        B = np.nonzero(~interior)[0]
        n_interior[d] = len(I)
        bnd_ids.append(B)
        # --- interior stage: CSR over interior edges, owned-local ids ---
        sel_i = interior[e_of] if ne else np.zeros(0, dtype=bool)
        if local_form == "aligned":
            loc_all = members[sel_i] - own_lo
            I, ptr_i, idx_i = _median_sort_interior(
                I, sizes, e_of, sel_i, loc_all, ne)
            int_csrs.append((ptr_i, idx_i))
            # empty placeholder tree (the aligned tables replace it)
            int_stages.append(build_tree(
                np.zeros(1, np.int64), np.zeros(0, np.int32), n_own,
                ngs, fan))
        else:
            ptr_i = np.zeros(max(len(I), 1) + 1, dtype=np.int64)
            np.cumsum(sizes[I], out=ptr_i[1 : len(I) + 1])
            idx_i = (members[sel_i] - own_lo).astype(np.int32)
            int_stages.append(build_tree(ptr_i, idx_i, n_own, ngs, fan))
        int_counts.append(I)
        # --- boundary stage: CSR over boundary edges, compact T_bnd ----
        sel_b = ~sel_i
        Tb = np.unique(members[sel_b])
        touched_bnd.append(Tb)
        ptr_b = np.zeros(max(len(B), 1) + 1, dtype=np.int64)
        np.cumsum(sizes[B], out=ptr_b[1 : len(B) + 1])
        idx_b = np.searchsorted(Tb, members[sel_b]).astype(np.int32)
        bnd_stages.append(build_tree(ptr_b, idx_b, max(len(Tb), 1), ngs, fan))
        # --- full touched set (return direction) -----------------------
        T = np.unique(members)
        touched.append(T)
        compact = np.searchsorted(T, members)
        # local CSR of H restricted to touched rows (compact) × local edges
        e_local = e_of
        order = np.lexsort((e_local, compact))
        h_indices = e_local[order].astype(np.int32)
        h_indptr = np.zeros(max(len(T), 1) + 1, dtype=np.int64)
        np.add.at(h_indptr, compact + 1, 1)
        np.cumsum(h_indptr, out=h_indptr)
        v_stages.append(
            build_tree(h_indptr, h_indices, max(ne, 1), ngs_v, fan)
        )

    e_int_pad = max(int(n_interior.max()), 1)
    e_bnd_pad = max(int((n_local - n_interior).max()), 1)
    t_max = max(max(len(T) for T in touched), 1)
    t_bnd_max = max(max(len(T) for T in touched_bnd), 1)

    int_aligned = None
    if local_form == "aligned":
        e_int_pad = _round_up(e_int_pad, 8)
        wb_f = _choose_wb(int_csrs, n_own)
        # transpose (exact-VJP direction): owned vertex ← interior edges
        t_csrs = [
            _transpose_csr(p, i, n_own) for p, i in int_csrs
        ]
        wb_b = _choose_wb(t_csrs, e_int_pad)
        if wb_f is None or wb_b is None:
            # interior too spill-heavy for the banded form — tree fallback
            return plan_halo(hg, n_shards, fan, local_form="tree")
        # aligned_spill_limit: giant shards (100M-nnz regime) pad the
        # uniform spill table to the max per-group width — callers that
        # can afford the host/device bytes raise the cap instead of
        # losing the aligned interior (scale_serialized)
        fwd_stages = [
            build_aligned_stage(p, i, n_own, 128, wb_f,
                                spill_limit=aligned_spill_limit)
            for p, i in int_csrs
        ]
        bwd_stages = [
            build_aligned_stage(p, i, e_int_pad, 128, wb_b,
                                spill_limit=aligned_spill_limit)
            for p, i in t_csrs
        ]
        int_aligned = {
            "fwd": _stack_aligned(
                fwd_stages, max(-(-e_int_pad // 128), 1), n_own),
            "bwd": _stack_aligned(
                bwd_stages, max(-(-n_own // 128), 1), e_int_pad),
            "wb_f": wb_f,
            "wb_b": wb_b,
        }

    # assembly map: local edge slot -> concat([xe_int, xe_bnd, zero]) row
    zero_row = e_int_pad + e_bnd_pad
    asm_idx = np.full((D, e_pad), zero_row, dtype=np.int32)
    e_counts = np.zeros((D, e_pad), dtype=np.float32)
    for d in range(D):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        ne = e1 - e0
        I, B = int_counts[d], bnd_ids[d]
        asm_idx[d, I] = np.arange(len(I), dtype=np.int32)
        asm_idx[d, B] = e_int_pad + np.arange(len(B), dtype=np.int32)
        e_counts[d, :ne] = np.diff(hg.ht_indptr[e0 : e1 + 1])

    # ---- return-direction boundary sets (full touched) ----------------
    S = [[None] * D for _ in range(D)]
    b_cap = 1
    for d in range(D):
        owner_of = touched[d] // n_own
        for dp in range(D):
            S[d][dp] = touched[d][owner_of == dp]
            b_cap = max(b_cap, len(S[d][dp]))
    b_cap = _round_up(b_cap, 8)

    # ---- halo-direction boundary sets (boundary touched only) ---------
    Sh = [[None] * D for _ in range(D)]
    b_cap_h = 1
    for d in range(D):
        owner_of = touched_bnd[d] // n_own
        for dp in range(D):
            Sh[d][dp] = touched_bnd[d][owner_of == dp]
            b_cap_h = max(b_cap_h, len(Sh[d][dp]))
    b_cap_h = _round_up(b_cap_h, 8)

    send_slot = np.zeros((D, D, b_cap), dtype=np.int32)
    send_mask = np.zeros((D, D, b_cap), dtype=np.float32)
    halo_send_slot = np.zeros((D, D, b_cap_h), dtype=np.int32)
    halo_mask = np.zeros((D, D, b_cap_h), dtype=np.float32)
    halo_idx = np.zeros((D, t_bnd_max), dtype=np.int32)
    own_stages = []
    for d in range(D):
        T = touched[d]
        for dp in range(D):
            s = S[d][dp]
            k = len(s)
            send_slot[d, dp, :k] = np.searchsorted(T, s)
            send_mask[d, dp, :k] = 1.0
            # halo direction: OWNER dp sends X rows Sh[d][dp] to shard d
            sh = Sh[d][dp]
            kh = len(sh)
            halo_send_slot[dp, d, :kh] = (sh - dp * n_own).astype(np.int32)
            halo_mask[dp, d, :kh] = 1.0
        # halo: shard d receives from owner dp the rows Sh[d][dp] at
        # recv[dp, :|Sh|]; compact T_bnd index t lives at flat slot
        # dp*b_cap_h + rank within Sh[d][owner(t)]
        owner_of = touched_bnd[d] // n_own
        for dp in range(D):
            sel = np.nonzero(owner_of == dp)[0]
            halo_idx[d, sel] = (dp * b_cap_h + np.arange(len(sel))).astype(
                np.int32
            )
    # owner-side combine: shard dp receives partial rows for owned
    # vertices from every source d at flat slot d*b_cap + rank(S[d][dp])
    for dp in range(D):
        rows = []  # (owned_local_vertex, flat_slot)
        for d in range(D):
            s = S[d][dp]
            loc = s - dp * n_own
            rows.append(
                np.stack([loc, d * b_cap + np.arange(len(s))], axis=1)
                if len(s)
                else np.zeros((0, 2), dtype=np.int64)
            )
        rows = np.concatenate(rows, axis=0) if rows else np.zeros((0, 2), np.int64)
        order = np.argsort(rows[:, 0], kind="stable")
        rows = rows[order]
        indptr = np.zeros(n_own + 1, dtype=np.int64)
        np.add.at(indptr, rows[:, 0] + 1, 1)
        np.cumsum(indptr, out=indptr)
        own_stages.append(
            build_tree(indptr, rows[:, 1].astype(np.int32), D * b_cap, 4, fan)
        )

    int_levels, int_fi, int_fm, _ = _stack_stages(int_stages, e_int_pad, fan)
    bnd_levels, bnd_fi, bnd_fm, _ = _stack_stages(bnd_stages, e_bnd_pad, fan)
    v_levels, v_fi, v_fm, _ = _stack_stages(v_stages, t_max, fan)
    own_levels, own_fi, own_fm, _ = _stack_stages(own_stages, n_own, fan)

    degE = np.zeros((D, e_pad, 1), dtype=np.float32)
    for d in range(D):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        degE[d, : e1 - e0] = hg.degE[e0:e1]
    degV_own = np.ones((D, n_own, 1), dtype=np.float32)
    degv = hg.degV
    for d in range(D):
        lo = d * n_own
        hi = min((d + 1) * n_own, hg.num_nodes)
        if hi > lo:
            degV_own[d, : hi - lo] = degv[lo:hi]

    plan = HaloPlan(
        n_shards=D,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
        n_own=n_own,
        t_max=t_max,
        t_bnd_max=t_bnd_max,
        b_cap=b_cap,
        b_cap_h=b_cap_h,
        e_pad=e_pad,
        e_int_pad=e_int_pad,
        e_bnd_pad=e_bnd_pad,
        edge_bounds=bounds,
        int_levels=int_levels, int_final_idx=int_fi, int_final_mask=int_fm,
        bnd_levels=bnd_levels, bnd_final_idx=bnd_fi, bnd_final_mask=bnd_fm,
        asm_idx=asm_idx, e_counts=e_counts,
        v_levels=v_levels, v_final_idx=v_fi, v_final_mask=v_fm,
        send_slot=send_slot, send_mask=send_mask,
        halo_send_slot=halo_send_slot, halo_mask=halo_mask, halo_idx=halo_idx,
        own_levels=own_levels, own_final_idx=own_fi, own_final_mask=own_fm,
        degE=degE, degV_own=degV_own,
        n_interior=n_interior, n_local_edges=n_local,
        local_form=local_form, int_aligned=int_aligned,
    )
    plan.device()
    return plan
