"""Ahead-of-time tiling planner: static-shape schedules for the fused kernels.

This is the descendant of the reference's workload balancer (CPU
schedule builder ``include/taskbalancer/balancer_kernel.cuh:229-259``
and its Python twin ``HyperGsys/balancer.py:15-33``).  The reference
chops each hyperedge's nnz range into chunks of ≤ ``ngs`` entries and
emits a *quadratic pairing* of chunks so each CUDA task has bounded work
and combines partials through atomicAdd.  Under jit there are no dynamic
shapes, so the plan here is different:

* the same chunk boundaries (⌈nnz_e/ngs⌉ chunks per hyperedge e) become
  rows of a padded ELL table — every chunk is exactly ``ngs`` slots wide,
  masked past its true size;
* partial sums of sibling chunks are combined by a *deterministic sorted
  segment reduction* over the (non-decreasing) chunk→edge map instead of
  atomics — no quadratic pairing, no races, exact fp reproducibility;
* the same structure is built for the vertex side (rows of H), so the
  E→V stage is also a gather + sorted segment sum.

Everything is plain integer NumPy on the host, computed once per graph
(the planner is pure — the C++ twin in ``csrc/`` produces bit-identical
tables; see :mod:`hypergef.sparse.native`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ----------------------------------------------------------------------
# Routing constants of the backend ladder (plan_aggregation) and of the
# aligned bucket-merge cost model.  They were derived on another
# accelerator and are NOT yet calibrated on the GPU; they stay only so
# the ladder routes somewhere until a measured per-device table
# replaces them.
# ----------------------------------------------------------------------
# H entries (N·E) up to which the dense two-matmul backend is chosen.
DENSE_AUTO_THRESHOLD = 32_000_000
# Beyond that, an unstructured graph still streams the int8 incidence
# through the dense backend while N·E < DENSE_STREAM_VS_GATHER · nnz
# (the table is sparse enough that the stream beats per-nnz gathers) and
# N·E stays under the table-size cap.
DENSE_STREAM_VS_GATHER = 2000
DENSE_STREAM_MAX_ENTRIES = 800_000_000
# nnz up to which the cumsum backend is preferred over the gather tree
# on graphs with no exploitable structure.
CUMSUM_PREFER_NNZ = 1 << 17
# N² entries up to which the precomputed propagation matrix is built
# (bf16 table size bound).
PRECOMP_MAX_ENTRIES = 80_000_000
# Aligned bucket merging: fixed cost of one dispatched kernel, kernels
# per band bucket (window gather + band dot), the charge per padded
# spill slot, and the unit costs of one streamed band-table element and
# one streamed feature byte.
ALIGNED_KERNEL_FIXED_S = 4.4e-6
ALIGNED_KERNELS_PER_BUCKET = 2
ALIGNED_SPILL_PAD_GATHER_S = 4e-9
MERGE_BAND_S_PER_ELEM = 1.0 / 768e9
MERGE_STREAM_S_PER_BYTE = 1.0 / 732e9


class EllTable(NamedTuple):
    """Padded ELL chunk table for one aggregation direction.

    ``gather_idx[c, k]`` is the source row to read for slot k of chunk c
    (0 for padded slots — always masked), ``mask[c, k]`` is 1.0 for live
    slots, ``seg_ids[c]`` is the (non-decreasing) output segment of chunk
    c (== num_segments for padded chunks, which sorted segment-sum
    drops), and ``seg_ptr`` maps each output segment to its chunk range.
    """

    gather_idx: np.ndarray  # [C_pad, ngs] int32
    mask: np.ndarray  # [C_pad, ngs] f32
    seg_ids: np.ndarray  # [C_pad] int32
    seg_ptr: np.ndarray  # [num_segments+1] int64 (chunk ranges, unpadded region)
    num_chunks: int  # true number of chunks (≤ C_pad)
    num_segments: int
    ngs: int


def build_ell(
    indptr: np.ndarray,
    indices: np.ndarray,
    ngs: int,
    pad_chunks_to: int = 8,
) -> EllTable:
    """Chunk CSR rows into an ELL table with ≤ ``ngs`` entries per chunk.

    Chunk boundaries are identical to the reference's ``balan_key``
    construction (``balancer.py:19-25``): row r with nnz_r entries
    contributes ⌈nnz_r/ngs⌉ chunks starting every ``ngs`` entries.
    """
    if ngs <= 0:
        raise ValueError("ngs must be positive")
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    num_rows = indptr.shape[0] - 1
    row_len = np.diff(indptr)
    chunks_per_row = -(-row_len // ngs)  # ceil
    num_chunks = int(chunks_per_row.sum())
    seg_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(chunks_per_row, out=seg_ptr[1:])

    c_pad = max(_round_up(max(num_chunks, 1), pad_chunks_to), pad_chunks_to)
    gather_idx = np.zeros((c_pad, ngs), dtype=np.int32)
    mask = np.zeros((c_pad, ngs), dtype=np.float32)
    seg_ids = np.full(c_pad, num_rows, dtype=np.int32)

    if num_chunks:
        # chunk → owning row (vectorized via searchsorted on the chunk ptr)
        chunk_row = (
            np.searchsorted(seg_ptr, np.arange(num_chunks, dtype=np.int64), side="right") - 1
        ).astype(np.int64)
        seg_ids[:num_chunks] = chunk_row.astype(np.int32)
        # start offset of each chunk inside the CSR nnz array
        chunk_rank = np.arange(num_chunks, dtype=np.int64) - seg_ptr[chunk_row]
        chunk_start = indptr[chunk_row] + chunk_rank * ngs
        chunk_size = np.minimum(indptr[chunk_row + 1] - chunk_start, ngs)
        # scatter nnz entries into the padded table
        slot = np.arange(ngs, dtype=np.int64)[None, :]
        src = chunk_start[:, None] + slot  # [num_chunks, ngs]
        live = slot < chunk_size[:, None]
        src_clipped = np.minimum(src, indices.shape[0] - 1 if indices.size else 0)
        gather_idx[:num_chunks] = np.where(live, indices[src_clipped], 0)
        mask[:num_chunks] = live.astype(np.float32)

    return EllTable(
        gather_idx=gather_idx,
        mask=mask,
        seg_ids=seg_ids,
        seg_ptr=seg_ptr,
        num_chunks=num_chunks,
        num_segments=num_rows,
        ngs=ngs,
    )


def choose_ngs(
    row_len: np.ndarray,
    min_ngs: int = 2,
    max_ngs: int = 512,
    chunk_overhead: float = 8.0,
    step: int = 8,
) -> int:
    """Analytic replacement for the reference's hand-tuned per-dataset
    ``partition_dict`` (``hypergraph.py:74-76``).

    Minimizes a simple cost model: ``padded_slots + chunk_overhead *
    num_chunks`` — padded slots model wasted gather work (each padded
    slot is a real row gather at level 0), the per-chunk constant models
    the combine-tree / segment bookkeeping.  Candidates are multiples of
    8 (f32 sublane count) plus {2, 4}: low-average-degree graphs
    (e.g. citation hypergraphs, deg ≈ 4.3) pay ~1.9× extra gathers when
    padded to 8 — the dominant cost in the gather-latency-bound random
    regime.
    """
    row_len = np.asarray(row_len, dtype=np.int64)
    if row_len.size == 0:
        return min_ngs
    candidates = [c for c in (2, 4) if c >= min_ngs]
    candidates += list(range(max(min_ngs, 8), max_ngs + 1, step))
    best, best_cost = candidates[0], np.inf
    for ngs in candidates:
        chunks = -(-row_len // ngs)
        cost = float((chunks * ngs).sum()) + chunk_overhead * float(chunks.sum())
        if cost < best_cost:
            best, best_cost = ngs, cost
    return best


# ----------------------------------------------------------------------
# reduction-tree schedule (the scatter-free combine structure)
# ----------------------------------------------------------------------
class TreeLevel(NamedTuple):
    gather_idx: np.ndarray  # [C, fan] int32 — rows of the previous level
    mask: np.ndarray  # [C, fan] f32


class TreeStage(NamedTuple):
    """One aggregation direction as a fixed-fan-in reduction tree.

    Applying the stage to x [num_inputs, F]:

        p = x
        for (g, m) in levels:  p = (take(p, g) * m[:,:,None]).sum(1)
        y = take(p, final_idx) * final_mask[:,None]        # [S, F]

    Level 0 gathers source rows (ELL chunks of the CSR); deeper levels
    combine sibling partials of the same output segment, fan at a time,
    so arbitrarily long rows (power-law tails) cost depth log_fan —
    every op is a dense gather/reshape/sum, no scatter, no cumsum.
    """

    levels: tuple  # tuple[TreeLevel]
    final_idx: np.ndarray  # [S] int32 — last-level row per segment (0 if empty)
    final_mask: np.ndarray  # [S] f32 — 0 for empty segments
    counts: np.ndarray  # [S] f32 — members per segment (for mean)
    num_inputs: int
    num_segments: int


def build_tree(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_inputs: int,
    ngs: int = 8,
    fan: int = 8,
) -> TreeStage:
    """Build the reduction-tree schedule for one CSR direction."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    num_rows = indptr.shape[0] - 1
    row_len = np.diff(indptr)

    # ---- level 0: ELL chunks over the CSR nnz --------------------------
    t0 = build_ell(indptr, indices, ngs, pad_chunks_to=1)
    levels = [TreeLevel(gather_idx=t0.gather_idx, mask=t0.mask)]
    # rows-per-segment at the current level
    seg_counts = (-(-row_len // ngs)).astype(np.int64)  # chunks per segment

    # ---- deeper levels: combine fan siblings of the same segment -------
    while seg_counts.max(initial=0) > 1:
        new_counts = -(-seg_counts // fan)
        c_new = int(new_counts.sum())
        prev_ptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(seg_counts, out=prev_ptr[1:])
        new_ptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(new_counts, out=new_ptr[1:])
        g = np.zeros((max(c_new, 1), fan), dtype=np.int32)
        m = np.zeros((max(c_new, 1), fan), dtype=np.float32)
        if c_new:
            new_id = np.arange(c_new, dtype=np.int64)
            seg_of_new = (
                np.searchsorted(new_ptr, new_id, side="right") - 1
            )
            rank = new_id - new_ptr[seg_of_new]
            start = prev_ptr[seg_of_new] + rank * fan
            size = np.minimum(prev_ptr[seg_of_new + 1] - start, fan)
            slot = np.arange(fan, dtype=np.int64)[None, :]
            src = start[:, None] + slot
            live = slot < size[:, None]
            g[:] = np.where(live, np.minimum(src, max(int(prev_ptr[-1]) - 1, 0)), 0)
            m[:] = live.astype(np.float32)
        levels.append(TreeLevel(gather_idx=g, mask=m))
        seg_counts = new_counts

    # ---- final map: one row (or none) per segment ----------------------
    last_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(seg_counts, out=last_ptr[1:])
    final_idx = np.minimum(last_ptr[:-1], max(int(last_ptr[-1]) - 1, 0)).astype(
        np.int32
    )
    final_mask = (seg_counts > 0).astype(np.float32)
    return TreeStage(
        levels=tuple(levels),
        final_idx=final_idx,
        final_mask=final_mask,
        counts=row_len.astype(np.float32),
        num_inputs=num_inputs,
        num_segments=num_rows,
    )


@dataclasses.dataclass
class TreePlan:
    """Two-direction reduction-tree schedule (the production plan).

    ``edge_stage`` computes V→E (rows = hyperedges, inputs = vertices),
    ``vertex_stage`` computes E→V.  Each stage is also the exact adjoint
    of the other (H vs Hᵀ), which the ops layer exploits for a
    scatter-free custom VJP.
    """

    edge_stage: TreeStage
    vertex_stage: TreeStage
    num_nodes: int
    num_edges: int
    _device: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @staticmethod
    def _stage_device(st):
        import jax.numpy as jnp

        if isinstance(st, AlignedStageB):
            from hypergef.ops.tree import (
                AlignedBucketDev, AlignedSpillDev, AlignedStageBDev,
            )

            # tables stay int8 on DEVICE too — the cast to bf16 happens
            # inside the jitted apply, where XLA fuses the convert into
            # the dot operand read (half the streamed band bytes)
            return AlignedStageBDev(
                buckets=tuple(
                    AlignedBucketDev(
                        b_dense=jnp.asarray(b.b_dense),
                        win_block=jnp.asarray(b.win_block),
                    )
                    for b in st.buckets
                ),
                spills=tuple(
                    AlignedSpillDev(
                        b_spill=jnp.asarray(s.b_spill),
                        spill_src=jnp.asarray(s.spill_src),
                    )
                    for s in st.spills
                ),
                base_slot=jnp.asarray(st.base_slot),
                spill_slot=jnp.asarray(st.spill_slot),
                counts=jnp.asarray(st.counts),
                num_inputs=st.num_inputs,
                num_segments=st.num_segments,
                group_rows=st.group_rows,
                block_rows=st.block_rows,
                # static identity detection → skip assembly gathers in
                # the apply (one fewer kernel each)
                base_identity=bool(
                    np.array_equal(st.base_slot,
                                   np.arange(len(st.base_slot)))),
                # identity requires the single bucket to cover EVERY
                # group: a trailing non-spilling group's zero-row slot
                # (== m_total) would continue the arange and alias
                spill_identity=bool(
                    len(st.spills) == 1
                    and st.spills[0].b_spill.shape[0] == len(st.spill_slot)
                    and np.array_equal(st.spill_slot,
                                       np.arange(len(st.spill_slot)))),
            )
        if isinstance(st, AlignedStage):
            from hypergef.ops.tree import AlignedStageDev

            # transfer int8, cast on device: halves the host->device
            # bytes for multi-GB band tables
            return AlignedStageDev(
                b_dense=jnp.asarray(st.b_dense).astype(jnp.bfloat16),
                win_block=jnp.asarray(st.win_block),
                spill_src=jnp.asarray(st.spill_src),
                b_spill=jnp.asarray(st.b_spill).astype(jnp.bfloat16),
                counts=jnp.asarray(st.counts),
                num_inputs=st.num_inputs,
                num_segments=st.num_segments,
                group_rows=st.group_rows,
                window_blocks=st.window_blocks,
            )
        if isinstance(st, TiledStage):
            from hypergef.ops.tree import TiledStageDev

            m_dense = None
            if st.form == "multihot_precomp":
                # host-build the dense multihot blocks once: streaming
                # batched matmul form with zero in-kernel compare work
                n_tiles, c_max, ngs = st.gidx.shape
                m = np.zeros((n_tiles, c_max, st.tile_rows), np.float32)
                t_g = np.broadcast_to(
                    np.arange(n_tiles)[:, None, None], st.gidx.shape
                )
                c_g = np.broadcast_to(
                    np.arange(c_max)[None, :, None], st.gidx.shape
                )
                np.add.at(m, (t_g, c_g, st.gidx), st.mask)
                m_dense = jnp.asarray(m, dtype=jnp.bfloat16)
            return TiledStageDev(
                gidx=jnp.asarray(st.gidx),
                mask=jnp.asarray(st.mask),
                combine=TreePlan._stage_device(st.combine),
                counts=jnp.asarray(st.counts),
                tile_rows=st.tile_rows,
                form=st.form,
                m_dense=m_dense,
            )
        return (
            tuple((jnp.asarray(l.gather_idx), jnp.asarray(l.mask)) for l in st.levels),
            jnp.asarray(st.final_idx),
            jnp.asarray(st.final_mask),
            jnp.asarray(st.counts),
        )

    def device(self):
        """Returns (edge_stage_pytree, vertex_stage_pytree) of jnp arrays."""
        if self._device is None:
            import jax

            # eager build even under a trace — traced constants cached
            # here would leak out of the transformation scope
            with jax.ensure_compile_time_eval():
                e = self._stage_device(self.edge_stage)
                v = self._stage_device(self.vertex_stage)
            self._device = (e, v)
        return self._device

    def depth(self):
        return (len(self.edge_stage.levels), len(self.vertex_stage.levels))

    def as_device(self):
        """Jit-argument pytree twin (:class:`ops.devplan.DevTreePlan`) —
        pass it as an operand instead of closing over the plan, so the
        device arrays are not embedded in the program as constants."""
        from hypergef.ops.devplan import DevTreePlan

        return DevTreePlan(self.device())


# Cache-blocked level 0 is OPT-IN: XLA-level dynamic-slice tiling keeps
# the sliced tile in device memory, so per-row gathers cost the same as
# untiled; true cache blocking needs kernel-level control.
TILED_SOURCE_THRESHOLD = 1 << 62
TILE_ROWS = 16_384


def plan_tree(hg, ngs: Optional[int] = None, ngs_vertex: Optional[int] = None,
              fan: int = 8, tiled_threshold: int = TILED_SOURCE_THRESHOLD,
              tile_rows: int = TILE_ROWS) -> TreePlan:
    """Build the two-direction reduction-tree plan for a hypergraph.

    Directions whose *source* row count exceeds ``tiled_threshold`` get
    a cache-blocked (tiled) level 0.
    """
    if ngs is None:
        ngs = choose_ngs(hg.edge_sizes(), min_ngs=4, max_ngs=64, step=4)
    if ngs_vertex is None:
        ngs_vertex = choose_ngs(hg.vertex_degrees(), min_ngs=4, max_ngs=64, step=4)
    if hg.num_nodes > tiled_threshold:
        e_stage = build_tiled_tree(
            hg.ht_indptr, hg.ht_indices, hg.num_nodes, ngs, fan, tile_rows
        )
    else:
        e_stage = build_tree(hg.ht_indptr, hg.ht_indices, hg.num_nodes, ngs, fan)
    if hg.num_edges > tiled_threshold:
        v_stage = build_tiled_tree(
            hg.h_indptr, hg.h_indices, hg.num_edges, ngs_vertex, fan, tile_rows
        )
    else:
        v_stage = build_tree(hg.h_indptr, hg.h_indices, hg.num_edges, ngs_vertex, fan)
    plan = TreePlan(
        edge_stage=e_stage,
        vertex_stage=v_stage,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
    )
    plan.device()  # materialize eagerly, outside any trace
    return plan


@dataclasses.dataclass
class DenseIncidence:
    """Dense |V|×|E| incidence table for the two-matmul dense backend.

    For small graphs two dense matmuls replace all gather orchestration
    — the analogue of the reference's kernel auto-select picking the
    dense-ish shm path for dense rows (hgnnAgg.cuh:1138-1157).

    int8 storage (the default): the i8→bf16 convert fuses into the
    ``dot_general`` operand read, so the table streams at its int8 byte
    size.  Entries are exact 0/1 incidence counts, so no precision
    change vs bf16.  This also extends the dense regime to mid-size
    *unstructured* graphs that the gather-bound sparse paths serve
    poorly (see ``DENSE_STREAM_VS_GATHER``).

    Opt-in packed int4 form (``dtype=jnp.int4``): **host-packed nibble
    pairs in an int8 carrier** of shape [N, ceil(E/2)] (low nibble =
    even column), re-viewed as S4 inside the program via
    ``lax.bitcast_convert_type`` behind optimization barriers (XLA
    mis-constant-folds S4 bitcasts of closure constants).  The unpack
    runs inside every consuming program, so it is not the default.
    """

    h: "object"  # jnp int8: counts [N, E] or packed nibbles [N, ceil(E/2)]
    num_nodes: int
    num_edges: int
    packed: bool = False  # True → ``h`` is the int4 nibble carrier

    @classmethod
    def from_hypergraph(cls, hg, dtype=None):
        """Build the device table.  ``dtype=None`` → int8 (the
        default); ``jnp.int4`` → the packed nibble-carrier
        form (explicit opt-in — see class docstring); ``jnp.int8`` /
        ``jnp.bfloat16`` force unpacked tables."""
        import jax.numpy as jnp
        import numpy as np

        arr = hg.to_scipy().toarray()
        amax = int(arr.max()) if arr.size else 0
        if dtype == jnp.int4:
            if amax > 7:
                raise MemoryError(
                    ">7 duplicate incidences in one (vertex, edge) pair "
                    "— the packed int4 form cannot represent this graph"
                )
            e_pad = -(-hg.num_edges // 2) * 2
            pad = np.zeros((hg.num_nodes, e_pad), np.int8)
            pad[:, : hg.num_edges] = arr
            pk = (pad[:, 0::2] & 0xF) | (pad[:, 1::2] << 4)
            return cls(
                h=jnp.asarray(pk.astype(np.int8)),
                num_nodes=hg.num_nodes,
                num_edges=hg.num_edges,
                packed=True,
            )
        dtype = jnp.int8 if dtype is None else dtype
        if dtype == jnp.int8:
            if amax > 127:
                raise MemoryError(
                    ">127 duplicate incidences in one (vertex, edge) pair "
                    "— not an incidence matrix?"
                )
            arr = arr.astype(np.int8)
        h = jnp.asarray(arr, dtype=dtype)
        return cls(h=h, num_nodes=hg.num_nodes, num_edges=hg.num_edges)

    def table(self):
        """The [N, E] integer operand for the two-stage dots.

        For the packed form this re-views the nibble carrier as S4 and
        should run under a trace/jit; ``ops/fused.py`` does so by
        wrapping the dense dots in inline jits.
        """
        if not self.packed:
            return self.h
        import jax
        import jax.numpy as jnp

        # pre-barrier: XLA mis-constant-folds S4 bitcasts of closure-
        # captured carriers (wrong nibbles); post-barrier: materialize
        # the S4 table once (rationale in ops/fused._dense_dot)
        h = jax.lax.optimization_barrier(self.h)
        h4 = jax.lax.bitcast_convert_type(h, jnp.int4)
        h4 = jax.lax.optimization_barrier(h4.reshape(self.num_nodes, -1))
        return h4[:, : self.num_edges]


@dataclasses.dataclass
class AggregationPlan:
    """Everything the backend dispatcher needs, built once per graph.

    ``preferred_backend`` implements the auto heuristic: dense matmuls
    for small incidence matrices, sparse forms otherwise.
    """

    tree: "TreePlan"
    dense: Optional[DenseIncidence] = None
    tile: Optional["TilePlan"] = None
    bsr: Optional[object] = None  # BsrPlan (sparse.bsr)
    precomp: Optional[DensePrecomp] = None
    multihot: Optional["TreePlan"] = None  # multihot-matmul TreePlan
    aligned: Optional["TreePlan"] = None  # segment-aligned banded TreePlan
    preferred_backend: str = "tree"


@dataclasses.dataclass
class DensePrecomp:
    """Precomputed A = diag(degV)·H·diag(degE)·Hᵀ in bf16 (sum aggr).

    bf16 is deliberate: per-row int8 quantization of A would halve the
    streamed bytes, but its rank-1-rescaled error measures 1.25e-2 of
    the output scale at cora size (bf16: 2.3e-3), over the reference's
    1e-2 tier-2 tolerance (check.cuh:47).
    """

    a: "object"  # jnp [N, N] bf16
    num_nodes: int

    @classmethod
    def from_hypergraph(cls, hg):
        import jax.numpy as jnp

        import jax

        h = jnp.asarray(hg.to_scipy().toarray(), dtype=jnp.float32)
        left = jnp.asarray(hg.degV) * h  # [N, E]
        right = (jnp.asarray(hg.degE) * h.T)  # [E, N]
        # full f32: a GPU may otherwise round this product through TF32
        a = jnp.matmul(left, right, precision=jax.lax.Precision.HIGHEST)
        a = a.astype(jnp.bfloat16)
        return cls(a=a, num_nodes=hg.num_nodes)


def plan_aggregation(
    hg,
    dense_threshold: int = DENSE_AUTO_THRESHOLD,
    with_tile: bool = False,
    with_bsr: Optional[bool] = None,
    with_precomp: bool = True,
    with_multihot: Optional[bool] = None,
    with_aligned: bool = True,
    bsr_fill_threshold: float = 0.02,
    multihot_tile_rows: int = 256,
    ngs: Optional[int] = None,
    fan: int = 8,
) -> AggregationPlan:
    """Build the full aggregation plan for a hypergraph (host-side, once).

    Auto-selection ladder (the reference's kernel auto-select analogue),
    with the routing constants at the top of this module: precomp or
    dense matmuls for small H; the aligned band form for
    community-sorted graphs; the int8 dense stream for mid-size
    unstructured ones; cumsum for small unstructured ones; tree
    otherwise.  BSR only on explicit request (``with_bsr=True``).
    """
    tree = plan_tree(hg, ngs=ngs, fan=fan)
    dense = None
    bsr = None
    precomp = None
    preferred = "tree"
    if with_precomp and hg.num_nodes * hg.num_nodes <= PRECOMP_MAX_ENTRIES:
        precomp = DensePrecomp.from_hypergraph(hg)
    if hg.num_nodes * hg.num_edges <= dense_threshold:
        dense = DenseIncidence.from_hypergraph(hg)
        preferred = "dense"
    elif with_bsr:
        # BSR is not on the auto ladder: hyperedge blocks rarely reach
        # break-even fill even under community reordering (the
        # ground-truth ordering of the SBM-60k workload yields ~0.1%
        # fill).  The aligned banded form is the structured-graph path.
        # Explicit opt-in (with_bsr=True) keeps the backend available.
        try:
            from hypergef.sparse.bsr import plan_bsr

            cand = plan_bsr(hg, reorder=True)
            if cand.fill_fraction() >= bsr_fill_threshold or with_bsr:
                bsr = cand
                preferred = "bsr"
        except MemoryError:
            pass
    if precomp is not None and hg.num_nodes <= 2 * hg.num_edges:
        # one matmul beats everything when applicable (sum aggr, frozen
        # Wdiag — the dispatcher falls through otherwise) AND reading A
        # (N² bf16) costs less than the dense path's two H reads
        # (2·N·E): i.e. N ≲ 2E.  Graphs with few giant hyperedges
        # (20news-like, N ≫ E) stay on the dense two-stage path.
        preferred = "precomp"
    aligned = None
    if with_aligned and dense is None and preferred in ("tree", "bsr"):
        # community-sorted graphs beyond the dense regime: the aligned
        # banded form replaces ALL per-nnz gathers with streamed band
        # matmuls.  aligned_spill_stats is a cheap host pre-pass — only
        # build when the graph's ordering supports it.
        try:
            aligned = plan_aligned(hg)
            preferred = "aligned"
        except (ValueError, MemoryError):
            aligned = None  # not community-sorted at wb=8
        if aligned is None:
            # E≫V (or V≫E) graphs: a community spans many 128-row blocks
            # of the larger side, so the default 8-block window spills
            # even on perfectly sorted inputs (yelp: E/V≈13 → E→V spill
            # 0.59 at wb=8 but 0.09 at wb=32).  The
            # bucketed optimizer prices per-group widths, so a wider cap
            # only costs where it pays.
            ratio = max(hg.num_edges, hg.num_nodes) / max(
                1, min(hg.num_edges, hg.num_nodes))
            if ratio >= 4:
                try:
                    aligned = plan_aligned(hg, window_blocks=32)
                    preferred = "aligned"
                except (ValueError, MemoryError):
                    aligned = None
    if (
        dense is None
        and dense_threshold > 0
        and preferred == "tree"
        and hg.num_nodes * hg.num_edges <= DENSE_STREAM_MAX_ENTRIES
        and hg.num_nodes * hg.num_edges < DENSE_STREAM_VS_GATHER * max(hg.nnz, 1)
    ):
        # unstructured graph (aligned refused), mid-size incidence:
        # streaming the int8 H beats per-nnz gathers (constants above)
        dense = DenseIncidence.from_hypergraph(hg)
        preferred = "dense"
    if preferred == "tree" and hg.nnz <= CUMSUM_PREFER_NNZ:
        # Small uniform-random graphs beyond the dense regime: the
        # cumsum backend (block-scan prefix, ops/segments._prefix_sum)
        # is preferred to the gather tree.  The tree plan stays
        # available for explicit override / max aggr.
        preferred = "cumsum"
    multihot = None
    if with_multihot or (
        with_multihot is None and dense is None and preferred == "tree"
    ):
        # beyond the dense regime the multihot matmul form is a
        # candidate sparse path; build it so backend="multihot" (and the
        # autotuner) can use it.  Its work scales with
        # fragmentation·nnz·tile_rows, so it suits clustered/reordered
        # graphs (fragmentation → 1).
        try:
            multihot = plan_multihot(hg, tile_rows=multihot_tile_rows, fan=fan)
        except MemoryError:
            multihot = None  # skewed per-tile chunk counts → padding blowup
    tile = plan_tiles(hg) if with_tile else None
    return AggregationPlan(
        tree=tree, dense=dense, tile=tile, bsr=bsr, precomp=precomp,
        multihot=multihot, aligned=aligned,
        preferred_backend=preferred,
    )


class TiledStage(NamedTuple):
    """Tree stage whose level 0 is cache-blocked over the source rows.

    Level-0 gathers are the only *random* gathers in a reduction tree
    (deeper levels read near-consecutive runs); for source arrays larger
    than on-chip memory each random row gather pays device-memory
    latency.  Cutting level-0 chunks at source-tile boundaries (CSR rows
    are column-sorted, so each chunk's sources are contiguous in tile
    space) lets the op gather from one dynamically-sliced tile at a
    time.

    ``form``: "gather" (per-slot gathers from the sliced tile) or
    "multihot"/"multihot_batched" (tile-local multihot bf16 matmul —
    see :func:`hypergef.ops.tree._apply_tiled_multihot`).
    """

    gidx: np.ndarray  # [n_tiles, c_max, ngs] int32 — tile-LOCAL source rows
    mask: np.ndarray  # [n_tiles, c_max, ngs] f32
    combine: "TreeStage"  # over the flat [n_tiles*c_max] partials
    counts: np.ndarray  # [num_segments] f32 — members per segment (mean)
    tile_rows: int
    num_inputs: int
    num_segments: int
    form: str = "gather"

    def fragmentation(self) -> float:
        """chunks / ideal chunks (1.0 = every chunk full inside one tile;
        random graphs with degree ≪ tiles approach ngs).  The multihot
        compare cost scales with this factor — the auto-select signal."""
        ngs = self.gidx.shape[2]
        live = float(self.mask.sum())
        if live == 0:
            return 1.0
        chunks = float((self.mask.sum(axis=2) > 0).sum())
        return chunks / max(live / ngs, 1.0)


def build_tiled_tree(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_inputs: int,
    ngs: int = 8,
    fan: int = 8,
    tile_rows: int = 16384,
    form: str = "gather",
    pad_limit: int = 1 << 26,
    combine_form: str = "tree",
    combine_tile_rows: int = 256,
) -> TiledStage:
    """Build a stage whose level-0 chunks are cut at source-tile
    boundaries and grouped per tile.

    ``combine_form``: "tree" (plain gather tree over the flat partials)
    or a multihot form — then the combine is a NESTED tiled stage whose
    level 0 is itself a multihot matmul over partial tiles.  On
    clustered graphs each segment's chunks are near-contiguous in flat
    position, so the nested stage has fragmentation ≈ 1 and replaces the
    combine's ~C random gathers (the dominant cost once level 0 is a
    matmul) with streaming matmul work.

    Raises ``MemoryError`` when the padded [n_tiles, c_max, ngs] table
    would exceed ``pad_limit`` entries (skewed per-tile chunk counts pad
    every tile to the hottest one — a power-law hazard)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    num_rows = indptr.shape[0] - 1
    nnz = indices.shape[0]
    n_tiles = max(-(-num_inputs // tile_rows), 1)
    row_of = np.repeat(np.arange(num_rows, dtype=np.int64), np.diff(indptr))
    tile_of = indices // tile_rows

    if nnz:
        # CSR columns are sorted within each row → (row, tile) runs are
        # contiguous in nnz order.  A new chunk starts at each run start
        # and every ngs entries within a run.
        new_run = np.ones(nnz, dtype=bool)
        new_run[1:] = (row_of[1:] != row_of[:-1]) | (tile_of[1:] != tile_of[:-1])
        run_starts = np.nonzero(new_run)[0]
        run_id = np.cumsum(new_run) - 1
        pos_in_run = np.arange(nnz, dtype=np.int64) - run_starts[run_id]
        slot = pos_in_run % ngs
        chunk_first = slot == 0
        chunk_id = np.cumsum(chunk_first) - 1  # [nnz]
        n_chunks = int(chunk_id[-1]) + 1
        first_idx = np.nonzero(chunk_first)[0]
        chunk_tile = tile_of[first_idx]
        chunk_row = row_of[first_idx]
        per_tile = np.bincount(chunk_tile, minlength=n_tiles)
        c_max = max(int(per_tile.max(initial=0)), 1)
        if n_tiles * c_max * ngs > pad_limit:
            raise MemoryError(
                f"tiled stage padding blowup: {n_tiles} tiles x c_max {c_max} "
                f"x ngs {ngs} > pad_limit {pad_limit}"
            )
        # compact rank of each chunk within its tile (chunk order is
        # row-major; stable sort by tile preserves row order per tile)
        order = np.argsort(chunk_tile, kind="stable")
        rank_in_tile = np.zeros(n_chunks, dtype=np.int64)
        prev_count = np.zeros(n_tiles + 1, dtype=np.int64)
        np.cumsum(per_tile, out=prev_count[1:])
        rank_in_tile[order] = np.arange(n_chunks, dtype=np.int64) - prev_count[
            chunk_tile[order]
        ]
        flat_pos = chunk_tile * c_max + rank_in_tile
        gidx = np.zeros((n_tiles, c_max, ngs), dtype=np.int32)
        mask = np.zeros((n_tiles, c_max, ngs), dtype=np.float32)
        t_of_entry = chunk_tile[chunk_id]
        r_of_entry = rank_in_tile[chunk_id]
        gidx[t_of_entry, r_of_entry, slot] = (
            indices - tile_of * tile_rows
        ).astype(np.int32)
        mask[t_of_entry, r_of_entry, slot] = 1.0
        # combine CSR: for each segment (row), its chunks' flat positions
        seg_order = np.lexsort((flat_pos, chunk_row))
        comb_indices = flat_pos[seg_order].astype(np.int32)
        comb_indptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.add.at(comb_indptr, chunk_row + 1, 1)
        np.cumsum(comb_indptr, out=comb_indptr)
    else:
        c_max = 1
        gidx = np.zeros((n_tiles, 1, ngs), dtype=np.int32)
        mask = np.zeros((n_tiles, 1, ngs), dtype=np.float32)
        comb_indices = np.zeros(0, dtype=np.int32)
        comb_indptr = np.zeros(num_rows + 1, dtype=np.int64)
    if combine_form == "tree":
        combine = build_tree(
            comb_indptr, comb_indices, n_tiles * c_max, ngs=4, fan=fan
        )
    else:
        # nested multihot combine (one level of nesting: its own combine
        # is a plain tree over the per-segment tile partials, fan ≈
        # tiles-touched-per-segment — ~1 on clustered graphs)
        combine = build_tiled_tree(
            comb_indptr, comb_indices, n_tiles * c_max, ngs=4, fan=fan,
            tile_rows=combine_tile_rows, form=combine_form,
            pad_limit=pad_limit, combine_form="tree",
        )
    return TiledStage(
        gidx=gidx,
        mask=mask,
        combine=combine,
        counts=np.diff(indptr).astype(np.float32),
        tile_rows=tile_rows,
        num_inputs=num_inputs,
        num_segments=num_rows,
        form=form,
    )


# per-stage byte budget for the host-precomputed dense multihot blocks
# (bf16).  Above it the precomp form silently downgrades to the
# in-kernel compare form, which has no such footprint.
MULTIHOT_PRECOMP_LIMIT = 256 * 1024 * 1024


def plan_multihot(
    hg,
    tile_rows: int = 256,
    ngs: int = 8,
    fan: int = 8,
    form: str = "multihot",
    precomp_limit_bytes: int = MULTIHOT_PRECOMP_LIMIT,
    combine: str = "auto",
) -> TreePlan:
    """Multihot plan: both aggregation directions as tile-bucketed
    stages whose level 0 is a multihot bf16 matmul per source tile.

    A matmul-form alternative to the reference's fused gather/atomics
    kernel (``hgnnaggr_cuda.cu:14-47``): random row access becomes
    iota-compare + one matmul per tile + streaming tile reads.  Cost
    scales with ``fragmentation()`` — near 1.0 on clustered/reordered
    graphs, up to ``ngs`` on uniform-random ones.
    """
    if combine == "auto":
        # the nested matmul combine pays off exactly when level 0 does
        # (precomp form); the compare forms keep the plain gather tree
        combine = "multihot_precomp" if form == "multihot_precomp" else "tree"
    e_stage = build_tiled_tree(
        hg.ht_indptr, hg.ht_indices, hg.num_nodes, ngs, fan, tile_rows, form,
        combine_form=combine,
    )
    v_stage = build_tiled_tree(
        hg.h_indptr, hg.h_indices, hg.num_edges, ngs, fan, tile_rows, form,
        combine_form=combine,
    )
    if form == "multihot_precomp":
        # downgrade per stage when the dense blocks would not fit
        def _fit(st):
            n_tiles, c_max, _ = st.gidx.shape
            if n_tiles * c_max * st.tile_rows * 2 > precomp_limit_bytes:
                return st._replace(form="multihot")
            return st

        e_stage = _fit(e_stage)
        v_stage = _fit(v_stage)
    plan = TreePlan(
        edge_stage=e_stage,
        vertex_stage=v_stage,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
    )
    plan.device()
    return plan


class AlignedStage(NamedTuple):
    """Segment-aligned banded-multihot stage — the gather-free fast path
    for community-sorted graphs.

    The bottleneck of every gather-based stage is random-row latency,
    and of the tiled multihot stages the per-segment combine/final
    gathers.  This form removes ALL per-nnz and per-segment gathers:

    * output rows are the segments **in order** — group g computes
      segments [g·G, (g+1)·G) directly, so the result is a reshape+slice,
      no final per-segment map;
    * each group reads a contiguous **window** of ``wb`` 128-row source
      blocks (one small block-gather of n_groups·wb block rows — 16 KB+
      rows amortize the latency) and multiplies by a dense 0/1 band
      matrix ``b_dense[g] ∈ [G, wb·128]``;
    * the few entries outside their group's window ("spill": noise
      members, community-boundary crossings) go through one gather of
      spill rows + a second small multihot matmul.

    Cost ∝ streamed bytes (B + spill tables) + spill gathers — on a
    community-sorted graph with s% spill this is ~2·E·W bytes + s·nnz
    gathers.  On unsorted /
    uniform-random graphs spill → 100%: plan_aligned raises unless
    ``allow_spill_heavy``.  Reference semantics: the same fused two-stage
    aggregation as ``hgnnaggr_cuda.cu:14-47``; the banded layout plays
    the part of its shared-memory neighbor-group reuse.
    """

    b_dense: np.ndarray  # [n_groups, G, W] int8 counts (device bf16)
    win_block: np.ndarray  # [n_groups, wb] int32 — source block ids
    spill_src: np.ndarray  # [n_groups, spill_w] int32 (num_inputs = zero row)
    b_spill: np.ndarray  # [n_groups, G, spill_w] int8
    counts: np.ndarray  # [num_segments] f32 — members per segment
    num_inputs: int
    num_segments: int
    group_rows: int  # G
    window_blocks: int  # wb

    @property
    def spill_fraction(self) -> float:
        total = float(self.b_dense.sum() + self.b_spill.sum())
        return float(self.b_spill.sum()) / max(total, 1.0)


ALIGNED_BLOCK = 128  # source block granularity (gather rows of 128·F)


def _aligned_windows(grp, blk, n_groups, nb, wb):
    """Per-group window start block: median member block, clamped.
    Fully vectorized (lexsort + middle-element pick per group) — the
    sweep calls this several times per stage, and at 10M-nnz scale a
    per-group Python loop costs minutes."""
    order = np.lexsort((blk, grp))
    gs, bs = grp[order], blk[order]
    cnt = np.bincount(gs, minlength=n_groups)
    start = np.cumsum(cnt) - cnt
    med = np.zeros(n_groups, dtype=np.int64)
    nz = cnt > 0
    med[nz] = bs[(start + cnt // 2)[nz]]
    o = np.clip(med - wb // 2, 0, max(nb - wb, 0))
    o[~nz] = 0
    return o


def aligned_spill_stats(indptr, indices, num_inputs, group_rows=128,
                        window_blocks=4):
    """Cheap pre-pass: spill fraction this stage would have (no tables)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    S = len(indptr) - 1
    if indices.size == 0 or S == 0:
        return 0.0
    n_groups = -(-S // group_rows)
    nb = max(-(-num_inputs // ALIGNED_BLOCK), window_blocks)
    seg = np.repeat(np.arange(S, dtype=np.int64), np.diff(indptr))
    grp = seg // group_rows
    blk = indices // ALIGNED_BLOCK
    o = _aligned_windows(grp, blk, n_groups, nb, window_blocks)
    og = o[grp]
    spill = (blk < og) | (blk >= og + window_blocks)
    return float(spill.mean())


def build_aligned_stage(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_inputs: int,
    group_rows: int = 128,
    window_blocks: int = 4,
    spill_limit: int = 1 << 28,
) -> AlignedStage:
    """Build one direction's aligned stage (see :class:`AlignedStage`).

    Raises ``MemoryError`` when the padded spill table would exceed
    ``spill_limit`` int8 entries (≈ bytes; spill-heavy graph — use
    tree/multihot).  Default 128M entries: the tables are int8 host /
    bf16 device, so this caps the device-side spill table at 512 MB."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    S = len(indptr) - 1
    G = group_rows
    wb = window_blocks
    W = wb * ALIGNED_BLOCK
    n_groups = max(-(-S // G), 1)
    nb = max(-(-num_inputs // ALIGNED_BLOCK), wb)
    counts = np.diff(indptr).astype(np.float32)
    if indices.size == 0:
        return AlignedStage(
            b_dense=np.zeros((n_groups, G, W), np.int8),
            win_block=np.zeros((n_groups, wb), np.int32),
            spill_src=np.zeros((n_groups, 0), np.int32),
            b_spill=np.zeros((n_groups, G, 0), np.int8),
            counts=counts, num_inputs=num_inputs, num_segments=S,
            group_rows=G, window_blocks=wb,
        )
    seg = np.repeat(np.arange(S, dtype=np.int64), np.diff(indptr))
    grp = seg // G
    row_in_g = seg % G
    blk = indices // ALIGNED_BLOCK
    o = _aligned_windows(grp, blk, n_groups, nb, wb)
    og = o[grp]
    in_win = (blk >= og) & (blk < og + wb)
    # int8 host tables (entries are small membership multiplicities):
    # at 10M-nnz scale the band tables are the plan's dominant memory —
    # f32 would be 4x the bytes.  Dedup-count instead of np.add.at so no
    # int8 accumulation can wrap.
    b_dense = np.zeros((n_groups, G, W), np.int8)
    key = (grp[in_win] * G + row_in_g[in_win]) * W + (
        indices[in_win] - og[in_win] * ALIGNED_BLOCK)
    uk, cnts = np.unique(key, return_counts=True)
    if cnts.size and cnts.max() > 127:
        raise MemoryError("aligned stage: >127 duplicate incidences in one "
                          "(segment, source) pair — not an incidence matrix?")
    b_dense.reshape(-1)[uk] = cnts.astype(np.int8)
    win_block = (o[:, None] + np.arange(wb)[None, :]).astype(np.int32)
    # spill: entries outside the window, grouped and slotted per group
    sp = ~in_win
    sgrp, srow, ssrc = grp[sp], row_in_g[sp], indices[sp]
    order = np.argsort(sgrp, kind="stable")
    sgrp, srow, ssrc = sgrp[order], srow[order], ssrc[order]
    per_g = np.bincount(sgrp, minlength=n_groups)
    spill_w = int(per_g.max(initial=0))
    if n_groups * G * spill_w > spill_limit:
        raise MemoryError(
            f"aligned stage spill table {n_groups}x{G}x{spill_w} > "
            f"{spill_limit} entries (spill-heavy graph; spill fraction "
            f"{sp.mean():.2f}) — use the tree or multihot backend"
        )
    spill_src = np.full((n_groups, max(spill_w, 0)), num_inputs, np.int32)
    b_spill = np.zeros((n_groups, G, max(spill_w, 0)), np.int8)
    if spill_w:
        starts = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(per_g, out=starts[1:])
        slot = np.arange(len(sgrp), dtype=np.int64) - starts[sgrp]
        spill_src[sgrp, slot] = ssrc.astype(np.int32)
        b_spill[sgrp, srow, slot] = 1
    return AlignedStage(
        b_dense=b_dense, win_block=win_block, spill_src=spill_src,
        b_spill=b_spill, counts=counts, num_inputs=num_inputs,
        num_segments=S, group_rows=G, window_blocks=wb,
    )


def plan_aligned(
    hg,
    group_rows: int = 128,
    window_blocks: Optional[int] = None,
    max_spill: float = 0.25,
    spill_limit: int = 1 << 28,
    form: str = "bucketed",
    feat_bytes: int = 64,
    block_rows: int = ALIGNED_BLOCK,
    spill_fudge: int = 256,
) -> TreePlan:
    """Two-direction aligned-banded plan (community-sorted graphs).

    ``form="bucketed"`` (default) builds :class:`AlignedStageB`: per-group
    cost-optimal window widths, bucketed matmuls, spill tables only for
    spilling groups.  ``form="uniform"`` builds the original
    :class:`AlignedStage`; there ``window_blocks=None`` sweeps (2, 4, 6, 8)
    per stage and keeps the smallest whose spill fraction is within 1.2×
    of the best.  Raises ``ValueError`` when either direction would spill
    more than ``max_spill`` of its entries at wb=8 (graph not
    sorted/clustered enough — reorder first:
    :func:`hypergef.sparse.reorder.community_reorder`)."""

    def feasibility(indptr, indices, n_in):
        # conservative pre-check with the median-window heuristic: the
        # bucketed per-group optimal windows only ever spill less.
        # When the caller requests wide windows (E≫V graphs), check
        # feasibility at that width — clamping to 8 would refuse plans
        # the requested width makes viable (yelp-shaped graphs).
        fr = aligned_spill_stats(indptr, indices, n_in, group_rows,
                                 window_blocks or 8)
        if fr > max_spill:
            raise ValueError(
                f"aligned plan spill fraction {fr:.2f} > {max_spill} — "
                "graph is not community-sorted; run community_reorder first"
            )
        return fr

    def choose(indptr, indices, n_in):
        cands = (2, 4, 6, 8) if window_blocks is None else (window_blocks,)
        fr = [aligned_spill_stats(indptr, indices, n_in, group_rows, wb)
              for wb in cands]
        best = min(fr)
        if best > max_spill:
            raise ValueError(
                f"aligned plan spill fraction {best:.2f} > {max_spill} — "
                "graph is not community-sorted; run community_reorder first"
            )
        for wb, f in zip(cands, fr):
            if f <= best * 1.2 + 1e-9:
                return wb
        return cands[-1]

    if form == "bucketed":
        feasibility(hg.ht_indptr, hg.ht_indices, hg.num_nodes)
        feasibility(hg.h_indptr, hg.h_indices, hg.num_edges)
        # default max window SPAN is 8 blocks of 128 rows; finer
        # block_rows keep the same span reachable with more blocks
        max_w = window_blocks or max(8 * ALIGNED_BLOCK // block_rows, 8)
        e_stage = build_aligned_stage_bucketed(
            hg.ht_indptr, hg.ht_indices, hg.num_nodes, group_rows,
            max_width=max_w, feat_bytes=feat_bytes,
            spill_limit=spill_limit, block_rows=block_rows,
            spill_fudge=spill_fudge,
        )
        v_stage = build_aligned_stage_bucketed(
            hg.h_indptr, hg.h_indices, hg.num_edges, group_rows,
            max_width=max_w, feat_bytes=feat_bytes,
            spill_limit=spill_limit, block_rows=block_rows,
            spill_fudge=spill_fudge,
        )
    elif form == "uniform":
        wb_e = choose(hg.ht_indptr, hg.ht_indices, hg.num_nodes)
        wb_v = choose(hg.h_indptr, hg.h_indices, hg.num_edges)
        e_stage = build_aligned_stage(
            hg.ht_indptr, hg.ht_indices, hg.num_nodes, group_rows, wb_e,
            spill_limit,
        )
        v_stage = build_aligned_stage(
            hg.h_indptr, hg.h_indices, hg.num_edges, group_rows, wb_v,
            spill_limit,
        )
    else:
        raise ValueError(f"plan_aligned form must be bucketed|uniform, got {form!r}")
    plan = TreePlan(
        edge_stage=e_stage,
        vertex_stage=v_stage,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
    )
    plan.device()
    return plan


class AlignedBucket(NamedTuple):
    """One window-width bucket of a bucketed aligned stage: the groups
    whose modeled-cost-optimal window is ``width`` blocks wide."""

    b_dense: np.ndarray  # [ng_b, G, width*128] int8 band tables
    win_block: np.ndarray  # [ng_b, width] int32 source block ids
    group_ids: np.ndarray  # [ng_b] int32 global group ids (sorted)


class AlignedSpill(NamedTuple):
    """One spill-width bucket: groups with similar out-of-window entry
    counts share a padded (gather + small multihot matmul) table."""

    b_spill: np.ndarray  # [m_b, G, sw] int8
    spill_src: np.ndarray  # [m_b, sw] int32 (num_inputs = zero row)
    group_ids: np.ndarray  # [m_b] int32


class AlignedStageB(NamedTuple):
    """Bucketed aligned banded-multihot stage.

    Same math as :class:`AlignedStage` but each group pays only for the
    window width *it* needs: groups are bucketed by a per-group
    cost-model-optimal (offset, width) — band bytes per extra block
    (~G·128 int8 + 128·F window rows) vs bytes per spill entry (~G int8
    band column + one gathered row) — instead of every group streaming
    the global max width.  Spill tables likewise include only spilling
    groups, bucketed by power-of-two spill width (the uniform form pads
    every group to the global max spill count: ~0.2% occupancy on
    SBM-60k).  Output assembly is two block-granular gathers
    ([G, F]-row permutation + padded spill slot map) — no scatter.
    """

    buckets: tuple  # of AlignedBucket
    spills: tuple  # of AlignedSpill
    base_slot: np.ndarray  # [n_groups] int32 — row of group g in concat(bucket outs)
    spill_slot: np.ndarray  # [n_groups] int32 — row in concat(spill outs), m_total = zero
    counts: np.ndarray  # [num_segments] f32
    num_inputs: int
    num_segments: int
    group_rows: int
    block_rows: int = 128  # source block granularity (gather row width)

    @property
    def spill_fraction(self) -> float:
        dense = sum(float(b.b_dense.sum()) for b in self.buckets)
        spill = sum(float(s.b_spill.sum()) for s in self.spills)
        return spill / max(dense + spill, 1.0)

    @property
    def window_blocks(self):
        """Bucket widths (blocks), widest first — diagnostic analogue of
        the uniform form's single ``window_blocks``."""
        return tuple(sorted((b.win_block.shape[1] for b in self.buckets),
                            reverse=True))

    def table_bytes(self) -> int:
        """Host/device band+spill table footprint (int8 entries)."""
        return int(
            sum(b.b_dense.size for b in self.buckets)
            + sum(s.b_spill.size + 4 * s.spill_src.size for s in self.spills)
        )


def _group_windows_opt(grp, blk, cnt_per_group, nb, max_width, G,
                       feat_bytes=64,
                       widths=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
                       block_rows=128, spill_fudge=256):
    """Per-group cost-optimal (offset, width).

    For each candidate width w the best window of a group is the one
    covering the most member entries — found by a sliding scan over the
    (group, block)-sorted entries (searchsorted over a group-separated
    key).  Modeled cost per group:

        cost(w) = w · (G·128 int8 band bytes + 128·feat_bytes window rows)
                + spill(w) · (G int8 band column + feat_bytes row + fudge)

    Returns (offset[n_groups] int64, width[n_groups] int64).  Vectorized:
    ~len(widths) searchsorted passes over nnz entries.
    """
    n_groups = len(cnt_per_group)
    widths = tuple(w for w in widths if w <= max_width) or (max_width,)
    # one combined-key stable sort instead of a two-pass lexsort: grp is
    # already non-decreasing (it derives from repeat(arange(S))), so the
    # group-separated key sorts blk within groups in a single pass — at
    # 10M nnz this and the per-width reduceat below (which replaces a
    # lexsort per width) cut this function ~6x
    sep = nb + max(widths) + 1
    key0 = grp * sep + blk
    order = np.argsort(key0, kind="stable")
    gs, bs, key = grp[order], blk[order], key0[order]
    starts = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(cnt_per_group, out=starts[1:])
    nonempty = cnt_per_group > 0
    ne_starts = starts[:-1][nonempty]
    j = np.arange(len(gs), dtype=np.int64)
    # spill_fudge: extra per-spill-entry charge, a routing weight like
    # the constants at the top of this module (not calibrated on GPU)
    block_cost = G * block_rows + block_rows * feat_bytes
    spill_cost = G + feat_bytes + spill_fudge
    # native C++ twin (csrc hg_aligned_windows): the per-group two-pointer
    # sweep replaces every searchsorted/reduceat pass below — the aligned
    # plan's hot loop at 10M+ nnz (bit-identical; tests/test_native.py)
    from hypergef.sparse import native as _native

    nat = _native.aligned_windows_native(
        starts, bs, nb, np.asarray(widths, np.int64), block_cost, spill_cost
    ) if len(gs) else None
    if nat is not None:
        return nat
    best_cost = np.full(n_groups, np.inf)
    best_off = np.zeros(n_groups, dtype=np.int64)
    best_w = np.full(n_groups, widths[0], dtype=np.int64)
    for w in widths:
        if len(gs):
            right = np.searchsorted(key, key + w, side="left")
            cover = right - j
            # per-group argmax coverage in O(n): groups are contiguous
            # runs in the sorted order, so a maximum.reduceat gives the
            # max and a second masked reduceat its LAST position (same
            # tie-break as the lexsort this replaces: largest block
            # offset among equal-coverage windows)
            maxcov = np.zeros(n_groups, dtype=np.int64)
            maxcov[nonempty] = np.maximum.reduceat(cover, ne_starts)
            is_max = cover == maxcov[gs]
            last = np.zeros(n_groups, dtype=np.int64)
            last[nonempty] = np.maximum.reduceat(
                np.where(is_max, j, -1), ne_starts)
            off_w = np.zeros(n_groups, dtype=np.int64)
            off_w[nonempty] = np.minimum(
                bs[last[nonempty]], max(nb - w, 0))
        else:
            maxcov = np.zeros(n_groups, dtype=np.int64)
            off_w = np.zeros(n_groups, dtype=np.int64)
        spill = cnt_per_group - maxcov
        cost = w * block_cost + spill * spill_cost
        upd = cost < best_cost
        best_cost[upd] = cost[upd]
        best_off[upd] = off_w[upd]
        best_w[upd] = w
    best_w[~nonempty] = widths[0]
    best_off[~nonempty] = 0
    return best_off, best_w


def _merge_buckets_cost(per_group_width, unit_cost_s,
                        fixed_s=ALIGNED_KERNEL_FIXED_S
                        * ALIGNED_KERNELS_PER_BUCKET,
                        max_buckets=None):
    """Cost-aware width-class merging.

    Each distinct width is one bucket = one gather + one dot kernel at
    ~``ALIGNED_KERNEL_FIXED_S`` fixed cost each.  Greedily merge the
    adjacent width-class pair whose added streaming cost (widening every
    group of the smaller class to the larger width, at ``unit_cost_s``
    seconds per group per unit width) is smallest, while that cost stays
    below the per-bucket fixed cost being removed.  ``max_buckets``
    forces merging down regardless of cost (upper-bounds kernel count).
    Returns the merged per-group widths (each group's width only ever
    grows, so windows only widen — coverage never shrinks).
    """
    values = np.asarray(per_group_width)
    uniq, cnts = np.unique(values, return_counts=True)
    widths = [int(u) for u in uniq]
    counts = [int(c) for c in cnts]
    rep = {int(u): int(u) for u in uniq}
    while len(widths) > 1:
        added = [counts[i] * (widths[i + 1] - widths[i]) * unit_cost_s
                 for i in range(len(widths) - 1)]
        i = int(np.argmin(added))
        forced = max_buckets is not None and len(widths) > max_buckets
        # reaching ONE bucket additionally removes the output assembly
        # gather (the slot maps become identity — see AlignedStageBDev
        # base_identity/spill_identity), worth one more kernel's fixed
        # cost on top of the bucket's own gather+dot pair
        eff_fixed = fixed_s
        if len(widths) == 2:
            eff_fixed += ALIGNED_KERNEL_FIXED_S
        if added[i] >= eff_fixed and not forced:
            break
        for k in rep:
            if rep[k] == widths[i]:
                rep[k] = widths[i + 1]
        counts[i + 1] += counts[i]
        del widths[i], counts[i]
    return np.asarray([rep[int(v)] for v in values.reshape(-1)],
                      dtype=values.dtype).reshape(values.shape)


def _merge_small_buckets(values, min_count):
    """Map each distinct value to a representative ≥ it so no bucket has
    fewer than ``min_count`` members (small buckets merge upward into the
    next larger distinct value; the largest always survives)."""
    uniq, cnts = np.unique(values, return_counts=True)
    mapping = {}
    carry = 0
    pending = []
    for u, c in zip(uniq, cnts):
        pending.append(u)
        carry += c
        if carry >= min_count or u == uniq[-1]:
            for p in pending:
                mapping[p] = u
            pending, carry = [], 0
    if pending:  # trailing small buckets merge into the largest rep
        rep = mapping[uniq[-1]] if uniq[-1] in mapping else uniq[-1]
        for p in pending:
            mapping[p] = rep
    return np.asarray(
        np.vectorize(mapping.__getitem__)(values), dtype=values.dtype
    )


def build_aligned_stage_bucketed(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_inputs: int,
    group_rows: int = 128,
    max_width: int = 8,
    feat_bytes: int = 64,
    spill_limit: int = 1 << 28,
    block_rows: int = ALIGNED_BLOCK,
    spill_fudge: int = 256,
    spill_pad_pow2: bool = False,
) -> AlignedStageB:
    """Build one direction's bucketed aligned stage (:class:`AlignedStageB`).

    ``spill_pad_pow2=True`` selects pow2/coarse-merge spill widths
    instead of the multiple-of-8 default (more padded slots)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    S = len(indptr) - 1
    G = group_rows
    n_groups = max(-(-S // G), 1)
    nb = max(-(-num_inputs // block_rows), 1)
    counts = np.diff(indptr).astype(np.float32)
    if indices.size == 0:
        empty_bucket = AlignedBucket(
            b_dense=np.zeros((n_groups, G, block_rows), np.int8),
            win_block=np.zeros((n_groups, 1), np.int32),
            group_ids=np.arange(n_groups, dtype=np.int32),
        )
        return AlignedStageB(
            buckets=(empty_bucket,), spills=(),
            base_slot=np.arange(n_groups, dtype=np.int32),
            spill_slot=np.zeros(n_groups, np.int32),
            counts=counts, num_inputs=num_inputs, num_segments=S,
            group_rows=G, block_rows=block_rows,
        )
    seg = np.repeat(np.arange(S, dtype=np.int64), np.diff(indptr))
    grp = seg // G
    row_in_g = seg % G
    blk = indices // block_rows
    cnt_per_group = np.bincount(grp, minlength=n_groups)
    off, wid = _group_windows_opt(
        grp, blk, cnt_per_group, nb, min(max_width, nb), G, feat_bytes,
        block_rows=block_rows, spill_fudge=spill_fudge,
    )
    # merge width classes cost-awarely: each bucket is a window gather +
    # band dot pair of kernels, each with a fixed launch cost.  Unit cost
    # of widening one group by one block: the extra band-table elements
    # + the extra window source rows streamed from device memory.
    band_unit_s = (G * block_rows) * MERGE_BAND_S_PER_ELEM \
        + (block_rows * feat_bytes) * MERGE_STREAM_S_PER_BYTE
    wid = _merge_buckets_cost(wid, band_unit_s)
    # re-clamp offsets: merging only widens windows ([off, off+w') ⊇
    # [off, off+w)), but off + w' must stay within the block count
    off = np.minimum(off, np.maximum(nb - wid, 0))
    og, wg = off[grp], wid[grp]
    in_win = (blk >= og) & (blk < og + wg)

    buckets = []
    base_slot = np.zeros(n_groups, dtype=np.int32)
    slot_base = 0
    for w in np.unique(wid):
        gsel = np.where(wid == w)[0]
        W = int(w) * block_rows
        ng_b = len(gsel)
        local_of_group = np.full(n_groups, -1, dtype=np.int64)
        local_of_group[gsel] = np.arange(ng_b)
        esel = in_win & (local_of_group[grp] >= 0)
        b_dense = np.zeros((ng_b, G, W), np.int8)
        key = (local_of_group[grp[esel]] * G + row_in_g[esel]) * W + (
            indices[esel] - og[esel] * block_rows
        )
        uk, cnts = np.unique(key, return_counts=True)
        if cnts.size and cnts.max() > 127:
            raise MemoryError(
                "aligned stage: >127 duplicate incidences in one "
                "(segment, source) pair — not an incidence matrix?"
            )
        b_dense.reshape(-1)[uk] = cnts.astype(np.int8)
        win_block = (
            off[gsel][:, None] + np.arange(int(w))[None, :]
        ).astype(np.int32)
        buckets.append(AlignedBucket(
            b_dense=b_dense, win_block=win_block,
            group_ids=gsel.astype(np.int32),
        ))
        base_slot[gsel] = slot_base + np.arange(ng_b, dtype=np.int32)
        slot_base += ng_b

    # ---- spill: only spilling groups, bucketed by pow2 spill width ----
    # dedup (group, src): a hub row spilled by several segments of one
    # group is gathered ONCE (its one-hot column carries every segment) —
    # 25%/18% of spill entries are intra-group duplicates on SBM-60k,
    # and the spill path is per-row-gather-latency-bound
    sp = ~in_win
    sgrp, srow, ssrc = grp[sp], row_in_g[sp], indices[sp]
    pair_key = sgrp * np.int64(num_inputs + 1) + ssrc
    uk, inv = np.unique(pair_key, return_inverse=True)
    ugrp = (uk // (num_inputs + 1)).astype(np.int64)
    usrc = (uk % (num_inputs + 1)).astype(np.int64)
    per_g = np.bincount(ugrp, minlength=n_groups)  # unique srcs per group
    spilling = np.where(per_g > 0)[0]
    spills = []
    m_total = 0
    spill_slot = np.zeros(n_groups, dtype=np.int32)
    if len(spilling):
        # width = count rounded up to a multiple of 8, NOT pow2: every
        # padded slot is a real per-row gather (even for the zero row),
        # and pow2 + coarse merging pads SBM-60k spills 1.4-1.8x.  A looser merge keeps more distinct widths —
        # each bucket is one extra (tiny) gather+dot in the SAME program,
        # not an extra dispatch.
        if spill_pad_pow2:
            sw_of = 1 << np.ceil(
                np.log2(np.maximum(per_g[spilling], 1))
            ).astype(np.int64)
            sw_of = _merge_small_buckets(sw_of, max(8, len(spilling) // 8))
        else:
            sw_of = -(-per_g[spilling] // 8) * 8
            # cost-aware merge: each spill bucket is a row gather + small
            # dot with a fixed launch cost.  Widening a group's spill
            # slot count costs the extra int8 band column per slot PLUS
            # a padded-slot gather charge, which lets small spill sets
            # collapse to one bucket while high-spread stages keep
            # enough width classes to bound padding.
            spill_unit = (G * MERGE_BAND_S_PER_ELEM
                          + ALIGNED_SPILL_PAD_GATHER_S)
            # spill buckets charge ONE kernel, not the band pair: the
            # many tiny spill gather+dots can overlap in a way the serial
            # band-dot chain cannot, so the fixed-cost model halves
            sw_of = _merge_buckets_cost(
                sw_of, spill_unit, fixed_s=ALIGNED_KERNEL_FIXED_S)
        total_entries = int(G * sw_of.sum())
        if total_entries > spill_limit:
            raise MemoryError(
                f"aligned stage spill tables ({total_entries} int8 entries) "
                f"> {spill_limit} (spill fraction {sp.mean():.2f}) — use the "
                "tree or multihot backend"
            )
        # uk is sorted by (group, src) → slots are contiguous per group
        starts = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(per_g, out=starts[1:])
        slot_of_pair = np.arange(len(uk), dtype=np.int64) - starts[ugrp]
        for sw in np.unique(sw_of):
            gsel = spilling[sw_of == sw]
            m_b = len(gsel)
            local_of_group = np.full(n_groups, -1, dtype=np.int64)
            local_of_group[gsel] = np.arange(m_b)
            psel = local_of_group[ugrp] >= 0  # pairs in this bucket
            spill_src = np.full((m_b, int(sw)), num_inputs, np.int32)
            b_spill = np.zeros((m_b, G, int(sw)), np.int8)
            spill_src[local_of_group[ugrp[psel]], slot_of_pair[psel]] = (
                usrc[psel].astype(np.int32)
            )
            esel = local_of_group[sgrp] >= 0  # entries in this bucket
            np.add.at(
                b_spill,
                (local_of_group[sgrp[esel]], srow[esel],
                 slot_of_pair[inv[esel]]),
                1,
            )
            spills.append(AlignedSpill(
                b_spill=b_spill, spill_src=spill_src,
                group_ids=gsel.astype(np.int32),
            ))
            spill_slot[gsel] = m_total + np.arange(m_b, dtype=np.int32)
            m_total += m_b
    spill_slot[per_g == 0] = m_total  # zero row
    return AlignedStageB(
        buckets=tuple(buckets), spills=tuple(spills),
        base_slot=base_slot, spill_slot=spill_slot,
        counts=counts, num_inputs=num_inputs, num_segments=S,
        group_rows=G, block_rows=block_rows,
    )


class TilePlanData(NamedTuple):
    """jnp view of a :class:`TilePlan` (flows through jit)."""

    e_gather_idx: "object"  # [Ce, ngs_e] int32 — vertex ids feeding each edge-chunk
    e_mask: "object"  # [Ce, ngs_e] f32
    e_seg_ids: "object"  # [Ce] int32 — edge id per chunk (sorted)
    v_gather_idx: "object"  # [Cv, ngs_v] int32 — edge ids feeding each vertex-chunk
    v_mask: "object"  # [Cv, ngs_v] f32
    v_seg_ids: "object"  # [Cv] int32 — vertex id per chunk (sorted)


@dataclasses.dataclass
class TilePlan:
    """Full static schedule for the fused two-stage aggregation."""

    edge_table: EllTable  # V→E stage: chunks of H^T rows
    vertex_table: EllTable  # E→V stage: chunks of H rows
    num_nodes: int
    num_edges: int

    _device: Optional[TilePlanData] = dataclasses.field(default=None, repr=False)

    @property
    def ngs_edge(self) -> int:
        return self.edge_table.ngs

    @property
    def ngs_vertex(self) -> int:
        return self.vertex_table.ngs

    def device(self) -> TilePlanData:
        if self._device is None:
            import jax
            import jax.numpy as jnp

            # never cache arrays materialized inside a jit trace — they
            # would be tracers and leak out of the transformation scope
            if isinstance(jnp.zeros(()), jax.core.Tracer):
                raise RuntimeError(
                    "TilePlan.device() first called inside a jit trace; "
                    "call plan.device() (or plan_tiles) eagerly first"
                )

            et, vt = self.edge_table, self.vertex_table
            self._device = TilePlanData(
                e_gather_idx=jnp.asarray(et.gather_idx),
                e_mask=jnp.asarray(et.mask),
                e_seg_ids=jnp.asarray(et.seg_ids),
                v_gather_idx=jnp.asarray(vt.gather_idx),
                v_mask=jnp.asarray(vt.mask),
                v_seg_ids=jnp.asarray(vt.seg_ids),
            )
        return self._device

    def padding_waste(self) -> float:
        """Fraction of padded (dead) gather slots across both tables."""
        et, vt = self.edge_table, self.vertex_table
        live = float(et.mask.sum() + vt.mask.sum())
        total = float(et.mask.size + vt.mask.size)
        return 1.0 - live / total if total else 0.0


def plan_tiles(
    hg,
    ngs: Optional[int] = None,
    ngs_vertex: Optional[int] = None,
    pad_chunks_to: int = 8,
) -> TilePlan:
    """Build the static two-stage schedule for a hypergraph.

    ``ngs`` defaults to the analytic rule of :func:`choose_ngs` on the
    hyperedge-size distribution (replacing the reference's per-dataset
    lookup table); the vertex side gets its own size from the vertex
    degree distribution.
    """
    if ngs is None:
        ngs = choose_ngs(hg.edge_sizes())
    if ngs_vertex is None:
        ngs_vertex = choose_ngs(hg.vertex_degrees())
    edge_table = build_ell(hg.ht_indptr, hg.ht_indices, ngs, pad_chunks_to)
    vertex_table = build_ell(hg.h_indptr, hg.h_indices, ngs_vertex, pad_chunks_to)
    plan = TilePlan(
        edge_table=edge_table,
        vertex_table=vertex_table,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
    )
    plan.device()  # materialize device arrays eagerly (outside any trace)
    return plan
