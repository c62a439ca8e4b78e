"""Reduction-tree aggregation ops.

Each aggregation direction runs as a scatter-free sequence of dense,
statically shaped ops:

    gather source rows (ELL chunks)  →  masked in-chunk sum
    → log_fan levels of gather + masked fan-in sum  →  final per-segment map

— dense, statically shaped ops only.  The plan comes from
:func:`hypergef.sparse.planner.build_tree` (the descendant of the
reference's balancer chunking, ``balancer_kernel.cuh:229-259``, with the
atomicAdd combination replaced by the tree).

VJP: the adjoint of the V→E stage *is* the E→V stage over the transposed
CSR, so :func:`tree_matvec` carries both stage plans and swaps them in
the backward — no scatter in any derivative order (same trick as
:func:`hypergef.ops.segments.incidence_gather_sum`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class TiledStageDev:
    """Device bundle for a cache-blocked (tiled level-0) stage.

    ``tile_rows`` is static pytree metadata so padding/slicing shapes
    stay concrete under jit.  ``form`` selects the level-0 applier:

    * ``"gather"``   — per-slot row gathers from the sliced tile
      (round-1 XLA form; measured NO faster than untiled — kept for
      reference, see planner.TILED_SOURCE_THRESHOLD);
    * ``"multihot"`` — tile-local multihot bf16 matrix built by
      iota-compare, partials via ONE matmul per tile (lax.scan) —
      random row access becomes streaming matmul work, for clustered
      graphs;
    * ``"multihot_batched"`` — same math as one batched dot_general
      (materializes the [n_tiles, c_max, tile_rows] multihot in HBM;
      lets XLA schedule all tiles at once).
    """

    gidx: "object"  # [n_tiles, c_max, ngs] int32, tile-local rows
    mask: "object"  # [n_tiles, c_max, ngs] f32
    combine: "object"  # tree-stage 4-tuple over flat partials
    counts: "object" = None  # [num_segments] f32 (mean denominators)
    tile_rows: int = 0
    form: str = "gather"
    m_dense: "object" = None  # [n_tiles, c_max, tile_rows] bf16 (precomp form)


jax.tree_util.register_dataclass(
    TiledStageDev,
    data_fields=["gidx", "mask", "combine", "counts", "m_dense"],
    meta_fields=["tile_rows", "form"],
)


@dataclasses.dataclass(frozen=True)
class AlignedStageDev:
    """Device bundle for a segment-aligned banded-multihot stage
    (:class:`hypergef.sparse.planner.AlignedStage`): output rows are
    the segments in order (reshape+slice, no final gather); each group
    reads a contiguous window of source blocks (block gather) and one
    small spill table.  All static bounds ride as pytree metadata."""

    b_dense: "object"  # [n_groups, G, W] bf16
    win_block: "object"  # [n_groups, wb] int32
    spill_src: "object"  # [n_groups, spill_w] int32
    b_spill: "object"  # [n_groups, G, spill_w] bf16
    counts: "object"  # [num_segments] f32
    num_inputs: int = 0
    num_segments: int = 0
    group_rows: int = 128
    window_blocks: int = 4


jax.tree_util.register_dataclass(
    AlignedStageDev,
    data_fields=["b_dense", "win_block", "spill_src", "b_spill", "counts"],
    meta_fields=["num_inputs", "num_segments", "group_rows", "window_blocks"],
)


@dataclasses.dataclass(frozen=True)
class AlignedBucketDev:
    """Device twin of :class:`planner.AlignedBucket` (tables int8 — cast
    to bf16 inside the apply so XLA fuses the convert into the dot)."""

    b_dense: "object"  # [ng_b, G, W] int8
    win_block: "object"  # [ng_b, wb] int32


jax.tree_util.register_dataclass(
    AlignedBucketDev, data_fields=["b_dense", "win_block"], meta_fields=[]
)


@dataclasses.dataclass(frozen=True)
class AlignedSpillDev:
    """Device twin of :class:`planner.AlignedSpill`."""

    b_spill: "object"  # [m_b, G, sw] int8
    spill_src: "object"  # [m_b, sw] int32


jax.tree_util.register_dataclass(
    AlignedSpillDev, data_fields=["b_spill", "spill_src"], meta_fields=[]
)


@dataclasses.dataclass(frozen=True)
class AlignedStageBDev:
    """Device bundle for the bucketed aligned stage
    (:class:`hypergef.sparse.planner.AlignedStageB`)."""

    buckets: tuple  # of AlignedBucketDev
    spills: tuple  # of AlignedSpillDev
    base_slot: "object"  # [n_groups] int32
    spill_slot: "object"  # [n_groups] int32
    counts: "object"  # [num_segments] f32
    num_inputs: int = 0
    num_segments: int = 0
    group_rows: int = 128
    block_rows: int = 128
    # static fast-path flags (set at plan→device conversion): with ONE
    # band bucket base_slot is the identity permutation and the assembly
    # gather can be skipped; likewise for spill when every group spills
    # into one bucket in order.  Saves 1-2 kernels per stage.
    base_identity: bool = False
    spill_identity: bool = False


jax.tree_util.register_dataclass(
    AlignedStageBDev,
    data_fields=["buckets", "spills", "base_slot", "spill_slot", "counts"],
    meta_fields=["num_inputs", "num_segments", "group_rows", "block_rows",
                 "base_identity", "spill_identity"],
)


def stage_counts(stage):
    if isinstance(stage, (TiledStageDev, AlignedStageDev, AlignedStageBDev)):
        return stage.counts
    return stage[3]


# elements above which a level's [C, fan, F] gathered intermediate would
# be memory-hostile (narrow-F padding blows it up several-fold) → switch
# to per-slot 2-D gathers there.
_LEVEL_3D_MAX_ELEMS = 1 << 22


def apply_level(p, g, m):
    """One fan-in combine level: y[c] = Σ_k p[g[c,k]] · m[c,k]."""
    c, fan = g.shape
    f = p.shape[1]
    if c * fan * f <= _LEVEL_3D_MAX_ELEMS:
        # compact 3-D form: one gather, small program (fast compiles)
        gathered = jnp.take(p, g.reshape(-1), axis=0).reshape(c, fan, f)
        return jnp.sum(gathered * m[:, :, None], axis=1)
    # per-slot 2-D gathers: no padded 3-D intermediate
    acc = jnp.take(p, g[:, 0], axis=0) * m[:, 0][:, None]
    for k in range(1, fan):
        acc = acc + jnp.take(p, g[:, k], axis=0) * m[:, k][:, None]
    return acc


def apply_levels(x, levels, final_idx, final_mask):
    """Apply a sequence of combine levels + the final per-segment map.

    Gathers use flat 1-D row-index form, the canonical gather XLA
    lowers natively."""
    p = x
    for g, m in levels:
        p = apply_level(p, g, m)
    return jnp.take(p, final_idx, axis=0) * final_mask[:, None]


# effectively -inf in f32 without being an actual inf (safe to negate,
# compare, and multiply by a zero mask without NaNs)
_NEG_F32 = -3.0e38


def apply_level_max(p, g, m):
    """One fan-in MAX combine level: y[c] = max_k p[g[c,k]] masked by m.

    Dead slots (m == 0) become ``-inf``-like so they never win; a row
    whose slots are all dead yields ``_NEG_F32`` and must be guarded by
    the caller's final mask (padded chunks are never gathered by live
    deeper-level slots)."""
    c, fan = g.shape
    f = p.shape[1]
    gathered = jnp.take(p, g.reshape(-1), axis=0).reshape(c, fan, f)
    cand = jnp.where(m[:, :, None] > 0, gathered, _NEG_F32)
    return jnp.max(cand, axis=1)


def apply_levels_max(x, levels, final_idx, final_mask):
    """Max-combine counterpart of :func:`apply_levels` — the same tree
    stage applied with max instead of sum at every level (partial maxima
    combine associatively exactly like partial sums).

    Empty segments map to 0 (the reference kernel's zero-initialized
    output, ``hgnnaggr_cuda.cu:144-208``).  Gradients are exact through
    standard JAX AD: the masked-``where`` confines cotangents to live
    slots and ``jnp.max``'s VJP routes each segment's cotangent to the
    winning member (ties split evenly — measure zero on float data).
    """
    p = x
    for g, m in levels:
        p = apply_level_max(p, g, m)
    y = jnp.take(p, final_idx, axis=0)
    return jnp.where(final_mask[:, None] > 0, y, 0.0)


def _apply_stage(x, stage):
    """stage = (levels, final_idx, final_mask, counts) of jnp arrays."""
    levels, final_idx, final_mask, _ = stage
    return apply_levels(x, levels, final_idx, final_mask)


def _apply_combine(flat, combine):
    """Combine partials via a plain tree stage OR a nested TiledStageDev
    (multihot matmul combine — once level 0 is a matmul the gather tree
    becomes the bottleneck, so clustered plans nest a second multihot
    level)."""
    if isinstance(combine, TiledStageDev):
        return _apply_any(flat, combine)
    return _apply_stage(flat, combine)


def _apply_tiled(x, stage: TiledStageDev):
    """Cache-blocked level 0: scan over source tiles, gathering from a
    dynamically-sliced tile, then tree-combine partials."""
    gidx, mask = stage.gidx, stage.mask
    n_tiles, c_max, ngs = gidx.shape
    t_rows = stage.tile_rows
    pad = n_tiles * t_rows - x.shape[0]
    xp = jnp.pad(x, ((0, max(pad, 0)), (0, 0)))

    def body(_, inp):
        t_gidx, t_mask, t = inp
        xt = jax.lax.dynamic_slice_in_dim(xp, t * t_rows, t_rows, axis=0)
        acc = jnp.take(xt, t_gidx[:, 0], axis=0) * t_mask[:, 0][:, None]
        for k in range(1, ngs):
            acc = acc + jnp.take(xt, t_gidx[:, k], axis=0) * t_mask[:, k][:, None]
        return None, acc

    _, partial = jax.lax.scan(
        body, None, (gidx, mask, jnp.arange(n_tiles, dtype=jnp.int32))
    )  # [n_tiles, c_max, F]
    flat = partial.reshape(n_tiles * c_max, -1)
    return _apply_combine(flat, stage.combine)


def _multihot_tile(t_gidx, t_mask, tile_rows):
    """Build the [c_max, tile_rows] bf16 multihot matrix of one tile.

    Row c is Σ_k mask[c,k]·onehot(gidx[c,k]) — duplicates accumulate, so
    the subsequent matmul has exact sum semantics (0/1/2… weights are
    exact in bf16).  Pure iota-compare work, no gather anywhere.
    """
    c_max, ngs = t_gidx.shape
    iota = jax.lax.broadcasted_iota(jnp.int32, (c_max, tile_rows), 1)
    m = jnp.zeros((c_max, tile_rows), jnp.bfloat16)
    for k in range(ngs):
        m = m + jnp.where(
            t_gidx[:, k : k + 1] == iota, t_mask[:, k : k + 1], 0.0
        ).astype(jnp.bfloat16)
    return m


def _apply_tiled_multihot(x, stage: TiledStageDev):
    """Level 0 as tile-local multihot matmuls (scan over tiles)."""
    gidx, mask = stage.gidx, stage.mask
    n_tiles, c_max, _ = gidx.shape
    t_rows = stage.tile_rows
    pad = n_tiles * t_rows - x.shape[0]
    xp = jnp.pad(x, ((0, max(pad, 0)), (0, 0))).astype(jnp.bfloat16)

    def body(_, inp):
        t_gidx, t_mask, t = inp
        xt = jax.lax.dynamic_slice_in_dim(xp, t * t_rows, t_rows, axis=0)
        m = _multihot_tile(t_gidx, t_mask, t_rows)
        p = jax.lax.dot_general(
            m, xt, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )
        return None, p

    _, partial = jax.lax.scan(
        body, None, (gidx, mask, jnp.arange(n_tiles, dtype=jnp.int32))
    )  # [n_tiles, c_max, F]
    flat = partial.reshape(n_tiles * c_max, -1)
    return _apply_combine(flat, stage.combine)


def _apply_tiled_multihot_batched(x, stage: TiledStageDev):
    """Same math as one batched dot_general over all tiles at once."""
    gidx, mask = stage.gidx, stage.mask
    n_tiles, c_max, _ = gidx.shape
    t_rows = stage.tile_rows
    pad = n_tiles * t_rows - x.shape[0]
    xp = jnp.pad(x, ((0, max(pad, 0)), (0, 0))).astype(jnp.bfloat16)
    xt = xp.reshape(n_tiles, t_rows, -1)
    m = jax.vmap(lambda g, mm: _multihot_tile(g, mm, t_rows))(gidx, mask)
    partial = jax.lax.dot_general(
        m, xt, (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32
    )  # [n_tiles, c_max, F]
    flat = partial.reshape(n_tiles * c_max, -1)
    return _apply_combine(flat, stage.combine)


def _apply_tiled_multihot_precomp(x, stage: TiledStageDev):
    """Level 0 with the HOST-precomputed dense multihot blocks: pure
    streaming batched matmul, zero in-kernel compare work.  The
    memory trade (n_tiles·c_max·tile_rows bf16) is guarded at plan time;
    this is the fastest form whenever M fits (mid-size graphs)."""
    m = stage.m_dense  # [n_tiles, c_max, tile_rows] bf16
    n_tiles, c_max, t_rows = m.shape
    pad = n_tiles * t_rows - x.shape[0]
    xt = jnp.pad(x, ((0, max(pad, 0)), (0, 0))).astype(jnp.bfloat16)
    xt = xt.reshape(n_tiles, t_rows, -1)
    partial = jax.lax.dot_general(
        m, xt, (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32
    )  # [n_tiles, c_max, F]
    flat = partial.reshape(n_tiles * c_max, -1)
    return _apply_combine(flat, stage.combine)


_ALIGNED_BLOCK = 128  # source block granularity; planner.ALIGNED_BLOCK


def _apply_aligned(x, st: AlignedStageDev):
    """out[s] = Σ_{v∈seg s} x[v] with ZERO per-nnz/per-segment gathers:
    band matmul over block-gathered windows + a small spill matmul.
    See :class:`hypergef.sparse.planner.AlignedStage`."""
    f = x.shape[1]
    n_groups, wb = st.win_block.shape
    pad = (-st.num_inputs) % _ALIGNED_BLOCK
    xb = jnp.pad(x, ((0, pad), (0, 0))).astype(jnp.bfloat16)
    xb = xb.reshape(-1, _ALIGNED_BLOCK, f)  # [nb, B, F]
    win = jnp.take(xb, st.win_block.reshape(-1), axis=0)
    win = win.reshape(n_groups, wb * _ALIGNED_BLOCK, f)
    out = jax.lax.dot_general(
        st.b_dense.astype(jnp.bfloat16), win, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [n_groups, G, F]
    spill_w = st.spill_src.shape[1]
    if spill_w:
        xz = jnp.pad(x, ((0, 1), (0, 0))).astype(jnp.bfloat16)  # zero row
        sp = jnp.take(xz, st.spill_src.reshape(-1), axis=0)
        sp = sp.reshape(n_groups, spill_w, f)
        out = out + jax.lax.dot_general(
            st.b_spill.astype(jnp.bfloat16), sp, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
    return out.reshape(n_groups * st.group_rows, f)[: st.num_segments]


def _apply_aligned_b(x, st: AlignedStageBDev):
    """Bucketed aligned apply: one band matmul per width bucket + one
    small matmul per spill bucket, assembled by two block-granular
    ([G, F]-row) gathers.  Tables ride int8 and cast to bf16 at the dot
    operand (fused convert — half the streamed band bytes)."""
    f = x.shape[1]
    g_rows = st.group_rows
    blk = st.block_rows
    pad = (-st.num_inputs) % blk
    xb = jnp.pad(x, ((0, pad), (0, 0))).astype(jnp.bfloat16)
    xb = xb.reshape(-1, blk, f)  # [nb, B, F]
    outs = []
    for bk in st.buckets:
        ng_b, wb = bk.win_block.shape
        win = jnp.take(xb, bk.win_block.reshape(-1), axis=0)
        win = win.reshape(ng_b, wb * blk, f)
        outs.append(jax.lax.dot_general(
            bk.b_dense.astype(jnp.bfloat16), win, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        ))  # [ng_b, G, F]
    cat = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    if st.base_identity:
        base = cat  # single bucket covering all groups in order
    else:
        base = jnp.take(cat, st.base_slot, axis=0)  # [n_groups, G, F]
    if st.spills:
        xz = jnp.pad(x, ((0, 1), (0, 0))).astype(jnp.bfloat16)  # zero row
        souts = []
        for sp in st.spills:
            m_b, sw = sp.spill_src.shape
            rows = jnp.take(xz, sp.spill_src.reshape(-1), axis=0)
            rows = rows.reshape(m_b, sw, f)
            souts.append(jax.lax.dot_general(
                sp.b_spill.astype(jnp.bfloat16), rows,
                (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            ))
        if st.spill_identity:
            base = base + souts[0]  # every group spills, one bucket, in order
        else:
            souts.append(jnp.zeros((1, g_rows, f), jnp.float32))
            scat = jnp.concatenate(souts, axis=0)
            base = base + jnp.take(scat, st.spill_slot, axis=0)
    return base.reshape(-1, f)[: st.num_segments]


def _apply_any(x, stage):
    if isinstance(stage, TiledStageDev):
        if stage.form == "multihot":
            return _apply_tiled_multihot(x, stage)
        if stage.form == "multihot_batched":
            return _apply_tiled_multihot_batched(x, stage)
        if stage.form == "multihot_precomp":
            return _apply_tiled_multihot_precomp(x, stage)
        return _apply_tiled(x, stage)
    if isinstance(stage, AlignedStageDev):
        return _apply_aligned(x, stage)
    if isinstance(stage, AlignedStageBDev):
        return _apply_aligned_b(x, stage)
    return _apply_stage(x, stage)


@jax.custom_vjp
def tree_matvec(x, fwd_stage, bwd_stage):
    """y = M x where M is the 0/1 incidence map encoded by ``fwd_stage``
    (plain tree or cache-blocked tiled stage); ``bwd_stage`` encodes Mᵀ
    and is used (swapped) in the VJP."""
    return _apply_any(x, fwd_stage)


def _tm_fwd(x, fwd_stage, bwd_stage):
    return _apply_any(x, fwd_stage), (fwd_stage, bwd_stage)


def _tm_bwd(res, g):
    fwd_stage, bwd_stage = res
    dx = tree_matvec(g, bwd_stage, fwd_stage)
    return dx, None, None


tree_matvec.defvjp(_tm_fwd, _tm_bwd)


def hgnn_aggregate_tree(hgd, x, wdiag, first_aggr, plan):
    """HGNN fused aggregation over a :class:`TreePlan` (sum/mean only;
    max routes to the nnz oracle path in the dispatcher)."""
    e_stage, v_stage = plan.device()
    xe = tree_matvec(x, e_stage, v_stage)
    if first_aggr == "mean":
        counts = stage_counts(e_stage)
        xe = xe / jnp.maximum(counts, 1.0)[:, None]
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    xv = tree_matvec(xe, v_stage, e_stage)
    return xv * hgd.degV


def unignn_aggregate_tree(hgd, x, use_deg, plan):
    e_stage, v_stage = plan.device()
    xe = tree_matvec(x, e_stage, v_stage)
    if use_deg:
        xe = xe * hgd.degE
    xv = tree_matvec(xe, v_stage, e_stage)
    if use_deg:
        xv = xv * hgd.degV
    return xv
