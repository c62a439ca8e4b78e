"""Fast ``max`` first-aggregation on the reduction-tree path.

The reference implements max with dedicated forward/backward kernels that
record, per (hyperedge, feature), which member vertex won the max
(``record_table``, ``source/hgnnaggr/hgnnaggr_cuda.cu:144-208``;
backward ``hgnnaggr.cc:93-120`` routes each cotangent to exactly that
member).  Round 1 routed every max call to the slow nnz oracle path
(``ops/refops.py``); this module is the fast counterpart:

* **forward** — the same fixed-fan reduction tree the sum path uses
  (:mod:`hypergef.ops.tree`), with dead slots masked to ``-inf`` and
  an argmax table carried level by level.  The carried value is the
  *source vertex id* (seeded from the level-0 gather table itself), so
  the final table is exactly the reference's record_table semantics:
  ``arg[e, f] = first CSR-order vertex achieving max_{v∈e} x[v, f]``.
  Everything is dense gather/compare/select — no scatter, no
  ``segment_max``.
* **backward** — scatter-free and exact: with the record table in hand,
  ``dx[v, f] = Σ_{e ∋ v} ḡ[e, f] · [arg[e, f] == v]`` is an
  entry-weighted gather + sorted segment sum over the vertex-major CSR —
  the identical data movement as the sum path's backward (one extra
  gathered operand and a compare), so max costs ~2× sum, not the
  oracle's scatter-bound path.

Tie-breaking matches the reference's strict ``>`` update (first maximal
member in CSR order): level-0 ``argmax`` picks the first slot, deeper
levels pick the first chunk, and chunk order is CSR order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hypergef.ops.segments import segment_sum_sorted

_NEG = -3.0e38  # effectively -inf in f32, safe to negate/compare


def _level_max(vals, args, g, m):
    """One fan-in max level: returns (new_vals, new_args).

    vals: [P, F] current partial maxima; args: [P, F] int32 source rows;
    g: [C, fan] gather table over P; m: [C, fan] live mask.
    """
    c, fan = g.shape
    f = vals.shape[1]
    cand = jnp.take(vals, g.reshape(-1), axis=0).reshape(c, fan, f)
    cand = jnp.where(m[:, :, None] > 0, cand, _NEG)
    k_star = jnp.argmax(cand, axis=1)  # [C, F] — first max slot
    new_vals = jnp.max(cand, axis=1)
    carg = jnp.take(args, g.reshape(-1), axis=0).reshape(c, fan, f)
    k_iota = jax.lax.broadcasted_iota(jnp.int32, (c, fan, f), 1)
    onehot = k_iota == k_star[:, None, :]
    new_args = jnp.sum(jnp.where(onehot, carg, 0), axis=1)
    return new_vals, new_args


def tree_max_with_arg(x, stage):
    """Max-reduce ``x`` over a tree stage; returns (y [S,F], arg [S,F]).

    ``stage`` is the device 4-tuple from ``TreePlan.device()`` (levels,
    final_idx, final_mask, counts).  Level 0 seeds args from the gather
    table (source row ids); empty segments get y=0, arg=-1.
    """
    levels, final_idx, final_mask, _ = stage
    g0, m0 = levels[0]
    c, ngs = g0.shape
    f = x.shape[1]
    cand = jnp.take(x, g0.reshape(-1), axis=0).reshape(c, ngs, f)
    cand = jnp.where(m0[:, :, None] > 0, cand, _NEG)
    k_star = jnp.argmax(cand, axis=1)
    vals = jnp.max(cand, axis=1)
    k_iota = jax.lax.broadcasted_iota(jnp.int32, (c, ngs, f), 1)
    onehot = k_iota == k_star[:, None, :]
    args = jnp.sum(jnp.where(onehot, g0[:, :, None], 0), axis=1)
    for g, m in levels[1:]:
        vals, args = _level_max(vals, args, g, m)
    y = jnp.take(vals, final_idx, axis=0)
    arg = jnp.take(args, final_idx, axis=0)
    alive = final_mask[:, None] > 0
    # empty segments → 0 like the reference's zero-initialized output;
    # all-(-inf) rows can only arise from empty segments (every real
    # chunk has ≥1 live slot), so the mask is the complete guard.
    y = jnp.where(alive, y, 0.0)
    arg = jnp.where(alive, arg, -1)
    return y, arg


@jax.custom_vjp
def v2e_max_tree(x, e_stage, h_edge, h_segids, h_indptr):
    """``y[e, f] = max_{v ∈ e} x[v, f]`` over the edge tree stage.

    ``h_edge/h_segids/h_indptr`` is the vertex-major CSR of H, used only
    by the backward (record-table routed cotangents).
    """
    y, _ = tree_max_with_arg(x, e_stage)
    return y


def _v2e_max_fwd(x, e_stage, h_edge, h_segids, h_indptr):
    y, arg = tree_max_with_arg(x, e_stage)
    return y, (arg, h_edge, h_segids, h_indptr)


def _v2e_max_bwd(res, g):
    arg, h_edge, h_segids, h_indptr = res
    gg = jnp.take(g, h_edge, axis=0)  # [nnz, F] cotangents of owning edges
    ga = jnp.take(arg, h_edge, axis=0)  # [nnz, F] winning vertex per (e,f)
    w = (ga == h_segids[:, None]).astype(g.dtype)
    dx = segment_sum_sorted(gg * w, h_indptr)
    return dx, None, None, None, None


v2e_max_tree.defvjp(_v2e_max_fwd, _v2e_max_bwd)


# ----------------------------------------------------------------------
# max over a segment-aligned band stage (raw aligned plans, halo aligned
# interiors): the masked argmax of the band's live slots, in XLA
# ----------------------------------------------------------------------
_BIG = 2**31 - 1
# elements of the [groups, G, W, F] candidate tensor built per map step
_MAX_CAND_ELEMS = 1 << 26


def _masked_argmax(band, gids, rows):
    """band [m, G, W] (nonzero = live), gids [m, W] global source id of
    each slot (ascending within a group), rows [m, W, F] candidates.
    Returns (val [m, G, F], arg [m, G, F]); arg = -1 where no slot is
    live.  ``argmax`` returns the first maximal slot, i.e. the lowest
    vertex id: the reference's first-CSR-member tie rule."""
    m, g_rows, w = band.shape
    f = rows.shape[2]

    def one(args):
        b, gid, r = args
        live = (b != 0)[:, :, None]  # [G, W, 1]
        cand = jnp.where(live, r[None], _NEG)  # [G, W, F]
        k = jnp.argmax(cand, axis=1)  # [G, F]
        arg = jnp.where(jnp.any(live, axis=1), gid[k], -1)
        return jnp.max(cand, axis=1), arg

    batch = max(1, min(m, _MAX_CAND_ELEMS // max(g_rows * w * f, 1)))
    return jax.lax.map(one, (band, gids, rows), batch_size=batch)


def _combine(val_a, arg_a, val_b, arg_b):
    """Merge two candidate sets with the first-CSR-winner tie rule
    (lower vertex id wins equal values; arg == -1 means no candidate)."""
    a_alive, b_alive = arg_a >= 0, arg_b >= 0
    take_b = b_alive & (
        (val_b > val_a)
        | ~a_alive
        | ((val_b == val_a) & (arg_b < jnp.where(a_alive, arg_a, _BIG)))
    )
    return jnp.where(take_b, val_b, val_a), jnp.where(take_b, arg_b, arg_a)


def _window_pieces(x, b_dense, win_block, blk):
    f = x.shape[1]
    ng, wb = win_block.shape
    xb = jnp.pad(x, ((0, (-x.shape[0]) % blk), (0, 0))).reshape(-1, blk, f)
    win = jnp.take(xb, win_block.reshape(-1), axis=0).reshape(ng, wb * blk, f)
    # pad rows (ids >= num_inputs) have zero band columns: never live
    gid = (win_block[:, :, None] * blk
           + jnp.arange(blk, dtype=jnp.int32)[None, None, :])
    return _masked_argmax(b_dense, gid.reshape(ng, wb * blk), win)


def _spill_pieces(x, spill_src, b_spill):
    """spill_src [m, sw] (num_inputs = the zero row, never live)."""
    m, sw = spill_src.shape
    xz = jnp.pad(x, ((0, 1), (0, 0)))
    rows = jnp.take(xz, spill_src.reshape(-1), axis=0).reshape(m, sw, -1)
    return _masked_argmax(b_spill, spill_src, rows)


def aligned_max_with_arg(x, st):
    """(y [S, F], arg [S, F]) over an aligned stage (uniform
    ``AlignedStageDev`` or bucketed ``AlignedStageBDev``) with
    record-table semantics; empty segments get y=0, arg=-1."""
    from hypergef.ops.tree import (
        _ALIGNED_BLOCK, AlignedStageBDev, AlignedStageDev)

    f = x.shape[1]
    if isinstance(st, AlignedStageDev):
        val, arg = _window_pieces(x, st.b_dense, st.win_block, _ALIGNED_BLOCK)
        if st.spill_src.shape[1]:
            val, arg = _combine(val, arg,
                                *_spill_pieces(x, st.spill_src, st.b_spill))
    elif isinstance(st, AlignedStageBDev):
        pieces = [_window_pieces(x, bk.b_dense, bk.win_block, st.block_rows)
                  for bk in st.buckets]
        val = jnp.take(jnp.concatenate([p[0] for p in pieces]), st.base_slot, axis=0)
        arg = jnp.take(jnp.concatenate([p[1] for p in pieces]), st.base_slot, axis=0)
        if st.spills:
            pieces = [_spill_pieces(x, sp.spill_src, sp.b_spill) for sp in st.spills]
            dead = (jnp.full((1, st.group_rows, f), _NEG, jnp.float32),
                    jnp.full((1, st.group_rows, f), -1, jnp.int32))
            sval = jnp.concatenate([p[0] for p in pieces] + [dead[0]])
            sarg = jnp.concatenate([p[1] for p in pieces] + [dead[1]])
            val, arg = _combine(val, arg, jnp.take(sval, st.spill_slot, axis=0),
                                jnp.take(sarg, st.spill_slot, axis=0))
    else:
        raise TypeError(f"aligned_max_with_arg needs an aligned stage, "
                        f"got {type(st).__name__}")
    y = val.reshape(-1, f)[: st.num_segments]
    a = arg.reshape(-1, f)[: st.num_segments]
    return jnp.where(a >= 0, y, 0.0), a


@jax.custom_vjp
def v2e_max_aligned(x, st):
    """``y[s, f] = max_{v ∈ s} x[v, f]`` over an aligned stage.  The VJP
    scatter-adds each cotangent onto its recorded winner: exact."""
    return aligned_max_with_arg(x, st)[0]


def _v2e_max_aligned_fwd(x, st):
    y, arg = aligned_max_with_arg(x, st)
    return y, (arg, st)


def _v2e_max_aligned_bwd(res, g):
    arg, st = res
    n, f = st.num_inputs, g.shape[1]
    live = arg >= 0
    cols = jnp.broadcast_to(jnp.arange(f, dtype=jnp.int32), arg.shape)
    dx = jnp.zeros((n, f), g.dtype).at[jnp.where(live, arg, n), cols].add(
        jnp.where(live, g, 0.0), mode="drop")
    return dx, None


v2e_max_aligned.defvjp(_v2e_max_aligned_fwd, _v2e_max_aligned_bwd)
