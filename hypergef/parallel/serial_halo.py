"""Serialized single-device execution of a multi-shard :class:`HaloPlan`.

Runs the D shard programs of a halo-sharded layer **back-to-back on one
device**, staging the two all_to_all exchanges through the host.  Three
uses:

* validating the halo decomposition bit-for-bit against the single-device
  fused op without D devices (test-time);
* executing graphs whose aligned tables exceed one device's memory (the
  100M-nnz regime) on a single device — slower than D devices, but a
  *measured* number instead of a projection;
* measuring true per-shard compute + the REAL exchange buffer sizes so
  only the link transfer term of a multi-device projection stays
  modeled.

Every shard's program has identical shapes (the plan's stacked arrays
guarantee it), so all D shards share ONE compiled program per phase.

Semantics: identical to ``halo_aggr.halo_hgnn_aggregate`` (same plan
arrays, same compute graph, host permutation replacing
``jax.lax.all_to_all``).  Reference: the fused two-stage aggregation of
``hgnnaggr_cuda.cu:14-47`` sharded as SURVEY.md §2.9 prescribes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _verbose() -> bool:
    import os

    return os.environ.get("HYPERGEF_SERIAL_VERBOSE", "0") == "1"


def _shard_ops(plan, d, jnp):
    """Device operand pytree for shard ``d`` (host→device per shard)."""
    if _verbose():
        return _shard_ops_verbose(plan, d, jnp)
    j = jnp.asarray
    ops = dict(
        int_levels=tuple((j(g[d]), j(m[d])) for g, m in plan.int_levels),
        int_fi=j(plan.int_final_idx[d]), int_fm=j(plan.int_final_mask[d]),
        bnd_levels=tuple((j(g[d]), j(m[d])) for g, m in plan.bnd_levels),
        bnd_fi=j(plan.bnd_final_idx[d]), bnd_fm=j(plan.bnd_final_mask[d]),
        asm_idx=j(plan.asm_idx[d]), e_cn=j(plan.e_counts[d]),
        v_levels=tuple((j(g[d]), j(m[d])) for g, m in plan.v_levels),
        v_fi=j(plan.v_final_idx[d]), v_fm=j(plan.v_final_mask[d]),
        send_slot=j(plan.send_slot[d]), send_mask=j(plan.send_mask[d]),
        own_levels=tuple((j(g[d]), j(m[d])) for g, m in plan.own_levels),
        own_fi=j(plan.own_final_idx[d]), own_fm=j(plan.own_final_mask[d]),
        degE=j(plan.degE[d]), degV_own=j(plan.degV_own[d]),
        halo_idx=j(plan.halo_idx[d]),
    )
    if plan.local_form == "aligned":
        al = plan.int_aligned
        ops["aligned"] = tuple(
            j(al[leg][k][d])
            for leg in ("fwd", "bwd")
            for k in ("b_dense", "win_block", "spill_src", "b_spill")
        )
    return ops


def _shard_combine_ops(plan, d, jnp):
    """Owner-combine subset of :func:`_shard_ops` — the only tables the
    phase-3 combine touches (staging the full shard ops there moves
    ~5 GB/shard of redundant bytes at the 100M scale)."""
    j = jnp.asarray
    return dict(
        own_levels=tuple((j(g[d]), j(m[d])) for g, m in plan.own_levels),
        own_fi=j(plan.own_final_idx[d]),
        own_fm=j(plan.own_final_mask[d]),
        degV_own=j(plan.degV_own[d]),
    )


def _shard_ops_verbose(plan, d, jnp):
    """Diagnostic twin of :func:`_shard_ops`: stages each array with a
    forced round-trip fence and logs size + time, so a stalled host→device
    transfer is localized to the exact array.
    Enable: HYPERGEF_SERIAL_VERBOSE=1."""
    import sys
    import time as _t

    import numpy as np

    def j(a, name):
        a = np.ascontiguousarray(a)
        t0 = _t.perf_counter()
        dev = jnp.asarray(a)
        # force the transfer to complete: tiny scalar fetch (the only
        # reliable fence on this backend — block_until_ready is a no-op)
        _ = np.asarray(dev.ravel()[:1])
        dt = _t.perf_counter() - t0
        if a.nbytes > 1 << 20:
            print(f"    [shard {d}] {name}: {a.nbytes/1e6:.0f} MB "
                  f"in {dt:.1f}s", file=sys.stderr, flush=True)
        return dev

    ops = dict(
        int_levels=tuple((j(g[d], f"int_l{i}g"), j(m[d], f"int_l{i}m"))
                         for i, (g, m) in enumerate(plan.int_levels)),
        int_fi=j(plan.int_final_idx[d], "int_fi"),
        int_fm=j(plan.int_final_mask[d], "int_fm"),
        bnd_levels=tuple((j(g[d], f"bnd_l{i}g"), j(m[d], f"bnd_l{i}m"))
                         for i, (g, m) in enumerate(plan.bnd_levels)),
        bnd_fi=j(plan.bnd_final_idx[d], "bnd_fi"),
        bnd_fm=j(plan.bnd_final_mask[d], "bnd_fm"),
        asm_idx=j(plan.asm_idx[d], "asm_idx"),
        e_cn=j(plan.e_counts[d], "e_cn"),
        v_levels=tuple((j(g[d], f"v_l{i}g"), j(m[d], f"v_l{i}m"))
                       for i, (g, m) in enumerate(plan.v_levels)),
        v_fi=j(plan.v_final_idx[d], "v_fi"),
        v_fm=j(plan.v_final_mask[d], "v_fm"),
        send_slot=j(plan.send_slot[d], "send_slot"),
        send_mask=j(plan.send_mask[d], "send_mask"),
        own_levels=tuple((j(g[d], f"own_l{i}g"), j(m[d], f"own_l{i}m"))
                         for i, (g, m) in enumerate(plan.own_levels)),
        own_fi=j(plan.own_final_idx[d], "own_fi"),
        own_fm=j(plan.own_final_mask[d], "own_fm"),
        degE=j(plan.degE[d], "degE"),
        degV_own=j(plan.degV_own[d], "degV_own"),
        halo_idx=j(plan.halo_idx[d], "halo_idx"),
    )
    if plan.local_form == "aligned":
        al = plan.int_aligned
        ops["aligned"] = tuple(
            j(al[leg][k][d], f"aligned_{leg}_{k}")
            for leg in ("fwd", "bwd")
            for k in ("b_dense", "win_block", "spill_src", "b_spill")
        )
    return ops


def _edge_stage(plan, x_blk, x_t, ops, first_aggr, jnp):
    """Per-shard V→E (interior + boundary) + assembly → [e_pad, F]."""
    from hypergef.ops.tree import apply_levels, apply_levels_max

    if plan.local_form == "aligned":
        from hypergef.ops.tree import AlignedStageDev, tree_matvec

        (af_bd, af_wb, af_ss, af_bs,
         ab_bd, ab_wb, ab_ss, ab_bs) = ops["aligned"]
        fwd = AlignedStageDev(
            b_dense=af_bd, win_block=af_wb, spill_src=af_ss, b_spill=af_bs,
            counts=ops["degE"][:, 0], num_inputs=plan.n_own,
            num_segments=plan.e_int_pad, group_rows=128,
            window_blocks=plan.int_aligned["wb_f"],
        )
        bwd = AlignedStageDev(
            b_dense=ab_bd, win_block=ab_wb, spill_src=ab_ss, b_spill=ab_bs,
            counts=ops["degV_own"][:, 0], num_inputs=plan.e_int_pad,
            num_segments=plan.n_own, group_rows=128,
            window_blocks=plan.int_aligned["wb_b"],
        )
        if first_aggr == "max":
            from hypergef.ops.maxops import v2e_max_aligned

            xe_int = v2e_max_aligned(x_blk, fwd)
        else:
            xe_int = tree_matvec(x_blk, fwd, bwd)
    elif first_aggr == "max":
        xe_int = apply_levels_max(x_blk, ops["int_levels"], ops["int_fi"],
                                  ops["int_fm"])
    else:
        xe_int = apply_levels(x_blk, ops["int_levels"], ops["int_fi"],
                              ops["int_fm"])
    if first_aggr == "max":
        xe_bnd = apply_levels_max(x_t, ops["bnd_levels"], ops["bnd_fi"],
                                  ops["bnd_fm"])
    else:
        xe_bnd = apply_levels(x_t, ops["bnd_levels"], ops["bnd_fi"],
                              ops["bnd_fm"])
    f = x_blk.shape[1]
    xe_cat = jnp.concatenate(
        [xe_int, xe_bnd, jnp.zeros((1, f), xe_int.dtype)], axis=0
    )
    return jnp.take(xe_cat, ops["asm_idx"], axis=0)


def serialized_halo_forward(
    plan,
    x,
    first_aggr: str = "sum",
    wdiag: Optional[np.ndarray] = None,
    use_deg: bool = True,
    stats: Optional[Dict] = None,
):
    """Full-layer halo aggregation, one shard at a time on one device.

    ``x``: [num_nodes, F] host features.  Returns [num_nodes, F].
    ``stats`` (optional dict) is filled with real exchange byte counts
    and per-shard wall times.
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    from hypergef.parallel.halo_aggr import (
        shard_vertex_features, unshard_vertex_features,
    )

    D, n_own = plan.n_shards, plan.n_own
    x = np.asarray(x, dtype=np.float32)
    f = x.shape[1]
    xs = shard_vertex_features(plan, x).reshape(D, n_own, f)
    # wdiag comes pre-stacked per local edge slot ([D, e_pad, 1]), the
    # layout halo_aggr's train step uses
    wd = None
    if wdiag is not None:
        wd = np.asarray(wdiag, dtype=np.float32)
        if wd.shape != (D, plan.e_pad, 1):
            raise ValueError(
                f"wdiag must be stacked [D, e_pad, 1]={D, plan.e_pad, 1}, "
                f"got {wd.shape}"
            )

    # phase 1 — halo out (pure host gather; owners send owned X rows).
    # No masking: matches halo_aggr.body exactly (halo_idx only ever
    # addresses live slots)
    b_cap_h = plan.halo_send_slot.shape[2]
    halo_out = np.stack([
        xs[d][plan.halo_send_slot[d].reshape(-1)].reshape(D, b_cap_h, f)
        for d in range(D)
    ])  # [src, dst, b_cap_h, F]
    halo_in = halo_out.transpose(1, 0, 2, 3)  # [recv, src, b_cap_h, F]

    # phase 2 — per-shard compute (ONE compiled program, D executions)
    def compute(x_blk, halo_in_d, ops, wdiag_d):
        x_t = jnp.take(halo_in_d.reshape(D * b_cap_h, f), ops["halo_idx"],
                       axis=0)
        xe = _edge_stage(plan, x_blk, x_t, ops, first_aggr, jnp)
        if first_aggr == "mean":
            xe = xe / jnp.maximum(ops["e_cn"], 1.0)[:, None]
        if use_deg:
            xe = xe * ops["degE"]
        if wdiag_d is not None:
            xe = xe * wdiag_d
        from hypergef.ops.tree import apply_levels

        part = apply_levels(xe, ops["v_levels"], ops["v_fi"], ops["v_fm"])
        b_cap = ops["send_slot"].shape[1]
        ret_out = (
            jnp.take(part, ops["send_slot"].reshape(-1), axis=0)
            .reshape(D, b_cap, f) * ops["send_mask"][:, :, None]
        )
        return ret_out

    compute_j = jax.jit(compute)
    # Host-memory discipline (round-5: the 100M run was OOM-KILLED at
    # 130 GB host RSS in phase 3): the return buffer is preallocated
    # ONCE ([D, D, b_cap, F] ≈ 20 GB at 100M) and filled per shard —
    # the list+stack form held it twice; the halo buffers and the
    # sharded feature copy are released the moment their phase ends.
    b_cap = plan.send_slot.shape[2]
    ret_all = np.empty((D, D, b_cap, f), np.float32)  # [src, dst, b_cap, F]
    shard_s = []
    verbose = _verbose()
    ops = ret = None
    for d in range(D):
        # Release the previous shard's device tables BEFORE staging the
        # next: at ~12M nnz/shard two shards' aligned tables alive at
        # once can exhaust device memory — serialized execution must
        # hold exactly one shard's operands at a time.
        del ops, ret
        t_st = _time.perf_counter()
        ops = _shard_ops(plan, d, jnp)
        wdiag_d = None if wd is None else jnp.asarray(wd[d])
        t0 = _time.perf_counter()
        if verbose:
            import sys

            print(f"  [shard {d}] staged in {t0-t_st:.1f}s; computing...",
                  file=sys.stderr, flush=True)
        ret = compute_j(jnp.asarray(xs[d]), jnp.asarray(halo_in[d]), ops,
                        wdiag_d)
        ret_all[d] = np.asarray(ret)  # fetch = device fence
        shard_s.append(_time.perf_counter() - t0)
        if verbose:
            print(f"  [shard {d}] compute+fetch {shard_s[-1]:.1f}s",
                  file=sys.stderr, flush=True)
    del ops, ret, halo_in, halo_out, xs
    ret_in = ret_all.transpose(1, 0, 2, 3)  # [recv, src, b_cap, F] (view)

    # phase 3 — owner-side combine (small; same device).  Stages ONLY
    # the owner-combine tables: re-staging the full shard ops here costs
    # ~5 GB/shard of redundant transfer at the 100M scale.
    def combine(ret_in_d, ops):
        from hypergef.ops.tree import apply_levels

        out = apply_levels(ret_in_d.reshape(-1, f), ops["own_levels"],
                           ops["own_fi"], ops["own_fm"])
        return out * ops["degV_own"] if use_deg else out

    combine_j = jax.jit(combine)
    outs = []
    ops = None
    for d in range(D):
        del ops  # one shard's tables on device at a time (see phase 2)
        ops = _shard_combine_ops(plan, d, jnp)
        outs.append(np.asarray(combine_j(jnp.asarray(ret_in[d]), ops)))
    del ops
    out_own = np.concatenate(outs, axis=0)  # [D·n_own, F]

    if stats is not None:
        stats["halo_bytes_real"] = int(plan.halo_mask.sum()) * f * 4
        stats["return_bytes_real"] = int(plan.send_mask.sum()) * f * 4
        stats["per_shard_wall_s"] = shard_s
        stats["n_shards"] = D
    return unshard_vertex_features(plan, out_own)[: plan.num_nodes]
