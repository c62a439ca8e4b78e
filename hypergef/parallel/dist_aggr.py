"""Distributed fused aggregation under ``shard_map``.

SPMD program per device (mesh axis ``"e"`` = hyperedge partition,
optional ``"f"`` = feature/tensor partition):

    xe_local   = local V→E reduction tree over X        (X rows replicated
                 along "e", feature-sharded along "f" — every index op is
                 row-wise so feature shards are independent)
    xe_local  *= degE_local (* Wdiag_local)             (device-local: the
                 partition is hyperedge-contiguous by design)
    part_local = local E→V reduction tree → [N, F] partial
    out        = psum(part_local, "e") * degV           (the multi-device
                 replacement for the reference's atomicAdd combination)

Gradients flow through ``shard_map`` + ``psum`` exactly (psum transposes
to identity broadcast; the local trees carry their own scatter-free
custom VJP).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from hypergef.parallel.mesh import EDGE_AXIS, FEATURE_AXIS
from hypergef.ops.tree import tree_matvec


def _squeeze0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


from hypergef.ops.tree import apply_levels as _local_stage  # noqa: E402


def _plan_specs(plan_dev):
    """PartitionSpec pytree for the stacked plan (leading axis = 'e')."""
    return jax.tree_util.tree_map(lambda _: P(EDGE_AXIS), plan_dev)


def sharded_hgnn_aggregate(
    plan,
    mesh,
    x,
    wdiag_stacked: Optional[jax.Array] = None,
    first_aggr: str = "sum",
    degV: Optional[jax.Array] = None,
    feature_sharded: bool = False,
):
    """HGNN aggregation over an edge-partitioned mesh.

    ``plan`` is a :class:`ShardedAggPlan`; ``x`` is [N, F] (replicated on
    the edge axis); ``wdiag_stacked`` is [D, e_pad, 1] from
    ``plan.shard_edge_vector``.  Returns [N, F], replicated (psum'd).
    """
    if first_aggr not in ("sum", "mean", "max"):
        raise ValueError("sharded path supports first_aggr in {sum, mean, max}")
    plan_dev = plan.device()
    # max: X is replicated and the partition is hyperedge-contiguous, so
    # every shard sees the FULL membership of its local edges — the local
    # argmax-carrying tree (ops/maxops) is exact, and only the E→V sum
    # partials cross chips (psum), exactly like sum/mean.  The record-
    # table VJP needs each shard's vertex-major local CSR (max_device()).
    maxb_dev = plan.max_device() if first_aggr == "max" else None
    fspec = FEATURE_AXIS if feature_sharded else None
    x_spec = P(None, fspec)
    w_spec = P(EDGE_AXIS)
    dv_spec = P(None, None)

    def body(plan_local, maxb_local, x_full, wdiag, degv):
        (e_levels, e_fi, e_fm, e_cn, v_levels, v_fi, v_fm, degE) = _squeeze0(
            plan_local
        )
        if first_aggr == "max":
            from hypergef.ops.maxops import v2e_max_tree

            h_ip, h_ed, h_sg = _squeeze0(maxb_local)
            xe = v2e_max_tree(
                x_full, (e_levels, e_fi, e_fm, e_cn), h_ed, h_sg, h_ip
            )
        else:
            xe = _local_stage(x_full, e_levels, e_fi, e_fm)
            if first_aggr == "mean":
                xe = xe / jnp.maximum(e_cn, 1.0)[:, None]
        xe = xe * degE
        if wdiag is not None:
            xe = xe * wdiag[0]
        part = _local_stage(xe, v_levels, v_fi, v_fm)
        out = jax.lax.psum(part, EDGE_AXIS)
        if degv is not None:
            out = out * degv
        return out

    specs_in = (
        _plan_specs(plan_dev),
        None if maxb_dev is None else jax.tree_util.tree_map(
            lambda _: P(EDGE_AXIS), maxb_dev
        ),
        x_spec,
        None if wdiag_stacked is None else w_spec,
        None if degV is None else dv_spec,
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=specs_in,
        out_specs=P(None, fspec),
        check_vma=False,
    )
    return fn(plan_dev, maxb_dev, x, wdiag_stacked, degV)


def sharded_unignn_aggregate(
    plan, mesh, x, use_deg: bool = False, degV: Optional[jax.Array] = None,
    feature_sharded: bool = False,
):
    plan_dev = plan.device()
    fspec = FEATURE_AXIS if feature_sharded else None

    def body(plan_local, x_full, degv):
        (e_levels, e_fi, e_fm, _e_cn, v_levels, v_fi, v_fm, degE) = _squeeze0(
            plan_local
        )
        xe = _local_stage(x_full, e_levels, e_fi, e_fm)
        if use_deg:
            xe = xe * degE
        part = _local_stage(xe, v_levels, v_fi, v_fm)
        out = jax.lax.psum(part, EDGE_AXIS)
        if use_deg and degv is not None:
            out = out * degv
        return out

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            _plan_specs(plan_dev),
            P(None, fspec),
            None if degV is None else P(None, None),
        ),
        out_specs=P(None, fspec),
        check_vma=False,
    )
    return fn(plan_dev, x, degV)
