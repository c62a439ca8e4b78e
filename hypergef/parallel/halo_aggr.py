"""Fully-sharded halo aggregation under ``shard_map``.

Per-device program for one fused HGNN aggregation with X *vertex-sharded*
(owned blocks of ⌈N/D⌉ rows per device) — communication is two
``all_to_all`` calls of the boundary sets only (comm ∝ cut size):

    1. halo in:   owners send the X rows each worker's edges touch
    2. local:     V→E tree (compact touched ids) → scale → E→V tree
    3. return:    workers send per-owner partial rows back
    4. combine:   owner-side reduction tree accumulates incoming partials
                  → out owned block ⊙ degV

Exact gradients flow through ``all_to_all`` (its transpose is the
reverse all_to_all) and the scatter-free local trees.

``first_aggr`` ∈ {sum, mean, max}: max runs the interior and boundary
V→E trees in max-combine form (``ops.tree.apply_levels_max`` — the
distributed counterpart of the reference's record-table max kernels,
``hgnnaggr_cuda.cu:144-208``); an aligned interior runs the masked
argmax over its band (``ops.maxops.v2e_max_aligned``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from hypergef.parallel.mesh import EDGE_AXIS


def _sq(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


from hypergef.ops.tree import apply_levels as _apply_levels  # noqa: E402
from hypergef.ops.tree import apply_levels_max as _apply_levels_max  # noqa: E402


def halo_hgnn_aggregate(plan, mesh, x_own, wdiag_stacked=None,
                        first_aggr: str = "sum", plan_dev=None,
                        use_deg: bool = True):
    """x_own: [D·n_own, F] vertex-sharded on the edge axis (each device
    holds its owned block).  Returns the aggregated output in the same
    sharded layout.

    ``plan_dev``: optional pre-built device pytree (``plan.device()``
    layout).  Multi-process (multi-host) callers pass globally-sharded
    arrays here — ``plan.device()`` builds process-local ones, which a
    cross-process mesh cannot consume directly."""
    if first_aggr not in ("sum", "mean", "max"):
        raise ValueError("halo path supports first_aggr in {sum, mean, max}")
    if plan_dev is None:
        plan_dev = plan.device()
    specs = jax.tree_util.tree_map(lambda _: P(EDGE_AXIS), plan_dev)

    def body(pl, x_blk, wdiag):
        (int_levels, int_fi, int_fm, bnd_levels, bnd_fi, bnd_fm,
         asm_idx, e_cn, v_levels, v_fi, v_fm,
         send_slot, send_mask, halo_send_slot, halo_idx,
         own_levels, own_fi, own_fm, degE, degV_own, aligned) = _sq(pl)
        x_blk = x_blk  # [n_own, F] owned rows
        f = x_blk.shape[1]
        # 1. halo out (as owner): gather rows for each dst, all_to_all
        hs = halo_send_slot  # [D, b_cap_h]
        d_, b_cap_h = hs.shape
        halo_out = jnp.take(x_blk, hs.reshape(-1), axis=0).reshape(d_, b_cap_h, f)
        halo_in = jax.lax.all_to_all(
            halo_out, EDGE_AXIS, split_axis=0, concat_axis=0, tiled=False
        )  # [D, b_cap_h, F]: block i = rows from owner i
        # 2a. INTERIOR V→E: reads x_blk only — no data dependence on the
        # all_to_all, so the latency-hiding scheduler can run this work
        # between the collective's start/done pair (the overlap workload).
        # Two forms: gather tree, or (community-sorted graphs) banded
        # aligned matmuls with the exact-VJP transpose stage.
        if plan.local_form == "aligned":
            from hypergef.ops.tree import AlignedStageDev, tree_matvec

            af_bd, af_wb, af_ss, af_bs, ab_bd, ab_wb, ab_ss, ab_bs = aligned
            fwd = AlignedStageDev(
                b_dense=af_bd, win_block=af_wb, spill_src=af_ss,
                b_spill=af_bs, counts=degE[:, 0],
                num_inputs=plan.n_own, num_segments=plan.e_int_pad,
                group_rows=128, window_blocks=plan.int_aligned["wb_f"],
            )
            bwd = AlignedStageDev(
                b_dense=ab_bd, win_block=ab_wb, spill_src=ab_ss,
                b_spill=ab_bs, counts=degV_own[:, 0],
                num_inputs=plan.e_int_pad, num_segments=plan.n_own,
                group_rows=128, window_blocks=plan.int_aligned["wb_b"],
            )
            if first_aggr == "max":
                # masked argmax over the band + record-routed VJP
                from hypergef.ops.maxops import v2e_max_aligned

                xe_int = v2e_max_aligned(x_blk, fwd)
            else:
                xe_int = tree_matvec(x_blk, fwd, bwd)
        elif first_aggr == "max":
            xe_int = _apply_levels_max(x_blk, int_levels, int_fi, int_fm)
        else:
            xe_int = _apply_levels(x_blk, int_levels, int_fi, int_fm)
        # 2b. boundary V→E over the (smaller) halo'd touched set
        x_t = jnp.take(halo_in.reshape(d_ * b_cap_h, f), halo_idx, axis=0)
        if first_aggr == "max":
            xe_bnd = _apply_levels_max(x_t, bnd_levels, bnd_fi, bnd_fm)
        else:
            xe_bnd = _apply_levels(x_t, bnd_levels, bnd_fi, bnd_fm)
        # 2c. assemble per-local-edge rows (static permutation, no scatter)
        xe_cat = jnp.concatenate(
            [xe_int, xe_bnd, jnp.zeros((1, f), xe_int.dtype)], axis=0
        )
        xe = jnp.take(xe_cat, asm_idx, axis=0)  # [e_pad, F]
        if first_aggr == "mean":
            xe = xe / jnp.maximum(e_cn, 1.0)[:, None]
        if use_deg:
            xe = xe * degE
        if wdiag is not None:
            xe = xe * wdiag[0]
        part = _apply_levels(xe, v_levels, v_fi, v_fm)  # [t_max, F]
        # 3. return partials to owners
        b_cap = send_slot.shape[1]
        ret_out = (
            jnp.take(part, send_slot.reshape(-1), axis=0).reshape(d_, b_cap, f)
            * send_mask[:, :, None]
        )
        ret_in = jax.lax.all_to_all(
            ret_out, EDGE_AXIS, split_axis=0, concat_axis=0, tiled=False
        )  # [D, b_cap, F]: block i = partials from worker i
        # 4. owner-side combine
        out = _apply_levels(
            ret_in.reshape(d_ * b_cap, f), own_levels, own_fi, own_fm
        )  # [n_own, F]
        return out * degV_own if use_deg else out

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            specs,
            P(EDGE_AXIS),
            None if wdiag_stacked is None else P(EDGE_AXIS),
        ),
        out_specs=P(EDGE_AXIS),
        check_vma=False,
    )
    return fn(plan_dev, x_own, wdiag_stacked)


def make_halo_train_step(mesh, plan, lr: float = 0.01, wd: float = 5e-4,
                         first_aggr: str = "sum", nclass: int = None):
    """Fully-sharded 2-layer HGNN training step: X, activations, labels
    and loss terms all live in the vertex-owner layout; the only
    cross-device traffic is the boundary all_to_all pairs (plus scalar
    psums for the loss).  Returns (jitted_step, tx, forward)."""
    import optax

    from hypergef.train.trainer import make_optimizer

    tx = make_optimizer(lr, wd)

    def forward(params, x_own):
        h = halo_hgnn_aggregate(plan, mesh, x_own @ params["W1"], None, first_aggr)
        h = jax.nn.relu(h)
        z = halo_hgnn_aggregate(plan, mesh, h @ params["W2"], None, first_aggr)
        if nclass is not None and z.shape[1] > nclass:
            col = jnp.arange(z.shape[1])[None, :]
            z = jnp.where(col < nclass, z, -1e30)
        return jax.nn.log_softmax(z, axis=1)

    def loss_fn(params, x_own, y_own, mask_own):
        logp = forward(params, x_own)
        picked = jnp.take_along_axis(logp, y_own[:, None], axis=1)[:, 0]
        return -jnp.sum(picked * mask_own) / jnp.maximum(mask_own.sum(), 1.0)

    @jax.jit
    def step(params, opt_state, x_own, y_own, mask_own):
        loss, grads = jax.value_and_grad(loss_fn)(params, x_own, y_own, mask_own)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, tx, forward


def shard_vertex_features(plan, x):
    """[N, F] → [D·n_own, F] padded owner-block layout (host-side prep)."""
    import numpy as np

    x = np.asarray(x)
    n_own, d = plan.n_own, plan.n_shards
    out = np.zeros((d * n_own, x.shape[1]), dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def unshard_vertex_features(plan, x_own):
    """[D·n_own, F] owner-block layout → [N, F]."""
    import numpy as np

    return np.asarray(x_own)[: plan.num_nodes]


def halo_unignn_aggregate(plan, mesh, x_own, use_deg: bool = False,
                          plan_dev=None):
    """UniGNN aggregation on the halo program: ``H Hᵀ X`` (plain, the
    UniGIN form) or ``degV·H·degE·Hᵀ·X`` (``use_deg=True``, the UniGCNII
    form) — reference semantics ``unignn_cuda`` minus its degV indexing
    bug (SURVEY §2.8-3)."""
    return halo_hgnn_aggregate(plan, mesh, x_own, None, "sum",
                               plan_dev=plan_dev, use_deg=use_deg)


def _halo_finish_step(tx, forward):
    import optax

    def loss_fn(params, x_own, y_own, mask_own):
        logp = forward(params, x_own)
        picked = jnp.take_along_axis(logp, y_own[:, None], axis=1)[:, 0]
        return -jnp.sum(picked * mask_own) / jnp.maximum(mask_own.sum(), 1.0)

    @jax.jit
    def step(params, opt_state, x_own, y_own, mask_own):
        loss, grads = jax.value_and_grad(loss_fn)(params, x_own, y_own, mask_own)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, tx, forward


def make_halo_unigin_train_step(mesh, plan, lr: float = 0.01,
                                wd: float = 5e-4, nclass: int = None):
    """Fully-sharded 2-layer UniGIN: ``(1+ε)·XW + H Hᵀ (XW)`` per layer
    in the vertex-owner layout (boundary all_to_alls only)."""
    from hypergef.train.trainer import make_optimizer

    tx = make_optimizer(lr, wd)

    def forward(params, x_own):
        xw = x_own @ params["W1"]
        h = halo_unignn_aggregate(plan, mesh, xw) + (1.0 + params["eps1"]) * xw
        h = jax.nn.relu(h)
        hw = h @ params["W2"]
        z = halo_unignn_aggregate(plan, mesh, hw) + (1.0 + params["eps2"]) * hw
        if nclass is not None and z.shape[1] > nclass:
            col = jnp.arange(z.shape[1])[None, :]
            z = jnp.where(col < nclass, z, -1e30)
        return jax.nn.log_softmax(z, axis=1)

    return _halo_finish_step(tx, forward)


def make_halo_unigcnii_train_step(mesh, plan, nlayer: int = 2,
                                  lamda: float = 0.5, alpha: float = 0.1,
                                  lr: float = 0.01, wd: float = 5e-4,
                                  nclass: int = None):
    """Fully-sharded UniGCNII: identity-mapping residual layers over the
    halo ``Xv = degV·H·degE·Hᵀ·X`` aggregation (reference
    ``unigcnii.py:23-36`` semantics; residuals stay in the owner
    layout, no extra communication)."""
    import math as _math

    from hypergef.train.trainer import make_optimizer

    tx = make_optimizer(lr, wd)
    betas = [_math.log(lamda / (i + 1) + 1.0) for i in range(nlayer)]

    def forward(params, x_own):
        h = jax.nn.relu(x_own @ params["lin_in"])
        h0 = h
        for i in range(nlayer):
            xv = halo_unignn_aggregate(plan, mesh, h, use_deg=True)
            xi = (1.0 - alpha) * xv + alpha * h0
            h = jax.nn.relu(
                (1.0 - betas[i]) * xi + betas[i] * (xi @ params[f"W{i}"])
            )
        z = h @ params["lin_out"]
        if nclass is not None and z.shape[1] > nclass:
            col = jnp.arange(z.shape[1])[None, :]
            z = jnp.where(col < nclass, z, -1e30)
        return jax.nn.log_softmax(z, axis=1)

    return _halo_finish_step(tx, forward)
