"""Serialized full TRAIN STEP over a multi-shard :class:`HaloPlan`:
fwd + loss + bwd + Adam, one shard at a time on one device,
host-staging every exchange — so the 100M-nnz regime gets an
end-to-end epoch number, not just a layer time.

Design (rematerialization): the cross-shard dataflow is
linear (exchanges are permutations + one owner-side gather), so the
global VJP factors into per-shard VJPs glued by host-side transposes:

* forward: per-shard jitted programs (linear → edge-stage compute →
  return exchange → combine), exactly
  :func:`hypergef.parallel.serial_halo.serialized_halo_forward`'s
  decomposition with the model's dense layers folded in;
* backward: runs the shards in the same one-at-a-time discipline; each
  shard's VJP program RECOMPUTES its forward inside one jitted call
  (``jax.vjp`` under ``jit``), so no shard's residuals outlive its
  turn — the serialized-memory invariant that makes 100M nnz fit one
  chip extends to the backward pass;
* exchange transposes on the host: the return/halo permutes transpose
  to their inverse permutes; the owner-side halo gather transposes to
  one ``np.add.at`` scatter per shard (host-side, no device scatter);
* Adam (optax) updates the replicated dense weights on the host.

Model: the 2-layer HGNN stack of the e2e protocol — z =
A(relu(A(X·W1))·W2), A = diag(degV)·H·diag(degE)·Hᵀ (the fused layer),
masked CE loss.  Gradient exactness is asserted against the full-graph
oracle + jax.grad in tests/test_serial_halo_train.py.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np


def _programs(plan, first_aggr="sum"):
    """Build the per-shard jitted programs (shared by every shard and
    both layers at equal feature width — a handful of compiles total)."""
    import jax
    import jax.numpy as jnp

    from hypergef.ops.tree import apply_levels
    from hypergef.parallel.serial_halo import _edge_stage

    D = plan.n_shards
    b_cap_h = plan.halo_send_slot.shape[2]

    def compute(x_blk, halo_in_d, ops):
        f = x_blk.shape[1]
        x_t = jnp.take(halo_in_d.reshape(D * b_cap_h, f), ops["halo_idx"],
                       axis=0)
        xe = _edge_stage(plan, x_blk, x_t, ops, first_aggr, jnp)
        xe = xe * ops["degE"]
        part = apply_levels(xe, ops["v_levels"], ops["v_fi"], ops["v_fm"])
        b_cap = ops["send_slot"].shape[1]
        return (
            jnp.take(part, ops["send_slot"].reshape(-1), axis=0)
            .reshape(D, b_cap, f) * ops["send_mask"][:, :, None]
        )

    def combine(ret_in_d, ops):
        f = ret_in_d.shape[-1]
        out = apply_levels(ret_in_d.reshape(-1, f), ops["own_levels"],
                           ops["own_fi"], ops["own_fm"])
        return out * ops["degV_own"]

    @jax.jit
    def linear(w, x_blk):
        return x_blk @ w

    @jax.jit
    def linear_vjp(w, x_blk, dxw):
        # dW contribution of this shard + upstream feature cotangent
        _, vjp = jax.vjp(lambda ww, xx: xx @ ww, w, x_blk)
        return vjp(dxw)

    @jax.jit
    def compute_fwd(x_blk, halo_in_d, ops):
        return compute(x_blk, halo_in_d, ops)

    @jax.jit
    def compute_vjp(x_blk, halo_in_d, ops, dret):
        _, vjp = jax.vjp(lambda a, b: compute(a, b, ops), x_blk, halo_in_d)
        return vjp(dret)

    @jax.jit
    def combine_relu_fwd(ret_in_d, ops):
        return jax.nn.relu(combine(ret_in_d, ops))

    @jax.jit
    def combine_relu_vjp(ret_in_d, ops, dh):
        _, vjp = jax.vjp(lambda r: jax.nn.relu(combine(r, ops)), ret_in_d)
        return vjp(dh)[0]

    @jax.jit
    def combine_loss_fwd(ret_in_d, ops, y_d, m_d):
        z = combine(ret_in_d, ops)
        logp = jax.nn.log_softmax(z, axis=-1)
        picked = jnp.take_along_axis(logp, y_d[:, None], axis=1)[:, 0]
        return -jnp.sum(picked * m_d), jnp.sum(m_d)

    @jax.jit
    def combine_loss_vjp(ret_in_d, ops, y_d, m_d, denom):
        def f(r):
            z = combine(r, ops)
            logp = jax.nn.log_softmax(z, axis=-1)
            picked = jnp.take_along_axis(logp, y_d[:, None], axis=1)[:, 0]
            return -jnp.sum(picked * m_d) / denom

        loss, vjp = jax.vjp(f, ret_in_d)
        return vjp(jnp.ones(()))[0]

    return dict(
        linear=linear, linear_vjp=linear_vjp,
        compute_fwd=compute_fwd, compute_vjp=compute_vjp,
        combine_relu_fwd=combine_relu_fwd, combine_relu_vjp=combine_relu_vjp,
        combine_loss_fwd=combine_loss_fwd, combine_loss_vjp=combine_loss_vjp,
    )


def _halo_exchange(plan, xw, D, b_cap_h):
    """Host halo exchange: owners gather + permute.  xw [D, n_own, F]."""
    halo_out = np.stack([
        xw[d][plan.halo_send_slot[d].reshape(-1)].reshape(D, b_cap_h, -1)
        for d in range(D)
    ])  # [src, dst, b_cap_h, F]
    return halo_out.transpose(1, 0, 2, 3)  # [recv, src, b_cap_h, F]


def _halo_exchange_T(plan, dhalo_in, D, b_cap_h, n_own, f):
    """Transpose of :func:`_halo_exchange`: permute back + per-owner
    host scatter-add over the send slots."""
    dhalo_out = np.asarray(dhalo_in).transpose(1, 0, 2, 3)  # [src, dst, ...]
    dxw = np.zeros((D, n_own, f), np.float32)
    for d in range(D):
        np.add.at(dxw[d], plan.halo_send_slot[d].reshape(-1),
                  dhalo_out[d].reshape(D * b_cap_h, f))
    return dxw


def _layer_forward(plan, progs, jnp, xw, stats):
    """Serialized halo layer on pre-linear features xw [D, n_own, F]:
    returns ret_in [D(recv), D(src), b_cap, F] (pre-combine partials) —
    the combine itself differs between hidden (relu) and loss layers."""
    import time as _time

    D = plan.n_shards
    b_cap_h = plan.halo_send_slot.shape[2]
    from hypergef.parallel.serial_halo import _shard_ops

    halo_in = _halo_exchange(plan, xw, D, b_cap_h)
    ret_all = []
    ops = ret = None
    for d in range(D):
        del ops, ret  # one shard's device tables at a time
        t0 = _time.perf_counter()
        ops = _shard_ops(plan, d, jnp)
        ret = progs["compute_fwd"](jnp.asarray(xw[d]),
                                   jnp.asarray(halo_in[d]), ops)
        ret_all.append(np.asarray(ret))
        stats.setdefault("shard_s", []).append(_time.perf_counter() - t0)
    del ops, ret
    return np.stack(ret_all).transpose(1, 0, 2, 3), halo_in


def _layer_backward(plan, progs, jnp, xw, halo_in, dret_in):
    """Serialized backward of one halo layer: given the cotangent of the
    pre-combine partials (dret_in [recv, src, b_cap, F]), recompute each
    shard's forward inside its VJP program and return dxw [D, n_own, F]."""
    D = plan.n_shards
    b_cap_h = plan.halo_send_slot.shape[2]
    n_own = plan.n_own
    f = xw.shape[-1]
    from hypergef.parallel.serial_halo import _shard_ops

    dret_out = np.asarray(dret_in).transpose(1, 0, 2, 3)  # [src(=d), recv...]
    dxw = np.zeros((D, n_own, f), np.float32)
    dhalo_in = np.zeros((D, D, b_cap_h, f), np.float32)
    ops = None
    for d in range(D):
        del ops
        ops = _shard_ops(plan, d, jnp)
        dx_d, dh_d = progs["compute_vjp"](
            jnp.asarray(xw[d]), jnp.asarray(halo_in[d]), ops,
            jnp.asarray(dret_out[d]))
        dxw[d] = np.asarray(dx_d)
        dhalo_in[d] = np.asarray(dh_d).reshape(D, b_cap_h, f)
    del ops
    dxw += _halo_exchange_T(plan, dhalo_in, D, b_cap_h, n_own, f)
    return dxw


def serialized_halo_train_step(
    plan,
    params: Dict[str, np.ndarray],
    x: np.ndarray,
    y: np.ndarray,
    train_mask: np.ndarray,
    stats: Optional[dict] = None,
):
    """One full-batch train step (fwd+loss+bwd) of the 2-layer HGNN
    stack over a halo-sharded graph, serialized on one device.

    params: {"w1": [F, H], "w2": [H, C]} (C padded to a lane-friendly
    width by the caller; extra classes never win argmax if masked y
    stays in range).  Returns (loss, grads dict).
    """
    import jax.numpy as jnp

    from hypergef.parallel.halo_aggr import shard_vertex_features

    progs = _programs(plan)
    D, n_own = plan.n_shards, plan.n_own
    st = stats if stats is not None else {}

    x = np.asarray(x, np.float32)
    xs = shard_vertex_features(plan, x).reshape(D, n_own, -1)
    y_sh = shard_vertex_features(plan, np.asarray(y, np.int32)[:, None])
    y_sh = y_sh.reshape(D, n_own).astype(np.int32)
    m_sh = shard_vertex_features(
        plan, np.asarray(train_mask, np.float32)[:, None]).reshape(D, n_own)

    w1 = jnp.asarray(params["w1"])
    w2 = jnp.asarray(params["w2"])

    # ---- forward ----
    xw1 = np.stack([np.asarray(progs["linear"](w1, jnp.asarray(xs[d])))
                    for d in range(D)])
    ret_in1, halo_in1 = _layer_forward(plan, progs, jnp, xw1, st)
    from hypergef.parallel.serial_halo import _shard_combine_ops

    h = np.zeros((D, n_own, w1.shape[1]), np.float32)
    ops = None
    for d in range(D):
        del ops
        ops = _shard_combine_ops(plan, d, jnp)
        h[d] = np.asarray(progs["combine_relu_fwd"](
            jnp.asarray(ret_in1[d]), ops))
    del ops

    hw2 = np.stack([np.asarray(progs["linear"](w2, jnp.asarray(h[d])))
                    for d in range(D)])
    ret_in2, halo_in2 = _layer_forward(plan, progs, jnp, hw2, st)
    loss_num = 0.0
    denom = 0.0
    ops = None
    for d in range(D):
        del ops
        ops = _shard_combine_ops(plan, d, jnp)
        ln, dn = progs["combine_loss_fwd"](
            jnp.asarray(ret_in2[d]), ops, jnp.asarray(y_sh[d]),
            jnp.asarray(m_sh[d]))
        loss_num += float(ln)
        denom += float(dn)
    del ops
    denom = max(denom, 1.0)
    loss = loss_num / denom

    # ---- backward ----
    dret_in2 = np.zeros_like(ret_in2)
    ops = None
    for d in range(D):
        del ops
        ops = _shard_combine_ops(plan, d, jnp)
        dret_in2[d] = np.asarray(progs["combine_loss_vjp"](
            jnp.asarray(ret_in2[d]), ops, jnp.asarray(y_sh[d]),
            jnp.asarray(m_sh[d]), jnp.asarray(np.float32(denom))))
    del ops
    dhw2 = _layer_backward(plan, progs, jnp, hw2, halo_in2, dret_in2)

    dw2 = np.zeros_like(np.asarray(w2))
    dh = np.zeros_like(h)
    for d in range(D):
        g_w, g_x = progs["linear_vjp"](w2, jnp.asarray(h[d]),
                                       jnp.asarray(dhw2[d]))
        dw2 += np.asarray(g_w)
        dh[d] = np.asarray(g_x)

    dret_in1 = np.zeros_like(ret_in1)
    ops = None
    for d in range(D):
        del ops
        ops = _shard_combine_ops(plan, d, jnp)
        dret_in1[d] = np.asarray(progs["combine_relu_vjp"](
            jnp.asarray(ret_in1[d]), ops, jnp.asarray(dh[d])))
    del ops
    dxw1 = _layer_backward(plan, progs, jnp, xw1, halo_in1, dret_in1)

    dw1 = np.zeros_like(np.asarray(w1))
    for d in range(D):
        g_w, _ = progs["linear_vjp"](w1, jnp.asarray(xs[d]),
                                     jnp.asarray(dxw1[d]))
        dw1 += np.asarray(g_w)

    return loss, {"w1": dw1, "w2": dw2}


def serialized_halo_train_epochs(
    plan, x, y, train_mask, nhid: int, nclass: int,
    epochs: int = 1, lr: float = 0.01, wd: float = 5e-4, seed: int = 0,
    stats: Optional[dict] = None,
):
    """Full-batch epochs (1 step each, reference protocol) with host-side
    Adam over the replicated dense weights.  Returns (params, losses)."""
    import optax

    rng = np.random.default_rng(seed)
    f = x.shape[1]
    c_pad = max(nclass, 8)
    params = {
        "w1": (rng.normal(size=(f, nhid)) / np.sqrt(f)).astype(np.float32),
        "w2": (rng.normal(size=(nhid, c_pad)) / np.sqrt(nhid)).astype(
            np.float32),
    }
    tx = optax.adamw(lr, weight_decay=wd)
    opt_state = tx.init(params)
    losses = []
    for _ in range(epochs):
        loss, grads = serialized_halo_train_step(
            plan, params, x, y, train_mask, stats=stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = {k: np.asarray(params[k] + updates[k]) for k in params}
        losses.append(loss)
    return params, losses
