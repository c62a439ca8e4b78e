"""Distributed full-batch training step (edge-partitioned HGNN).

The multi-chip training path for BASELINE config #5: a functional 2-layer
HGNN whose aggregations run the edge-partitioned ``shard_map`` program
(:mod:`hypergef.parallel.dist_aggr`) while the dense projections and
optimizer run under GSPMD around it.  Works on any ``(e, f)`` mesh —
including the simulated CPU mesh used in tests and the driver's
multi-chip dry-run.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from hypergef.parallel.dist_aggr import sharded_hgnn_aggregate
from hypergef.train.trainer import make_optimizer


def init_dist_params(rng, nfeat: int, nhid: int, nclass: int, class_pad: int = 1):
    """``class_pad``: round the classifier width up to this multiple so
    the logits dimension stays divisible by the feature-mesh axis."""
    k1, k2 = jax.random.split(rng)
    ncls_p = -(-nclass // class_pad) * class_pad
    scale1 = (1.0 / nfeat) ** 0.5
    scale2 = (1.0 / nhid) ** 0.5
    return {
        "W1": jax.random.uniform(k1, (nfeat, nhid), minval=-scale1, maxval=scale1),
        "W2": jax.random.uniform(k2, (nhid, ncls_p), minval=-scale2, maxval=scale2),
    }


def make_dist_train_step(
    mesh,
    plan,
    degV,
    lr: float = 0.01,
    wd: float = 5e-4,
    first_aggr: str = "sum",
    feature_sharded: bool = False,
    nclass: int = None,
):
    """Returns (jitted_step, tx, forward, run_epochs) for the 2-layer distributed HGNN.

    step(params, opt_state, x, y, train_mask) -> (params, opt_state, loss)
    When the classifier width is padded for feature-mesh divisibility,
    pass ``nclass`` so padded logit columns are masked out of the softmax.
    """
    tx = make_optimizer(lr, wd)

    def forward(params, x):
        h = sharded_hgnn_aggregate(
            plan, mesh, x @ params["W1"], None, first_aggr, degV=degV,
            feature_sharded=feature_sharded,
        )
        h = jax.nn.relu(h)
        z = sharded_hgnn_aggregate(
            plan, mesh, h @ params["W2"], None, first_aggr, degV=degV,
            feature_sharded=feature_sharded,
        )
        if nclass is not None and z.shape[1] > nclass:
            ncols = z.shape[1]
            col = jnp.arange(ncols)[None, :]
            z = jnp.where(col < nclass, z, -1e30)
        return jax.nn.log_softmax(z, axis=1)

    def loss_fn(params, x, y, train_mask):
        logp = forward(params, x)
        # padded classifier columns (feature-mesh divisibility) are
        # excluded by indexing true labels only
        picked = jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return -jnp.sum(picked * train_mask) / jnp.maximum(train_mask.sum(), 1.0)

    def _step(params, opt_state, x, y, train_mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y, train_mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    step = jax.jit(_step)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run_epochs(params, opt_state, x, y, train_mask, n):
        """``n`` chained epochs as ONE jitted program (lax.scan): one
        dispatch regardless of epoch count.  This is both a clean timing
        unit (dispatch latency excluded by construction) and the fix for
        the simulated CPU mesh's async-queue abort — with a single
        in-flight program there is no dispatch queue to overflow."""

        def body(carry, _):
            params, opt_state, _ = carry
            return _step(params, opt_state, x, y, train_mask), None

        init = (params, opt_state, jnp.zeros(()))
        (params, opt_state, loss), _ = jax.lax.scan(
            body, init, None, length=n)
        return params, opt_state, loss

    return step, tx, forward, run_epochs


# ----------------------------------------------------------------------
# distributed UniGIN / UniGCNII (the other two reference model families
# on the edge-partitioned SPMD program; single-chip stacks: models/zoo.py,
# reference semantics model/pygnn/unigin.py:17-26, unigcnii.py:23-36)
# ----------------------------------------------------------------------
def init_unigin_params(rng, nfeat: int, nhid: int, nclass: int,
                       class_pad: int = 1):
    k1, k2 = jax.random.split(rng)
    ncls_p = -(-nclass // class_pad) * class_pad
    s1 = (1.0 / nfeat) ** 0.5
    s2 = (1.0 / nhid) ** 0.5
    return {
        "W1": jax.random.uniform(k1, (nfeat, nhid), minval=-s1, maxval=s1),
        "W2": jax.random.uniform(k2, (nhid, ncls_p), minval=-s2, maxval=s2),
        # learnable per-layer ε, zero-initialized like the single-chip conv
        "eps1": jnp.zeros(()),
        "eps2": jnp.zeros(()),
    }


def make_dist_unigin_train_step(
    mesh, plan, lr: float = 0.01, wd: float = 5e-4,
    feature_sharded: bool = False, nclass: int = None,
):
    """2-layer distributed UniGIN: ``(1+ε)·XW + H Hᵀ (XW)`` per layer,
    aggregation edge-partitioned (no degree scaling — reference
    ``unigin.py:17-26``), projections/optimizer under GSPMD."""
    from hypergef.parallel.dist_aggr import sharded_unignn_aggregate

    tx = make_optimizer(lr, wd)

    def forward(params, x):
        xw = x @ params["W1"]
        h = sharded_unignn_aggregate(
            plan, mesh, xw, use_deg=False, feature_sharded=feature_sharded
        ) + (1.0 + params["eps1"]) * xw
        h = jax.nn.relu(h)
        hw = h @ params["W2"]
        z = sharded_unignn_aggregate(
            plan, mesh, hw, use_deg=False, feature_sharded=feature_sharded
        ) + (1.0 + params["eps2"]) * hw
        if nclass is not None and z.shape[1] > nclass:
            col = jnp.arange(z.shape[1])[None, :]
            z = jnp.where(col < nclass, z, -1e30)
        return jax.nn.log_softmax(z, axis=1)

    return _finish_step(tx, forward)


def init_unigcnii_params(rng, nfeat: int, nhid: int, nclass: int,
                         nlayer: int = 2, class_pad: int = 1):
    ks = jax.random.split(rng, nlayer + 2)
    ncls_p = -(-nclass // class_pad) * class_pad
    s_in = (1.0 / nfeat) ** 0.5
    s_h = (1.0 / nhid) ** 0.5
    params = {
        "lin_in": jax.random.uniform(
            ks[0], (nfeat, nhid), minval=-s_in, maxval=s_in),
        "lin_out": jax.random.uniform(
            ks[1], (nhid, ncls_p), minval=-s_h, maxval=s_h),
    }
    for i in range(nlayer):
        params[f"W{i}"] = jax.random.uniform(
            ks[2 + i], (nhid, nhid), minval=-s_h, maxval=s_h)
    return params


def make_dist_unigcnii_train_step(
    mesh, plan, degV, nlayer: int = 2, lamda: float = 0.5,
    alpha: float = 0.1, lr: float = 0.01, wd: float = 5e-4,
    feature_sharded: bool = False, nclass: int = None,
):
    """Distributed UniGCNII (reference ``unigcnii.py:23-36`` semantics,
    fixing the dead hgsys path §2.8-2): identity-mapping residual layers
    over the edge-partitioned ``Xv = degV·H·degE·Hᵀ·X`` aggregation."""
    import math as _math

    from hypergef.parallel.dist_aggr import sharded_unignn_aggregate

    tx = make_optimizer(lr, wd)
    betas = [
        _math.log(lamda / (i + 1) + 1.0) for i in range(nlayer)
    ]

    def forward(params, x):
        h = jax.nn.relu(x @ params["lin_in"])
        h0 = h
        for i in range(nlayer):
            xv = sharded_unignn_aggregate(
                plan, mesh, h, use_deg=True, degV=degV,
                feature_sharded=feature_sharded,
            )
            xi = (1.0 - alpha) * xv + alpha * h0
            h = jax.nn.relu(
                (1.0 - betas[i]) * xi + betas[i] * (xi @ params[f"W{i}"])
            )
        z = h @ params["lin_out"]
        if nclass is not None and z.shape[1] > nclass:
            col = jnp.arange(z.shape[1])[None, :]
            z = jnp.where(col < nclass, z, -1e30)
        return jax.nn.log_softmax(z, axis=1)

    return _finish_step(tx, forward)


def _finish_step(tx, forward):
    """Shared loss/step/epoch-chain assembly for the distributed model
    factories — returns (step, tx, forward, run_epochs) like
    :func:`make_dist_train_step`."""

    def loss_fn(params, x, y, train_mask):
        logp = forward(params, x)
        picked = jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return -jnp.sum(picked * train_mask) / jnp.maximum(train_mask.sum(), 1.0)

    def _step(params, opt_state, x, y, train_mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y, train_mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    step = jax.jit(_step)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run_epochs(params, opt_state, x, y, train_mask, n):
        def body(carry, _):
            params, opt_state, _ = carry
            return _step(params, opt_state, x, y, train_mask), None

        init = (params, opt_state, jnp.zeros(()))
        (params, opt_state, loss), _ = jax.lax.scan(
            body, init, None, length=n)
        return params, opt_state, loss

    return step, tx, forward, run_epochs
