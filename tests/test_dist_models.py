"""Distributed UniGIN / UniGCNII train steps (edge-partitioned mesh).

The reference's other two model families on the SPMD program — forward
parity vs the dense NumPy oracle with identical parameters, plus a
learning check via the chained-epoch runner.  (Reference semantics:
``model/pygnn/unigin.py:17-26``, ``unigcnii.py:23-36``.)
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from conftest import dense_unignn_oracle

from hypergef.data.synthetic import homophilic_hypergraph
from hypergef.parallel import make_mesh
from hypergef.parallel.dist_model import (
    init_unigcnii_params,
    init_unigin_params,
    make_dist_unigcnii_train_step,
    make_dist_unigin_train_step,
)
from hypergef.parallel.partition import plan_sharded_aggregation
from hypergef.train import rand_train_test_idx


def _setup(n=300, e=200, c=4, f=12, seed=0):
    hg, y = homophilic_hypergraph(n, e, c, seed=seed)
    x = np.random.default_rng(seed + 1).normal(size=(n, f)).astype(np.float32)
    return hg, x, y


def test_dist_unigin_forward_matches_oracle():
    hg, x, _ = _setup()
    mesh = make_mesh(8, 1)
    plan = plan_sharded_aggregation(hg, 8)
    params = init_unigin_params(jax.random.PRNGKey(0), x.shape[1], 8, 4)
    _, _, forward, _ = make_dist_unigin_train_step(mesh, plan, nclass=4)
    got = np.asarray(forward(params, jnp.asarray(x)))

    w1 = np.asarray(params["W1"], np.float64)
    w2 = np.asarray(params["W2"], np.float64)
    e1 = float(params["eps1"])
    e2 = float(params["eps2"])
    xw = x.astype(np.float64) @ w1
    h = dense_unignn_oracle(hg, xw) + (1.0 + e1) * xw
    h = np.maximum(h, 0.0)
    hw = h @ w2
    z = dense_unignn_oracle(hg, hw) + (1.0 + e2) * hw
    want = z - np.log(np.exp(z - z.max(1, keepdims=True)).sum(1, keepdims=True)) - z.max(1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dist_unigcnii_forward_matches_oracle():
    hg, x, _ = _setup(seed=3)
    mesh = make_mesh(8, 1)
    plan = plan_sharded_aggregation(hg, 8)
    nhid, nlayer, lamda, alpha = 8, 2, 0.5, 0.1
    params = init_unigcnii_params(
        jax.random.PRNGKey(1), x.shape[1], nhid, 4, nlayer=nlayer)
    _, _, forward, _ = make_dist_unigcnii_train_step(
        mesh, plan, jnp.asarray(hg.degV), nlayer=nlayer, nclass=4)
    got = np.asarray(forward(params, jnp.asarray(x)))

    h = np.maximum(x.astype(np.float64) @ np.asarray(params["lin_in"], np.float64), 0.0)
    h0 = h
    for i in range(nlayer):
        beta = math.log(lamda / (i + 1) + 1.0)
        xv = dense_unignn_oracle(hg, h, use_deg=True)
        xi = (1.0 - alpha) * xv + alpha * h0
        h = np.maximum(
            (1.0 - beta) * xi + beta * (xi @ np.asarray(params[f"W{i}"], np.float64)),
            0.0,
        )
    z = h @ np.asarray(params["lin_out"], np.float64)
    want = z - np.log(np.exp(z - z.max(1, keepdims=True)).sum(1, keepdims=True)) - z.max(1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dist_unigin_learns():
    hg, x, y = _setup(n=400, e=250, seed=5)
    split = rand_train_test_idx(y, seed=6)
    mask = np.zeros(len(y), np.float32)
    mask[split["train"]] = 1.0
    mesh = make_mesh(8, 1)
    plan = plan_sharded_aggregation(hg, 8)
    params = init_unigin_params(jax.random.PRNGKey(2), x.shape[1], 16, 4)
    step, tx, forward, run_epochs = make_dist_unigin_train_step(
        mesh, plan, nclass=4)
    opt_state = tx.init(params)
    xj, yj, mj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    params, opt_state, l0 = step(params, opt_state, xj, yj, mj)
    params, opt_state, loss = run_epochs(params, opt_state, xj, yj, mj, 40)
    assert np.isfinite(float(loss)) and float(loss) < float(l0), (l0, loss)


def test_dist_unigcnii_learns():
    hg, x, y = _setup(n=400, e=250, seed=7)
    split = rand_train_test_idx(y, seed=8)
    mask = np.zeros(len(y), np.float32)
    mask[split["train"]] = 1.0
    mesh = make_mesh(8, 1)
    plan = plan_sharded_aggregation(hg, 8)
    params = init_unigcnii_params(jax.random.PRNGKey(3), x.shape[1], 16, 4)
    step, tx, forward, run_epochs = make_dist_unigcnii_train_step(
        mesh, plan, jnp.asarray(hg.degV), nclass=4)
    opt_state = tx.init(params)
    xj, yj, mj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    params, opt_state, l0 = step(params, opt_state, xj, yj, mj)
    params, opt_state, loss = run_epochs(params, opt_state, xj, yj, mj, 40)
    assert np.isfinite(float(loss)) and float(loss) < float(l0), (l0, loss)
