"""Edge-sharded int8 dense-stream aggregation (multi-chip brute
bandwidth for unstructured graphs) — oracle parity + gradients on the
simulated 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.parallel import (
    make_mesh,
    plan_sharded_dense,
    sharded_dense_hgnn_aggregate,
    sharded_dense_unignn_aggregate,
)

from conftest import dense_hgnn_oracle, dense_unignn_oracle


def rand_x(hg, f=8, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).normal(size=(hg.num_nodes, f)).astype(np.float32)
    )


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_sharded_dense_hgnn_matches_oracle(skewed_hg, n_shards, aggr):
    hg = skewed_hg
    mesh = make_mesh(n_shards, 1, devices=jax.devices()[:n_shards])
    plan = plan_sharded_dense(hg, n_shards)
    x = rand_x(hg, f=6, seed=1)
    degV = jnp.asarray(hg.degV)
    out = sharded_dense_hgnn_aggregate(plan, mesh, x, None, aggr, degV=degV)
    want = dense_hgnn_oracle(hg, np.asarray(x), None, aggr)
    # bf16 matmul tolerance class
    np.testing.assert_allclose(np.asarray(out), want, rtol=2e-2, atol=2e-2)


def test_sharded_dense_hgnn_wdiag_and_feature_sharding(skewed_hg):
    hg = skewed_hg
    mesh = make_mesh(4, 2)
    plan = plan_sharded_dense(hg, 4)
    rng = np.random.default_rng(3)
    w = rng.random((hg.num_edges, 1)).astype(np.float32)
    ws = jnp.asarray(plan.shard_edge_vector(w))
    x = rand_x(hg, f=8, seed=2)
    degV = jnp.asarray(hg.degV)
    out = sharded_dense_hgnn_aggregate(
        plan, mesh, x, ws, "sum", degV=degV, feature_sharded=True
    )
    want = dense_hgnn_oracle(hg, np.asarray(x), w, "sum")
    np.testing.assert_allclose(np.asarray(out), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("use_deg", [False, True])
def test_sharded_dense_unignn_matches_oracle(skewed_hg, use_deg):
    hg = skewed_hg
    mesh = make_mesh(8, 1)
    plan = plan_sharded_dense(hg, 8)
    x = rand_x(hg, f=4, seed=4)
    degV = jnp.asarray(hg.degV) if use_deg else None
    out = sharded_dense_unignn_aggregate(plan, mesh, x, use_deg, degV=degV)
    want = dense_unignn_oracle(hg, np.asarray(x), use_deg)
    # hub rows of the skewed graph reach O(100) under raw HH^T — compare
    # on the value scale (bf16 error is relative to magnitude)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(np.asarray(out) / scale, want / scale, atol=1e-2)


def test_sharded_dense_grad_matches_single_device(skewed_hg):
    """d/dx through shard_map + psum must equal the single-device dense
    gradient (exact adjoint — no symmetric approximation)."""
    hg = skewed_hg
    mesh = make_mesh(8, 1)
    plan = plan_sharded_dense(hg, 8)
    x = rand_x(hg, f=4, seed=5)
    degV = jnp.asarray(hg.degV)

    def loss(xv):
        out = sharded_dense_hgnn_aggregate(plan, mesh, xv, None, "sum", degV=degV)
        return jnp.sum(out**2)

    g = np.asarray(jax.grad(loss)(x))

    # single-device f32 oracle gradient via the numpy dense operator:
    # loss = ||A x||^2 -> grad = 2 A^T A x
    import scipy.sparse as sp

    h = hg.to_scipy().astype(np.float64)
    a = sp.diags(hg.degV[:, 0].astype(np.float64)) @ h @ sp.diags(
        hg.degE[:, 0].astype(np.float64)) @ h.T
    want = 2.0 * (a.T @ (a @ np.asarray(x, np.float64)))
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(g / scale, want / scale, atol=3e-2)


def test_sharded_dense_budget_guard(skewed_hg):
    with pytest.raises(MemoryError):
        plan_sharded_dense(skewed_hg, 2, max_bytes_per_device=16)
