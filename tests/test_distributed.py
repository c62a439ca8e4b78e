"""Multi-device tests on the simulated 8-device CPU mesh (SURVEY.md §4:
the fake-backend capability the single-GPU reference never needed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.parallel import (
    edge_partition_bounds,
    make_mesh,
    plan_sharded_aggregation,
    sharded_hgnn_aggregate,
    sharded_unignn_aggregate,
)

from conftest import dense_hgnn_oracle, dense_unignn_oracle


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh(8, 1)


@pytest.fixture(scope="module")
def mesh4x2():
    return make_mesh(4, 2)


def rand_x(hg, f=8, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).normal(size=(hg.num_nodes, f)).astype(np.float32)
    )


def test_partition_bounds_cover_and_balance(skewed_hg):
    hg = skewed_hg
    b = edge_partition_bounds(hg, 8)
    assert b[0] == 0 and b[-1] == hg.num_edges
    assert (np.diff(b) >= 0).all()
    nnz_per = [
        hg.ht_indptr[b[i + 1]] - hg.ht_indptr[b[i]] for i in range(8)
    ]
    assert sum(nnz_per) == hg.nnz
    # balanced within 2x of ideal for all non-trivial shards
    ideal = hg.nnz / 8
    assert max(nnz_per) <= 2.5 * ideal


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_sharded_hgnn_matches_oracle(skewed_hg, n_shards, aggr):
    hg = skewed_hg
    mesh = make_mesh(n_shards, 1, devices=jax.devices()[:n_shards])
    plan = plan_sharded_aggregation(hg, n_shards)
    x = rand_x(hg, f=6, seed=1)
    degV = jnp.asarray(hg.degV)
    out = sharded_hgnn_aggregate(plan, mesh, x, None, aggr, degV=degV)
    want = dense_hgnn_oracle(hg, np.asarray(x), None, aggr)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)


def test_sharded_with_wdiag(small_hg, mesh8):
    hg = small_hg
    plan = plan_sharded_aggregation(hg, 8)
    x = rand_x(hg, f=4, seed=2)
    w = np.random.default_rng(3).uniform(0.5, 1.5, size=(hg.num_edges, 1)).astype(np.float32)
    w_stacked = jnp.asarray(plan.shard_edge_vector(w))
    out = sharded_hgnn_aggregate(
        plan, mesh8, x, w_stacked, "sum", degV=jnp.asarray(hg.degV)
    )
    want = dense_hgnn_oracle(hg, np.asarray(x), w, "sum")
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)


def test_sharded_unignn(skewed_hg, mesh8):
    hg = skewed_hg
    plan = plan_sharded_aggregation(hg, 8)
    x = rand_x(hg, f=4, seed=4)
    out = sharded_unignn_aggregate(
        plan, mesh8, x, use_deg=True, degV=jnp.asarray(hg.degV)
    )
    want = dense_unignn_oracle(hg, np.asarray(x), use_deg=True)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)


def test_sharded_grad_matches_single_device(skewed_hg, mesh8):
    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_tree

    hg = skewed_hg
    plan = plan_sharded_aggregation(hg, 8)
    sp = plan_tree(hg)
    hgd = hg.device_data()
    x = rand_x(hg, f=4, seed=5)
    degV = jnp.asarray(hg.degV)

    g_dist = jax.grad(
        lambda xv: jnp.sum(
            sharded_hgnn_aggregate(plan, mesh8, xv, None, "sum", degV=degV) ** 2
        )
    )(x)
    g_single = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=sp, backend="tree") ** 2
        )
    )(x)
    np.testing.assert_allclose(
        np.asarray(g_dist), np.asarray(g_single), rtol=1e-3, atol=1e-3
    )


def test_sharded_under_jit(skewed_hg, mesh8):
    hg = skewed_hg
    plan = plan_sharded_aggregation(hg, 8)
    x = rand_x(hg, f=4, seed=6)
    degV = jnp.asarray(hg.degV)
    f = jax.jit(lambda xv: sharded_hgnn_aggregate(plan, mesh8, xv, None, "sum", degV=degV))
    out = f(x)
    want = dense_hgnn_oracle(hg, np.asarray(x), None, "sum")
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)


def test_feature_sharded_2d_mesh(skewed_hg, mesh4x2):
    hg = skewed_hg
    plan = plan_sharded_aggregation(hg, 4)
    x = rand_x(hg, f=8, seed=7)
    degV = jnp.asarray(hg.degV)
    out = sharded_hgnn_aggregate(
        plan, mesh4x2, x, None, "sum", degV=degV, feature_sharded=True
    )
    want = dense_hgnn_oracle(hg, np.asarray(x), None, "sum")
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)
