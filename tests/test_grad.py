"""Gradient tests — a tier the reference lacks entirely (its backward is
a symmetric approximation, SURVEY.md §0/§2.8-4; ours must be exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.ops import refops, fused
from hypergef.sparse.planner import plan_tiles

from conftest import dense_hgnn_oracle


def num_grad(f, x, eps=1e-3):
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        i = it.multi_index
        xp = x.copy(); xp[i] += eps
        xm = x.copy(); xm[i] -= eps
        g[i] = (f(xp) - f(xm)) / (2 * eps)
        it.iternext()
    return g


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_hgnn_grad_matches_finite_difference(tiny_hg, aggr):
    hg = tiny_hg
    hgd = hg.device_data()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(hg.num_nodes, 3)).astype(np.float64)
    w = rng.normal(size=(hg.num_nodes, 3)).astype(np.float64)  # random cotangent

    def scalar_loss(xv):
        out = refops.hgnn_aggregate_ref(hgd, jnp.asarray(xv, jnp.float32), None, aggr)
        return float(jnp.sum(out * jnp.asarray(w, jnp.float32)))

    g = jax.grad(
        lambda xv: jnp.sum(
            refops.hgnn_aggregate_ref(hgd, xv, None, aggr) * jnp.asarray(w, jnp.float32)
        )
    )(jnp.asarray(x, jnp.float32))
    g_num = num_grad(lambda xv: scalar_loss(xv), x.astype(np.float64), eps=1e-2)
    np.testing.assert_allclose(np.asarray(g), g_num, rtol=2e-2, atol=2e-2)


def test_sum_grad_is_exact_adjoint(small_hg):
    """For sum aggregation the op is linear: grad must equal Aᵀ w where
    A = diag(degV)·H·diag(degE)·Hᵀ — NOT the reference's A w approximation."""
    hg = small_hg
    hgd = hg.device_data()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(hg.num_nodes, 2)).astype(np.float32)
    w = rng.normal(size=(hg.num_nodes, 2)).astype(np.float32)
    g = jax.grad(
        lambda xv: jnp.sum(refops.hgnn_aggregate_ref(hgd, xv, None, "sum") * w)
    )(jnp.asarray(x))
    H = hg.to_scipy().toarray().astype(np.float64)
    A = np.diag(hg.degV[:, 0].astype(np.float64)) @ H @ np.diag(
        hg.degE[:, 0].astype(np.float64)
    ) @ H.T
    want = A.T @ w.astype(np.float64)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-4, atol=1e-4)
    # and A is NOT symmetric in general — the reference's backward
    # (re-apply forward) would be wrong here.
    assert not np.allclose(A, A.T)


def test_max_grad_routes_to_single_argmax(tiny_hg):
    hg = tiny_hg
    hgd = hg.device_data()
    # X[v] = v: argmax of edge0={0,1,2} is v2, edge1={1,2,3} is v3, edge2={0,4} is v4
    x = jnp.arange(5, dtype=jnp.float32)[:, None]
    g = jax.grad(
        lambda xv: jnp.sum(
            refops.segment_max_gather(xv, hgd.ht_vertex, hgd.ht_segids, hgd.num_edges)
        )
    )(x)
    np.testing.assert_allclose(np.asarray(g)[:, 0], [0.0, 0.0, 1.0, 1.0, 1.0])


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_ell_backend_grad_matches_xla(skewed_hg, aggr):
    hg = skewed_hg
    hgd = hg.device_data()
    plan = plan_tiles(hg)
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(hg.num_nodes, 6)).astype(np.float32))

    def loss(backend):
        def f(xv):
            out = fused.hgnn_aggregate(hgd, xv, None, aggr, plan=plan, backend=backend)
            return jnp.sum(out**2)
        return jax.grad(f)(x)

    np.testing.assert_allclose(
        np.asarray(loss("ell")), np.asarray(loss("xla")), rtol=1e-3, atol=1e-3
    )


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_dense_int8_backend_grad_matches_xla(small_hg, aggr):
    """The int8 DenseIncidence (round 2) differentiates wrt x through
    the fused i8->bf16 cast at the dot — gradient must match the f32
    gather path within the bf16-matmul tolerance class."""
    from hypergef.sparse.planner import plan_aggregation

    hg = small_hg
    hgd = hg.device_data()
    plan = plan_aggregation(hg)
    assert plan.dense is not None and str(plan.dense.h.dtype) == "int8"
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(hg.num_nodes, 6)).astype(np.float32))

    def grad_of(backend):
        def f(xv):
            out = fused.hgnn_aggregate(
                hgd, xv, None, aggr, plan=plan, backend=backend)
            return jnp.sum(out**2)
        return np.asarray(jax.grad(f)(x))

    g_dense, g_xla = grad_of("dense"), grad_of("xla")
    scale = np.abs(g_xla).max() + 1e-9
    np.testing.assert_allclose(g_dense / scale, g_xla / scale, atol=3e-2)
