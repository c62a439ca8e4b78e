"""Reduction-tree and dense-matmul backend tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.ops import fused
from hypergef.sparse.planner import build_tree, plan_aggregation, plan_tree
from conftest import dense_unignn_oracle

from conftest import dense_hgnn_oracle, dense_unignn_oracle


def rand_x(hg, f=8, seed=0):
    return np.random.default_rng(seed).normal(size=(hg.num_nodes, f)).astype(np.float32)


def apply_stage_numpy(x, st):
    """Slow NumPy evaluation of a TreeStage for invariants."""
    p = np.asarray(x, dtype=np.float64)
    for lvl in st.levels:
        g = p[lvl.gather_idx]  # [C, fan, F]
        p = (g * lvl.mask[:, :, None]).sum(axis=1)
    return p[st.final_idx] * st.final_mask[:, None]


@pytest.mark.parametrize("ngs,fan", [(1, 2), (4, 4), (8, 8), (4, 8)])
def test_tree_stage_equals_csr_rowsum(skewed_hg, ngs, fan):
    hg = skewed_hg
    st = build_tree(hg.ht_indptr, hg.ht_indices, hg.num_nodes, ngs=ngs, fan=fan)
    x = rand_x(hg, f=3, seed=1)
    got = apply_stage_numpy(x, st)
    # oracle: per-edge sums over member vertices
    want = np.zeros((hg.num_edges, 3))
    for e in range(hg.num_edges):
        mem = hg.ht_indices[hg.ht_indptr[e] : hg.ht_indptr[e + 1]]
        want[e] = x[mem].astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tree_depth_logarithmic():
    """A single giant hyperedge of size 4096 needs depth ~log_fan."""
    from hypergef.sparse.hypergraph import Hypergraph

    v = np.arange(4096)
    e = np.zeros(4096, dtype=np.int64)
    hg = Hypergraph.from_coo(v, e, num_nodes=4096, num_edges=1)
    plan = plan_tree(hg, ngs=8, fan=8)
    # 4096/8 = 512 chunks → 512→64→8→1: 3 extra levels
    assert len(plan.edge_stage.levels) == 4


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_tree_backend_matches_oracle(skewed_hg, aggr):
    hg = skewed_hg
    hgd = hg.device_data()
    plan = plan_tree(hg)
    x = rand_x(hg, f=6, seed=2)
    got = fused.hgnn_aggregate(hgd, x, None, aggr, plan=plan, backend="tree")
    want = dense_hgnn_oracle(hg, x, None, aggr)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_tree_backend_unignn(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_tree(hg)
    x = rand_x(hg, f=4, seed=3)
    got = fused.unignn_aggregate(hgd, x, use_deg=True, plan=plan, backend="tree")
    want = dense_unignn_oracle(hg, x, use_deg=True)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_tree_grad_matches_xla_and_no_scatter(skewed_hg):
    hg = skewed_hg
    hgd = hg.device_data()
    plan = plan_tree(hg)
    x = jnp.asarray(rand_x(hg, f=4, seed=4))

    def g(backend, p=None):
        return jax.grad(
            lambda xv: jnp.sum(
                fused.hgnn_aggregate(hgd, xv, None, "sum", plan=p, backend=backend) ** 2
            )
        )(x)

    np.testing.assert_allclose(
        np.asarray(g("tree", plan)), np.asarray(g("xla")), rtol=1e-3, atol=1e-3
    )
    hlo = jax.jit(
        lambda xv: jax.grad(
            lambda z: jnp.sum(
                fused.hgnn_aggregate(hgd, z, None, "sum", plan=plan, backend="tree")
            )
        )(xv)
    ).lower(x).as_text()
    assert "scatter" not in hlo


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_dense_backend_matches_oracle(small_hg, aggr):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_aggregation(hg)
    assert plan.preferred_backend in ("dense", "precomp")  # small graph
    x = rand_x(hg, f=8, seed=5)
    got = fused.hgnn_aggregate(hgd, x, None, aggr, plan=plan, backend="dense")
    want = dense_hgnn_oracle(hg, x, None, aggr)
    # bf16 matmul: loose tolerance
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)


def test_auto_backend_routes(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_aggregation(hg, dense_threshold=0, with_bsr=False,
                            with_precomp=False, with_aligned=False)
    # matmul-form backends disabled → the gather ladder picks: cumsum for
    # small random graphs (CUMSUM_PREFER_NNZ), tree above it
    assert plan.preferred_backend in ("tree", "cumsum")
    x = rand_x(hg, f=4, seed=6)
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="auto")
    want = dense_hgnn_oracle(hg, x, None, "sum")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_empty_segments_and_isolated(tiny_hg):
    """Tree handles empty hyperedges / isolated vertices (mask=0 rows)."""
    from hypergef.sparse.hypergraph import Hypergraph

    v = np.array([0, 1, 2])
    e = np.array([0, 0, 2])  # edge 1 empty; vertex 3 isolated
    hg = Hypergraph.from_coo(v, e, num_nodes=4, num_edges=3)
    plan = plan_tree(hg)
    hgd = hg.device_data()
    x = np.ones((4, 2), dtype=np.float32)
    got = np.asarray(
        fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="tree")
    )
    want = dense_hgnn_oracle(hg, x, None, "sum")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("aggr", ["sum"])
def test_precomp_backend_matches_oracle(small_hg, aggr):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_aggregation(hg)
    assert plan.precomp is not None
    x = rand_x(hg, f=8, seed=7)
    got = fused.hgnn_aggregate(hgd, x, None, aggr, plan=plan, backend="precomp")
    want = dense_hgnn_oracle(hg, x, None, aggr)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)
    # grads: A is linear — autodiff exact
    g = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, aggr, plan=plan, backend="precomp") ** 2
        )
    )(jnp.asarray(x))
    assert np.isfinite(np.asarray(g)).all()


def test_precomp_falls_back_with_wdiag_or_mean(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_aggregation(hg)
    x = rand_x(hg, f=4, seed=8)
    w = np.random.default_rng(9).uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)
    got = fused.hgnn_aggregate(hgd, x, jnp.asarray(w), "sum", plan=plan, backend="precomp")
    want = dense_hgnn_oracle(hg, x, w, "sum")
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)
    got_m = fused.hgnn_aggregate(hgd, x, None, "mean", plan=plan, backend="precomp")
    want_m = dense_hgnn_oracle(hg, x, None, "mean")
    np.testing.assert_allclose(np.asarray(got_m), want_m, rtol=2e-2, atol=2e-2)


def test_precomp_unignn_deg(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_aggregation(hg)
    x = rand_x(hg, f=4, seed=10)
    got = fused.unignn_aggregate(hgd, x, use_deg=True, plan=plan, backend="precomp")
    want = dense_unignn_oracle(hg, x, use_deg=True)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)


def test_tiled_tree_matches_plain(skewed_hg):
    """Cache-blocked level-0 (forced small tiles) == plain tree == oracle."""
    hg = skewed_hg
    hgd = hg.device_data()
    plain = plan_tree(hg, tiled_threshold=10**9)
    tiled = plan_tree(hg, tiled_threshold=64, tile_rows=64)
    from hypergef.ops.tree import TiledStageDev

    assert isinstance(tiled.device()[0], TiledStageDev)
    x = rand_x(hg, f=5, seed=11)
    for aggr in ("sum", "mean"):
        want = np.asarray(
            fused.hgnn_aggregate(hgd, x, None, aggr, plan=plain, backend="tree")
        )
        got = np.asarray(
            fused.hgnn_aggregate(hgd, x, None, aggr, plan=tiled, backend="tree")
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # gradient parity through the tiled adjoint
    g_plain = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=plain, backend="tree") ** 2
        )
    )(jnp.asarray(x))
    g_tiled = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=tiled, backend="tree") ** 2
        )
    )(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(g_tiled), np.asarray(g_plain), rtol=1e-3, atol=1e-3
    )


def test_tiled_tree_under_jit(skewed_hg):
    hg = skewed_hg
    hgd = hg.device_data()
    tiled = plan_tree(hg, tiled_threshold=64, tile_rows=64)
    x = jnp.asarray(rand_x(hg, f=4, seed=12))
    f = jax.jit(
        lambda xv: fused.hgnn_aggregate(hgd, xv, None, "sum", plan=tiled, backend="tree")
    )
    out = f(x)
    want = dense_hgnn_oracle(hg, np.asarray(x), None, "sum")
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)
