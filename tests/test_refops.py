"""Oracle-op tests: jnp segment-reduction ops vs a dense NumPy oracle
(tier-2 of the reference's test strategy, SURVEY.md §4)."""

import numpy as np
import pytest

from hypergef.ops import refops, fused
from hypergef.sparse.planner import plan_tiles

from conftest import dense_hgnn_oracle, dense_unignn_oracle, dense_incidence


def rand_x(hg, f=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(hg.num_nodes, f)).astype(np.float32)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_hgnn_ref_matches_dense(small_hg, aggr):
    hg = small_hg
    x = rand_x(hg)
    wdiag = np.random.default_rng(1).uniform(0.5, 1.5, size=(hg.num_edges, 1)).astype(np.float32)
    out = refops.hgnn_aggregate_ref(hg.device_data(), x, wdiag, aggr)
    want = dense_hgnn_oracle(hg, x, wdiag, aggr)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_hgnn_ref_matches_dense_skewed(skewed_hg, aggr):
    hg = skewed_hg
    x = rand_x(hg, f=8, seed=5)
    out = refops.hgnn_aggregate_ref(hg.device_data(), x, None, aggr)
    want = dense_hgnn_oracle(hg, x, None, aggr)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_deg", [False, True])
def test_unignn_ref_matches_dense(small_hg, use_deg):
    hg = small_hg
    x = rand_x(hg, seed=2)
    out = refops.unignn_aggregate_ref(hg.device_data(), x, use_deg)
    want = dense_unignn_oracle(hg, x, use_deg)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-5)


def test_tiny_hand_example(tiny_hg):
    # edge 0 = {0,1,2}, edge 1 = {1,2,3}, edge 2 = {0,4}
    hg = tiny_hg
    x = np.arange(5, dtype=np.float32)[:, None]  # X[v] = v
    hgd = hg.device_data()
    xe = refops.v2e_aggregate(hgd, x, "sum")
    np.testing.assert_allclose(np.asarray(xe)[:, 0], [3.0, 6.0, 4.0])
    xe_max = refops.v2e_aggregate(hgd, x, "max")
    np.testing.assert_allclose(np.asarray(xe_max)[:, 0], [2.0, 3.0, 4.0])
    xv = refops.e2v_sum(hgd, xe)
    # v0 ∈ e0,e2 → 3+4=7; v1 ∈ e0,e1 → 9; v2 ∈ e0,e1 → 9; v3 ∈ e1 → 6; v4 ∈ e2 → 4
    np.testing.assert_allclose(np.asarray(xv)[:, 0], [7.0, 9.0, 9.0, 6.0, 4.0])


def test_deg_guard_isolated_vertices_empty_edges():
    from hypergef.sparse.hypergraph import Hypergraph

    # vertex 3 isolated; edge 2 empty
    v = np.array([0, 1, 2])
    e = np.array([0, 0, 1])
    hg = Hypergraph.from_coo(v, e, num_nodes=4, num_edges=3)
    assert np.isfinite(hg.degV).all() and np.isfinite(hg.degE).all()
    assert hg.degV[3, 0] == 1.0  # inf → 1 (hypergraph.py:44-45 semantics)
    x = np.ones((4, 2), dtype=np.float32)
    out = refops.hgnn_aggregate_ref(hg.device_data(), x, None, "sum")
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_ell_backend_matches_xla(skewed_hg, aggr):
    hg = skewed_hg
    x = rand_x(hg, f=12, seed=9)
    plan = plan_tiles(hg)
    hgd = hg.device_data()
    want = fused.hgnn_aggregate(hgd, x, None, aggr, backend="xla")
    got = fused.hgnn_aggregate(hgd, x, None, aggr, plan=plan, backend="ell")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ell_backend_unignn_matches_xla(small_hg):
    hg = small_hg
    x = rand_x(hg, f=4, seed=11)
    plan = plan_tiles(hg, ngs=8, ngs_vertex=8)
    hgd = hg.device_data()
    want = fused.unignn_aggregate(hgd, x, use_deg=True, backend="xla")
    got = fused.unignn_aggregate(hgd, x, use_deg=True, plan=plan, backend="ell")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_incidence_matches_scipy(small_hg):
    sp_H = small_hg.to_scipy().toarray()
    np.testing.assert_array_equal(sp_H, dense_incidence(small_hg))
