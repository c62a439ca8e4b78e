"""BSR (block-sparse matmul) backend tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.ops import fused
from hypergef.sparse.bsr import BLOCK, build_bsr_stage, plan_bsr, rcm_bipartite_order

from conftest import dense_hgnn_oracle, dense_unignn_oracle


def rand_x(hg, f=8, seed=0):
    return np.random.default_rng(seed).normal(size=(hg.num_nodes, f)).astype(np.float32)


def test_bsr_stage_reconstructs_matrix(skewed_hg):
    hg = skewed_hg
    st = build_bsr_stage(hg.ht_indptr, hg.ht_indices, hg.num_edges, hg.num_nodes)
    # reassemble dense M from blocks and compare to H^T
    M = np.zeros((st.num_row_blocks * BLOCK, st.num_col_blocks * BLOCK))
    rowptr = np.zeros(st.num_row_blocks + 1, dtype=np.int64)
    # recover per-block row from combine.counts? use seg_ptr of level-0 of combine
    # simpler: verify via matvec against dense oracle below instead; here
    # check block count and total nnz
    assert st.blocks.sum() == hg.nnz


@pytest.mark.parametrize("reorder", [False, True])
def test_bsr_matches_oracle(skewed_hg, reorder):
    hg = skewed_hg
    hgd = hg.device_data()
    plan = plan_bsr(hg, reorder=reorder)
    x = rand_x(hg, f=6, seed=1)
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="bsr")
    want = dense_hgnn_oracle(hg, x, None, "sum")
    # bf16 blocks: loose tolerance
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)


def test_bsr_mean_and_wdiag(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_bsr(hg, reorder=True)
    x = rand_x(hg, f=4, seed=2)
    w = np.random.default_rng(3).uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)
    got = fused.hgnn_aggregate(hgd, x, jnp.asarray(w), "mean", plan=plan, backend="bsr")
    want = dense_hgnn_oracle(hg, x, w, "mean")
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)


def test_bsr_unignn(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    plan = plan_bsr(hg, reorder=True)
    x = rand_x(hg, f=4, seed=4)
    got = fused.unignn_aggregate(hgd, x, use_deg=True, plan=plan, backend="bsr")
    want = dense_unignn_oracle(hg, x, use_deg=True)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)


def test_bsr_grad_matches_tree(skewed_hg):
    from hypergef.sparse.planner import plan_tree

    hg = skewed_hg
    hgd = hg.device_data()
    bplan = plan_bsr(hg, reorder=True)
    tplan = plan_tree(hg)
    x = jnp.asarray(rand_x(hg, f=4, seed=5))

    def g(backend, plan):
        return jax.grad(
            lambda xv: jnp.sum(
                fused.hgnn_aggregate(hgd, xv, None, "sum", plan=plan, backend=backend)
                ** 2
            )
        )(x)

    np.testing.assert_allclose(
        np.asarray(g("bsr", bplan)), np.asarray(g("tree", tplan)), rtol=5e-2, atol=5e-2
    )


def test_rcm_reordering_improves_or_equal_blocks():
    from hypergef.data.synthetic import homophilic_hypergraph

    hg, _ = homophilic_hypergraph(1500, 900, 8, avg_edge_size=5.0, noise=0.02, seed=3)
    p_plain = plan_bsr(hg, reorder=False)
    p_rcm = plan_bsr(hg, reorder=True)
    # community-structured graph: RCM should not increase block count
    assert p_rcm.edge_stage.blocks.shape[0] <= p_plain.edge_stage.blocks.shape[0]


def test_bsr_memory_guard():
    from hypergef.data.synthetic import random_hypergraph

    hg = random_hypergraph(4000, 3000, avg_edge_size=3.0, seed=0)
    with pytest.raises(MemoryError, match="budget"):
        plan_bsr(hg, reorder=False, max_bytes=1000)


def test_bsr_community_reorder_fill():
    """Community ordering should raise block fill on clustered graphs
    (vs no reordering); plan stays numerically correct."""
    import jax.numpy as jnp

    from hypergef.data.synthetic import homophilic_hypergraph
    from hypergef.ops import fused
    from hypergef.sparse.bsr import plan_bsr

    from conftest import dense_hgnn_oracle

    hg, _ = homophilic_hypergraph(500, 300, 4, avg_edge_size=8.0,
                                  noise=0.02, seed=13)
    p_none = plan_bsr(hg, reorder=False)
    p_comm = plan_bsr(hg, reorder=True, method="community")
    assert p_comm.fill_fraction() > p_none.fill_fraction()
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, 4)).astype(np.float32)
    want = dense_hgnn_oracle(hg, x, None, "sum")
    got = fused.hgnn_aggregate(hg.device_data(), x, None, "sum",
                               plan=p_comm, backend="bsr")
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-2, atol=3e-2)
