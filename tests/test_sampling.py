"""Hyperedge-sampled minibatch path tests."""

import numpy as np
import pytest

from hypergef.data.sampling import HyperedgeSampler
from hypergef.data.synthetic import homophilic_hypergraph, random_features
from hypergef.ops import refops
from hypergef.train import TrainConfig, rand_train_test_idx
from hypergef.train.minibatch import MinibatchTrainer

from conftest import dense_hgnn_oracle


@pytest.fixture(scope="module")
def big_setup():
    hg, y = homophilic_hypergraph(600, 400, 4, seed=0)
    x = np.random.default_rng(1).normal(size=(600, 12)).astype(np.float32)
    return hg, x, y


def test_batch_shapes_are_bucketed(big_setup):
    hg, x, y = big_setup
    s = HyperedgeSampler(hg, batch_edges=32, seed=0)
    shapes = set()
    for _ in range(5):
        b = s.sample_batch()
        shapes.add((b.data.num_nodes, b.data.num_edges, b.data.ht_vertex.shape[0]))
        # power-of-two buckets
        for v in shapes:
            assert all((n & (n - 1)) == 0 for n in v)
    assert len(shapes) <= 3  # bucketing keeps compilation cache small


def test_batch_aggregation_matches_full_graph_subset(big_setup):
    """Aggregation over an induced batch == full-graph aggregation
    restricted to vertices all of whose incident edges are in the batch."""
    hg, x, y = big_setup
    s = HyperedgeSampler(hg, batch_edges=hg.num_edges, seed=0)
    b = s.induce(np.arange(hg.num_edges))  # the full graph as one batch
    xb = x[b.vertex_ids]
    out_b = np.asarray(
        refops.hgnn_aggregate_ref(b.data, xb, None, "sum")
    )
    want = dense_hgnn_oracle(hg, x, None, "sum")
    nv = b.num_real_vertices
    got = np.zeros_like(want)
    got[b.vertex_ids[:nv]] = out_b[:nv]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ghost_rows_absorb_padding(big_setup):
    hg, x, y = big_setup
    s = HyperedgeSampler(hg, batch_edges=16, seed=3)
    b = s.sample_batch()
    # padded nnz live in the ghost (last) rows only
    ht_ptr = np.asarray(b.data.ht_indptr)
    assert ht_ptr[-1] == b.data.ht_vertex.shape[0]
    assert ht_ptr[b.num_real_edges] == ht_ptr[-2]  # padding rows are empty


def test_epoch_covers_all_edges(big_setup):
    hg, x, y = big_setup
    s = HyperedgeSampler(hg, batch_edges=64, seed=1, drop_last=False)
    seen = []
    for b in s.epoch(shuffle=True):
        seen.append(b.edge_ids[: b.num_real_edges])
    seen = np.sort(np.concatenate(seen))
    np.testing.assert_array_equal(seen, np.arange(hg.num_edges))


def test_minibatch_training_learns(big_setup):
    hg, x, y = big_setup
    split = rand_train_test_idx(y, seed=2)
    cfg = TrainConfig(model="HGNN", nhid=16, epochs=1, dropout=0.1, input_drop=0.1)
    tr = MinibatchTrainer(cfg, hg, x, y, split["train"], batch_edges=64)
    res = tr.fit(epochs=20)
    assert np.isfinite(res["final_loss"])
    acc = tr.evaluate_full(split)
    # structure-correlated labels: minibatch training must beat 4-class chance
    assert acc["test_acc"] > 35.0, (res, acc)


def test_padded_batch_gradient_parity(big_setup):
    """The round-5 minibatch convergence diagnosis: padded batch CSRs
    must be EXACT transposes (pad entries at the other side's ghost
    index), or incidence_gather_sum's stage-swap VJP computes the
    adjoint of a different matrix and injects a pad-count-sized bogus
    gradient through row 0.  Values were always right (ghost rows are
    masked); this pins the gradient."""
    import jax
    import jax.numpy as jnp

    from hypergef.ops import fused

    hg, x, y = big_setup
    s = HyperedgeSampler(hg, batch_edges=48, seed=5)
    b = s.sample_batch()
    xb = jnp.asarray(x[b.vertex_ids][:, :8])

    g_fast = jax.grad(lambda a: fused.hgnn_aggregate(
        b.data, a, None, "sum", plan=None, backend="cumsum").sum())(xb)
    g_ref = jax.grad(lambda a: refops.hgnn_aggregate_ref(
        b.data, a, None, "sum").sum())(xb)
    scale = float(jnp.max(jnp.abs(g_ref)))
    np.testing.assert_allclose(np.asarray(g_fast), np.asarray(g_ref),
                               atol=1e-3 * scale)


def test_padded_csr_pair_is_exact_transpose(big_setup):
    """Encoded H (vertex-major) and Hᵀ (edge-major) of a padded batch,
    including ghost rows and pad multiplicities, must be transposes."""
    import scipy.sparse as sp

    hg, x, y = big_setup
    s = HyperedgeSampler(hg, batch_edges=48, seed=6)
    b = s.sample_batch()
    ht_ptr = np.asarray(b.data.ht_indptr, dtype=np.int64)
    ht_idx = np.asarray(b.data.ht_vertex)
    h_ptr = np.asarray(b.data.h_indptr, dtype=np.int64)
    h_idx = np.asarray(b.data.h_edge)
    n_pad, e_pad = b.data.num_nodes, b.data.num_edges
    M_t = sp.csr_matrix((np.ones(len(ht_idx)), ht_idx, ht_ptr),
                        shape=(e_pad, n_pad))  # edges x vertices
    M = sp.csr_matrix((np.ones(len(h_idx)), h_idx, h_ptr),
                      shape=(n_pad, e_pad))  # vertices x edges
    diff = (M - M_t.T).tocoo()
    assert diff.nnz == 0, f"{diff.nnz} mismatched incidence entries"


def test_ht_degree_correction(big_setup):
    """Sampled batches scale degV by E/b (Horvitz-Thompson 1/p on the
    E→V sum); a batch covering every edge gets no correction."""
    hg, x, y = big_setup
    s = HyperedgeSampler(hg, batch_edges=48, seed=7)
    b = s.sample_batch()
    nv = b.num_real_vertices
    want = hg.degV[b.vertex_ids[:nv]] * (hg.num_edges / b.num_real_edges)
    np.testing.assert_allclose(np.asarray(b.data.degV[:nv]), want,
                               rtol=1e-6)
    s_full = HyperedgeSampler(hg, batch_edges=hg.num_edges, seed=7)
    bf = s_full.induce(np.arange(hg.num_edges))
    np.testing.assert_allclose(
        np.asarray(bf.data.degV[: bf.num_real_vertices]),
        hg.degV[bf.vertex_ids[: bf.num_real_vertices]], rtol=1e-6)
