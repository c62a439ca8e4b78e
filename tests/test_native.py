"""Native C++ library tests: bit-identical parity with the NumPy twins.

Skipped when the library isn't built (``make -C csrc``)."""

import os

import numpy as np
import pytest

from hypergef.sparse import native
from hypergef.sparse.planner import build_ell

pytestmark = pytest.mark.skipif(
    not (native.available() or native.build()), reason="native lib not built"
)


@pytest.mark.parametrize("ngs", [1, 4, 8, 32])
def test_build_ell_bit_identical(skewed_hg, ngs):
    hg = skewed_hg
    want = build_ell(hg.ht_indptr, hg.ht_indices, ngs)
    got = native.build_ell_native(hg.ht_indptr, hg.ht_indices, ngs)
    assert got.num_chunks == want.num_chunks
    np.testing.assert_array_equal(got.gather_idx, want.gather_idx)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.seg_ids, want.seg_ids)
    np.testing.assert_array_equal(got.seg_ptr, want.seg_ptr)


def test_mtx_roundtrip(tmp_path, small_hg):
    from hypergef.sparse import mtx

    path = str(tmp_path) + "/"
    fn = small_hg.store_mtx(path)
    assert os.path.exists(fn)
    hg2 = mtx.read_mtx(fn)
    assert hg2.num_nodes == small_hg.num_nodes
    assert hg2.num_edges == small_hg.num_edges
    np.testing.assert_array_equal(hg2.h_indptr, small_hg.h_indptr)
    np.testing.assert_array_equal(hg2.h_indices, small_hg.h_indices)


def test_native_mtx_matches_scipy(tmp_path, skewed_hg):
    import scipy.io

    from hypergef.sparse.hypergraph import Hypergraph

    fn = str(tmp_path / "g.mtx")
    scipy.io.mmwrite(fn, skewed_hg.to_scipy())
    n, e, r, c = native.read_mtx_coo(fn)
    assert (n, e) == (skewed_hg.num_nodes, skewed_hg.num_edges)
    hg2 = Hypergraph.from_coo(r, c, num_nodes=n, num_edges=e)
    np.testing.assert_array_equal(hg2.h_indptr, skewed_hg.h_indptr)
    np.testing.assert_array_equal(hg2.h_indices, skewed_hg.h_indices)


def test_native_symmetric_expansion(tmp_path):
    fn = str(tmp_path / "sym.mtx")
    with open(fn, "w") as f:
        f.write(
            "%%MatrixMarket matrix coordinate pattern symmetric\n"
            "% comment\n"
            "3 3 3\n"
            "1 1\n"
            "2 1\n"
            "3 2\n"
        )
    n, e, r, c = native.read_mtx_coo(fn)
    assert (n, e) == (3, 3)
    pairs = sorted(zip(r.tolist(), c.tolist()))
    assert pairs == [(0, 0), (0, 1), (1, 0), (1, 2), (2, 1)]


def test_coo_to_csr_native():
    import ctypes

    lib = native._load()
    row = np.array([2, 0, 1, 0, 2], dtype=np.int32)
    col = np.array([1, 3, 0, 1, 0], dtype=np.int32)
    indptr = np.zeros(4, dtype=np.int64)
    indices = np.zeros(5, dtype=np.int32)
    rc = lib.hg_coo_to_csr(
        native._i32p(row), native._i32p(col), 5, 3,
        native._i64p(indptr), native._i32p(indices),
    )
    assert rc == 0
    assert indptr.tolist() == [0, 2, 3, 5]
    assert indices.tolist() == [1, 3, 0, 0, 1]


def test_community_order_parity():
    """C++ label propagation ≡ NumPy twin, bit-for-bit."""
    import pytest

    from hypergef.sparse import native
    from hypergef.sparse.reorder import community_order_numpy

    if not native.available():
        pytest.skip("native lib not built")
    from hypergef.data.synthetic import homophilic_hypergraph, random_hypergraph

    for hg in [
        homophilic_hypergraph(300, 200, 8, seed=3)[0],
        (lambda o: o[0] if isinstance(o, tuple) else o)(
            random_hypergraph(150, 90, avg_edge_size=4.0, seed=5)),
    ]:
        got = native.community_order_native(hg, iters=6)
        want = community_order_numpy(hg, iters=6)
        np.testing.assert_array_equal(got, want)


def test_coarsen_order_parity():
    """C++ multilevel coarsening ≡ NumPy twin, bit-for-bit — including
    the float best-friend weight ties (both sides aggregate per-(u,v)
    weights as sequential prefix-sum differences; np.add.reduceat sums
    pairwise and would diverge)."""
    import pytest

    from hypergef.sparse import native
    from hypergef.sparse.reorder import apply_vertex_order, coarsen_order

    if not native.available():
        pytest.skip("native lib not built")
    from hypergef.data.synthetic import (
        homophilic_hypergraph, powerlaw_hypergraph, random_hypergraph)

    hgs = [
        homophilic_hypergraph(500, 300, 4, avg_edge_size=6, seed=3)[0],
        (lambda o: o[0] if isinstance(o, tuple) else o)(
            random_hypergraph(300, 150, avg_edge_size=5.0, seed=5)),
        powerlaw_hypergraph(400, 200, seed=2),
    ]
    # shuffled community graph (the production input shape)
    hg0, _ = homophilic_hypergraph(800, 500, 8, avg_edge_size=7,
                                   noise=0.03, seed=11)
    perm = np.random.default_rng(7).permutation(hg0.num_nodes)
    hgs.append(apply_vertex_order(hg0, perm.astype(np.int64),
                                  sort_edges=False)[0])
    for hg in hgs:
        want = coarsen_order(hg, use_native=False)
        got = native.coarsen_order_native(hg)
        np.testing.assert_array_equal(got, want)


def test_community_reorder_improves_locality():
    """On a community graph with SHUFFLED vertex ids, the reorder must
    recover tile locality (lower multihot fragmentation)."""
    from hypergef.data.synthetic import homophilic_hypergraph
    from hypergef.sparse.hypergraph import Hypergraph
    from hypergef.sparse.planner import plan_multihot
    from hypergef.sparse.reorder import community_reorder

    hg0, labels = homophilic_hypergraph(600, 400, 6, avg_edge_size=8.0,
                                        noise=0.02, seed=11)
    frag_before = plan_multihot(hg0, tile_rows=128).edge_stage.fragmentation()
    hg2, rank = community_reorder(hg0, iters=8)
    assert hg2.nnz == hg0.nnz
    frag_after = plan_multihot(hg2, tile_rows=128).edge_stage.fragmentation()
    assert frag_after < frag_before * 0.8, (frag_before, frag_after)


def test_apply_vertex_order_preserves_structure():
    from hypergef.data.synthetic import random_hypergraph
    from hypergef.sparse.reorder import apply_vertex_order

    out = random_hypergraph(80, 50, avg_edge_size=3.0, seed=9)
    hg = out[0] if isinstance(out, tuple) else out
    order = np.random.default_rng(0).permutation(80).astype(np.int32)
    hg2, rank = apply_vertex_order(hg, order)
    # edge-size multiset preserved
    assert sorted(np.diff(hg.ht_indptr).tolist()) == sorted(
        np.diff(hg2.ht_indptr).tolist()
    )
    # membership preserved under the rank map (as sets per edge, matched
    # via sorted member lists)
    def edge_sets(h, mapv=None):
        out = []
        for e in range(h.num_edges):
            lo, hi = int(h.ht_indptr[e]), int(h.ht_indptr[e + 1])
            mem = h.ht_indices[lo:hi]
            if mapv is not None:
                mem = mapv[mem]
            out.append(tuple(sorted(mem.tolist())))
        return sorted(out)

    assert edge_sets(hg, rank) == edge_sets(hg2)
