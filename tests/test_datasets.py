"""Dataset ETL format tests on tiny synthetic raw fixtures."""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from hypergef.data import datasets


def test_le_format(tmp_path):
    d = tmp_path / "zoo" / "raw"
    d.mkdir(parents=True)
    (d / "zoo.content").write_text(
        "10 1.0 0.0 catA\n11 0.0 1.0 catB\n12 1.0 1.0 catA\n"
    )
    (d / "zoo.edges").write_text("10 11\n11 12\n10 12 11\n")
    ds = datasets.load_LE_dataset(str(tmp_path), "zoo")
    assert ds.hg.num_nodes == 3 and ds.hg.num_edges == 3
    assert ds.num_classes == 2 and ds.num_features == 2
    assert ds.hg.nnz == 7
    # cached round-trip through load_dataset
    ds2 = datasets.load_dataset("zoo", root=str(tmp_path))
    ds3 = datasets.load_dataset("zoo", root=str(tmp_path))  # from cache
    np.testing.assert_array_equal(ds2.hg.h_indices, ds3.hg.h_indices)
    np.testing.assert_array_equal(ds2.features, ds3.features)


def test_citation_format(tmp_path):
    d = tmp_path / "cora" / "raw"
    d.mkdir(parents=True)
    feats = sp.csr_matrix(np.eye(4, dtype=np.float32))
    with open(d / "features.pickle", "wb") as f:
        pickle.dump(feats, f)
    with open(d / "labels.pickle", "wb") as f:
        pickle.dump([0, 1, 0, 1], f)
    with open(d / "hypergraph.pickle", "wb") as f:
        pickle.dump({"p1": [0, 1, 2], "p2": [2, 3]}, f)
    ds = datasets.load_citation_dataset(str(tmp_path), "cora")
    assert ds.hg.num_nodes == 4 and ds.hg.num_edges == 2 and ds.hg.nnz == 5
    assert ds.num_classes == 2


def test_cornell_format(tmp_path):
    d = tmp_path / "house-committees" / "raw"
    d.mkdir(parents=True)
    (d / "node-labels-house-committees.txt").write_text("1\n2\n1\n2\n")
    (d / "hyperedges-house-committees.txt").write_text("1,2\n2,3,4\n")
    ds = datasets.load_cornell_dataset(str(tmp_path), "house-committees", seed=1)
    assert ds.hg.num_nodes == 4 and ds.hg.num_edges == 2
    assert ds.labels.tolist() == [0, 1, 0, 1]
    assert ds.features.shape == (4, 2)  # one-hot(2 classes) + noise


def test_missing_raises_helpful_error(tmp_path):
    with pytest.raises(datasets.DatasetNotAvailable, match="no network access"):
        datasets.load_dataset("pubmed", root=str(tmp_path))


def test_unknown_dataset():
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.load_dataset("imagenet")


def test_from_edge_index_id_space_semantics():
    """Non-dense hyperedge id spaces must not be
    silently mislabeled.  The reference counts *unique* ids but indexes
    with *raw* values (hypergraph.py:15-19) — here the two semantics are
    explicit: raw (gaps = empty hyperedges) vs compact (dense remap)."""
    import numpy as np
    from hypergef.sparse.hypergraph import Hypergraph

    n = 4
    # vertices 0..3; hyperedge ids n+0 and n+5 (gap: ids 1..4 unused)
    ei = np.array([[0, 1, 2, 3, 4, 9],
                   [4, 4, 9, 9, 0, 2]])
    # V→E half only: columns where row0 < n
    hg_raw = Hypergraph.from_edge_index(ei, num_nodes=n)
    assert hg_raw.num_edges == 6  # max raw id 5 → 6 edges, 4 empty
    deg = np.diff(hg_raw.ht_indptr)
    assert deg[0] == 2 and deg[5] == 2 and deg[1:5].sum() == 0

    hg_c = Hypergraph.from_edge_index(ei, num_nodes=n, compact=True)
    assert hg_c.num_edges == 2
    assert np.diff(hg_c.ht_indptr).tolist() == [2, 2]

    # both give identical aggregation over non-empty edges
    np.testing.assert_array_equal(hg_raw.ht_indices[:2], hg_c.ht_indices[:2])

    # num_nodes mandatory; negative rebase must raise
    import pytest as _pytest
    with _pytest.raises(ValueError):
        Hypergraph.from_edge_index(ei, num_nodes=None)
    with _pytest.raises(ValueError):
        Hypergraph.from_edge_index(np.array([[0, 1], [1, 2]]), num_nodes=4)
