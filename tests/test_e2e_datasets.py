"""Tier-1 end-to-end analogue of the reference's ``test/hgnn_test.py:65-92``:
load real-format raw data for ALL 13 named datasets (committed fixtures)
→ plan → train → assert accuracy bands.

The fixtures (tests/fixtures/data, generated by
scripts/make_fixture_datasets.py) carry homophilic structure, so models
must clearly beat chance; bands are generous to stay deterministic-safe
but meaningful (chance = 25–50%).  The yelp fixture follows the
reference loader's exact raw schema (5 CSVs, 1-based incidence —
load_dataset.py:199-303), closing the round-2 "best-effort schema" gap."""

import os

import numpy as np
import pytest

from hypergef.data.datasets import EXISTING_DATASETS, load_dataset
from hypergef.train import TrainConfig, rand_train_test_idx, train_full_batch

FIXTURE_ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "data")

# every loader family, one representative trained per model (full list
# below is load-tested; training all 13 x 3 would dominate suite time)
TRAIN_REPRESENTATIVES = {
    "zoo": "LE (.content/.edges)",
    "cora": "citation pickles",
    "coauthor_dblp": "citation pickles (coauthor)",
    "walmart-trips": "cornell txt",
    "yelp": "reference 5-CSV schema",
}


@pytest.mark.parametrize("name", sorted(EXISTING_DATASETS))
def test_load_fixture_all_13(name):
    """Every dataset name the reference's tier-1 test runs loads
    end-to-end from its real raw format (dataloader.py:20-58)."""
    ds = load_dataset(name, root=FIXTURE_ROOT, cache=False)
    assert ds.hg.num_nodes > 100 and ds.hg.num_edges >= 24
    assert ds.features.shape[0] == ds.hg.num_nodes
    assert ds.labels.shape[0] == ds.hg.num_nodes
    assert ds.num_classes >= 2
    # CSR invariants
    assert int(ds.hg.h_indptr[-1]) == ds.hg.nnz
    assert int(ds.hg.ht_indptr[-1]) == ds.hg.nnz


def test_yelp_reference_schema_features():
    """The yelp loader reproduces the reference's feature construction:
    latlong (2) + state one-hot + city one-hot + name bag-of-words,
    labels shifted to 0-based stars (load_dataset.py:199-303)."""
    ds = load_dataset("yelp", root=FIXTURE_ROOT, cache=False)
    # fixture: 3 states, 6 cities, <=9 name words + counts digits
    assert ds.features.shape[1] >= 2 + 3 + 6 + 5
    # one-hot blocks: exactly one state and one city bit set per node
    state = ds.features[:, 2:5]
    city = ds.features[:, 5:11]
    assert np.all(state.sum(axis=1) == 1.0)
    assert np.all(city.sum(axis=1) == 1.0)
    assert ds.labels.min() == 0  # label shift parity


@pytest.mark.parametrize("model", ["HGNN", "UniGIN", "UniGCNII"])
@pytest.mark.parametrize("name", sorted(TRAIN_REPRESENTATIVES))
def test_train_accuracy_band(name, model):
    ds = load_dataset(name, root=FIXTURE_ROOT, cache=False)
    split = rand_train_test_idx(ds.labels, seed=1)
    cfg = TrainConfig(model=model, nhid=32, epochs=60, lr=0.01,
                      dropout=0.2, input_drop=0.2)
    res = train_full_batch(cfg, ds.hg, ds.features, ds.labels, split)
    chance = 100.0 / ds.num_classes
    if name == "yelp":
        # 9 star classes with band-level structure: the learnable signal
        # separates 3 bands, so the right bar is "clearly above chance"
        assert res["train_acc"] > chance + 10, (name, model, res)
        assert res["test_acc"] > chance + 5, (name, model, res)
    else:
        assert res["train_acc"] > chance + 25, (name, model, res)
        assert res["test_acc"] > chance + 10, (name, model, res)


def test_cli_on_fixture(tmp_path, capsys):
    """The reference CLI surface over a real-format fixture dataset."""
    from hypergef.train.cli import main

    out_f = tmp_path / "res.csv"
    res = main([
        "--dname", "zoo", "--data-path", FIXTURE_ROOT, "--model", "HGNN",
        "--epochs", "20", "--nhid", "16", "--seed", "1",
        "--output", str(out_f), "--platform", "cpu",
    ])
    assert "test_acc" in res
    row = out_f.read_text().strip()
    assert "HGNN" in row and "zoo" in row  # reference CSV schema row
