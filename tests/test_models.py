"""End-to-end model tests: shapes, training convergence, and the full
trainer protocol (tier-1 analogue of test/hgnn_test.py, plus training
checks the reference lacks)."""

import numpy as np
import pytest

from hypergef.data.synthetic import random_features, random_hypergraph
from hypergef.train import TrainConfig, Trainer, rand_train_test_idx, train_full_batch


@pytest.fixture(scope="module")
def setup():
    hg = random_hypergraph(150, 100, avg_edge_size=6.0, seed=0)
    x, y = random_features(hg.num_nodes, 16, 4, seed=1)
    split = rand_train_test_idx(y, seed=2)
    return hg, x, y, split


@pytest.mark.parametrize("model", ["HGNN", "UniGIN", "UniGCNII"])
def test_model_forward_shapes(setup, model):
    hg, x, y, split = setup
    cfg = TrainConfig(model=model, nhid=8, nlayer=2, epochs=1, warmup=0)
    tr = Trainer(cfg, hg, x, y)
    z = np.asarray(tr._forward(tr.params, tr.x))
    assert z.shape == (hg.num_nodes, 4)
    # log_softmax rows sum to 1 in prob space
    np.testing.assert_allclose(np.exp(z).sum(axis=1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("model", ["HGNN", "UniGIN", "UniGCNII"])
def test_training_learns(setup, model):
    hg, x, y, split = setup
    cfg = TrainConfig(
        model=model, nhid=16, nlayer=2, epochs=60, warmup=0,
        dropout=0.1, input_drop=0.1,
    )
    res = train_full_batch(cfg, hg, x, y, split)
    # class-separable synthetic features: must beat 4-class chance (25%)
    assert res["train_acc"] > 50.0, res
    assert res["test_acc"] > 40.0, res
    assert np.isfinite(res["final_loss"])


@pytest.mark.parametrize("first_aggr", ["sum", "mean", "max"])
def test_hgnn_first_aggr_variants(setup, first_aggr):
    hg, x, y, split = setup
    cfg = TrainConfig(
        model="HGNN", nhid=8, epochs=5, warmup=0, first_aggr=first_aggr,
        dropout=0.0, input_drop=0.0,
    )
    res = train_full_batch(cfg, hg, x, y, split)
    assert np.isfinite(res["final_loss"])


def test_ell_backend_end_to_end(setup):
    hg, x, y, split = setup
    cfg = TrainConfig(model="HGNN", nhid=8, epochs=5, warmup=0, backend="ell",
                      dropout=0.0, input_drop=0.0)
    res = train_full_batch(cfg, hg, x, y, split)
    assert np.isfinite(res["final_loss"])


def test_multihead(setup):
    hg, x, y, split = setup
    cfg = TrainConfig(model="HGNN", nhid=8, nhead=4, epochs=3, warmup=0)
    res = train_full_batch(cfg, hg, x, y, split)
    assert np.isfinite(res["final_loss"])


def test_splits_partition():
    y = np.random.default_rng(0).integers(0, 3, size=200)
    split = rand_train_test_idx(y, train_prop=0.5, valid_prop=0.25, seed=1)
    all_idx = np.concatenate([split["train"], split["valid"], split["test"]])
    assert len(np.unique(all_idx)) == 200
    assert len(split["train"]) == 100
    split_b = rand_train_test_idx(y, balance=True, seed=1)
    assert len(split_b["train"]) > 0 and len(split_b["test"]) > 0
