"""DistTrainer end-to-end on the simulated 8-device CPU mesh."""

import numpy as np

from hypergef.data.synthetic import homophilic_hypergraph
from hypergef.parallel.trainer import DistTrainer
from hypergef.train import rand_train_test_idx


def test_dist_trainer_learns_and_matches_mesh_sizes():
    hg, y = homophilic_hypergraph(500, 300, 4, seed=0)
    x = np.random.default_rng(1).normal(size=(500, 16)).astype(np.float32)
    split = rand_train_test_idx(y, seed=2)
    tr = DistTrainer(hg, x, y, nhid=16, n_shards=8)
    # chained (single-dispatch lax.scan) mode: the root fix for the
    # simulated CPU mesh's async-queue abort — only one in-flight program
    res = tr.fit(split["train"], epochs=30)
    assert res["n_shards"] == 8
    assert np.isfinite(res["final_loss"])
    acc = tr.evaluate(split)
    assert acc["test_acc"] > 35.0, (res, acc)


def test_dist_trainer_2d_mesh():
    hg, y = homophilic_hypergraph(300, 200, 3, seed=1)
    x = np.random.default_rng(2).normal(size=(300, 8)).astype(np.float32)
    split = rand_train_test_idx(y, seed=3)
    tr = DistTrainer(hg, x, y, nhid=8, n_shards=4, n_feature=2)
    # legacy per-step dispatch path kept covered (fenced)
    res = tr.fit(split["train"], epochs=20, warmup=1, fence_every=1,
                 chained=False)
    assert np.isfinite(res["final_loss"])


def test_dist_trainer_unigin_and_unigcnii():
    """All three reference model families train through DistTrainer."""
    hg, y = homophilic_hypergraph(400, 250, 4, seed=4)
    x = np.random.default_rng(5).normal(size=(400, 12)).astype(np.float32)
    split = rand_train_test_idx(y, seed=6)
    for model in ("UniGIN", "UniGCNII"):
        tr = DistTrainer(hg, x, y, nhid=16, n_shards=8, model=model)
        res = tr.fit(split["train"], epochs=30)
        assert np.isfinite(res["final_loss"])
        acc = tr.evaluate(split)
        assert acc["test_acc"] > 35.0, (model, res, acc)


def test_dist_trainer_rejects_nonsum_aggr_for_unignn():
    """first_aggr != 'sum' must be an explicit error for the UniGNN family
    (it used to be silently ignored while the CLI reported the requested
    value)."""
    import pytest

    hg, y = homophilic_hypergraph(100, 60, 3, seed=20)
    x = np.random.default_rng(21).normal(size=(100, 8)).astype(np.float32)
    for model in ("UniGIN", "UniGCNII"):
        with pytest.raises(ValueError, match="first_aggr"):
            DistTrainer(hg, x, y, nhid=8, n_shards=4, model=model,
                        first_aggr="max")


def test_dist_trainer_max_chained_epochs():
    """Regression: first max_device()/device() call used to happen inside
    the chained-epoch scan trace, caching traced constants that leaked
    into later traces (UnexpectedTracerError). Plan device caches must
    build eagerly (jax.ensure_compile_time_eval)."""
    hg, y = homophilic_hypergraph(300, 200, 4, seed=12)
    x = np.random.default_rng(13).normal(size=(300, 12)).astype(np.float32)
    split = rand_train_test_idx(y, seed=14)
    tr = DistTrainer(hg, x, y, nhid=16, n_shards=8, first_aggr="max")
    # max first-aggr converges slower than sum on this synthetic; 60 epochs
    # reaches ~90% test acc (10 epochs is still below chance — round-2's
    # miscalibrated band).  The regression this guards (tracer leak) would
    # surface as an UnexpectedTracerError, not low accuracy.
    res = tr.fit(split["train"], epochs=60)
    acc = tr.evaluate(split)  # retrace after the scan — must not leak
    assert np.isfinite(res["final_loss"]) and acc["test_acc"] > 50.0


def test_dist_trainer_checkpoint_resume(tmp_path):
    """Distributed checkpoint/resume: sharded (params, opt_state) round-trip
    through the .npz checkpoint onto the live mesh, and training continues from the
    restored state (SURVEY §5: the reference has no resume at all)."""
    import jax
    import numpy as np

    from hypergef.data.synthetic import homophilic_hypergraph, random_features
    from hypergef.parallel.trainer import DistTrainer
    from hypergef.train import rand_train_test_idx

    hg, y = homophilic_hypergraph(200, 120, 3, avg_edge_size=5.0, seed=11)
    x, _ = random_features(hg.num_nodes, 12, 3, seed=12)
    split = rand_train_test_idx(y, seed=13)

    tr = DistTrainer(hg, x, y, nhid=8, n_shards=4, seed=3)
    tr.fit(split["train"], epochs=5, warmup=0)
    acc0 = tr.evaluate(split)["test_acc"]
    tr.save(str(tmp_path / "ck"), step=5)

    tr2 = DistTrainer(hg, x, y, nhid=8, n_shards=4, seed=99)  # different init
    step = tr2.restore(str(tmp_path / "ck"))
    assert step == 5
    for a, b in zip(
        jax.tree_util.tree_leaves(tr.params), jax.tree_util.tree_leaves(tr2.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tr2.evaluate(split)["test_acc"] == acc0
    # restored state is trainable (shardings landed on the mesh correctly)
    tr2.fit(split["train"], epochs=3, warmup=0)
