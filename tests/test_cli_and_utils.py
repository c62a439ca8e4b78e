"""CLI, transforms, checkpoint, and profiling-utility tests."""

import numpy as np
import pytest

from hypergef.data.transforms import add_self_loops, extract_v2e
from hypergef.data.synthetic import random_hypergraph


def test_add_self_loops(tiny_hg):
    hg2 = add_self_loops(tiny_hg)
    # tiny_hg has no singleton edges → one new edge per vertex
    assert hg2.num_edges == tiny_hg.num_edges + tiny_hg.num_nodes
    sizes = hg2.edge_sizes()
    assert (sizes[tiny_hg.num_edges :] == 1).all()
    # vertices already in singleton edges are skipped
    from hypergef.sparse.hypergraph import Hypergraph

    hg3 = Hypergraph.from_coo(np.array([0, 1, 2]), np.array([0, 1, 1]),
                              num_nodes=3, num_edges=2)
    hg4 = add_self_loops(hg3)  # vertex 0 already singleton {0}
    assert hg4.num_edges == 2 + 2  # only vertices 1, 2 get loops


def test_extract_v2e():
    # bipartite symmetric: V={0,1}, E ids offset by 2
    ei = np.array([[2, 0, 1, 3], [0, 2, 3, 1]])
    out = extract_v2e(ei, num_nodes=2)
    assert (out[0] < 2).all()
    assert out.shape[1] == 2


def test_cli_synthetic_smoke(tmp_path):
    from hypergef.train import cli

    out = str(tmp_path / "res.csv")
    res = cli.main([
        "--synthetic", "homophilic", "--n", "200", "--e", "120",
        "--classes", "3", "--feat", "8", "--nhid", "8", "--epochs", "10",
        "--dropout", "0.1", "--input-drop", "0.1", "--output", out,
    ])
    assert np.isfinite(res["final_loss"])
    line = open(out).read()
    assert "HGNN" in line and "auto" in line


def test_cli_tune_smoke(tmp_path, monkeypatch):
    """--tune routes plan construction through the measured autotuner
    (round-3 mandate #4: the tuner in the product path, not a side tool);
    the second run must hit the persisted cache."""
    from hypergef.train import cli
    from hypergef.sparse import autotune

    monkeypatch.setenv("HYPERGEF_TUNE_DIR", str(tmp_path / "tune"))
    res = cli.main([
        "--synthetic", "homophilic", "--n", "200", "--e", "120",
        "--classes", "3", "--feat", "8", "--nhid", "8", "--epochs", "5",
        "--dropout", "0.1", "--input-drop", "0.1", "--tune",
    ])
    assert np.isfinite(res["final_loss"])
    import os

    recs = os.listdir(str(tmp_path / "tune"))
    assert len(recs) == 1  # persisted measurement record
    # the cached record resolves without a sweep (instant plan)
    from hypergef.data.synthetic import homophilic_hypergraph

    hg, _ = homophilic_hypergraph(200, 120, 3, seed=1)  # CLI default seed
    rec = autotune.load_cached(autotune.graph_key(hg, 8))
    assert rec is not None and "backend" in rec


def test_plan_halo_auto_local_form(tmp_path, monkeypatch):
    """local_form='auto' picks the aligned interior iff the persisted
    single-chip tune record says aligned (and trees with no record)."""
    from hypergef.data.synthetic import homophilic_hypergraph
    from hypergef.parallel.halo import plan_halo
    from hypergef.sparse import autotune

    monkeypatch.setenv("HYPERGEF_TUNE_DIR", str(tmp_path / "tune"))
    hg, _ = homophilic_hypergraph(300, 200, 3, seed=1)
    plan = plan_halo(hg, 4, local_form="auto")  # no record -> tree
    assert plan.local_form == "tree"
    autotune.save_cached(
        autotune.graph_key(hg, 32),
        {"backend": "aligned", "params": {}, "per_iter_s": 1e-6},
    )
    plan2 = plan_halo(hg, 4, local_form="auto")
    # aligned requested via record; may still legitimately fall back to
    # tree if a shard interior is spill-heavy — both are valid outcomes,
    # what must hold is that the record was consulted without error
    assert plan2.local_form in ("aligned", "tree")


def test_cli_minibatch_smoke():
    from hypergef.train import cli

    res = cli.main([
        "--synthetic", "homophilic", "--n", "300", "--e", "200",
        "--classes", "3", "--feat", "8", "--nhid", "8", "--epochs", "20",
        "--minibatch-edges", "64", "--dropout", "0.1", "--input-drop", "0.1",
    ])
    assert np.isfinite(res["final_loss"])


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from hypergef.train.checkpoint import restore_checkpoint, save_checkpoint

    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}
    opt_state = {"m": jnp.ones(3)}
    save_checkpoint(str(tmp_path / "ck"), 7, params, opt_state)
    step, p2, o2 = restore_checkpoint(
        str(tmp_path / "ck"),
        params_template=params,
        opt_state_template=opt_state,
    )
    assert step == 7
    np.testing.assert_array_equal(np.asarray(p2["w"]), np.asarray(params["w"]))
    np.testing.assert_array_equal(np.asarray(o2["m"]), np.asarray(opt_state["m"]))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), params, opt_state)


def test_cost_analysis_traffic_report(small_hg):
    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_aggregation
    from hypergef.utils.profiling import traffic_report

    hg = small_hg
    hgd = hg.device_data()
    plan = plan_aggregation(hg)
    import jax.numpy as jnp

    x = jnp.ones((hg.num_nodes, 8))
    rep = traffic_report(
        {
            "xla": lambda a: fused.hgnn_aggregate(hgd, a, None, "sum", backend="xla"),
            "cumsum": lambda a: fused.hgnn_aggregate(hgd, a, None, "sum", backend="cumsum"),
        },
        x,
    )
    assert "xla" in rep and "cumsum" in rep
    assert rep["xla"].get("bytes_accessed", 0) >= 0


def test_cli_export_serving_artifact(tmp_path):
    """--export on the full-batch path writes a loadable serving artifact
    (the reference has no serving/persistence subsystem — SURVEY §5)."""
    from hypergef import serve
    from hypergef.train import cli

    art = str(tmp_path / "m.hgefsrv")
    res = cli.main([
        "--synthetic", "homophilic", "--n", "150", "--e", "90",
        "--classes", "3", "--feat", "8", "--nhid", "8", "--epochs", "5",
        "--dropout", "0.1", "--input-drop", "0.1", "--export", art,
    ])
    assert res["export_path"] == art
    m = serve.ServingModel.load(art)
    assert m.meta["model"] == "HGNN"
    out = m.predict(np.zeros(tuple(m.meta["input_shape"]), np.float32))
    assert out.shape == tuple(m.meta["output_shape"])


def test_trainer_save_restore_methods(tmp_path):
    from hypergef.data.synthetic import homophilic_hypergraph, random_features
    from hypergef.train import TrainConfig, Trainer, rand_train_test_idx

    hg, y = homophilic_hypergraph(120, 70, 3, avg_edge_size=4.0, seed=21)
    x, _ = random_features(hg.num_nodes, 8, 3, seed=22)
    split = rand_train_test_idx(y, seed=23)
    tr = Trainer(TrainConfig(model="HGNN", nhid=8, epochs=3, warmup=0), hg, x, y)
    tr.fit(split["train"], epochs=3, warmup=0)
    tr.save(str(tmp_path / "ck"), step=3)
    tr2 = Trainer(TrainConfig(model="HGNN", nhid=8, epochs=3, warmup=0, seed=9), hg, x, y)
    assert tr2.restore(str(tmp_path / "ck")) == 3
    import jax

    for a, b in zip(
        jax.tree_util.tree_leaves(tr.params), jax.tree_util.tree_leaves(tr2.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_epoch_device_time_stats_shape():
    """Median+spread protocol: stats must carry
    >= the requested windows, ordered min <= median <= max."""
    from hypergef.data.synthetic import homophilic_hypergraph, random_features
    from hypergef.train import TrainConfig, Trainer, rand_train_test_idx

    hg, y = homophilic_hypergraph(100, 60, 3, avg_edge_size=4.0, seed=31)
    x, _ = random_features(hg.num_nodes, 8, 3, seed=32)
    split = rand_train_test_idx(y, seed=33)
    tr = Trainer(TrainConfig(model="HGNN", nhid=8, epochs=1, warmup=0), hg, x, y)
    st = tr.epoch_device_time_stats(split["train"], iters=3, windows=3, repeats=2)
    assert st["windows"] == 3
    assert len(st["samples_s"]) == 3
    assert st["min_s"] <= st["median_s"] <= st["max_s"]
    assert st["median_s"] >= 0
    assert st["iters"] == 3

    # min-window rule (round-4 e2e hygiene): a huge min_window_s must
    # widen the chained loop beyond the requested iters.  The window
    # measurement is stubbed to a fixed positive pilot so the widening
    # math is exercised deterministically — a real differenced window
    # can measure <= 0 under scheduler jitter, which legitimately skips
    # widening and made this assertion flaky (advisor r4).
    seen_iters = []

    def fixed_windows(train_idx, iters, windows, repeats):
        seen_iters.append(iters)
        return [0.001] * windows

    tr._epoch_windows = fixed_windows
    st = tr.epoch_device_time_stats(
        split["train"], iters=2, windows=1, repeats=1, min_window_s=0.05)
    assert st["iters"] == 50  # ceil(0.05 s / 1 ms pilot)
    assert seen_iters == [2, 50]  # pilot at requested iters, then widened
