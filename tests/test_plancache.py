"""Persistent plan serialization (sparse/plancache.py).

The reference amortizes its host-side preprocessing by caching processed
datasets (`HyperGsys/dataloader.py` ``.pt`` files); our analogue caches
the built :class:`AggregationPlan` keyed by graph content.  These tests
pin (a) a bit-exact structural round-trip across every stage family the
planner emits (tree levels, aligned band/spill buckets, dense/precomp
device tables), (b) result parity of the fused op on a reloaded plan,
(c) the cache lifecycle: content-keyed hit, kwarg miss, corrupt-file
rebuild, and the Trainer/CLI wiring.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest

from hypergef.data.synthetic import random_hypergraph
from hypergef.ops import fused
from hypergef.sparse import plancache
from hypergef.sparse.planner import plan_aggregation

from test_aligned import _community_hg


def _assert_same(a, b, path="plan"):
    import jax

    assert type(a) is type(b), f"{path}: {type(a)} != {type(b)}"
    if isinstance(a, (np.ndarray, jax.Array)):
        an, bn = np.asarray(a), np.asarray(b)
        assert an.dtype == bn.dtype, f"{path}: dtype {an.dtype} != {bn.dtype}"
        np.testing.assert_array_equal(an, bn, err_msg=path)
        return
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            if f.name.startswith("_"):
                continue
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
        return
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        for n in a._fields:
            _assert_same(getattr(a, n), getattr(b, n), f"{path}.{n}")
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), f"{path}: len {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
        return
    assert a == b, f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("mk", [
    # aligned plan (band buckets + spill buckets + tree + multihot)
    lambda: _community_hg(900, 700, 12, 5, 0.05, 7),
    # small graph → dense int8 + bf16 precomp device tables
    lambda: random_hypergraph(150, 90, avg_edge_size=4.0, seed=11),
])
def test_round_trip_bit_exact(tmp_path, mk):
    hg = mk()
    plan = plan_aggregation(hg)
    p = str(tmp_path / "plan.npz")
    plancache.save_plan(plan, p)
    plan2 = plancache.load_plan(p)
    _assert_same(plan, plan2)

    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(hg.num_nodes, 16)).astype(np.float32)
    )
    hgd = hg.device_data()
    for backend in (plan.preferred_backend, "tree"):
        a = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend=backend)
        b = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan2, backend=backend)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_key_is_content_and_kwargs_sensitive():
    hg1 = random_hypergraph(100, 60, avg_edge_size=4.0, seed=1)
    hg2 = random_hypergraph(100, 60, avg_edge_size=4.0, seed=2)
    k1 = plancache.plan_key(hg1)
    assert k1 == plancache.plan_key(hg1)
    assert k1 != plancache.plan_key(hg2)
    assert k1 != plancache.plan_key(hg1, with_tile=True)


def test_cached_builds_once_then_loads(tmp_path, monkeypatch):
    hg = random_hypergraph(120, 70, avg_edge_size=4.0, seed=5)
    d = str(tmp_path / "plans")
    calls = []
    import hypergef.sparse.planner as planner_mod

    real = planner_mod.plan_aggregation

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(planner_mod, "plan_aggregation", counting)
    p1 = plancache.cached_plan_aggregation(hg, cache_dir=d)
    assert len(calls) == 1
    assert len(os.listdir(d)) == 1
    p2 = plancache.cached_plan_aggregation(hg, cache_dir=d)
    assert len(calls) == 1  # served from disk, not rebuilt
    _assert_same(p1, p2)


def test_corrupt_cache_file_rebuilds(tmp_path):
    hg = random_hypergraph(80, 50, avg_edge_size=4.0, seed=9)
    d = str(tmp_path / "plans")
    plancache.cached_plan_aggregation(hg, cache_dir=d)
    (fname,) = os.listdir(d)
    with open(os.path.join(d, fname), "wb") as fh:
        fh.write(b"not an npz")
    plan = plancache.cached_plan_aggregation(hg, cache_dir=d)
    assert plan.tree is not None  # rebuilt, not crashed


def test_refuses_foreign_classes(tmp_path):
    with pytest.raises(ValueError, match="outside hypergef"):
        plancache._resolve_class("os.path:join")


def test_halo_plan_round_trip(tmp_path):
    """HaloPlan (distributed) round-trips bit-exact and the sharded
    program on a reloaded plan matches the original's output."""
    import jax

    from hypergef.parallel.halo import plan_halo
    from hypergef.parallel.halo_aggr import (
        halo_hgnn_aggregate, shard_vertex_features, unshard_vertex_features,
    )
    from hypergef.parallel.mesh import make_mesh

    hg = random_hypergraph(200, 140, avg_edge_size=5.0, seed=13)
    plan = plan_halo(hg, 4)
    d = str(tmp_path / "plans")
    plan2 = plancache.cached_plan_halo(hg, 4, cache_dir=d)
    _assert_same(plan, plan2)
    plan3 = plancache.cached_plan_halo(hg, 4, cache_dir=d)  # disk hit
    _assert_same(plan, plan3)

    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, 8)).astype(np.float32)
    outs = []
    for p in (plan, plan3):
        x_own = jnp.asarray(shard_vertex_features(p, x))
        out_own = halo_hgnn_aggregate(p, mesh, x_own, None, "sum")
        outs.append(np.asarray(unshard_vertex_features(p, out_own)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_trainer_plan_cache_wiring(tmp_path):
    from hypergef.train import TrainConfig, rand_train_test_idx
    from hypergef.train.trainer import Trainer
    from hypergef.data.synthetic import homophilic_hypergraph

    hg, y = homophilic_hypergraph(200, 120, 4, seed=3)
    x = np.random.default_rng(3).normal(size=(200, 16)).astype(np.float32)
    d = str(tmp_path / "plans")
    cfg = TrainConfig(epochs=2, warmup=0, plan_cache=d, nhid=8)
    tr1 = Trainer(cfg, hg, x, y)
    assert len(os.listdir(d)) == 1
    tr2 = Trainer(cfg, hg, x, y)  # second construction loads from disk
    split = rand_train_test_idx(y, seed=0)
    r1 = tr1.fit(split["train"], epochs=2, warmup=0)
    r2 = tr2.fit(split["train"], epochs=2, warmup=0)
    np.testing.assert_allclose(
        float(r1["final_loss"]), float(r2["final_loss"]), rtol=1e-5
    )
