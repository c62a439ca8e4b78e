"""Measured autotuner (sparse/autotune): sweep runs, cache round-trips,
autotune_plan returns a working plan whose auto backend ties-or-beats the
candidates it measured (on the measuring device)."""

import numpy as np
import pytest

from hypergef.data.synthetic import random_hypergraph
from hypergef.ops import fused
from hypergef.sparse import autotune
from hypergef.sparse.planner import plan_aggregation

from conftest import dense_hgnn_oracle


@pytest.fixture(scope="module")
def hg():
    out = random_hypergraph(200, 120, avg_edge_size=4.0, seed=9)
    return out[0] if isinstance(out, tuple) else out


def test_sweep_and_cache(hg, tmp_path):
    res = autotune.sweep(hg, feature_size=4, iters=2)
    assert len(res) >= 3
    assert all(r.per_iter_s >= 0 for r in res)
    assert res == sorted(res, key=lambda r: r.per_iter_s)

    best = autotune.autotune(hg, feature_size=4, iters=2,
                             cache_dir=str(tmp_path))
    key = autotune.graph_key(hg, 4)
    rec = autotune.load_cached(key, str(tmp_path))
    assert rec is not None and rec["backend"] == best.backend
    # second call hits the cache (no sweep → instant, same result)
    again = autotune.autotune(hg, feature_size=4, iters=2,
                              cache_dir=str(tmp_path))
    assert again.backend == best.backend and again.params == best.params


def test_autotune_plan_correct(hg, tmp_path):
    plan = autotune.autotune_plan(hg, feature_size=4, cache_dir=str(tmp_path))
    hgd = hg.device_data()
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, 4)).astype(np.float32)
    want = dense_hgnn_oracle(hg, x, None, "sum")
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="auto")
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-2, atol=3e-2)


def test_graph_key_stability(hg):
    k1 = autotune.graph_key(hg, 32)
    k2 = autotune.graph_key(hg, 32)
    assert k1 == k2
    assert autotune.graph_key(hg, 64) != k1


def test_default_candidates_cover_ladder(hg):
    cands = autotune.default_candidates(hg)
    backends = {b for b, _ in cands}
    assert {"cumsum", "tree", "multihot"} <= backends
    # small graph → dense + precomp candidates present
    assert "dense" in backends and "precomp" in backends
