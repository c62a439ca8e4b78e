"""Regression tests for the backend auto-selection ladder.

A mis-attached branch here once routed 20news-shaped graphs to BSR
(8× slower there) — lock the canonical routings down.
"""

import numpy as np
import pytest

from hypergef.data.synthetic import random_hypergraph
from hypergef.sparse.planner import plan_aggregation


def test_cora_shape_prefers_precomp():
    hg = random_hypergraph(2708, 2708, avg_edge_size=4.0, seed=0)
    plan = plan_aggregation(hg)
    # N == E: precomputed A (one matmul) is the best fused layer
    assert plan.preferred_backend == "precomp"
    assert plan.precomp is not None


def test_20news_shape_prefers_dense_two_stage():
    # few giant hyperedges: N >> E → A (N²) is 80× the two H reads
    hg = random_hypergraph(16242, 100, avg_edge_size=654.5, seed=0)
    plan = plan_aggregation(hg)
    assert plan.preferred_backend == "dense"
    assert plan.bsr is None  # dense-eligible graphs must not build BSR


def test_large_sparse_prefers_tree_unless_bsr_fill():
    hg = random_hypergraph(60_000, 30_000, avg_edge_size=8.0, seed=0)
    plan = plan_aggregation(hg)
    # uniform random graph: BSR fill is far below threshold
    assert plan.preferred_backend == "tree"
    assert plan.dense is None and plan.precomp is None


def test_every_preference_is_runnable(small_hg):
    """Whatever the ladder picks must execute via backend='auto'."""
    import jax.numpy as jnp

    from hypergef.ops import fused

    plan = plan_aggregation(small_hg)
    hgd = small_hg.device_data()
    x = jnp.ones((small_hg.num_nodes, 4), jnp.float32)
    out = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="auto")
    assert np.isfinite(np.asarray(out)).all()


def test_midsize_unstructured_prefers_dense_stream():
    """Round-2: unstructured graphs past the small-dense gate but with
    N*E small relative to nnz route to the int8 dense-stream backend
    (measured 1.5-2.5x the gather paths; probe_dense_int8.py)."""
    import jax.numpy as jnp

    # N*E = 64M > DENSE_AUTO_THRESHOLD, N^2 > PRECOMP cap, ratio
    # N*E/nnz ~ 1600 < DENSE_STREAM_VS_GATHER
    hg = random_hypergraph(16_000, 4_000, avg_edge_size=10.0, seed=0)
    assert hg.num_nodes * hg.num_edges > 32_000_000
    plan = plan_aggregation(hg)
    assert plan.preferred_backend == "dense"
    assert plan.dense is not None
    # int8 is the measured default (packed int4 is a recorded negative
    # result for per-layer calls — planner.DenseIncidence docstring)
    assert not plan.dense.packed and plan.dense.h.dtype == jnp.int8


def test_midsize_unstructured_high_ratio_stays_on_gather_ladder():
    """Sparse relative to its bounding box (ratio >> crossover): the
    dense stream would lose; the gather ladder keeps the pick."""
    hg = random_hypergraph(30_000, 8_000, avg_edge_size=3.0, seed=0)
    # ratio = 240M / ~24k nnz ~ 10000
    plan = plan_aggregation(hg)
    assert plan.preferred_backend in ("tree", "cumsum")
    assert plan.dense is None
