"""Serialized single-device HaloPlan execution (parallel/serial_halo).

Must agree with the shard_map halo program and the dense oracle — that
equivalence is what lets the 100M-nnz artifact replace a projection
with a serialized measurement (round-4 mandate #9).
"""

import numpy as np
import pytest

from hypergef.parallel.halo import plan_halo
from hypergef.parallel.serial_halo import serialized_halo_forward

from conftest import dense_hgnn_oracle


def rand_x(hg, f=6, seed=0):
    return np.random.default_rng(seed).normal(
        size=(hg.num_nodes, f)).astype(np.float32)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_serialized_matches_oracle(skewed_hg, n_shards, aggr):
    hg = skewed_hg
    plan = plan_halo(hg, n_shards)
    x = rand_x(hg, seed=1)
    got = serialized_halo_forward(plan, x, first_aggr=aggr)
    want = dense_hgnn_oracle(hg, x, None, aggr)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serialized_matches_shard_map(skewed_hg):
    """Bit-level agreement with the live shard_map program (same plan
    arrays, same compute graph, host permutation replacing a2a)."""
    import jax
    import jax.numpy as jnp

    from hypergef.parallel import make_mesh
    from hypergef.parallel.halo_aggr import (
        halo_hgnn_aggregate, shard_vertex_features, unshard_vertex_features,
    )

    hg = skewed_hg
    plan = plan_halo(hg, 4)
    x = rand_x(hg, seed=3)
    got = serialized_halo_forward(plan, x)
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    x_own = jnp.asarray(shard_vertex_features(plan, x))
    live = unshard_vertex_features(
        plan, halo_hgnn_aggregate(plan, mesh, x_own, None, "sum")
    )[: hg.num_nodes]
    np.testing.assert_allclose(got, np.asarray(live), rtol=1e-6, atol=1e-6)


def test_serialized_aligned_interior():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "experiments"))
    from weak_scaling import clustered_hypergraph

    hg = clustered_hypergraph(4000, 2000, 8.0, seed=3)
    plan = plan_halo(hg, 4, local_form="aligned")
    assert plan.local_form == "aligned"
    x = rand_x(hg, seed=4)
    got = serialized_halo_forward(plan, x)
    want = dense_hgnn_oracle(hg, x, None, "sum")
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_serialized_stats_filled(skewed_hg):
    plan = plan_halo(skewed_hg, 2)
    stats = {}
    serialized_halo_forward(plan, rand_x(skewed_hg, seed=5), stats=stats)
    assert stats["n_shards"] == 2
    assert stats["halo_bytes_real"] > 0
    assert stats["return_bytes_real"] > 0
    assert len(stats["per_shard_wall_s"]) == 2
