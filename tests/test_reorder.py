"""Community reordering: multilevel coarsening recovery + median edge
sort.  The reference vendors an unused Rabbit-Order subsystem
(rabbit_order.hpp:267-753); here the ordering is load-bearing — it is
what makes the gather-free aligned backend reachable from raw input.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hypergef.ops import fused, refops
from hypergef.sparse import planner
from hypergef.sparse.reorder import (
    apply_vertex_order, coarsen_order, community_reorder,
)

from conftest import dense_hgnn_oracle  # noqa: F401


def _sbm(n_nodes, n_edges, n_comm, avg, noise, seed):
    from experiments.clustered_bench import community_hypergraph

    return community_hypergraph(n_nodes, n_edges, n_comm, avg, noise, seed)


def _spill(hg):
    return max(
        planner.aligned_spill_stats(hg.ht_indptr, hg.ht_indices, hg.num_nodes),
        planner.aligned_spill_stats(hg.h_indptr, hg.h_indices, hg.num_edges),
    )


@pytest.fixture(scope="module")
def sbm_shuffled():
    hg = _sbm(6000, 3000, 24, 10, 0.02, 7)
    gt, _ = apply_vertex_order(hg, np.arange(hg.num_nodes), sort_edges=True)
    perm = np.random.default_rng(11).permutation(hg.num_nodes)
    shuf, _ = apply_vertex_order(hg, perm, sort_edges=True)
    return gt, shuf


def test_coarsen_order_is_permutation(sbm_shuffled):
    _, shuf = sbm_shuffled
    order = coarsen_order(shuf)
    assert sorted(order.tolist()) == list(range(shuf.num_nodes))


def test_coarsen_recovers_planted_structure(sbm_shuffled):
    """Shuffled SBM → coarsening order: aligned-window spill must come
    back near the planted (ground-truth) ordering's."""
    gt, shuf = sbm_shuffled
    assert _spill(shuf) > 0.5  # shuffled input really is unusable
    rec, _ = apply_vertex_order(shuf, coarsen_order(shuf), sort_edges=True)
    gt_spill = _spill(gt)
    assert _spill(rec) <= max(1.5 * gt_spill, gt_spill + 0.05)


def test_median_edge_sort_bounds_noise_spill(sbm_shuffled):
    """Median (not mean) edge-sort key: a single noise member must not
    drag its hyperedge out of the community window, so e-stage spill
    stays near the noise rate."""
    gt, _ = sbm_shuffled
    spe = planner.aligned_spill_stats(gt.ht_indptr, gt.ht_indices,
                                      gt.num_nodes, window_blocks=8)
    assert spe < 0.15


def test_full_pipeline_shuffled_to_aligned(sbm_shuffled):
    """Raw (shuffled) graph → community_reorder → plan_aligned →
    fused aggregation parity vs the oracle: the production path for
    making a raw clustered graph fast."""
    _, shuf = sbm_shuffled
    hg2, rank = community_reorder(shuf, method="coarsen")
    al = planner.plan_aligned(hg2)
    hgd = hg2.device_data()
    rng = np.random.default_rng(3)
    x2 = rng.normal(size=(hg2.num_nodes, 6)).astype(np.float32)
    got = fused.hgnn_aggregate(hgd, jnp.asarray(x2), None, "sum",
                               plan=al.as_device(), backend="aligned")
    want = refops.hgnn_aggregate_ref(hgd, jnp.asarray(x2), None, "sum")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-2, atol=3e-2)
    # rank maps old ids to new ids: feature rows move consistently
    assert sorted(rank.tolist()) == list(range(shuf.num_nodes))


def test_coarsen_handles_degenerate_graphs():
    from hypergef.sparse.hypergraph import Hypergraph

    # singleton edges only → no pairs → identity-ish order, still valid
    hg = Hypergraph.from_coo(np.array([0, 1, 2]), np.array([0, 1, 2]),
                             num_nodes=4, num_edges=3)
    order = coarsen_order(hg)
    assert sorted(order.tolist()) == list(range(4))
