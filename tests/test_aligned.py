"""Segment-aligned banded-multihot backend (backend="aligned"):
gather-free fused aggregation for community-sorted graphs.

Reference semantics: the same fused two-stage aggregation as the
reference kernel (hgnnaggr_cuda.cu:14-47) in a banded/windowed layout
(see planner.AlignedStage docstring).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hypergef.data.synthetic import random_hypergraph
from hypergef.ops import fused, refops
from hypergef.sparse import planner
from hypergef.sparse.hypergraph import Hypergraph
from hypergef.sparse.reorder import apply_vertex_order

from conftest import dense_hgnn_oracle


def _community_hg(n_nodes, n_edges, n_comm, avg, noise, seed):
    rng = np.random.default_rng(seed)
    comm_of = np.sort(rng.integers(0, n_comm, size=n_nodes))
    starts = np.searchsorted(comm_of, np.arange(n_comm))
    ends = np.searchsorted(comm_of, np.arange(n_comm), side="right")
    vs, es = [], []
    for e in range(n_edges):
        c = rng.integers(0, n_comm)
        lo, hi = starts[c], ends[c]
        if hi - lo < 2:
            lo, hi = 0, n_nodes
        k = max(int(rng.poisson(avg)), 2)
        members = np.unique(rng.integers(lo, hi, size=k))
        vs.append(members)
        es.append(np.full(len(members), e, dtype=np.int64))
    hg = Hypergraph.from_coo(np.concatenate(vs), np.concatenate(es),
                             num_nodes=n_nodes, num_edges=n_edges)
    hg, _ = apply_vertex_order(hg, np.arange(n_nodes), sort_edges=True)
    return hg


@pytest.fixture(scope="module")
def sorted_hg():
    return _community_hg(2000, 1600, 25, 5, 0.05, 3)


def test_aligned_forward_parity(sorted_hg):
    hg = sorted_hg
    hgd = hg.device_data()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(hg.num_nodes, 7)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)
    al = planner.plan_aligned(hg)
    for aggr in ("sum", "mean"):
        want = dense_hgnn_oracle(hg, x, w, aggr)
        got = fused.hgnn_aggregate(
            hgd, x, jnp.asarray(w), aggr, plan=al.as_device(),
            backend="aligned",
        )
        np.testing.assert_allclose(np.asarray(got), want, rtol=3e-2,
                                   atol=3e-2, err_msg=aggr)


def test_aligned_grad_parity(sorted_hg):
    hg = sorted_hg
    hgd = hg.device_data()
    x = jnp.asarray(
        np.random.default_rng(1).normal(size=(hg.num_nodes, 5)).astype(np.float32)
    )
    al = planner.plan_aligned(hg)

    def loss(backend, plan):
        return lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=plan,
                                 backend=backend) ** 2
        )

    got = np.asarray(jax.grad(loss("aligned", al.as_device()))(x))
    want = np.asarray(jax.grad(loss("xla", None))(x))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_aligned_unignn_parity(sorted_hg):
    hg = sorted_hg
    hgd = hg.device_data()
    x = jnp.asarray(
        np.random.default_rng(2).normal(size=(hg.num_nodes, 4)).astype(np.float32)
    )
    al = planner.plan_aligned(hg)
    for use_deg in (False, True):
        want = refops.unignn_aggregate_ref(hgd, x, use_deg)
        got = fused.unignn_aggregate(hgd, x, use_deg, plan=al.as_device(),
                                     backend="aligned")
        # bf16 matmul accumulation: ~7e-3 relative on O(10) magnitudes
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=3e-2, atol=1e-1)


def test_aligned_spill_correct_on_random():
    """Forced aligned build on an (unsorted) random graph: everything
    lands in the spill path — results must still be exact."""
    out = random_hypergraph(900, 700, avg_edge_size=4.0, seed=2)
    hg = out[0] if isinstance(out, tuple) else out
    e_st = planner.build_aligned_stage(hg.ht_indptr, hg.ht_indices, hg.num_nodes)
    v_st = planner.build_aligned_stage(hg.h_indptr, hg.h_indices, hg.num_edges)
    al = planner.TreePlan(edge_stage=e_st, vertex_stage=v_st,
                          num_nodes=hg.num_nodes, num_edges=hg.num_edges)
    hgd = hg.device_data()
    x = jnp.asarray(np.random.default_rng(5).normal(size=(900, 6)).astype(np.float32))
    want = refops.hgnn_aggregate_ref(hgd, x, None, "sum")
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=al.as_device(),
                               backend="aligned")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-2, atol=3e-2)


def test_aligned_refuses_spill_heavy():
    """A large uniform-random graph cannot be banded: plan_aligned must
    refuse with guidance rather than build a pathological plan."""
    out = random_hypergraph(19717, 9000, avg_edge_size=4.3, seed=0)
    hg = out[0] if isinstance(out, tuple) else out
    with pytest.raises(ValueError, match="community_reorder"):
        planner.plan_aligned(hg)


def test_bucketed_matches_uniform(sorted_hg):
    """The bucketed form (per-group window widths, spill buckets) is an
    efficiency refactor — results must match the uniform form exactly up
    to bf16 matmul noise."""
    hg = sorted_hg
    hgd = hg.device_data()
    x = jnp.asarray(
        np.random.default_rng(7).normal(size=(hg.num_nodes, 9)).astype(np.float32)
    )
    uni = planner.plan_aligned(hg, form="uniform")
    buck = planner.plan_aligned(hg, form="bucketed")
    got_u = fused.hgnn_aggregate(hgd, x, None, "sum", plan=uni.as_device(),
                                 backend="aligned")
    got_b = fused.hgnn_aggregate(hgd, x, None, "sum", plan=buck.as_device(),
                                 backend="aligned")
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(got_u),
                               rtol=1e-2, atol=1e-2)
    # bucketed must never stream more band bytes than uniform pays
    for bs, us in ((buck.edge_stage, uni.edge_stage),
                   (buck.vertex_stage, uni.vertex_stage)):
        uni_bytes = us.b_dense.size + us.b_spill.size
        assert bs.table_bytes() <= uni_bytes * 2  # int8 both; slack for src idx


def test_bucketed_width_merge_clamps_offsets():
    """Regression: merging a group's width upward must re-clamp its
    window offset (off + w' past the last source block fed jnp.take OOB
    fill → NaN).  A graph whose communities sit at the far end of the
    vertex range exercises the clamp."""
    rng = np.random.default_rng(11)
    n, e = 2000, 1600
    vs, es = [], []
    for j in range(e):
        lo = rng.integers(max(n - 300, 0), n - 10)
        members = np.unique(rng.integers(lo, n, size=4))
        vs.append(members)
        es.append(np.full(len(members), j, dtype=np.int64))
    hg = Hypergraph.from_coo(np.concatenate(vs), np.concatenate(es),
                             num_nodes=n, num_edges=e)
    st = planner.build_aligned_stage_bucketed(hg.ht_indptr, hg.ht_indices,
                                              hg.num_nodes)
    nb = -(-hg.num_nodes // planner.ALIGNED_BLOCK)
    for b in st.buckets:
        assert int(b.win_block.max(initial=0)) <= nb - 1
    dev = planner.TreePlan._stage_device(st)
    from hypergef.ops.tree import _apply_aligned_b

    x = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    out = np.asarray(_apply_aligned_b(x, dev))
    assert np.isfinite(out).all()


def test_aligned_max_raw_plan_runs_fast(sorted_hg):
    """first_aggr='max' on a RAW aligned TreePlan runs the masked argmax
    over the band (ops/maxops.v2e_max_aligned) — no oracle fallback.
    The V→E max values are exact; the E→V sum rides the bf16 band
    matmuls like every aligned sum, hence the loose fwd tolerance."""
    hg = sorted_hg
    hgd = hg.device_data()
    x = jnp.asarray(
        np.random.default_rng(3).normal(size=(hg.num_nodes, 3)).astype(np.float32)
    )
    al = planner.plan_aligned(hg)
    want = refops.hgnn_aggregate_ref(hgd, x, None, "max")
    got = fused.hgnn_aggregate(hgd, x, None, "max", plan=al, backend="aligned")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-2, atol=3e-2)
    # the V→E stage itself must be EXACT (values and record table)
    from hypergef.ops.maxops import aligned_max_with_arg, tree_max_with_arg

    tp = planner.plan_tree(hg)
    te, _ = tp.device()
    fe, _ = al.device()
    yv, av = aligned_max_with_arg(x, fe)
    yt, at = tree_max_with_arg(x, te)
    assert jnp.array_equal(yv, yt) and jnp.array_equal(av, at)


@pytest.mark.parametrize("form", ["bucketed", "uniform"])
def test_aligned_max_matches_argmax_tree(sorted_hg, form):
    """The band-form masked argmax equals the argmax tree exactly, in
    values and in the record table, for both stage layouts (with spills)."""
    from hypergef.ops.maxops import aligned_max_with_arg, tree_max_with_arg

    hg = sorted_hg
    x = jnp.asarray(np.random.default_rng(11).normal(
        size=(hg.num_nodes, 5)).astype(np.float32))
    fe, _ = planner.plan_aligned(hg, form=form, window_blocks=2).device()
    te, _ = planner.plan_tree(hg).device()
    yv, av = aligned_max_with_arg(x, fe)
    yt, at = tree_max_with_arg(x, te)
    assert jnp.array_equal(yv, yt) and jnp.array_equal(av, at)


def test_aligned_max_ties_route_to_first_csr_member(sorted_hg):
    """Constant features: every member ties, the record table must hold
    each edge's first CSR member, and the whole cotangent goes there."""
    from hypergef.ops.maxops import aligned_max_with_arg, v2e_max_aligned

    hg = sorted_hg
    hgd = hg.device_data()
    x = jnp.ones((hg.num_nodes, 2), jnp.float32)
    fe, _ = planner.plan_aligned(hg).device()
    _, arg = aligned_max_with_arg(x, fe)
    arg = np.asarray(arg)
    ptr, members = np.asarray(hgd.ht_indptr), np.asarray(hgd.ht_vertex)
    first = np.where(ptr[1:] > ptr[:-1], members[np.minimum(ptr[:-1], len(members) - 1)], -1)
    np.testing.assert_array_equal(arg, np.repeat(first[:, None], 2, axis=1))
    g = np.asarray(jax.grad(lambda v: jnp.sum(v2e_max_aligned(v, fe)))(x))
    want = np.zeros_like(g)
    np.add.at(want, first[first >= 0], 1.0)
    np.testing.assert_array_equal(g, want)


def test_aligned_max_grad_matches_dense_oracle(sorted_hg):
    from hypergef.ops.maxops import v2e_max_aligned

    hg = sorted_hg
    x = jnp.asarray(np.random.default_rng(12).normal(
        size=(hg.num_nodes, 3)).astype(np.float32))
    cot = jnp.asarray(np.random.default_rng(13).normal(
        size=(hg.num_edges, 3)).astype(np.float32))
    fe, _ = planner.plan_aligned(hg).device()
    H = np.zeros((hg.num_nodes, hg.num_edges), np.float32)
    H[np.asarray(hg.ht_indices), np.repeat(np.arange(hg.num_edges),
                                           np.diff(hg.ht_indptr))] = 1.0
    live = jnp.asarray(H.T > 0)

    def oracle(v):
        y = jnp.max(jnp.where(live[:, :, None], v[None], -3.0e38), axis=1)
        return jnp.vdot(jnp.where(live.any(axis=1)[:, None], y, 0.0), cot)

    got = jax.grad(lambda v: jnp.vdot(v2e_max_aligned(v, fe), cot))(x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(jax.grad(oracle)(x)),
                               rtol=1e-6, atol=1e-6)


def test_aligned_max_full_plan_fast_e2v(sorted_hg):
    """With the full AggregationPlan, max = argmax tree V→E + the
    ALIGNED band-matmul E→V (the plain tree only carries the argmax
    stage).  Forward and gradient must match the oracle."""
    hg = sorted_hg
    hgd = hg.device_data()
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(hg.num_nodes, 6)).astype(np.float32))
    plan = planner.plan_aggregation(hg, dense_threshold=0, with_precomp=False)
    assert plan.preferred_backend == "aligned"

    want = refops.hgnn_aggregate_ref(hgd, x, None, "max")
    got = fused.hgnn_aggregate(hgd, x, None, "max", plan=plan,
                               backend="aligned")
    # bf16 band-matmul E→V accumulation → loose fwd tolerance
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-2, atol=3e-2)

    def loss(backend, plan_):
        return lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "max", plan=plan_,
                                 backend=backend) ** 2)

    g_got = np.asarray(jax.grad(loss("aligned", plan))(x))
    g_want = np.asarray(jax.grad(loss("xla", None))(x))
    np.testing.assert_allclose(g_got, g_want, rtol=5e-2, atol=5e-2)


def test_wide_window_gate_for_skewed_aspect():
    """E≫V community graphs: the default 8-block window spills even on
    perfectly sorted input (a community spans many 128-row edge
    blocks); the ladder must escalate to wide windows instead of
    falling back to the tree (round-4 yelp finding)."""
    rng = np.random.default_rng(0)
    # past the dense (n·e ≤ 32M) and precomp (n² ≤ 80M) gates; ~21
    # edge-blocks per community (spills at wb=8, fits wb=32)
    n, e, comm = 10_000, 80_000, 30
    comm_of = np.sort(rng.integers(0, comm, size=n))
    starts = np.searchsorted(comm_of, np.arange(comm))
    ends = np.searchsorted(comm_of, np.arange(comm), side="right")
    vs, es = [], []
    for ei in range(e):
        c = rng.integers(0, comm)
        lo, hi = int(starts[c]), int(ends[c])
        k = min(max(int(rng.poisson(3.0)), 2), hi - lo)
        members = lo + rng.choice(hi - lo, size=k, replace=False)
        vs.append(members)
        es.append(np.full(len(members), ei, dtype=np.int64))
    hg = Hypergraph.from_coo(np.concatenate(vs), np.concatenate(es),
                             num_nodes=n, num_edges=e)
    hg, _ = apply_vertex_order(hg, np.arange(n), sort_edges=True)
    # per-direction spill at wb=8 must show the skew problem this test
    # exists for (E->V reads edge rows: e/128 blocks per community)
    s8 = planner.aligned_spill_stats(hg.h_indptr, hg.h_indices,
                                     hg.num_edges, 128, 8)
    assert s8 > 0.3, f"fixture not skewed enough (spill {s8:.2f})"
    plan = planner.plan_aggregation(hg)
    assert plan.preferred_backend == "aligned"
    assert plan.aligned is not None
    # and the wide-window plan must still be exact
    hgd = hg.device_data()
    x = np.random.default_rng(1).normal(size=(n, 5)).astype(np.float32)
    got = fused.hgnn_aggregate(hgd, jnp.asarray(x), None, "sum",
                               plan=plan.aligned.as_device(),
                               backend="aligned")
    want = dense_hgnn_oracle(hg, x, None, "sum")
    np.testing.assert_allclose(np.asarray(got), want, rtol=5e-2, atol=5e-2)
