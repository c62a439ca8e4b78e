"""Planner unit tests: schedule invariants the reference never tested
(SURVEY.md §4 implication) plus parity of chunk boundaries with a literal
transcription of the reference's balancer chunking rule."""

import numpy as np
import pytest

from hypergef.sparse.planner import build_ell, choose_ngs, plan_tiles


def reference_chunk_keys(ngs, indptr):
    """Literal (slow) transcription of the reference balancer's chunk
    boundary construction (HyperGsys/balancer.py:15-33 ``balan_key``):
    row r contributes chunk starts every ngs entries of its nnz range."""
    keys = []
    nrow = len(indptr) - 1
    for rid in range(nrow):
        lo, hi = int(indptr[rid]), int(indptr[rid + 1])
        k = lo
        while k < hi:
            keys.append(k)
            k += ngs
    if keys and keys[-1] != int(indptr[-1]):
        keys.append(int(indptr[-1]))
    return keys


@pytest.mark.parametrize("ngs", [1, 3, 8, 16, 64])
def test_ell_covers_every_nnz_exactly_once(skewed_hg, ngs):
    hg = skewed_hg
    t = build_ell(hg.ht_indptr, hg.ht_indices, ngs)
    # live slots, grouped by owning segment, reproduce the CSR lists
    for e in range(hg.num_edges):
        c0, c1 = t.seg_ptr[e], t.seg_ptr[e + 1]
        got = []
        for c in range(c0, c1):
            assert t.seg_ids[c] == e
            live = t.mask[c] > 0
            got.extend(t.gather_idx[c][live].tolist())
        want = hg.ht_indices[hg.ht_indptr[e] : hg.ht_indptr[e + 1]].tolist()
        assert got == want
    # total live slot count == nnz
    assert int(t.mask.sum()) == hg.nnz


@pytest.mark.parametrize("ngs", [2, 5, 40])
def test_chunk_boundaries_match_reference_balancer(skewed_hg, ngs):
    hg = skewed_hg
    t = build_ell(hg.ht_indptr, hg.ht_indices, ngs)
    keys = reference_chunk_keys(ngs, hg.ht_indptr)
    # reference emits one key per chunk (+ terminal sentinel)
    assert t.num_chunks == len(keys) - 1
    # our chunk starts equal the reference keys
    starts = []
    for e in range(hg.num_edges):
        lo = hg.ht_indptr[e]
        for c in range(t.seg_ptr[e], t.seg_ptr[e + 1]):
            rank = c - t.seg_ptr[e]
            starts.append(int(lo + rank * ngs))
    assert starts == keys[:-1]


def test_seg_ids_sorted_and_padding_masked(small_hg):
    t = build_ell(small_hg.ht_indptr, small_hg.ht_indices, 8)
    live = t.seg_ids[: t.num_chunks]
    assert (np.diff(live) >= 0).all()
    assert (t.seg_ids[t.num_chunks :] == t.num_segments).all()
    assert (t.mask[t.num_chunks :] == 0).all()


def test_empty_rows_get_no_chunks():
    # rows 1 and 3 empty
    indptr = np.array([0, 2, 2, 5, 5, 6])
    indices = np.array([4, 7, 1, 2, 3, 0], dtype=np.int32)
    t = build_ell(indptr, indices, 2)
    assert t.seg_ptr.tolist() == [0, 1, 1, 3, 3, 4]
    assert t.num_chunks == 4
    assert int(t.mask.sum()) == 6


def test_choose_ngs_bounds_and_alignment(skewed_hg):
    ngs = choose_ngs(skewed_hg.edge_sizes())
    # candidates: {2, 4} (low-degree graphs — padding to 8 costs ~1.9x
    # extra level-0 gathers) plus sublane-aligned multiples of 8
    assert (ngs in (2, 4) or ngs % 8 == 0) and 2 <= ngs <= 512


def test_choose_ngs_low_degree_picks_small():
    # avg degree ~4: padding every row to 8 wastes ~2x gather slots
    row_len = np.full(1000, 4, dtype=np.int64)
    assert choose_ngs(row_len) == 4
    assert choose_ngs(row_len, min_ngs=8) == 8  # bound still honored


def test_plan_tiles_waste_reasonable(skewed_hg):
    plan = plan_tiles(skewed_hg)
    assert plan.padding_waste() < 0.9  # sanity: auto ngs keeps some density
    assert plan.edge_table.num_segments == skewed_hg.num_edges
    assert plan.vertex_table.num_segments == skewed_hg.num_nodes


def test_auto_ladder_prefers_cumsum_small_random():
    """Uniform-random graphs beyond the dense/precomp regimes but under
    CUMSUM_PREFER_NNZ land on the cumsum backend (measured faster than
    the gather tree below ~131k nnz, probe_cumsum_crossover.py)."""
    from hypergef.data.synthetic import random_hypergraph
    from hypergef.sparse.planner import CUMSUM_PREFER_NNZ, plan_aggregation

    hg = random_hypergraph(10_000, 10_000, avg_edge_size=4.0, seed=0)
    assert hg.nnz <= CUMSUM_PREFER_NNZ
    plan = plan_aggregation(hg)
    assert plan.dense is None and plan.precomp is None
    assert plan.preferred_backend == "cumsum"
    # the tree plan stays available for explicit override / max aggr
    assert plan.tree is not None
