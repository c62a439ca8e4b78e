"""The backend set after the removal of the accelerator-specific kernels:
the dispatcher rejects the removed names, and the auto ladder never
routes to one, across the N·E range where one of them used to sit."""

import types

import numpy as np
import pytest

from hypergef.ops import fused
from hypergef.sparse import planner

REMOVED = ("pallas", "pallas_sparse", "bitstream")


@pytest.mark.parametrize("name", REMOVED)
def test_set_default_backend_rejects_removed(name):
    before = fused.get_default_backend()
    with pytest.raises(ValueError):
        fused.set_default_backend(name)
    assert fused.get_default_backend() == before


@pytest.mark.parametrize("name", REMOVED)
def test_resolve_rejects_removed(name):
    with pytest.raises(ValueError, match="backend must be one of"):
        fused._resolve(name, plan=object(), nnz=10)


def _fake_graph(n, e, nnz):
    return types.SimpleNamespace(
        num_nodes=n, num_edges=e, nnz=nnz,
        ht_indptr=np.zeros(e + 1, np.int64), ht_indices=np.zeros(0, np.int32),
        h_indptr=np.zeros(n + 1, np.int64), h_indices=np.zeros(0, np.int32))


@pytest.fixture
def cheap_builders(monkeypatch):
    """Routing depends only on (N, E, nnz) and on whether the aligned
    form accepts the graph; stub the table builders so the sweep can
    reach billions of H entries without building anything."""
    def refuse(*a, **k):
        raise ValueError("not community-sorted")

    monkeypatch.setattr(planner, "plan_tree", lambda hg, **k: "tree")
    monkeypatch.setattr(planner, "plan_multihot", lambda hg, **k: "multihot")
    monkeypatch.setattr(planner, "plan_aligned", refuse)
    monkeypatch.setattr(planner.DenseIncidence, "from_hypergraph",
                        classmethod(lambda cls, hg, dtype=None: "dense"))
    monkeypatch.setattr(planner.DensePrecomp, "from_hypergraph",
                        classmethod(lambda cls, hg: "precomp"))


# (N, E, nnz): below, inside (0.8 G, 6.4 G] and above the range where the
# removed bit-packed stream used to be chosen, each stream-favoured
# (N·E < DENSE_STREAM_VS_GATHER · nnz) or not.
_SWEEP = [
    (20_000, 30_000, 400_000),      # 0.6 G, stream-favoured
    (30_000, 30_000, 500_000),      # 0.9 G, stream-favoured
    (40_000, 30_000, 1_000_000),    # 1.2 G, stream-favoured
    (60_000, 50_000, 2_000_000),    # 3.0 G, stream-favoured
    (80_000, 80_000, 3_300_000),    # 6.4 G, stream-favoured
    (80_000, 80_000, 100_000),      # 6.4 G, gather-favoured
    (100_000, 100_000, 6_000_000),  # 10 G, past every stream cap
]


@pytest.mark.parametrize("n,e,nnz", _SWEEP)
def test_ladder_never_returns_removed_name(cheap_builders, n, e, nnz):
    plan = planner.plan_aggregation(_fake_graph(n, e, nnz))
    assert plan.preferred_backend in fused._VALID
    assert plan.preferred_backend not in REMOVED
    assert not hasattr(plan, "bitstream") and not hasattr(plan, "pallas_sparse")
    if n * e > planner.DENSE_STREAM_MAX_ENTRIES:
        # the old bit-stream graphs now take the ladder's gather rungs
        want = "cumsum" if nnz <= planner.CUMSUM_PREFER_NNZ else "tree"
        assert plan.preferred_backend == want
