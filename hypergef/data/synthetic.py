"""Synthetic hypergraph generators (test fixtures + scaling benchmarks).

The reference tests against 13 real downloaded datasets (``test/
hgnn_test.py:65-92``); those require network ETL, so the test/bench
fixtures here are random hypergraphs with controllable size skew —
including heavy-tailed hyperedge-size distributions that exercise the
load-balancing planner the same way the real datasets do (the whole
point of the reference's balancer is power-law nnz/row skew).
"""

from __future__ import annotations

import numpy as np

from hypergef.sparse.hypergraph import Hypergraph


def random_hypergraph(
    num_nodes: int,
    num_edges: int,
    avg_edge_size: float = 6.0,
    seed: int = 0,
    name: str = "random",
) -> Hypergraph:
    """Uniform random membership: each hyperedge draws a Poisson-sized
    vertex set uniformly at random (≥1 member)."""
    rng = np.random.default_rng(seed)
    sizes = np.maximum(rng.poisson(avg_edge_size, size=num_edges), 1)
    sizes = np.minimum(sizes, num_nodes)
    edge = np.repeat(np.arange(num_edges, dtype=np.int64), sizes)
    vertex = rng.integers(0, num_nodes, size=edge.shape[0], dtype=np.int64)
    return Hypergraph.from_coo(
        vertex, edge, num_nodes=num_nodes, num_edges=num_edges, name=name
    )


def powerlaw_hypergraph(
    num_nodes: int,
    num_edges: int,
    alpha: float = 2.0,
    max_edge_size: int | None = None,
    seed: int = 0,
    name: str = "powerlaw",
) -> Hypergraph:
    """Heavy-tailed hyperedge sizes (Zipf exponent ``alpha``) and
    preferential vertex attachment — the skewed workload the reference's
    balancer exists for (SURVEY.md §7 hard part (a))."""
    rng = np.random.default_rng(seed)
    if max_edge_size is None:
        max_edge_size = max(num_nodes // 4, 2)
    sizes = np.minimum(rng.zipf(alpha, size=num_edges), max_edge_size)
    edge = np.repeat(np.arange(num_edges, dtype=np.int64), sizes)
    # preferential attachment: vertex popularity itself heavy-tailed
    pop = rng.zipf(alpha, size=num_nodes).astype(np.float64)
    pop /= pop.sum()
    vertex = rng.choice(num_nodes, size=edge.shape[0], p=pop).astype(np.int64)
    return Hypergraph.from_coo(
        vertex, edge, num_nodes=num_nodes, num_edges=num_edges, name=name
    )


def homophilic_hypergraph(
    num_nodes: int,
    num_edges: int,
    num_classes: int,
    avg_edge_size: float = 6.0,
    noise: float = 0.1,
    seed: int = 0,
    name: str = "homophilic",
):
    """Hypergraph whose structure correlates with labels: each hyperedge
    draws its members mostly from one class (with ``noise`` fraction of
    out-of-class members).  Returns ``(Hypergraph, labels)``.  Use this
    when a convergence test must actually beat chance — structure of the
    plain random generators is label-independent, so aggregation-only
    models sit at chance on them."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)
    by_class = [np.nonzero(y == c)[0] for c in range(num_classes)]
    sizes = np.maximum(rng.poisson(avg_edge_size, size=num_edges), 2)
    vs, es = [], []
    for e in range(num_edges):
        c = rng.integers(0, num_classes)
        pool = by_class[c]
        if pool.size == 0:
            pool = np.arange(num_nodes)
        k = int(min(sizes[e], pool.size))
        members = rng.choice(pool, size=k, replace=False)
        flip = rng.random(k) < noise
        members[flip] = rng.integers(0, num_nodes, size=int(flip.sum()))
        vs.append(members)
        es.append(np.full(k, e, dtype=np.int64))
    vertex = np.concatenate(vs)
    edge = np.concatenate(es)
    hg = Hypergraph.from_coo(
        vertex, edge, num_nodes=num_nodes, num_edges=num_edges, name=name
    )
    return hg, y.astype(np.int32)


def random_features(
    num_nodes: int, num_features: int, num_classes: int, seed: int = 0
):
    """Random features + class-correlated labels for training smoke tests."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)
    centers = rng.normal(size=(num_classes, num_features))
    x = centers[y] + 0.5 * rng.normal(size=(num_nodes, num_features))
    return x.astype(np.float32), y.astype(np.int32)
