"""Test configuration: force CPU with 8 virtual devices.

Multi-chip sharding paths are tested on a simulated 8-device CPU mesh
(SURVEY.md §4: the fake-backend capability the single-GPU reference never
needed).  Must run before the first jax import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hypergef.data.synthetic import (  # noqa: E402
    powerlaw_hypergraph,
    random_hypergraph,
)


@pytest.fixture(scope="session")
def small_hg():
    return random_hypergraph(120, 80, avg_edge_size=5.0, seed=3)


@pytest.fixture(scope="session")
def skewed_hg():
    return powerlaw_hypergraph(300, 200, alpha=1.8, seed=7)


@pytest.fixture(scope="session")
def tiny_hg():
    # hand-checkable: 5 vertices, 3 hyperedges
    from hypergef.sparse.hypergraph import Hypergraph

    v = np.array([0, 1, 2, 1, 2, 3, 4, 0])
    e = np.array([0, 0, 0, 1, 1, 1, 2, 2])
    return Hypergraph.from_coo(v, e, num_nodes=5, num_edges=3, name="tiny")


def dense_incidence(hg) -> np.ndarray:
    """Dense |V|×|E| H for oracle computations."""
    H = np.zeros((hg.num_nodes, hg.num_edges), dtype=np.float64)
    for v in range(hg.num_nodes):
        for k in range(hg.h_indptr[v], hg.h_indptr[v + 1]):
            H[v, hg.h_indices[k]] = 1.0
    return H


def dense_hgnn_oracle(hg, X, wdiag=None, first_aggr="sum"):
    """NumPy dense oracle of SURVEY.md §0 HGNN semantics (role of the
    reference's hyperaggr_reference_host, check.cuh:83-115)."""
    H = dense_incidence(hg)
    X = np.asarray(X, dtype=np.float64)
    cnt = H.sum(axis=0)  # [E]
    if first_aggr == "sum":
        Xe = H.T @ X
    elif first_aggr == "mean":
        Xe = H.T @ X / np.maximum(cnt, 1.0)[:, None]
    elif first_aggr == "max":
        Xe = np.zeros((hg.num_edges, X.shape[1]))
        for e in range(hg.num_edges):
            members = hg.ht_indices[hg.ht_indptr[e] : hg.ht_indptr[e + 1]]
            if len(members):
                Xe[e] = X[members].max(axis=0)
    else:
        raise ValueError(first_aggr)
    Xe = Xe * hg.degE.astype(np.float64)
    if wdiag is not None:
        Xe = Xe * np.asarray(wdiag, dtype=np.float64)
    Xv = H @ Xe
    return Xv * hg.degV.astype(np.float64)


def dense_unignn_oracle(hg, X, use_deg=False):
    H = dense_incidence(hg)
    X = np.asarray(X, dtype=np.float64)
    Xe = H.T @ X
    if use_deg:
        Xe = Xe * hg.degE.astype(np.float64)
    Xv = H @ Xe
    if use_deg:
        Xv = Xv * hg.degV.astype(np.float64)
    return Xv
