"""hypergef — a hypergraph-GNN framework in JAX.

A from-scratch JAX / XLA re-architecture of the capabilities of HyperGef
(MLSys'23, ``fishmingyu/HyperGef``): HGNNConv and UniGNNConv (UniGIN /
UniGCNII) model families whose hot path — the two-stage incidence-matrix
aggregation V→E→V — runs as fused, statically planned XLA programs with
exact autodiff.

Design stance (vs the CUDA reference):

* The CUDA chunk-pair + atomicAdd fused kernel (reference
  ``source/hgnnaggr/hgnnaggr_cuda.cu:14-47``) becomes a choice of
  backends over *static-shape* index arrays emitted ahead of time by a
  host-side planner (:mod:`hypergef.sparse.planner`), the
  descendant of the reference's CPU balancer
  (``include/taskbalancer/balancer_kernel.cuh:229-259``): dense matmuls
  for small graphs, banded matmuls for community-sorted graphs,
  gather/segment-reduce trees otherwise.
* Most backends need no atomics: races are designed out and their
  segment reductions are deterministic.
* Autodiff is exact (custom VJP on the fused op), not the reference's
  symmetric approximation (``source/hgnnaggr/hgnnaggr.cc:51-64``).
* Multi-device scaling (absent in the single-GPU reference) is built in:
  hyperedge-contiguous nnz sharding over a ``jax.sharding.Mesh`` with
  collective combination of boundary vertex partials
  (:mod:`hypergef.parallel`).
"""

__version__ = "0.1.0"

from hypergef.sparse.hypergraph import Hypergraph
from hypergef.sparse.planner import (
    AggregationPlan,
    TilePlan,
    TreePlan,
    plan_aggregation,
    plan_tiles,
    plan_tree,
)
from hypergef import ops
from hypergef import models

__all__ = [
    "Hypergraph",
    "TilePlan",
    "TreePlan",
    "AggregationPlan",
    "plan_tiles",
    "plan_tree",
    "plan_aggregation",
    "ops",
    "models",
]
