from hypergef.sparse.hypergraph import Hypergraph
from hypergef.sparse.planner import (
    AggregationPlan,
    TilePlan,
    TreePlan,
    plan_aggregation,
    plan_tiles,
    plan_tree,
)

__all__ = [
    "Hypergraph",
    "TilePlan",
    "TreePlan",
    "AggregationPlan",
    "plan_tiles",
    "plan_tree",
    "plan_aggregation",
]
