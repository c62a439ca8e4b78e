from hypergef.ops.refops import (
    v2e_aggregate,
    e2v_sum,
    hgnn_aggregate_ref,
    unignn_aggregate_ref,
)
from hypergef.ops.fused import (
    hgnn_aggregate,
    unignn_aggregate,
    set_default_backend,
    get_default_backend,
)

__all__ = [
    "v2e_aggregate",
    "e2v_sum",
    "hgnn_aggregate_ref",
    "unignn_aggregate_ref",
    "hgnn_aggregate",
    "unignn_aggregate",
    "set_default_backend",
    "get_default_backend",
]
