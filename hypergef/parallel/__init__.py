from hypergef.parallel.partition import (
    ShardedAggPlan,
    edge_partition_bounds,
    plan_sharded_aggregation,
)
from hypergef.parallel.dist_aggr import (
    sharded_hgnn_aggregate,
    sharded_unignn_aggregate,
)
from hypergef.parallel.dense_shard import (
    ShardedDensePlan,
    plan_sharded_dense,
    sharded_dense_hgnn_aggregate,
    sharded_dense_unignn_aggregate,
)
from hypergef.parallel.mesh import make_mesh
from hypergef.parallel.multihost import (
    init_distributed,
    make_hybrid_mesh,
    local_shard_info,
)
from hypergef.parallel.halo import HaloPlan, plan_halo
from hypergef.parallel.halo_aggr import (
    halo_hgnn_aggregate,
    make_halo_train_step,
    shard_vertex_features,
    unshard_vertex_features,
)
from hypergef.parallel.trainer import DistTrainer

__all__ = [
    "HaloPlan",
    "plan_halo",
    "halo_hgnn_aggregate",
    "make_halo_train_step",
    "shard_vertex_features",
    "unshard_vertex_features",
    "DistTrainer",
    "ShardedAggPlan",
    "edge_partition_bounds",
    "plan_sharded_aggregation",
    "sharded_hgnn_aggregate",
    "sharded_unignn_aggregate",
    "ShardedDensePlan",
    "plan_sharded_dense",
    "sharded_dense_hgnn_aggregate",
    "sharded_dense_unignn_aggregate",
    "make_mesh",
    "init_distributed",
    "make_hybrid_mesh",
    "local_shard_info",
]
