"""Device-mesh helpers.

The reference is strictly single-GPU (SURVEY.md §2.9: no distributed code
of any kind); scaling here is built in from the ground up: a
``jax.sharding.Mesh`` whose ``"e"`` axis carries the hyperedge partition
(graph parallelism) and optional ``"f"`` axis shards the feature
dimension (tensor parallelism for the dense projections).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


EDGE_AXIS = "e"
FEATURE_AXIS = "f"


def make_mesh(
    n_edge: Optional[int] = None,
    n_feature: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create an (e, f) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_edge is None:
        n_edge = len(devices) // n_feature
    if n_edge * n_feature != len(devices):
        raise ValueError(
            f"mesh {n_edge}x{n_feature} does not cover {len(devices)} devices"
        )
    arr = np.asarray(devices).reshape(n_edge, n_feature)
    return Mesh(arr, (EDGE_AXIS, FEATURE_AXIS))
