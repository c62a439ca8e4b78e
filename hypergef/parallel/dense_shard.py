"""Edge-sharded **int8 dense-stream** aggregation: multi-device brute
bandwidth for unstructured graphs.

When a graph has no community structure to exploit, a fast fused layer
need not be a gather formulation at all — it can stream the whole int8
incidence through two dense matmuls, viable while N·E bytes stay
moderate.  This module extends
that regime across a device mesh: each device holds a hyperedge-
contiguous **slice** ``H_d = H[:, e_d:e_{d+1}]`` as int8, computes both
dense stages locally (the degE·Wdiag scaling is device-local by the
edge-contiguous cut, exactly like the tree-based
:mod:`~hypergef.parallel.dist_aggr`), and combines vertex partials
with one ``psum``:

    out = psum_d( H_d · diag(degE_d·W_d) · H_dᵀ · X ) · diag(degV)

Per device and per layer this streams ``2·N·e_pad`` int8 bytes and one
``[N, F]`` psum — D devices cut the dominant table stream D-ways (an
SBM-60k-scale unstructured graph's 1.8 GB int8 table becomes ~225 MB per
device on 8) — the "scaling the structureless worst case" answer that
the halo path (comm ∝ cut; cut is ~everything on random graphs) cannot
give.  (A packed-int4 slice form exists behind ``packed=True``, see
:func:`plan_sharded_dense`.)

Reference analogue: none — the reference is single-GPU (SURVEY.md
§2.9); the closest intra-GPU idea is its dense-row shm kernel
(``hgnnaggr_cuda.cu:211-348``).  Gradients are exact: plain dots +
``psum`` under ``shard_map`` transpose correctly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from hypergef.parallel.mesh import EDGE_AXIS, FEATURE_AXIS
from hypergef.parallel.partition import edge_partition_bounds
from hypergef.sparse.hypergraph import Hypergraph

# per-DEVICE int8 slice budget: leaves room for activations, and past it
# the table stream loses to tree/halo formulations anyway
DENSE_SHARD_MAX_BYTES = 2 << 30


@dataclasses.dataclass
class ShardedDensePlan:
    """Stacked int8 H slices, one per device (leading axis = mesh "e").

    ``packed=True`` (explicit opt-in, see :func:`plan_sharded_dense`):
    ``h`` is a [D, N, e_pad/2] int8 **nibble carrier** (low nibble =
    even local column), re-viewed as S4 inside the shard_map body.
    """

    n_shards: int
    num_nodes: int
    num_edges: int
    e_pad: int
    edge_bounds: np.ndarray  # [n_shards+1] global hyperedge cuts
    h: np.ndarray  # [D, N, e_pad] int8 counts, or [D, N, e_pad/2] packed
    degE: np.ndarray  # [D, e_pad, 1] f32
    counts: np.ndarray  # [D, e_pad, 1] f32 — members per local edge
    packed: bool = False
    _device: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def device(self):
        if self._device is None:
            import jax
            import jax.numpy as jnp

            # eager build even under a trace (see ShardedAggPlan.device)
            with jax.ensure_compile_time_eval():
                self._device = (
                    jnp.asarray(self.h),
                    jnp.asarray(self.degE),
                    jnp.asarray(self.counts),
                )
        return self._device

    def shard_edge_vector(self, vec: np.ndarray) -> np.ndarray:
        """Global per-hyperedge [E, k] → padded stacked [D, e_pad, k]."""
        vec = np.asarray(vec)
        out = np.zeros((self.n_shards, self.e_pad, vec.shape[1]), vec.dtype)
        for d in range(self.n_shards):
            e0, e1 = int(self.edge_bounds[d]), int(self.edge_bounds[d + 1])
            out[d, : e1 - e0] = vec[e0:e1]
        return out

    def table_bytes_per_device(self) -> int:
        return self.num_nodes * (self.e_pad // 2 if self.packed else self.e_pad)


def plan_sharded_dense(
    hg: Hypergraph,
    n_shards: int,
    max_bytes_per_device: int = DENSE_SHARD_MAX_BYTES,
    packed: bool = False,
) -> ShardedDensePlan:
    """Build the stacked int8 slice plan for an ``n_shards``-way
    edge-contiguous partition (cuts from :func:`edge_partition_bounds`,
    so nnz — and with it the *useful* table mass — balances).

    ``packed=True`` opts into the int4 nibble-carrier form: half the
    table bytes, but the S4 unpack runs inside every consuming program
    (XLA does not hoist it out of loop bodies); for consumers that unpack
    outside their iteration loop."""
    bounds = edge_partition_bounds(hg, n_shards)
    widths = np.diff(bounds)
    e_pad = -(-int(max(widths.max(), 1)) // 2) * 2  # even, for nibble pairs
    table_bytes = hg.num_nodes * (e_pad // 2 if packed else e_pad)
    if table_bytes > max_bytes_per_device:
        raise MemoryError(
            f"dense shard slice {hg.num_nodes} x {e_pad} "
            f"({table_bytes} bytes) exceeds {max_bytes_per_device} "
            "bytes/device — use the tree-based sharded plan or more shards"
        )
    h = np.zeros((n_shards, hg.num_nodes, e_pad), np.int8)
    degE = np.zeros((n_shards, e_pad, 1), np.float32)
    counts = np.ones((n_shards, e_pad, 1), np.float32)
    sizes_all = np.diff(hg.ht_indptr)
    for d in range(n_shards):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        lo, hi = int(hg.ht_indptr[e0]), int(hg.ht_indptr[e1])
        local_e = np.repeat(
            np.arange(e1 - e0, dtype=np.int64), sizes_all[e0:e1]
        )
        np.add.at(h[d], (hg.ht_indices[lo:hi].astype(np.int64), local_e), 1)
        degE[d, : e1 - e0] = hg.degE[e0:e1]
        counts[d, : e1 - e0, 0] = np.maximum(sizes_all[e0:e1], 1)
    if packed:
        if h.max(initial=0) > 7:
            raise MemoryError(
                ">7 duplicate incidences — packed int4 cannot represent "
                "this graph; use packed=False"
            )
        h = (h[:, :, 0::2] & 0xF) | (h[:, :, 1::2] << 4)
    plan = ShardedDensePlan(
        n_shards=n_shards,
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges,
        e_pad=e_pad,
        edge_bounds=bounds,
        h=h,
        degE=degE,
        counts=counts,
        packed=packed,
    )
    plan.device()
    return plan


def _two_stage_local(h_local, x, scale_e, packed):
    """H_d diag(scale_e) H_dᵀ x with the int slice riding into the dots."""
    import jax
    import jax.numpy as jnp

    if packed:
        # nibble carrier → S4 [N, e_pad]; pre-barrier guards against
        # XLA's broken constant-folding of S4 bitcasts, post-barrier
        # materializes the S4 table once (rationale in ops/fused._dense_dot)
        h_local = jax.lax.optimization_barrier(h_local)
        h_local = jax.lax.bitcast_convert_type(h_local, jnp.int4)
        h_local = h_local.reshape(h_local.shape[0], -1)
        h_local = jax.lax.optimization_barrier(h_local)
    hb = h_local.astype(jnp.bfloat16)  # fused into the dot operand read
    xe = jax.lax.dot_general(
        hb, x.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [e_pad, F]
    xe = xe * scale_e
    return jax.lax.dot_general(
        hb, xe.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [N, F] partial


def sharded_dense_hgnn_aggregate(
    plan: ShardedDensePlan,
    mesh,
    x,
    wdiag_stacked=None,
    first_aggr: str = "sum",
    degV=None,
    feature_sharded: bool = False,
):
    """HGNN aggregation: int8 dense stages per shard + one ``psum``.

    ``x`` is [N, F], replicated on the edge axis (feature-sharded on
    "f" when ``feature_sharded`` — both dense stages are row-wise in F).
    Returns [N, F] replicated.
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if first_aggr not in ("sum", "mean"):
        raise ValueError("dense shard path supports first_aggr in {sum, mean}")
    h_dev, degE_dev, cnt_dev = plan.device()
    fspec = FEATURE_AXIS if feature_sharded else None

    def body(h_local, degE_local, cnt_local, x_full, wdiag, degv):
        scale = degE_local[0]
        if first_aggr == "mean":
            scale = scale / cnt_local[0]
        if wdiag is not None:
            scale = scale * wdiag[0]
        part = _two_stage_local(h_local[0], x_full, scale, plan.packed)
        out = jax.lax.psum(part, EDGE_AXIS)
        if degv is not None:
            out = out * degv
        return out

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(EDGE_AXIS), P(EDGE_AXIS), P(EDGE_AXIS),
            P(None, fspec),
            None if wdiag_stacked is None else P(EDGE_AXIS),
            None if degV is None else P(None, None),
        ),
        out_specs=P(None, fspec),
        check_vma=False,
    )
    return fn(h_dev, degE_dev, cnt_dev, x, wdiag_stacked, degV)


def sharded_dense_unignn_aggregate(
    plan: ShardedDensePlan, mesh, x, use_deg: bool = False, degV=None,
    feature_sharded: bool = False,
):
    """UniGNN aggregation (plain H Hᵀ x, or degree-scaled) on the
    sharded int8 slices."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    h_dev, degE_dev, _ = plan.device()
    fspec = FEATURE_AXIS if feature_sharded else None

    def body(h_local, degE_local, x_full, degv):
        scale = degE_local[0] if use_deg else jnp.ones_like(degE_local[0])
        part = _two_stage_local(h_local[0], x_full, scale, plan.packed)
        out = jax.lax.psum(part, EDGE_AXIS)
        if use_deg and degv is not None:
            out = out * degv
        return out

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(EDGE_AXIS), P(EDGE_AXIS), P(None, fspec),
            None if degV is None else P(None, None),
        ),
        out_specs=P(None, fspec),
        check_vma=False,
    )
    return fn(h_dev, degE_dev, x, degV)
