"""Worker process for the multi-host CPU validation test.

Launched by tests/test_multihost.py as N processes, each with 4 virtual
CPU devices; rendezvous via jax.distributed on a localhost coordinator.
Exercises: init, hybrid (d, e, f) mesh over 2 processes, a psum that
crosses the process boundary (the DCN axis), and an all-to-all within
the process-local edge axis (the ICI analogue).
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hypergef.parallel import multihost  # noqa: E402


def main():
    multihost.init_distributed()
    n_proc = jax.process_count()
    pid = jax.process_index()
    assert n_proc == int(os.environ["JAX_NUM_PROCESSES"]), n_proc
    assert len(jax.devices()) == 4 * n_proc, len(jax.devices())

    mesh = multihost.make_hybrid_mesh(n_edge=4, n_feature=1)
    assert mesh.devices.shape == (n_proc, 4, 1)

    info = multihost.local_shard_info(mesh, axis=multihost.DATA_AXIS)
    assert info["local_slots"] == [pid], info

    # cross-process psum over the DCN axis + intra-process sum over e
    from jax.experimental.shard_map import shard_map

    def body(v):
        d_sum = jax.lax.psum(v, multihost.DATA_AXIS)
        e_sum = jax.lax.psum(d_sum, multihost.EDGE_AXIS)
        return e_sum

    global_shape = (n_proc * 4, 8)
    sharding = NamedSharding(mesh, P((multihost.DATA_AXIS, multihost.EDGE_AXIS)))

    def cb(idx):
        # each shard = its global row index value
        rows = np.arange(*idx[0].indices(global_shape[0]))
        return np.broadcast_to(rows[:, None], (len(rows), 8)).astype(np.float32)

    v = jax.make_array_from_callback(global_shape, sharding, cb)
    out = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=P((multihost.DATA_AXIS, multihost.EDGE_AXIS), None),
            out_specs=P((multihost.DATA_AXIS, multihost.EDGE_AXIS), None),
        )
    )(v)
    # every shard row now holds sum over all global rows = sum 0..7 = 28
    local = np.asarray(out.addressable_shards[0].data)
    expect = float(sum(range(n_proc * 4)))
    assert np.allclose(local, expect), (local[0, 0], expect)
    # ---- full halo aggregation across the process boundary ------------
    # The fully-sharded halo program (two all_to_alls + local trees) over
    # an 8-shard edge axis spanning both processes — every boundary
    # exchange whose (src, dst) pair crosses processes rides the DCN
    # analogue.  Validated for sum AND max first aggregation against a
    # dense NumPy oracle on this process's owned rows.
    from jax.sharding import Mesh

    from hypergef.data.synthetic import powerlaw_hypergraph
    from hypergef.parallel.halo import plan_halo
    from hypergef.parallel.halo_aggr import (
        halo_hgnn_aggregate,
        shard_vertex_features,
    )

    n_dev = len(jax.devices())
    hmesh = Mesh(
        np.asarray(jax.devices()).reshape(n_dev, 1),
        (multihost.EDGE_AXIS, multihost.FEATURE_AXIS),
    )
    hg = powerlaw_hypergraph(240, 160, alpha=1.8, seed=5)  # same on all procs
    plan = plan_halo(hg, n_dev)
    x = np.random.default_rng(9).normal(size=(hg.num_nodes, 6)).astype(
        np.float32
    )

    def mkglobal(a):
        arr = np.asarray(a)
        sh = NamedSharding(hmesh, P(multihost.EDGE_AXIS))
        return jax.make_array_from_callback(arr.shape, sh, lambda i: arr[i])

    plan_glob = jax.tree_util.tree_map(mkglobal, plan.device())
    x_own = mkglobal(shard_vertex_features(plan, x))

    # dense oracle (small graph)
    H = np.zeros((hg.num_nodes, hg.num_edges))
    for e in range(hg.num_edges):
        H[hg.ht_indices[hg.ht_indptr[e] : hg.ht_indptr[e + 1]], e] = 1.0
    for aggr in ("sum", "max"):
        out = halo_hgnn_aggregate(
            plan, hmesh, x_own, None, aggr, plan_dev=plan_glob
        )
        if aggr == "sum":
            xe = H.T @ x.astype(np.float64)
        else:
            xe = np.full((hg.num_edges, x.shape[1]), -np.inf)
            for e in range(hg.num_edges):
                m = hg.ht_indices[hg.ht_indptr[e] : hg.ht_indptr[e + 1]]
                if len(m):
                    xe[e] = x[m].max(axis=0)
            xe[~np.isfinite(xe).all(axis=1)] = 0.0
        want = (H @ (xe * hg.degE)) * hg.degV
        want_pad = np.zeros((n_dev * plan.n_own, x.shape[1]))
        want_pad[: hg.num_nodes] = want
        for shard in out.addressable_shards:
            lo = shard.index[0].start or 0
            np.testing.assert_allclose(
                np.asarray(shard.data),
                want_pad[lo : lo + plan.n_own],
                rtol=1e-4,
                atol=1e-4,
            )
    print(f"WORKER_OK pid={pid} procs={n_proc} devices={len(jax.devices())}",
          flush=True)


if __name__ == "__main__":
    main()
