"""Weak-scaling study of the fully-sharded halo design: plan-derived
traffic accounting + a modeled link/compute projection (BASELINE
config #5).

* **per-link traffic** comes from the halo plan itself: ``send_mask``
  counts exactly the rows each (src → dst) pair exchanges per
  all_to_all, twice per layer (X halo out, partial combine back);
* **comm_frac** = boundary rows / full-replication rows (the design's
  headline: ∝ cut, not ∝ N·D);
* **modeled link time** = max-link bytes / per-link bandwidth (the
  all_to_all critical path), with the bandwidth a required, recorded
  option (``--link-gbps``; an H100's NVLink is 450 GB/s each way);
* **modeled compute time** = local nnz × per-nnz aggregation cost, both
  costs required options (``--ns-per-nnz`` for gather trees,
  ``--ns-per-nnz-aligned`` for aligned interiors) that the caller takes
  from a measurement on the target card — also recorded.

Graphs: uniform random (near-worst-case cut) AND clustered
(homophilic, hyperedges sorted by community so the contiguous edge
partition aligns with structure — the regime the halo design is for).

Optional ``--measure`` adds mesh wall-clock per shard count (on a CPU
mesh: structural validation only).

Usage (CPU mesh):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python experiments/weak_scaling.py --shards 1,2,4,8 \
        --link-gbps 450 --ns-per-nnz <measured> --ns-per-nnz-aligned <measured>
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np


def clustered_hypergraph(n_nodes, n_edges, avg, seed):
    """Homophilic graph with hyperedges sorted by community, so the
    contiguous hyperedge partition (edge_partition_bounds) is aligned
    with structure — what a community-aware partitioner would produce."""
    from hypergef.data.synthetic import homophilic_hypergraph
    from hypergef.sparse.hypergraph import Hypergraph

    n_classes = 32
    hg, labels = homophilic_hypergraph(
        n_nodes, n_edges, n_classes, avg_edge_size=avg, noise=0.05, seed=seed
    )
    # community reordering: renumber vertices so each class is a
    # contiguous id range (what a community detector + relabel pass
    # produces), then sort hyperedges by mean member id so the
    # contiguous edge partition aligns with the vertex communities.
    vperm = np.argsort(labels, kind="stable")  # new order
    vrank = np.empty_like(vperm)
    vrank[vperm] = np.arange(len(vperm))
    vertex = []
    keys = []
    for e in range(hg.num_edges):
        lo, hi = int(hg.ht_indptr[e]), int(hg.ht_indptr[e + 1])
        mem = vrank[hg.ht_indices[lo:hi]]
        keys.append(mem.mean() if len(mem) else 0.0)
        vertex.append(mem)
    order = np.argsort(np.asarray(keys), kind="stable")
    vs, es = [], []
    for new_e, old_e in enumerate(order):
        vs.append(vertex[old_e])
        es.append(np.full(len(vertex[old_e]), new_e, dtype=np.int64))
    return Hypergraph.from_coo(
        np.concatenate(vs), np.concatenate(es),
        num_nodes=hg.num_nodes, num_edges=hg.num_edges, name="clustered",
    )


def analyze(hg, d, feat, link_gbps, ns_per_nnz, ns_aligned):
    """Plan-derived traffic + modeled times for one (graph, D) point."""
    from hypergef.parallel.halo import plan_halo

    plan = plan_halo(hg, d)
    # rows exchanged per (src, dst) link per all_to_all; the two
    # directions differ now: halo ships only boundary-touched rows
    # (interior-only vertices are never exchanged), return ships partial
    # rows for the full touched set
    ret_rows = plan.send_mask.sum(axis=2)  # [D, D]
    halo_rows = plan.halo_mask.sum(axis=2)  # [D, D]
    np.fill_diagonal(ret_rows, 0.0)  # self-exchange is local
    np.fill_diagonal(halo_rows, 0.0)
    bytes_per_row = feat * 4
    total_bytes = float(ret_rows.sum() + halo_rows.sum()) * bytes_per_row
    max_link = float(ret_rows.max() + halo_rows.max()) * bytes_per_row
    # cross-shard boundary rows / full-replication rows (self-exchange is
    # a local copy, not link traffic — excluded, unlike plan.comm_fraction)
    comm_frac = float(ret_rows.sum() + halo_rows.sum()) / (
        2 * max(d * hg.num_nodes, 1)
    )
    # fraction of local-edge V→E work independent of the halo collective
    # (the latency-hiding scheduler's overlap budget)
    ifrac = plan.interior_fraction()
    # compute model: interior edges run the aligned banded stage when
    # the graph supports it — boundary edges stay gather trees
    nnz_d = hg.nnz / d
    t_aligned = (
        nnz_d * (ifrac * ns_aligned + (1 - ifrac) * ns_per_nnz) * 1e-3
    )
    return plan, {
        "comm_frac": comm_frac,
        "total_MB": total_bytes / 1e6,
        "max_link_MB": max_link / 1e6,
        "t_link_us": max_link / (link_gbps * 1e9) * 1e6,
        "t_compute_us": nnz_d * ns_per_nnz * 1e-3,
        "t_compute_aligned_us": t_aligned,
        "interior_frac": ifrac,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--nnz-per-shard", type=int, default=200_000)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--link-gbps", type=float, required=True,
                    help="per-link bandwidth between cards (GB/s, one "
                    "direction; data sheet), recorded in the CSV")
    ap.add_argument("--ns-per-nnz", type=float, required=True,
                    help="per-nnz tree aggregation cost measured on the "
                    "target card")
    ap.add_argument("--ns-per-nnz-aligned", type=float, required=True,
                    help="per-nnz aligned-stage cost measured on the "
                    "target card")
    ap.add_argument("--measure", action="store_true",
                    help="also run CPU-mesh wall clock (structural check)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="experiments/out/weak_scaling.csv")
    args = ap.parse_args()

    import jax

    from hypergef.data.synthetic import random_hypergraph

    rows = [
        "# halo weak scaling: plan-derived traffic + modeled projection",
        f"# link_gbps={args.link_gbps} ns_per_nnz={args.ns_per_nnz} "
        f"ns_per_nnz_aligned={args.ns_per_nnz_aligned} "
        f"feat={args.feat} nnz_per_shard={args.nnz_per_shard}",
        "graph,shards,nnz,comm_frac,interior_frac,total_MB,max_link_MB,"
        "t_link_us,t_compute_us,t_compute_aligned_us,comm_over_compute,"
        "wall_ms",
    ]
    for kind in ("random", "clustered"):
        for d in map(int, args.shards.split(",")):
            avg = 10.0
            n_edges = args.nnz_per_shard * d // int(avg)
            n_nodes = n_edges * 2
            if kind == "random":
                hg = random_hypergraph(n_nodes, n_edges, avg_edge_size=avg,
                                       seed=0, name=f"ws{d}")
            else:
                hg = clustered_hypergraph(n_nodes, n_edges, avg, seed=0)
            plan, m = analyze(hg, d, args.feat, args.link_gbps,
                              args.ns_per_nnz, args.ns_per_nnz_aligned)
            wall = ""
            if args.measure and d <= len(jax.devices()):
                wall = f"{measure_wall(hg, plan, d, args) * 1e3:.3f}"
            ratio = m["t_link_us"] / max(m["t_compute_us"], 1e-9)
            row = (f"{kind},{d},{hg.nnz},{m['comm_frac']:.4f},"
                   f"{m['interior_frac']:.4f},"
                   f"{m['total_MB']:.3f},{m['max_link_MB']:.3f},"
                   f"{m['t_link_us']:.2f},{m['t_compute_us']:.2f},"
                   f"{m['t_compute_aligned_us']:.2f},"
                   f"{ratio:.3f},{wall}")
            rows.append(row)
            print(row, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fo:
        fo.write("\n".join(rows) + "\n")
    print(f"wrote {args.out}")


def measure_wall(hg, plan, d, args):
    """Structural-validation wall clock on the local (CPU) mesh."""
    import time

    import jax
    import jax.numpy as jnp

    from hypergef.parallel import make_mesh
    from hypergef.parallel.halo_aggr import (
        halo_hgnn_aggregate,
        shard_vertex_features,
    )

    mesh = make_mesh(d, 1, devices=jax.devices()[:d])
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, args.feat)).astype(
        np.float32
    )
    xs = jnp.asarray(shard_vertex_features(plan, x))
    f = jax.jit(lambda xv: halo_hgnn_aggregate(plan, mesh, xv, None, "sum"))
    jax.block_until_ready(f(xs))
    t0 = time.perf_counter()
    out = None
    for _ in range(args.iters):
        out = f(xs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / args.iters


if __name__ == "__main__":
    enable_compile_cache()
    main()
