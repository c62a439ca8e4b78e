"""Halo collective/compute overlap profile (plan- and program-derived).

The question: is the all_to_all overlapped with local tree compute?
Overlap is produced by
XLA's latency-hiding scheduler from ONE structural property we control:
the interior V→E tree must have no data dependence on the halo
``all_to_all``.  This profile verifies that property mechanically on
the traced program (jaxpr forward-reachability,
``utils/introspect.collective_overlap_report``) and quantifies the
overlap budget per workload:

* ``interior_frac`` — fraction of local V→E edge work that is
  collective-independent (from the plan);
* ``independent_elems`` — element count of collective-independent
  compute in the traced program (the scheduler's hiding material);
* ``t_a2a_us`` — modeled halo all_to_all time (max-link bytes / link
  bandwidth, ``--link-gbps``);
* ``t_interior_us`` — modeled interior tree time (interior nnz ×
  ``--ns-per-nnz``, measured on the target card);
* ``coverage`` — min(1, t_interior/t_a2a): 1.0 ⇒ the collective can be
  fully hidden.

Single-process CPU lowers *synchronous* all-to-alls (no async pairs to
profile), so on a CPU mesh the modeled numbers + the verified
schedulability property are the result; a wall-clock demonstration
needs ≥2 real cards.

Run (CPU mesh):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python experiments/halo_overlap.py --link-gbps 450 --ns-per-nnz <measured>
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="2,4,8")
    ap.add_argument("--nnz-per-shard", type=int, default=200_000)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--link-gbps", type=float, required=True,
                    help="per-link bandwidth between cards (GB/s, one "
                    "direction; data sheet)")
    ap.add_argument("--ns-per-nnz", type=float, required=True,
                    help="per-nnz tree cost measured on the target card")
    ap.add_argument("--out", default="experiments/out/halo_overlap.csv")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax


    from weak_scaling import clustered_hypergraph

    from hypergef.data.synthetic import random_hypergraph
    from hypergef.parallel.halo import plan_halo
    from hypergef.parallel.halo_aggr import (
        halo_hgnn_aggregate, shard_vertex_features)
    from hypergef.parallel.mesh import make_mesh
    from hypergef.utils.introspect import collective_overlap_report

    rows = [
        "# halo overlap profile: jaxpr-verified collective-independent "
        "interior compute + modeled hiding coverage",
        f"# link_gbps={args.link_gbps} ns_per_nnz={args.ns_per_nnz} "
        f"feat={args.feat} nnz_per_shard={args.nnz_per_shard}",
        "graph,shards,interior_frac,independent_elems,downstream_elems,"
        "halo_MB_maxlink,t_a2a_us,t_interior_us,coverage,chain_ok",
    ]
    n_dev = len(jax.devices())
    for kind in ("random", "clustered"):
        for d in map(int, args.shards.split(",")):
            if d > n_dev:
                continue
            avg = 10.0
            n_edges = args.nnz_per_shard * d // int(avg)
            n_nodes = n_edges * 2
            if kind == "random":
                hg = random_hypergraph(n_nodes, n_edges, avg_edge_size=avg,
                                       seed=0, name=f"ov{d}")
            else:
                hg = clustered_hypergraph(n_nodes, n_edges, avg, seed=0)
            plan = plan_halo(hg, d)
            mesh = make_mesh(d, 1, devices=jax.devices()[:d])
            x = shard_vertex_features(
                plan, np.zeros((hg.num_nodes, args.feat), np.float32))
            rep = collective_overlap_report(
                lambda xo: halo_hgnn_aggregate(plan, mesh, xo), x)
            halo_rows = plan.halo_mask.sum(axis=2)
            np.fill_diagonal(halo_rows, 0.0)
            max_link_b = float(halo_rows.max()) * args.feat * 4
            t_a2a = max_link_b / (args.link_gbps * 1e9) * 1e6
            int_nnz = hg.nnz * plan.interior_fraction() / d
            t_int = int_nnz * args.ns_per_nnz * 1e-3
            cov = min(1.0, t_int / t_a2a) if t_a2a > 0 else 1.0
            ok = (rep["chain"] and rep["output_depends_on_collective"]
                  and rep["independent_elems"] > 0)
            row = (f"{kind},{d},{plan.interior_fraction():.4f},"
                   f"{rep['independent_elems']},{rep['downstream_elems']},"
                   f"{max_link_b/1e6:.3f},{t_a2a:.2f},{t_int:.2f},"
                   f"{cov:.3f},{ok}")
            rows.append(row)
            print(row, flush=True)
    with open(args.out, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    enable_compile_cache()
    main()
