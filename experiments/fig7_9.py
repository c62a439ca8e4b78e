"""fig7/fig9 analogue: fused-kernel vs baseline-formulation sweep.

Reference: ``experiment/fig7.cu``/``fig9.cu`` compare cuSPARSE two-step
SpMM vs the fused kernel per dataset.  Here the "cuSPARSE two-step"
analogue is the plain XLA segment-sum path (materialized nnz
intermediates, scatter combine) and the fused contenders are the
cumsum / tree / dense backends; measured as device time per iteration.

    python experiments/fig7_9.py --out fig7.csv
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/out/fig7.csv")
    ap.add_argument("--configs", default="cora,pubmed")
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--backends", default="xla,cumsum,tree,dense")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--vs-ref", action="store_true",
                    help="emit per-dataset SUMMARY rows vs RTX 3090 ref")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax.numpy as jnp

    from hypergef.data.synthetic import random_hypergraph
    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_aggregation
    from hypergef.utils.timing import device_time_per_iter

    shapes = {
        "cora": (2708, 2708, 4.0),
        "citeseer": (3312, 3312, 3.2),
        # "pubmed" kept the square round-1 convention for cross-round
        # comparability; "pubmed_real" matches the reference dataset's
        # actual incidence box (19717 vertices x 7963 cocitation
        # hyperedges, AllSet/dataloader.py:31) at the same ~85k nnz
        "pubmed": (19717, 19717, 4.3),
        "pubmed_real": (19717, 7963, 10.8),
        "big": (100_000, 50_000, 10.0),
        # Remaining reference fig7 suite (BASELINE.md §1), at the
        # datasets' published incidence dims (AllSet paper Table 7 /
        # reference data/load_dataset.py loaders); connectivity is
        # synthetic uniform-random at those dims (no raw data in this
        # env — worst case for us: no community structure to exploit).
        "coauthor_cora": (2708, 1072, 4.3),
        "coauthor_dblp": (41302, 22363, 4.5),
        "NTU2012": (2012, 2012, 5.0),
        "ModelNet40": (12311, 12311, 5.0),
        "Mushroom": (8124, 298, 500.0),
        "20newsW100": (16242, 100, 654.5),
        "house-committees-100": (1290, 341, 35.0),
        "zoo": (101, 43, 39.0),
        "walmart-trips-100": (88860, 69906, 6.6),
    }
    # Clustered variants of the two largest suite datasets: planted
    # community structure (~250 vertices/community, 2% noise) at the
    # same incidence dims — the regime real coauthorship/trip data
    # occupies, where the aligned banded backend applies.  Suffix
    # "_clustered" routes through community_hypergraph + edge sort.
    clustered = {
        "coauthor_dblp_clustered": (41302, 22363, 160, 4.5, 0.02),
        "walmart-trips-100_clustered": (88860, 69906, 355, 6.6, 0.02),
    }
    # RTX 3090 reference times (ms, f=32): cuSPARSE two-step and the
    # tuned fused kernel (BASELINE.md §1, result.xlsx "fig7,fig9").
    ref_ms_f32 = {
        "cora": (0.04067, 0.004795),
        "citeseer": (0.04039, 0.003698),
        "pubmed": (0.05767, 0.012484),
        "pubmed_real": (0.05767, 0.012484),
        "coauthor_cora": (0.03248, 0.004330),
        "coauthor_dblp": (0.10162, 0.030438),
        "NTU2012": (0.03056, 0.004630),
        "ModelNet40": (0.04477, 0.012058),
        "Mushroom": (0.03265, 0.026144),
        "20newsW100": (0.04927, 0.046639),
        "house-committees-100": (0.03420, 0.007815),
        "zoo": (0.023511, 0.0039626),
        "walmart-trips-100": (0.306176, 0.131158),
        # clustered variants compare against the same dataset's ref row
        "coauthor_dblp_clustered": (0.10162, 0.030438),
        "walmart-trips-100_clustered": (0.306176, 0.131158),
    }
    with open(args.out, "a") as f:
        for cname in args.configs.split(","):
            if cname in clustered:
                from clustered_bench import community_hypergraph
                from hypergef.sparse.reorder import apply_vertex_order

                n, e, comm, avg, noise = clustered[cname]
                hg = community_hypergraph(n, e, comm, avg, noise, 0)
                hg, _ = apply_vertex_order(hg, np.arange(hg.num_nodes),
                                           sort_edges=True)
            else:
                n, e, avg = shapes[cname]
                hg = random_hypergraph(n, e, avg_edge_size=avg, seed=0,
                                       name=cname)
            plan = plan_aggregation(hg)
            hgd = hg.device_data()
            x0 = jnp.asarray(
                np.random.default_rng(0)
                .normal(size=(n, args.feat))
                .astype(np.float32)
            )
            base_t = None
            times = {}
            for backend in args.backends.split(","):
                if backend == "dense" and plan.dense is None:
                    continue
                if backend == "precomp" and plan.precomp is None:
                    continue
                if backend == "aligned" and plan.aligned is None:
                    continue
                def step(a, _b=backend):
                    return fused.hgnn_aggregate(
                        hgd, a, None, "sum", plan=plan, backend=_b
                    )

                try:
                    r = device_time_per_iter(step, x0, iters=args.iters)
                    if r["per_iter_s"] <= 0 or r.get("noisy"):
                        # sub-ms kernels: the differenced window drowns
                        # in dispatch jitter below ~60 chained iters
                        r = device_time_per_iter(step, x0,
                                                 iters=args.iters * 5)
                except Exception as ex:
                    print(f"{cname}/{backend}: FAILED {ex}")
                    continue
                t = r["per_iter_s"]
                if t <= 0:
                    print(f"{cname}/{backend}: unresolved (jitter > compute)")
                    continue
                if base_t is None and t > 0:
                    base_t = t
                times[backend] = t
                speedup = base_t / t if (base_t and t > 0) else float("nan")
                row = (
                    f"{cname},{backend},f={args.feat},nnz={hg.nnz},"
                    f"{t*1e6:.2f}us,speedup_vs_first={speedup:.2f}"
                )
                print(row)
                print(row, file=f, flush=True)
            # fig7 summary: our best backend vs the RTX 3090 reference
            # times (vs_ref > 1 means this framework is faster).
            if args.vs_ref and times and cname in ref_ms_f32 and args.feat == 32:
                ref_cus, ref_fus = ref_ms_f32[cname]
                best = min(times, key=times.get)
                best_us = times[best] * 1e6
                auto = plan.preferred_backend
                row = (
                    f"SUMMARY,{cname},nnz={hg.nnz},auto={auto},best={best},"
                    f"{best_us:.2f}us,ref_cusparse={ref_cus*1e3:.1f}us,"
                    f"ref_fused={ref_fus*1e3:.2f}us,"
                    f"vs_ref_cusparse={ref_cus*1e3/best_us:.2f},"
                    f"vs_ref_fused={ref_fus*1e3/best_us:.3f}"
                )
                print(row)
                print(row, file=f, flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
