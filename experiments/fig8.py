"""fig8 analogue: memory-traffic comparison of aggregation backends.

Reference: ``experiment/fig8.py`` profiles DRAM sectors (Nsight Compute)
for cuSPARSE vs the fused kernel.  Here: XLA's own cost analysis
(bytes accessed / flops) per backend — no hardware counters needed, and
the ratio mirrors the reference's DRAM_Read_Write table.

    python experiments/fig8.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/out/fig8.csv")
    ap.add_argument("--configs", default="cora,pubmed")
    ap.add_argument("--feat", type=int, default=32)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax.numpy as jnp

    from hypergef.data.synthetic import random_hypergraph
    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_aggregation
    from hypergef.utils.profiling import traffic_report

    shapes = {
        "cora": (2708, 2708, 4.0),
        "pubmed": (19717, 19717, 4.3),
    }
    with open(args.out, "a") as f:
        for cname in args.configs.split(","):
            n, e, avg = shapes[cname]
            hg = random_hypergraph(n, e, avg_edge_size=avg, seed=0, name=cname)
            plan = plan_aggregation(hg)
            hgd = hg.device_data()
            x = jnp.ones((n, args.feat), jnp.float32)
            backends = {"xla": "xla", "cumsum": "cumsum", "tree": "tree"}
            if plan.dense is not None:
                backends["dense"] = "dense"
            rep = traffic_report(
                {
                    name: (
                        lambda a, b=b: fused.hgnn_aggregate(
                            hgd, a, None, "sum", plan=plan, backend=b
                        )
                    )
                    for name, b in backends.items()
                },
                x,
            )
            for name, row in rep.items():
                line = (
                    f"{cname},{name},bytes={row['bytes_accessed']:.0f},"
                    f"flops={row['flops']:.0f},"
                    f"ratio={row.get('bytes_ratio_vs_baseline', 1.0):.3f}"
                )
                print(line)
                print(line, file=f, flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
