"""fig10 analogue: chunk-size (ngs) sensitivity sweep.

Reference: ``experiment/fig10.cu`` sweeps partition sizes 4…600 with and
without shared-memory grouping.  Here: sweep the planner's ngs for the
tree backend (the shm-grouping analogue is the fan-in tree combine,
always on) and report device time + padding waste.

    python experiments/fig10.py --config 20news
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/out/fig10.csv")
    ap.add_argument("--config", default="20news")
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--ngs", default="4,8,16,32,64,128")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax.numpy as jnp

    from hypergef.data.synthetic import random_hypergraph
    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_tree
    from hypergef.utils.timing import device_time_per_iter

    shapes = {
        "20news": (16242, 100, 654.5),
        "Mushroom": (8124, 298, 500.0),
        "cora": (2708, 2708, 4.0),
    }
    n, e, avg = shapes[args.config]
    hg = random_hypergraph(n, e, avg_edge_size=avg, seed=0, name=args.config)
    hgd = hg.device_data()
    x0 = jnp.asarray(
        np.random.default_rng(0).normal(size=(n, args.feat)).astype(np.float32)
    )
    with open(args.out, "a") as f:
        for ngs in map(int, args.ngs.split(",")):
            plan = plan_tree(hg, ngs=ngs)
            r = device_time_per_iter(
                lambda a: fused.hgnn_aggregate(
                    hgd, a, None, "sum", plan=plan, backend="tree"
                ),
                x0,
                iters=args.iters,
            )
            depth = plan.depth()
            row = (
                f"{args.config},ngs={ngs},depth={depth},"
                f"{r['per_iter_s']*1e6:.2f}us,compile={r['compile_s']:.1f}s"
            )
            print(row)
            print(row, file=f, flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
