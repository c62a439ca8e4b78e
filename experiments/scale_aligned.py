"""Large-graph scaling of the aligned (gather-free) fused aggregation.

The aligned banded form
replaces all per-nnz gathers with streamed band matmuls, so its cost is
streamed-bytes-bound (∝ num_segments · window) — per-nnz time *improves*
with density and scale instead of degrading.

Two configs:
  * ``pubmed_clustered`` — pubmed-shaped (19717², nnz≈85k) with planted
    community structure (reference fused kernel: 12.484 µs, BASELINE §1)
  * ``sbm10m`` — 2M vertices × 1M hyperedges, avg 10, nnz≈10M

Both measured against the tree backend.
Output: experiments/out/scale_aligned.csv

Run:
    python experiments/scale_aligned.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np


def big_sbm(n_nodes, n_edges, n_comm, avg, noise, seed):
    """Vectorized SBM hypergraph: vertices contiguous per community
    (the ordering a community detector recovers; see
    tests/test_reorder.py for the raw→reordered pipeline)."""
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n_nodes, n_comm + 1).astype(np.int64)
    lo_c, hi_c = bounds[:-1], bounds[1:]
    ecomm = rng.integers(0, n_comm, size=n_edges)
    k = np.maximum(rng.poisson(avg, size=n_edges), 2)
    seg = np.repeat(np.arange(n_edges, dtype=np.int64), k)
    lo, hi = lo_c[ecomm][seg], hi_c[ecomm][seg]
    mem = lo + (rng.random(k.sum()) * (hi - lo)).astype(np.int64)
    flip = rng.random(k.sum()) < noise
    mem[flip] = rng.integers(0, n_nodes, size=int(flip.sum()))
    from hypergef.sparse.hypergraph import Hypergraph

    return Hypergraph.from_coo(mem, seg, num_nodes=n_nodes,
                               num_edges=n_edges, name=f"sbm{n_comm}")


CONFIGS = {
    "pubmed_clustered": dict(n=19717, e=19717, comm=80, avg=4.3, noise=0.01,
                             ref_us=12.484, also_tree=True),
    "sbm10m": dict(n=2_000_000, e=1_000_000, comm=4000, avg=10.0, noise=0.01,
                   ref_us=None, also_tree=True),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="experiments/out/scale_aligned.csv")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from hypergef.ops import fused
    from hypergef.sparse import planner
    from hypergef.sparse.reorder import apply_vertex_order
    from hypergef.utils.timing import chain_fold, device_time_per_iter

    rows = [
        f"# aligned scaling f={args.feat} dev={jax.devices()[0].platform}",
        "config,nnz,backend,per_iter_us,ns_per_nnz,plan_s,extra",
    ]
    for cname in args.configs:
        c = CONFIGS[cname]
        t0 = time.time()
        hg = big_sbm(c["n"], c["e"], c["comm"], c["avg"], c["noise"], 0)
        hg, _ = apply_vertex_order(hg, np.arange(hg.num_nodes),
                                   sort_edges=True)
        print(f"{cname}: nnz={hg.nnz} gen {time.time()-t0:.1f}s", flush=True)
        hgd = hg.device_data()
        x0 = jnp.asarray(np.random.default_rng(0)
                         .normal(size=(hg.num_nodes, args.feat))
                         .astype(np.float32))
        cands = []
        t0 = time.time()
        try:
            al = planner.plan_aligned(hg)
            tplan = time.time() - t0
            sp = round(max(al.edge_stage.spill_fraction,
                           al.vertex_stage.spill_fraction), 4)
            wbs = f"{al.edge_stage.window_blocks}/{al.vertex_stage.window_blocks}"
            cands.append(("aligned", al.as_device(), tplan,
                          f"spill={sp};wb={wbs}"))
        except (ValueError, MemoryError) as exc:
            rows.append(f"{cname},{hg.nnz},aligned,REFUSED,,,"
                        f"{type(exc).__name__}")
        if c["also_tree"]:
            t0 = time.time()
            tp = planner.plan_tree(hg)
            cands.append(("tree", tp.as_device(), time.time() - t0, ""))
        for backend, pdev, tplan, extra in cands:
            try:
                def step(xv, h, p, _b=backend):
                    y = fused.hgnn_aggregate(h, xv, None, "sum", plan=p,
                                             backend=_b)
                    # full-shape fold (timing.chain_fold): scalar folds
                    # let XLA strength-reduce matmul-form backends
                    return chain_fold(y, xv)

                # the tree leg at 10M nnz is slow per iteration: cap its
                # chain so one dispatch stays well under a minute
                leg_iters = (min(args.iters, 10)
                             if backend == "tree" and hg.nnz > 5_000_000
                             else args.iters)
                t = device_time_per_iter(step, x0, iters=leg_iters,
                                         operands=(hgd, pdev))
                us = t["per_iter_s"] * 1e6
                row = (f"{cname},{hg.nnz},{backend},{us:.1f},"
                       f"{1e3*us/hg.nnz:.2f},{tplan:.1f},"
                       f"{extra};compile={t['compile_s']:.0f}s")
                if c["ref_us"] and backend == "aligned":
                    row += f";vs_ref3090={c['ref_us']/us:.3f}"
            except Exception as exc:  # noqa: BLE001
                row = (f"{cname},{hg.nnz},{backend},FAILED,,,"
                       f"{type(exc).__name__}: {str(exc)[:80]}")
            rows.append(row)
            print(row, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fo:
        fo.write("\n".join(rows) + "\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
