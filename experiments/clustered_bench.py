"""Clustered-workload backend shootout: does BSR (or multihot) earn its
place beyond the dense regime?

Workload: SBM-style community hypergraph, vertices renumbered by
community (the reorder a community detector provides — upstream ships an
unused Rabbit-Order subsystem for exactly this, rabbit_order.hpp:267-753;
here the clustering is explicit so the ordering is exact), at a scale
beyond the dense/precomp caps.  Backends: cumsum / tree / bsr
(RCM-reordered 128x128 blocks) / multihot (tile-local matmul).
Fenced device timing.  Output: experiments/out/clustered.csv.

Run:
    python experiments/clustered_bench.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np


def community_hypergraph(n_nodes, n_edges, n_comm, avg, noise, seed):
    """Community-structured hypergraph with vertices ALREADY renumbered
    by community (contiguous id ranges per community)."""
    rng = np.random.default_rng(seed)
    comm_of = np.sort(rng.integers(0, n_comm, size=n_nodes))  # contiguous
    starts = np.searchsorted(comm_of, np.arange(n_comm))
    ends = np.searchsorted(comm_of, np.arange(n_comm), side="right")
    vs, es = [], []
    for e in range(n_edges):
        c = rng.integers(0, n_comm)
        lo, hi = starts[c], ends[c]
        if hi - lo < 2:
            lo, hi = 0, n_nodes
        k = max(int(rng.poisson(avg)), 2)
        members = rng.integers(lo, hi, size=k)
        flip = rng.random(k) < noise
        members[flip] = rng.integers(0, n_nodes, size=int(flip.sum()))
        members = np.unique(members)
        vs.append(members)
        es.append(np.full(len(members), e, dtype=np.int64))
    from hypergef.sparse.hypergraph import Hypergraph

    return Hypergraph.from_coo(
        np.concatenate(vs), np.concatenate(es),
        num_nodes=n_nodes, num_edges=n_edges, name=f"sbm{n_comm}",
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--e", type=int, default=30_000)
    ap.add_argument("--comm", type=int, default=240,
                    help="#communities; n/comm=250 vertices each → edges "
                    "touch ~2 BSR blocks / 1-2 multihot tiles")
    ap.add_argument("--avg", type=int, default=12)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--also-random", action="store_true", default=True)
    ap.add_argument("--out", default="experiments/out/clustered.csv")
    args = ap.parse_args()

    import jax

    import jax.numpy as jnp

    from hypergef.data.synthetic import random_hypergraph
    from hypergef.ops import fused
    from hypergef.sparse import planner
    from hypergef.sparse.bsr import plan_bsr
    from hypergef.utils.timing import chain_fold, device_time_per_iter

    from hypergef.sparse.reorder import apply_vertex_order

    sbm = community_hypergraph(args.n, args.e, args.comm, args.avg,
                               args.noise, 0)
    # align hyperedge numbering with the community-sorted vertex order
    # (median member id sort) — edge ids are arbitrary for every backend,
    # and the aligned backend requires segment-sorted edges
    sbm, _ = apply_vertex_order(sbm, np.arange(sbm.num_nodes),
                                sort_edges=True)
    graphs = [("sbm", sbm)]
    if args.also_random:
        graphs.append(
            ("random", random_hypergraph(args.n, args.e,
                                         avg_edge_size=float(args.avg), seed=0))
        )

    rows = [
        f"# clustered backend shootout n={args.n} e={args.e} comm={args.comm} "
        f"avg={args.avg} noise={args.noise} f={args.feat} dev={jax.devices()[0].platform}",
        "graph,nnz,backend,params,per_iter_us,extra",
    ]
    for gname, hg in graphs:
        hg = hg[0] if isinstance(hg, tuple) else hg
        hgd = hg.device_data()
        rng = np.random.default_rng(0)
        x0 = jnp.asarray(rng.normal(size=(hg.num_nodes, args.feat)).astype(np.float32))
        cands = [("cumsum", {}, None), ("tree", {}, None)]
        try:
            bp = plan_bsr(hg, reorder=True)
            cands.append(("bsr", {"fill": round(bp.fill_fraction(), 5)},
                          planner.AggregationPlan(tree=planner.plan_tree(hg), bsr=bp)))
        except Exception as exc:  # noqa: BLE001
            rows.append(f"{gname},{hg.nnz},bsr,,FAILED,{type(exc).__name__}")
        for tr in (128, 256, 512):
            for form in ("multihot", "multihot_precomp"):
                try:
                    mh = planner.plan_multihot(hg, tile_rows=tr, form=form)
                    frag = round(mh.edge_stage.fragmentation(), 3)
                    label = "mh" if form == "multihot" else "mhp"
                    cands.append(
                        ("multihot", {"tile_rows": tr, "frag": frag, "form": label},
                         planner.AggregationPlan(tree=planner.plan_tree(hg),
                                                 multihot=mh)))
                except MemoryError:
                    rows.append(f"{gname},{hg.nnz},multihot,tr={tr};{form},SKIP,pad-blowup")
        try:
            al = planner.plan_aligned(hg)
            sp = round(max(al.edge_stage.spill_fraction,
                           al.vertex_stage.spill_fraction), 3)
            wbs = (al.edge_stage.window_blocks, al.vertex_stage.window_blocks)
            cands.append(("aligned", {"spill": sp, "wb": f"{wbs[0]}/{wbs[1]}"},
                          planner.AggregationPlan(tree=planner.plan_tree(hg),
                                                  aligned=al)))
        except (ValueError, MemoryError) as exc:
            rows.append(f"{gname},{hg.nnz},aligned,,REFUSED,{type(exc).__name__}")
        base_plan = planner.AggregationPlan(tree=planner.plan_tree(hg))
        for backend, params, plan in cands:
            p = plan or base_plan
            # pass graph data + device plan as jit OPERANDS, not as
            # embedded program constants (BSR blocks, mhp tables)
            if backend == "bsr":
                pdev = p.bsr.as_device()
            elif backend == "multihot":
                pdev = p.multihot.as_device()
            elif backend == "aligned":
                pdev = p.aligned.as_device()
            elif backend == "tree":
                pdev = p.tree.as_device()
            else:
                pdev = None
            try:
                def step(xv, hgd_, pd):
                    y = fused.hgnn_aggregate(hgd_, xv, None, "sum", plan=pd,
                                             backend=backend)
                    # full-shape fold (timing.chain_fold): scalar folds
                    # let XLA strength-reduce matmul-form backends
                    return chain_fold(y, xv)

                t = device_time_per_iter(step, x0, iters=args.iters,
                                         operands=(hgd, pdev))
                row = (f"{gname},{hg.nnz},{backend},"
                       f"{';'.join(f'{k}={v}' for k, v in params.items())},"
                       f"{t['per_iter_s']*1e6:.1f},compile={t['compile_s']:.0f}s")
            except Exception as exc:  # noqa: BLE001
                row = (f"{gname},{hg.nnz},{backend},"
                       f"{';'.join(f'{k}={v}' for k, v in params.items())},"
                       f"FAILED,{type(exc).__name__}")
            rows.append(row)
            print(row, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fo:
        fo.write("\n".join(rows) + "\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
