"""fig7/fig9 analogue on REALISTIC (clustered) graphs with the FULL
production ladder.

The reference's headline kernel table (``experiment/fig9.cu:15-84``,
BASELINE.md §1) is per real dataset, and every real hypergraph in its
suite is clustered (cocitation/coauthor communities, store trips, ...).
Uniform-random synthetics would miss the aligned backend + coarsen
reorder (the system's core contribution).  So:

* per dataset, connectivity is COMMUNITY-STRUCTURED at the dataset's
  published incidence dims (exact-k member sampling keeps nnz at the
  real dataset's scale), then vertex ids are SHUFFLED to a raw order;
* the full production pipeline runs from that raw input:
  ``community_reorder(method="coarsen")`` → ``plan_aggregation`` (auto
  ladder) → measure the auto-selected backend, the aligned backend
  where planned, and the XLA two-step baseline (the cuSPARSE analogue);
* SUMMARY rows carry reorder/plan build time next to the kernel time
  (the reference counts its schedule build as part of the system,
  ``hypergraph.py:76-77``) and the ratios vs the RTX 3090 reference
  numbers (result.xlsx "fig7,fig9").

Run:
    python experiments/fig7_9_realistic.py --out experiments/out/fig7_9.csv
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np

# Published incidence dims (AllSet raw data via the reference loaders,
# data/load_dataset.py; see fig7_9.py for provenance notes).
SHAPES = {
    "cora": (2708, 2708, 4.0),
    "citeseer": (3312, 3312, 3.2),
    "pubmed": (19717, 7963, 10.8),  # real cocitation box (dataloader.py:31)
    "coauthor_cora": (2708, 1072, 4.3),
    "coauthor_dblp": (41302, 22363, 4.5),
    "NTU2012": (2012, 2012, 5.0),
    "ModelNet40": (12311, 12311, 5.0),
    "Mushroom": (8124, 298, 500.0),
    "20newsW100": (16242, 100, 654.5),
    "house-committees-100": (1290, 341, 35.0),
    "zoo": (101, 43, 39.0),
    "walmart-trips-100": (88860, 69906, 6.6),
    "yelp": (50758, 679302, 2.7),  # AllSet dims; no ref kernel number
}

# RTX 3090 (cuSPARSE two-step, tuned fused) ms at f=32 — BASELINE.md §1.
REF_MS_F32 = {
    "cora": (0.04067, 0.004795),
    "citeseer": (0.04039, 0.003698),
    "pubmed": (0.05767, 0.012484),
    "coauthor_cora": (0.03248, 0.004330),
    "coauthor_dblp": (0.10162, 0.030438),
    "NTU2012": (0.03056, 0.004630),
    "ModelNet40": (0.04477, 0.012058),
    "Mushroom": (0.03265, 0.026144),
    "20newsW100": (0.04927, 0.046639),
    "house-committees-100": (0.03420, 0.007815),
    "zoo": (0.023511, 0.0039626),
    "walmart-trips-100": (0.306176, 0.131158),
}


def clustered_at_dims(name, n, e, avg, noise=0.02, seed=0):
    """Community hypergraph at the dataset's real dims with exact-k
    member sampling (without replacement) so nnz lands at the real
    dataset's scale; vertices come out community-contiguous and are
    shuffled by the caller.  Community size scales with the edge size so
    giant-edge datasets (Mushroom, 20news) keep edges community-local."""
    rng = np.random.default_rng(seed)
    n_comm = max(1, min(n // 250, n // max(int(2.5 * avg), 1)))
    comm_of = np.sort(rng.integers(0, n_comm, size=n))
    starts = np.searchsorted(comm_of, np.arange(n_comm))
    ends = np.searchsorted(comm_of, np.arange(n_comm), side="right")
    vs, es = [], []
    for ei in range(e):
        c = rng.integers(0, n_comm)
        lo, hi = int(starts[c]), int(ends[c])
        if hi - lo < 2:
            lo, hi = 0, n
        k = max(int(rng.poisson(avg)), 2)
        k = min(k, hi - lo)
        members = lo + rng.choice(hi - lo, size=k, replace=False)
        flip = rng.random(k) < noise
        members[flip] = rng.integers(0, n, size=int(flip.sum()))
        members = np.unique(members)
        vs.append(members)
        es.append(np.full(len(members), ei, dtype=np.int64))
    from hypergef.sparse.hypergraph import Hypergraph

    return Hypergraph.from_coo(
        np.concatenate(vs), np.concatenate(es),
        num_nodes=n, num_edges=e, name=name,
    )


def measure(step, x0, iters, operands=()):
    """Honest fenced per-iter time with the min-window widening rule
    (same guard as sparse/autotune.sweep).  dynamic_iters: one compile
    per (dataset, backend), so per-trip-count compiles do not dominate
    a 13-dataset sweep."""
    from hypergef.utils.timing import device_time_per_iter

    t = device_time_per_iter(step, x0, iters=iters, operands=operands,
                             dynamic_iters=True)
    cur = iters
    # dynamic mode compiles once, so iterations are cheap: the cap must
    # be high enough that even a ~1 µs kernel can chain past 2× dispatch
    while cur < 500_000 and (
        t["noisy"] or t["per_iter_s"] * cur < 2.0 * t["dispatch_s"]
    ):
        cur *= 5
        t = device_time_per_iter(step, x0, iters=cur, operands=operands,
                                 dynamic_iters=True)
    return t["per_iter_s"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/out/fig7_9.csv")
    ap.add_argument("--configs", default=",".join(SHAPES))
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--noise", type=float, default=0.02)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax.numpy as jnp

    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_aggregation
    from hypergef.sparse.reorder import apply_vertex_order, community_reorder
    from hypergef.utils.timing import chain_fold

    header = (
        "dataset,nnz,backend,us,reorder_s,plan_s,"
        "vs_ref_cusparse,vs_ref_fused"
    )
    fresh = not os.path.exists(args.out)
    with open(args.out, "a") as f:
        if fresh:
            print(header, file=f, flush=True)
        for cname in args.configs.split(","):
            n, e, avg = SHAPES[cname]
            hg = clustered_at_dims(cname, n, e, avg, noise=args.noise)
            # raw order: shuffle away the generator's community layout
            perm = np.random.default_rng(7).permutation(hg.num_nodes)
            hg, _ = apply_vertex_order(hg, perm, sort_edges=False)
            t0 = time.time()
            hg, _ = community_reorder(hg, method="coarsen")
            reorder_s = time.time() - t0
            t0 = time.time()
            plan = plan_aggregation(hg)
            plan_s = time.time() - t0
            hgd = hg.device_data()
            x0 = jnp.asarray(
                np.random.default_rng(0)
                .normal(size=(hg.num_nodes, args.feat))
                .astype(np.float32)
            )
            auto = plan.preferred_backend
            backends = ["xla", auto]
            if plan.aligned is not None and auto != "aligned":
                backends.append("aligned")
            times = {}
            for backend in backends:
                # plans and graph data ride as jit OPERANDS (devplan
                # pytrees), not as embedded program constants
                if backend in ("tree", "multihot", "aligned"):
                    def step(a, hgd_, pd, _b=backend):
                        y = fused.hgnn_aggregate(
                            hgd_, a, None, "sum", plan=pd, backend=_b
                        )
                        return chain_fold(y, a)

                    # raw per-backend TreePlan as a device operand (the
                    # fused dispatch accepts it directly)
                    sub = getattr(plan, backend, None) or plan.tree
                    operands = (hgd, sub.as_device())
                else:
                    def step(a, hgd_, _b=backend, _p=plan):
                        y = fused.hgnn_aggregate(
                            hgd_, a, None, "sum", plan=_p, backend=_b
                        )
                        return chain_fold(y, a)

                    operands = (hgd,)

                try:
                    t = measure(step, x0, args.iters, operands)
                except Exception as ex:
                    print(f"{cname}/{backend}: FAILED {type(ex).__name__}: "
                          f"{str(ex).splitlines()[0][:140]}", flush=True)
                    continue
                if t <= 0:
                    print(f"{cname}/{backend}: unresolved window", flush=True)
                    continue
                times[backend] = t
                row = (f"{cname},{hg.nnz},{backend},{t*1e6:.2f},"
                       f"{reorder_s:.2f},{plan_s:.2f},,")
                print(row, flush=True)
                print(row, file=f, flush=True)
            if not times:
                continue
            best = min(times, key=times.get)
            best_us = times[best] * 1e6
            ref = REF_MS_F32.get(cname)
            vs_cus = f"{ref[0]*1e3/best_us:.2f}" if ref else ""
            vs_fus = f"{ref[1]*1e3/best_us:.3f}" if ref else ""
            srow = (
                f"SUMMARY,{cname},nnz={hg.nnz},auto={auto},best={best},"
                f"{best_us:.2f}us,reorder={reorder_s:.2f}s,plan={plan_s:.2f}s,"
                f"xla_us={times.get('xla', float('nan'))*1e6:.2f},"
                f"vs_ref_cusparse={vs_cus},vs_ref_fused={vs_fus}"
            )
            print(srow, flush=True)
            print(srow, file=f, flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
