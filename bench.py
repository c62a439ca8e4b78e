"""Headline benchmark: fused HGNN-layer aggregation throughput per device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Protocol: the fig7/fig9 analogue (BASELINE.md §1) — the fused HGNN
aggregation (two-stage incidence aggregation + degree/weight scaling) at
feature_size=32 on a cora-shaped hypergraph (|V|=|E|=2708, nnz≈10.9k —
the reference's cora.mtx workload), device time per iteration measured by
chaining iterations inside one jitted fori_loop (the analogue of the
reference's ITER-loop around kernel launches, hgnnAgg.cuh:14).

Baseline: reference fused CUDA kernel on RTX 3090, cora f=32:
0.004795 ms (BASELINE.md §1, result.xlsx "fig7,fig9").
vs_baseline = baseline_time / our_time (>1 means faster than reference).

The backend is the plan's auto-selection (dense at this scale — the
production fused path for small graphs). Run with --backend/--config to
override.  Every record names the device it ran on; any failing leg
fails the run.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _device():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


REF_CORA_FUSED_MS = 0.004795  # RTX 3090, BASELINE.md §1
# Reference end-to-end HGNN train epoch, 20newsW100 nhid=32 (BASELINE.md §2):
# hgsys (fused backend) 1.471 ms on RTX 3090, protocol = 10 warm-up +
# 200 timed epochs, full train step (fwd + nll + bwd + Adam).
REF_20NEWS_EPOCH_MS = 1.471


def bench_e2e(args):
    """fig6 analogue: HGNN train-epoch device time on a 20news-shaped
    hypergraph (16242 vertices, 100 giant hyperedges, nnz≈65k, 100
    features, 4 classes, nhid=32, 2 layers)."""
    import jax

    from hypergef.data.synthetic import random_hypergraph, random_features
    from hypergef.train import TrainConfig, Trainer, rand_train_test_idx

    _log(f"bench_e2e: devices={jax.devices()}")
    hg = random_hypergraph(16242, 100, avg_edge_size=654.5, seed=0, name="news20")
    x, y = random_features(hg.num_nodes, 100, 4, seed=1)
    split = rand_train_test_idx(y, seed=2)
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, epochs=1, warmup=0,
                      backend=args.backend if args.backend != "auto" else "auto")
    _log(f"bench_e2e: graph={hg}, building trainer...")
    tr = Trainer(cfg, hg, x, y)
    _log("bench_e2e: trainer ready, timing chained epochs (compiles may take minutes)...")
    # ≥5 independent differenced windows: publish the median WITH its
    # spread.  min-window rule (same as the autotuner's): pilot-estimate,
    # then widen the chained loop until each window holds ≥20 ms of
    # device compute, so dispatch jitter amortizes out.
    st = tr.epoch_device_time_stats(split["train"], iters=args.iters, windows=5,
                                    min_window_s=0.02)
    if st["median_s"] <= 0:  # windows swamped by dispatch jitter — widen
        _log("bench_e2e: zero median window (dispatch jitter) — retrying with 5x iters")
        st = tr.epoch_device_time_stats(split["train"], iters=args.iters * 5, windows=5,
                                        min_window_s=0.1)
    t_s = st["median_s"]
    if t_s <= 0:
        raise RuntimeError(
            "bench_e2e: could not resolve a positive device-time window "
            "(dispatch jitter above the compute window)"
        )
    _log(f"bench_e2e: per-epoch median {t_s*1e6:.1f} us "
         f"[{st['min_s']*1e6:.1f}, {st['max_s']*1e6:.1f}] over {st['windows']} windows")
    epochs_per_s = 1.0 / t_s
    vs = REF_20NEWS_EPOCH_MS / (t_s * 1e3)
    return {
        "metric": "hgnn_e2e_train_epochs_per_s_20news_nhid32",
        "value": round(epochs_per_s, 2),
        "unit": "epochs/s",
        "vs_baseline": round(vs, 3),
        "per_epoch_us": round(t_s * 1e6, 1),
        "per_epoch_us_spread": [round(st["min_s"] * 1e6, 1),
                                round(st["max_s"] * 1e6, 1)],
        "windows": st["windows"],
        "iters_per_window": st.get("iters", args.iters),
        "nnz": hg.nnz,
        "baseline": "RTX3090 hgsys fused e2e train epoch 20newsW100 nhid=32 = 1.471ms (BASELINE.md §2)",
        "note": "device time per full train step (fwd+nll+bwd+Adam), host dispatch excluded; 20news-shaped synthetic hypergraph; value = median over independent windows, spread = [min,max]",
    }


# reference fused kernel per-nnz rate on pubmed — the reference's BEST
# per-nnz rate in BASELINE.md §1 (12.484 us / 85k nnz): the strictest
# per-nnz yardstick for workloads it has no direct dataset analogue for
REF_BEST_NS_PER_NNZ = 0.1468


def bench_kernel(args):
    import jax
    import jax.numpy as jnp

    from hypergef.data.synthetic import random_hypergraph
    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_aggregation
    from hypergef.utils.timing import device_time_per_iter

    shapes = {
        "cora": dict(n=2708, e=2708, avg=4.0, ref_ms=REF_CORA_FUSED_MS),
        # square round-1 convention (kept for cross-round comparability)
        "pubmed": dict(n=19717, e=19717, avg=4.3, ref_ms=0.012484),
        # the reference dataset's actual incidence box: 19717 vertices x
        # 7963 cocitation hyperedges (dataloader.py:31, AllSet), same
        # ~85k nnz — mid-size unstructured, routes to the int8 dense
        # stream
        "pubmed_real": dict(n=19717, e=7963, avg=10.8, ref_ms=0.012484),
        "big": dict(n=100_000, e=50_000, avg=10.0, ref_ms=None),
        # community-structured workload (the realistic sparse regime —
        # every real hypergraph in the reference's suite is clustered);
        # ref_ms derived per-nnz from the reference's best rate
        "clustered": dict(n=60_000, e=30_000, avg=12, comm=240, ref_ms=None),
    }
    s = shapes[args.config]
    provenance = None
    if args.config == "clustered":
        import time as _time

        from experiments.clustered_bench import community_hypergraph
        from hypergef.sparse.reorder import community_reorder

        # The FULL production pipeline from raw input: shuffle the
        # generator's community-contiguous vertex ids
        # to a raw order, then recover locality with the coarsening
        # reorderer — the headline number must be reachable from raw
        # input, and ordering+planning time must be visible next to it
        # (the reference counts its schedule build as part of the
        # system, hypergraph.py:76-77).
        from hypergef.sparse.reorder import apply_vertex_order

        hg = community_hypergraph(s["n"], s["e"], s["comm"], s["avg"], 0.02, 0)
        perm = np.random.default_rng(7).permutation(hg.num_nodes)
        hg, _ = apply_vertex_order(hg, perm, sort_edges=False)  # raw order
        t0 = _time.time()
        hg, _ = community_reorder(hg, method="coarsen")
        reorder_s = _time.time() - t0
        provenance = {"ordering": "coarsen_order from shuffled raw input",
                      "reorder_s": round(reorder_s, 2)}
        ref_ms = REF_BEST_NS_PER_NNZ * hg.nnz * 1e-6
    else:
        hg = random_hypergraph(s["n"], s["e"], avg_edge_size=s["avg"], seed=0,
                               name=args.config)
        ref_ms = s["ref_ms"]
    import time as _time

    t0 = _time.time()
    plan = plan_aggregation(hg)
    plan_s = _time.time() - t0
    hgd = hg.device_data()
    x0 = jnp.asarray(
        np.random.default_rng(0).normal(size=(hg.num_nodes, args.feat)).astype(np.float32)
    )
    backend = args.backend if args.backend != "auto" else plan.preferred_backend

    def step(a):
        return fused.hgnn_aggregate(hgd, a, None, "sum", plan=plan, backend=backend)

    iters_used = args.iters
    r = device_time_per_iter(step, x0, iters=iters_used)
    if r["per_iter_s"] <= 0 or r.get("noisy"):
        _log(f"bench_kernel[{args.config}]: noisy window — retrying 5x iters")
        iters_used = args.iters * 5  # track the actual window
        r = device_time_per_iter(step, x0, iters=iters_used)
    # min-window rule (matches the e2e leg): widen until the differenced
    # window holds >=20 ms of device compute so dispatch jitter
    # amortizes out of the per-iter number.  max() keeps the widening
    # from SHRINKING the window relative to the noisy-retry measurement.
    if r["per_iter_s"] > 0 and r["per_iter_s"] * iters_used < 0.02:
        iters_used = max(iters_used, int(np.ceil(0.02 / r["per_iter_s"])))
        _log(f"bench_kernel[{args.config}]: widening window to "
             f"{iters_used} iters (min-window rule)")
        r = device_time_per_iter(step, x0, iters=iters_used)
    t_s = r["per_iter_s"]
    if t_s <= 0:
        raise RuntimeError(
            f"bench_kernel[{args.config}]: could not resolve a positive "
            "device-time window (dispatch jitter above compute)"
        )
    nnz_per_s = hg.nnz / t_s
    vs = (ref_ms / (t_s * 1e3)) if ref_ms else 0.0
    rec = {
        "metric": f"fused_hgnn_layer_nnz_per_s_{args.config}_f{args.feat}_{backend}",
        "value": round(nnz_per_s, 1),
        "unit": "incidence-nnz/s",
        "vs_baseline": round(vs, 4),
        "per_iter_us": round(t_s * 1e6, 2),
        "iters_per_window": iters_used,
        "compile_s": round(r["compile_s"], 1),
        "plan_s": round(plan_s, 2),
        "nnz": hg.nnz,
        "baseline": (
            f"RTX3090 best per-nnz fused rate x nnz (BASELINE.md §1 pubmed)"
            if args.config == "clustered"
            else f"RTX3090 fused {args.config} f=32 (BASELINE.md §1)"
        ),
    }
    if provenance:
        rec["provenance"] = provenance
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="both", choices=["both", "e2e", "kernel"])
    ap.add_argument("--config", default="cora")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    from hypergef.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.mode == "e2e":
        rec = bench_e2e(args)
    elif args.mode == "kernel":
        rec = bench_kernel(args)
    else:
        # headline (fig6-analogue e2e, dense regime) PLUS the sparse
        # kernel-mode legs in ONE json line
        rec = bench_e2e(args)
        import copy

        for leg, cfg in (("sparse_kernel", "pubmed_real"),
                         ("clustered_kernel", "clustered")):
            kargs = copy.copy(args)
            kargs.config = cfg
            krec = bench_kernel(kargs)
            rec[leg] = {
                k: krec[k] for k in
                ("metric", "value", "unit", "vs_baseline", "per_iter_us",
                 "plan_s", "provenance")
                if k in krec
            }
    rec["device"] = _device()
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
