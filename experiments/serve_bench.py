"""Serving-path perf artifact: the measured cost of the serving
subsystem.

The reference has no serving story at all (SURVEY.md §5: nothing is
persisted but CSVs, ``hgsys.py:207-211``), so there is no baseline row
to beat — this driver establishes OUR numbers for the deployment unit:
a ``jax.export`` AOT artifact of the full-graph forward, loaded in a
fresh ``ServingModel`` and called repeatedly.

Per workload, measured in one process:

* ``export_s``     — trained Trainer → serialized StableHLO artifact;
* ``artifact_mb``  — on-disk size (weights + incidence tables +
  schedule constants are closure constants in the program);
* ``load_s``       — read + rebuild the exported program (no compile);
* ``first_call_s`` — first ``predict`` (XLA compile of the AOT program);
* ``warm_ms_*``    — steady-state request latency, wall-clock with
  ``block_until_ready`` (dispatch included — that IS serving latency),
  median and p95 over ``--calls`` calls, plus derived qps;
* ``direct_ms_median`` — the same forward through the live Trainer's
  jitted apply, as the no-serialization control: the artifact path
  should cost ~nothing extra per call;
* ``dev_us_forward`` / ``dev_us_direct`` — per-forward DEVICE time
  (hoisting-safe chained fori_loop, ``utils/timing.py``): the
  exported-vs-direct pair shows the AOT program itself costs nothing
  extra.

Run:
    python experiments/serve_bench.py --out experiments/out/serve.csv
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np

WORKLOADS = {
    # name: (n_vertices, n_hyperedges, classes, avg_edge_size, feat)
    "cora_shaped": (2708, 2708, 7, 4.0, 64),
    "pubmed_shaped": (19717, 7963, 3, 10.8, 64),
    "20news_shaped": (16242, 100, 4, 100.0, 64),
}


def _lat_stats(fn, x, calls):
    import jax

    samples = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        samples.append(time.perf_counter() - t0)
    arr = np.sort(np.asarray(samples))
    return {
        "median_ms": float(arr[len(arr) // 2] * 1e3),
        "p95_ms": float(arr[min(len(arr) - 1, int(0.95 * len(arr)))] * 1e3),
        "mean_s": float(arr.mean()),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/out/serve.csv")
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--dev-iters", type=int, default=200)
    ap.add_argument("--artifact-dir", default="experiments/out/artifacts")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax

    from hypergef import serve
    from hypergef.data.synthetic import homophilic_hypergraph, random_features
    from hypergef.train import TrainConfig, Trainer, rand_train_test_idx

    os.makedirs(args.artifact_dir, exist_ok=True)
    header = (
        "workload,nnz,feat,backend,export_s,artifact_mb,load_s,first_call_s,"
        "warm_ms_median,warm_ms_p95,qps,direct_ms_median,"
        "dev_us_forward,dev_us_direct,parity_max_abs"
    )
    # appending under a schema change silently misaligns columns
    # (advisor r4): verify the existing header matches the driver's; if
    # not, move the stale file aside and start fresh.
    if os.path.exists(args.out):
        with open(args.out) as fh:
            old_header = fh.readline().strip()
        if old_header != header:
            stale = args.out + ".stale"
            os.replace(args.out, stale)
            print(f"stale header in {args.out} (moved to {stale}); "
                  f"starting fresh", flush=True)
    fresh = not os.path.exists(args.out)
    with open(args.out, "a") as f:
        if fresh:
            print(header, file=f, flush=True)
        failures = []
        for wname in args.workloads.split(","):
            n, e, ncls, avg, feat = WORKLOADS[wname]
            hg, y = homophilic_hypergraph(n, e, ncls, avg_edge_size=avg, seed=21)
            x, _ = random_features(hg.num_nodes, feat, ncls, seed=22)
            split = rand_train_test_idx(y, seed=23)
            cfg = TrainConfig(model="HGNN", nhid=32, epochs=args.epochs,
                              warmup=0, seed=24)
            tr = Trainer(cfg, hg, x, y)
            tr.fit(split["train"], epochs=args.epochs, warmup=0)
            backend = tr.plan.preferred_backend

            path = os.path.join(args.artifact_dir, f"{wname}.hgefsrv")
            t0 = time.perf_counter()
            meta = serve.export_trainer(tr, path)
            export_s = time.perf_counter() - t0
            mb = os.path.getsize(path) / 1e6

            t0 = time.perf_counter()
            m = serve.ServingModel.load(path)
            load_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            first = jax.block_until_ready(m.predict(x))
            first_call_s = time.perf_counter() - t0

            warm = _lat_stats(m.predict, x, args.calls)
            qps = 1.0 / max(warm["mean_s"], 1e-12)

            # no-serialization control: the live jitted forward
            direct_fn = jax.jit(
                lambda a: tr.model.apply({"params": tr.params}, a, tr.hgd,
                                         tr.plan, deterministic=True))
            jax.block_until_ready(direct_fn(x))  # compile outside timing
            direct = _lat_stats(direct_fn, x, args.calls)
            parity = float(np.max(np.abs(np.asarray(first) -
                                         np.asarray(direct_fn(x)))))

            # device time per forward, without host dispatch
            from hypergef.utils.timing import chain_fold, device_time_per_iter

            def dev_us(call):
                r = device_time_per_iter(
                    lambda a: chain_fold(call(a), a), x, iters=args.dev_iters)
                if r["per_iter_s"] <= 0 or r.get("noisy"):
                    r = device_time_per_iter(
                        lambda a: chain_fold(call(a), a), x,
                        iters=args.dev_iters * 5)
                return r["per_iter_s"] * 1e6

            dev_fwd = dev_us(m._call)
            dev_dir = dev_us(direct_fn)

            row = (f"{wname},{hg.nnz},{feat},{backend},{export_s:.2f},"
                   f"{mb:.2f},{load_s:.3f},{first_call_s:.2f},"
                   f"{warm['median_ms']:.3f},{warm['p95_ms']:.3f},"
                   f"{qps:.1f},{direct['median_ms']:.3f},"
                   f"{dev_fwd:.1f},{dev_dir:.1f},{parity:.2e}")
            # parity gates the row (advisor r4: a diverging artifact
            # must not persist unflagged), and a failure on one
            # workload must not truncate the sweep
            if parity >= 1e-4:
                failures.append(wname)
                row += ",PARITY_FAIL"
                print(f"{wname}: serving artifact diverges from live "
                      f"forward ({parity:.2e}) — row flagged", flush=True)
            print(row, flush=True)
            print(row, file=f, flush=True)
            del meta
    if failures:
        raise SystemExit(f"parity failures: {failures}")


if __name__ == "__main__":
    enable_compile_cache()
    main()
