"""Minibatch-path perf artifact (BASELINE config #4).

The reference has no sampled/minibatch path at all — its e2e protocol
(``hgsys.py:146-211``: warm-up + timed epochs + accuracy) is the bar
this driver applies to the capability the reference lacks.  For each
workload it measures, interleaved in one process:

* **full-batch** (the reference-style path): device-honest epoch time +
  wall-clock time/epochs until the valid accuracy reaches a band;
* **minibatch** (hyperedge-sampled, fixed bucket shapes): batches/s,
  wall-clock time to the same band, and the jitted step's compile count
  (the no-per-batch-recompile guarantee, asserted == small).

Band protocol: train full-batch to ``--epochs`` first, take its final
valid accuracy A*, band = 0.95·A*; then re-train each path fresh,
evaluating every eval-interval, and record the first time/epoch where
valid ≥ band.  Wall-clock is the honest metric for the minibatch path
(host-in-loop sampling is part of the design).

Run:
    python experiments/minibatch_bench.py --out experiments/out/minibatch.csv
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np

WORKLOADS = {
    # name: (n, e, classes, avg_edge_size, feat)
    "pubmed_shaped": (19717, 7963, 3, 10.8, 64),
    "dblp_shaped": (41302, 22363, 6, 4.5, 64),
    "20news_shaped": (16242, 100, 4, 100.0, 64),
}


def time_to_band(fit_chunk, evaluate, band, max_units, unit_chunk):
    """Generic: call ``fit_chunk()`` (advances unit_chunk units), then
    ``evaluate()`` → valid acc; returns (units, wall_s, acc) at first
    acc ≥ band, or at max_units."""
    t0 = time.perf_counter()
    units = 0
    acc = 0.0
    while units < max_units:
        fit_chunk()
        units += unit_chunk
        acc = evaluate()
        if acc >= band:
            break
    return units, time.perf_counter() - t0, acc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/out/minibatch.csv")
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch-edges", type=int, default=512)
    ap.add_argument("--eval-every", type=int, default=10)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    from hypergef.data.synthetic import homophilic_hypergraph, random_features
    from hypergef.train import TrainConfig, Trainer, rand_train_test_idx
    from hypergef.train.minibatch import MinibatchTrainer

    header = (
        "workload,path,nnz,band_acc,reached_acc,units,unit,wall_s,"
        "rate,rate_unit,compile_count"
    )
    fresh = not os.path.exists(args.out)
    with open(args.out, "a") as f:
        if fresh:
            print(header, file=f, flush=True)
        for wname in args.workloads.split(","):
            n, e, ncls, avg, feat = WORKLOADS[wname]
            hg, y = homophilic_hypergraph(n, e, ncls, avg_edge_size=avg,
                                          seed=11)
            x, _ = random_features(hg.num_nodes, feat, ncls, seed=12)
            split = rand_train_test_idx(y, seed=13)
            cfg = lambda seed: TrainConfig(  # noqa: E731
                model="HGNN", nhid=32, epochs=args.epochs, warmup=0,
                seed=seed)

            # 1. calibration run: full-batch final valid acc → band
            tr0 = Trainer(cfg(1), hg, x, y)
            tr0.fit(split["train"], epochs=args.epochs, warmup=0)
            a_star = tr0.evaluate(split)["valid_acc"] / 100.0
            band = 0.95 * a_star
            print(f"{wname}: A*={a_star:.3f} band={band:.3f}", flush=True)

            # 2. full-batch fresh: time-to-band (wall clock, chunked)
            tr = Trainer(cfg(2), hg, x, y)
            ev = lambda: tr.evaluate(split)["valid_acc"] / 100.0  # noqa: E731
            units, wall, acc = time_to_band(
                lambda: tr.fit(split["train"], epochs=args.eval_every,
                               warmup=0),
                ev, band, args.epochs, args.eval_every,
            )
            # device-honest epoch rate for reference
            ep_t = tr.epoch_device_time(split["train"], iters=30)
            row = (f"{wname},full_batch,{hg.nnz},{band:.3f},{acc:.3f},"
                   f"{units},epochs,{wall:.2f},{1.0/max(ep_t,1e-12):.1f},"
                   f"epochs_per_s_device,1")
            print(row, flush=True)
            print(row, file=f, flush=True)

            # 3. minibatch fresh: time-to-band + batches/s + compiles
            mb = MinibatchTrainer(cfg(3), hg, x, y, split["train"],
                                  batch_edges=args.batch_edges)
            state = {"batches": 0, "time": 0.0}

            def mb_chunk():
                r = mb.fit(epochs=args.eval_every)
                state["batches"] += r["batches"]
                state["time"] += r["time_s"]

            mb_ev = lambda: mb.evaluate_full(split)["valid_acc"] / 100.0  # noqa: E731
            units, wall, acc = time_to_band(
                mb_chunk, mb_ev, band, args.epochs, args.eval_every,
            )
            bps = state["batches"] / max(state["time"], 1e-9)
            row = (f"{wname},minibatch_be{args.batch_edges},{hg.nnz},"
                   f"{band:.3f},{acc:.3f},{units},epochs,{wall:.2f},"
                   f"{bps:.1f},batches_per_s_wall,{mb.compile_count}")
            print(row, flush=True)
            print(row, file=f, flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
