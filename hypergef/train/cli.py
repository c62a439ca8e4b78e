"""Training CLI — parity with the reference driver ``HyperGsys/hgsys.py``.

Same flag surface (hgsys.py:22-70) plus this framework's options
(backend, mesh, minibatch, export).  Outputs the same CSV row schema (hgsys.py:207-211)
when ``--output`` is given.

Usage:
    python -m hypergef.train.cli --dname cora --model HGNN --backend auto
    python -m hypergef.train.cli --synthetic powerlaw --n 5000 --e 3000
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse(argv=None):
    p = argparse.ArgumentParser(description="hypergef trainer")
    # reference surface (hgsys.py:22-70)
    p.add_argument("--dname", default="walmart-trips")
    p.add_argument("--model", type=str, default="HGNN",
                   help="HGNN | UniGIN | UniGCNII")
    p.add_argument("--data-path", type=str, default="data/")
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--activation", type=str, default="relu")
    p.add_argument("--nlayer", type=int, default=2)
    p.add_argument("--first-aggr", type=str, default="sum",
                   choices=["sum", "mean", "max"])
    p.add_argument("--nhid", type=int, default=32)
    p.add_argument("--nhead", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.6)
    p.add_argument("--input-drop", type=float, default=0.6)
    p.add_argument("--feature_noise", default="1", type=str)
    p.add_argument("--train_prop", type=float, default=0.5)
    p.add_argument("--valid_prop", type=float, default=0.25)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--wd", type=float, default=5e-4)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--profile", type=int, default=0)
    # extensions beyond the reference surface
    p.add_argument("--tune", action="store_true",
                   help="measured per-graph backend/parameter autotune "
                        "(sparse/autotune.py) with persistent cache — the "
                        "reference's partition_dict, measured not hard-coded")
    p.add_argument("--backend", type=str, default="auto",
                   help="auto|xla|cumsum|ell|tree|dense|bsr|precomp|"
                        "multihot|aligned")
    p.add_argument("--plan-cache", type=str, default=None, nargs="?",
                   const="",
                   help="persist built plans to this directory keyed by "
                        "graph content (no DIR: the default user cache); "
                        "reruns skip the host schedule build entirely")
    p.add_argument("--platform", type=str, default=None,
                   help="force jax platform (e.g. cpu)")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="after training, AOT-export the forward pass as a "
                        "self-contained serving artifact (hypergef.serve)")
    p.add_argument("--export-platforms", type=str, default=None,
                   help="comma-separated lowering platforms for --export "
                        "(e.g. cuda,cpu); default: the training platform")
    p.add_argument("--validate-parity", action="store_true",
                   help="real-data readiness check: load --dname from "
                        "--data-path, verify format/shape/oracle/accuracy "
                        "against the published AllSet record "
                        "(hypergef.data.parity), exit nonzero on FAIL")
    p.add_argument("--parity-record", type=str, default=None, metavar="JSON",
                   help="with --validate-parity: write raw-file sha256 "
                        "fingerprints + loaded stats to this JSON")
    p.add_argument("--minibatch-edges", type=int, default=0,
                   help=">0: train with hyperedge-sampled minibatches")
    p.add_argument("--shards", type=int, default=0,
                   help=">0: edge-partitioned distributed training over a mesh")
    p.add_argument("--feature-shards", type=int, default=1,
                   help="feature (tensor-parallel) mesh axis size")
    p.add_argument("--synthetic", type=str, default=None,
                   choices=[None, "random", "powerlaw", "homophilic"],
                   help="use a synthetic graph instead of --dname")
    p.add_argument("--n", type=int, default=5000)
    p.add_argument("--e", type=int, default=3000)
    p.add_argument("--feat", type=int, default=32)
    p.add_argument("--classes", type=int, default=5)
    return p.parse_args(argv)


def load_problem(args):
    from hypergef.data import synthetic

    if args.synthetic:
        if args.synthetic == "homophilic":
            hg, y = synthetic.homophilic_hypergraph(
                args.n, args.e, args.classes, seed=args.seed
            )
            x = np.random.default_rng(args.seed).normal(
                size=(args.n, args.feat)
            ).astype(np.float32)
        else:
            gen = (
                synthetic.powerlaw_hypergraph
                if args.synthetic == "powerlaw"
                else synthetic.random_hypergraph
            )
            hg = gen(args.n, args.e, seed=args.seed)
            x, y = synthetic.random_features(
                args.n, args.feat, args.classes, seed=args.seed
            )
        return hg, x, y
    from hypergef.data.datasets import load_dataset

    ds = load_dataset(args.dname, root=args.data_path,
                      feature_noise=float(args.feature_noise))
    hg = ds.hg
    if args.add_self_loop:
        from hypergef.data.transforms import add_self_loops

        hg = add_self_loops(hg)
    return hg, ds.features, ds.labels


def main(argv=None):
    args = parse(argv)
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from hypergef.utils.cache import enable_compile_cache

    enable_compile_cache()

    from hypergef.train import TrainConfig, rand_train_test_idx
    from hypergef.train.trainer import Trainer

    if args.validate_parity:
        from hypergef.data.parity import validate

        results = validate(
            args.dname, root=args.data_path,
            feature_noise=float(args.feature_noise),
            seed=args.seed, record=args.parity_record,
        )
        for r in results:
            print(r.line())
        failed = [r for r in results if r.status == "FAIL"]
        verdict = "FAIL" if failed else "PASS"
        print(f"parity[{args.dname}]: {verdict} "
              f"({sum(r.status == 'PASS' for r in results)} pass, "
              f"{len(failed)} fail, "
              f"{sum(r.status == 'SKIP' for r in results)} skip)")
        sys.exit(1 if failed else 0)
    if args.export and (args.profile or args.shards > 0):
        # --profile and --shards return before the export block below;
        # surface the skip up front rather than silently dropping the
        # artifact
        print("--export requires the full-batch trainer path "
              "(exported programs are full-graph forwards); skipped",
              file=sys.stderr)
        args.export = None
    hg, x, y = load_problem(args)
    print(hg)
    np.random.seed(args.seed)
    split = rand_train_test_idx(
        y, train_prop=args.train_prop, valid_prop=args.valid_prop, seed=args.seed
    )
    cfg = TrainConfig(
        model=args.model,
        nhid=args.nhid,
        nlayer=args.nlayer,
        nhead=args.nhead,
        first_aggr=args.first_aggr,
        dropout=args.dropout,
        input_drop=args.input_drop,
        activation=args.activation,
        lr=args.lr,
        wd=args.wd,
        epochs=args.epochs,
        seed=args.seed,
        backend=args.backend,
        tune=args.tune,
        plan_cache=args.plan_cache,
    )
    if args.profile:
        # reference --profile fast path (hgsys.py:146-159): time the raw
        # epoch loop without the warm-up/timed split, then report device
        # memory (the GPUtil.memoryUsed / cuda.memory_summary analogue,
        # hgsys.py:169-170,191)
        import time

        tr = Trainer(cfg, hg, x, y)
        t0 = time.perf_counter()
        res = tr.fit(split["train"], epochs=args.epochs, warmup=0)
        print(f"epoch time: {time.perf_counter() - t0:.4f}")
        stats = getattr(jax.local_devices()[0], "memory_stats", lambda: None)()
        if stats:
            used = stats.get("bytes_in_use", 0) / 1e6
            peak = stats.get("peak_bytes_in_use", 0) / 1e6
            print(f"device memory: {used:.1f} MB in use, {peak:.1f} MB peak")
        return res
    if args.shards > 0:
        from hypergef.parallel.trainer import DistTrainer

        tr = DistTrainer(
            hg, x, y, nhid=args.nhid, n_shards=args.shards,
            n_feature=args.feature_shards, lr=args.lr, wd=args.wd,
            seed=args.seed, model=args.model, first_aggr=args.first_aggr,
        )
        res = tr.fit(split["train"], epochs=args.epochs)
        res.update(tr.evaluate(split))
        print(f"distributed ({res['n_shards']} shards): "
              f"avg epoch time {res['train_epoch_time_s']:.6f}")
        for k in ("train_acc", "valid_acc", "test_acc", "final_loss"):
            if k in res:
                print(f"{k}: {res[k]:.4f}")
        return res
    if args.minibatch_edges > 0:
        from hypergef.train.minibatch import MinibatchTrainer

        tr = MinibatchTrainer(
            cfg, hg, x, y, split["train"], batch_edges=args.minibatch_edges
        )
        res = tr.fit(epochs=max(args.epochs // 10, 1))
        res.update(tr.evaluate_full(split))
        train_time = res["time_s"] / max(res["batches"], 1)
        infer_time = float("nan")
    else:
        tr = Trainer(cfg, hg, x, y)
        res = tr.fit(split["train"])
        res["inference_time_s"] = tr.time_inference(iters=max(args.epochs // 2, 1))
        res.update(tr.evaluate(split))
        train_time = res["train_epoch_time_s"]
        infer_time = res["inference_time_s"]
    if args.export and isinstance(tr, Trainer):
        from hypergef import serve

        plats = (
            [s.strip() for s in args.export_platforms.split(",") if s.strip()]
            if args.export_platforms else None
        )
        meta = serve.export_trainer(tr, args.export, platforms=plats)
        print(f"exported serving artifact: {args.export} "
              f"({meta['payload_bytes']} bytes, platforms={meta['platforms']})")
        res["export_path"] = args.export
    elif args.export:
        print("--export requires the full-batch trainer path "
              "(exported programs are full-graph forwards); skipped",
              file=sys.stderr)
    backend = cfg.backend
    print(f"backend {backend}: avg epoch time {train_time:.6f}")
    for k in ("train_acc", "valid_acc", "test_acc", "final_loss"):
        if k in res:
            print(f"{k}: {res[k]:.4f}" if isinstance(res[k], float) else f"{k}: {res[k]}")
    if args.output:
        # CSV row schema of hgsys.py:207-211
        with open(args.output, "a") as f:
            print(
                f"{backend},{args.model},{args.dname},nlayer={args.nlayer},"
                f" nhid={args.nhid}, nhead={args.nhead},"
                f"first_aggr={args.first_aggr},{train_time},{infer_time}",
                file=f,
            )
    return res


if __name__ == "__main__":
    main()
