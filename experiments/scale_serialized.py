"""100M-nnz halo layer, measured by serialized execution on one card.

Builds the real 8-shard HaloPlan of a 100M-nnz community graph and
executes all 8 shard programs back-to-back on one device
(``parallel/serial_halo.serialized_halo_forward``, oracle- and
shard_map-equivalence-tested), staging the two all_to_alls through the
host.  Reported:

* per-shard device compute, chained-fenced;
* the REAL exchange buffer sizes from the plan's masks — the link
  transfer term is the ONLY modeled quantity (``--link-gbps``, required:
  the card's data-sheet rate, e.g. 450 GB/s each way for H100 NVLink);
* total serialized wall time (staging + compute) for provenance.

Output: experiments/out/scale_serialized.csv
Run (long: graph gen + plan build are tens of minutes host-side):
    python -u experiments/scale_serialized.py --link-gbps 450
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np

from scale_aligned import big_sbm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20_000_000)
    ap.add_argument("--edges", type=int, default=10_000_000)
    ap.add_argument("--comm", type=int, default=40_000)
    ap.add_argument("--avg", type=float, default=10.0)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--link-gbps", type=float, required=True,
                    help="per-link bandwidth between cards (GB/s, one "
                    "direction; data sheet), recorded in the CSV")
    ap.add_argument("--out",
                    default="experiments/out/scale_serialized.csv")
    ap.add_argument("--plan-cache", default="experiments/out/plancache")
    ap.add_argument("--epoch", action="store_true",
                    help="also measure ONE serialized full train step "
                    "(fwd+loss+bwd+Adam) and append "
                    "an epoch row")
    ap.add_argument("--skip-layer", action="store_true",
                    help="skip the layer measurement (epoch-only rerun "
                    "against the cached plan)")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax.numpy as jnp

    from hypergef.parallel.halo import plan_halo
    from hypergef.parallel.serial_halo import (
        _shard_ops, serialized_halo_forward,
    )
    from hypergef.sparse.reorder import apply_vertex_order
    from hypergef.utils.timing import chain_fold, device_time_per_iter

    t0 = time.time()
    hg = big_sbm(args.nodes, args.edges, args.comm, args.avg, 0.01, 0)
    hg, _ = apply_vertex_order(hg, np.arange(hg.num_nodes), sort_edges=True)
    gen_s = time.time() - t0
    print(f"graph: nnz={hg.nnz} gen {gen_s:.0f}s", flush=True)

    t0 = time.time()
    # raised spill cap: at 12.5M-nnz shards the uniform interior pads
    # its spill table past the default 2^28 guard (~287M entries at 5%
    # spill); this host affords the bytes.  Content-keyed cache: the
    # 100M-nnz plan build is ~17 min host-side — cache it so a re-run
    # (e.g. after an OOM fix in the executor) re-measures in minutes.
    from hypergef.sparse.plancache import cached_plan_halo

    plan = cached_plan_halo(hg, args.shards, cache_dir=args.plan_cache,
                            local_form="aligned",
                            aligned_spill_limit=1 << 30)
    plan_s = time.time() - t0
    print(f"halo plan ({plan.local_form} interior): {plan_s:.0f}s, "
          f"comm_frac={plan.comm_fraction():.4f} "
          f"halo_frac={plan.halo_comm_fraction():.4f}", flush=True)

    x = np.random.default_rng(0).normal(
        size=(hg.num_nodes, args.feat)).astype(np.float32)

    rows = [
        "# 100M-nnz halo layer: serialized MEASUREMENT (one card, "
        "host-staged exchanges); link transfer is the only modeled term",
        "quantity,value,unit,provenance",
        f"graph_nnz,{hg.nnz},nnz,generated community graph "
        f"({args.nodes}x{args.edges} comm={args.comm})",
        f"plan_build,{plan_s:.0f},s,MEASURED host ({plan.local_form} "
        "interior)",
    ]

    if args.epoch:
        # serialized full train step: epoch = one
        # full-batch fwd+loss+bwd+Adam step (reference protocol)
        from hypergef.parallel.serial_halo_train import (
            serialized_halo_train_epochs,
        )

        ncls = 8
        y = np.random.default_rng(1).integers(
            0, ncls, size=hg.num_nodes).astype(np.int32)
        mask = (np.random.default_rng(2).random(hg.num_nodes) < 0.5
                ).astype(np.float32)
        est = {}
        t0 = time.time()
        params, losses = serialized_halo_train_epochs(
            plan, x, y, mask, nhid=args.feat, nclass=ncls, epochs=1,
            stats=est)
        ep_wall = time.time() - t0
        dev_s = float(np.sum(est.get("shard_s", [0.0])))
        print(f"serialized TRAIN EPOCH wall {ep_wall:.1f}s "
              f"(fwd layer-shard device+staging {dev_s:.1f}s) "
              f"loss {losses[0]:.4f}", flush=True)
        rows.append(
            f"train_epoch_wall,{ep_wall:.1f},s,MEASURED(serialized) one "
            "full-batch fwd+loss+bwd+Adam step on one chip incl host "
            "staging (2-layer HGNN nhid=%d)" % args.feat)
        rows.append(
            f"train_epoch_loss,{losses[0]:.4f},nll,sanity (finite, "
            f"~ln({ncls})={np.log(ncls):.2f} at init)")

    if args.skip_layer:
        with open(args.out, "a" if args.epoch else "w") as fh:
            fh.write("\n".join(rows) + "\n")
        print("\n".join(rows), flush=True)
        return

    # full serialized layer (output sanity + wall provenance + buffers)
    stats = {}
    t0 = time.time()
    out = serialized_halo_forward(plan, x, stats=stats)
    wall_s = time.time() - t0
    assert np.isfinite(out).all()
    print(f"serialized layer wall {wall_s:.1f}s; "
          f"halo {stats['halo_bytes_real']/1e6:.1f} MB, "
          f"return {stats['return_bytes_real']/1e6:.1f} MB", flush=True)

    # honest chained per-shard compute (shard 0 — all shards share one
    # program shape by construction)
    import jax

    from hypergef.parallel.serial_halo import _edge_stage
    from hypergef.ops.tree import apply_levels

    D, f = plan.n_shards, args.feat
    b_cap_h = plan.halo_send_slot.shape[2]
    from hypergef.parallel.halo_aggr import shard_vertex_features

    xs = shard_vertex_features(plan, x).reshape(D, plan.n_own, f)
    halo_in0 = np.zeros((D, b_cap_h, f), np.float32)

    def step(x_blk, halo_in_d, ops):
        x_t = jnp.take(halo_in_d.reshape(D * b_cap_h, f), ops["halo_idx"],
                       axis=0)
        xe = _edge_stage(plan, x_blk, x_t, ops, "sum", jnp)
        xe = xe * ops["degE"]
        part = apply_levels(xe, ops["v_levels"], ops["v_fi"], ops["v_fm"])
        return chain_fold(part[: x_blk.shape[0]], x_blk)

    ops0 = _shard_ops(plan, 0, jnp)
    r = device_time_per_iter(step, jnp.asarray(xs[0]), iters=args.iters,
                             operands=(jnp.asarray(halo_in0), ops0))
    t_shard = r["per_iter_s"]
    shard_nnz = hg.nnz / D
    print(f"chained shard compute: {t_shard*1e3:.2f} ms "
          f"({t_shard/shard_nnz*1e9:.2f} ns/nnz, compile {r['compile_s']:.0f}s)",
          flush=True)

    # link model on REAL buffer sizes (the only modeled term left)
    t_link = (stats["halo_bytes_real"] + stats["return_bytes_real"]) / (
        args.shards * args.link_gbps * 1e9
    )
    t_layer = t_shard + t_link
    rows += [
        f"shard_compute,{t_shard*1e3:.3f},ms,MEASURED(serialized) chained "
        f"on {jax.devices()[0].device_kind}; all {args.shards} shards "
        "share this program shape",
        f"shard_ns_per_nnz,{t_shard/shard_nnz*1e9:.3f},ns/nnz,MEASURED(serialized)",
        f"halo_buffer,{stats['halo_bytes_real']/1e6:.1f},MB,REAL plan mask sum",
        f"return_buffer,{stats['return_bytes_real']/1e6:.1f},MB,REAL plan mask sum",
        f"link_transfer,{t_link*1e3:.3f},ms,MODELED {args.link_gbps} GB/s/link "
        "over real buffer bytes",
        f"layer_100M,{t_layer*1e3:.3f},ms,MEASURED(serialized) shard compute "
        "+ modeled link only",
        f"aggregate_ns_per_nnz,{t_layer / hg.nnz * 1e9:.3f},ns/nnz,"
        f"layer time / total nnz ({args.shards}-card throughput)",
        f"serialized_wall,{wall_s:.1f},s,full layer on one card incl. host "
        "staging (provenance)",
    ]
    with open(args.out, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    print("\n".join(rows), flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
