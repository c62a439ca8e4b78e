"""Smoke test of the system's main paths on an NVIDIA GPU.

    python chip_smoke.py             # phases 1-6 on one card
    python chip_smoke.py --cards 4   # phase 7 only: the multi-card paths

Phases, at the widths of the configurations the repository benchmarks:

1. device     platform, device kind, count; card name and power limit.
2. train      the 20news-shaped HGNN (16,242 x 100, avg edge 654.5,
              100 features, 4 classes, nhid 32, 2 layers, backend auto)
              through ``Trainer.fit`` + ``evaluate``, and the CLI.
3. reference  5 train steps, backend auto vs the ``xla`` oracle, from the
              same parameters and dropout key.
4. backends   every backend of ``ops.fused._VALID`` against ``refops``
              (HGNN sum/mean/max and UniGNN, forward and gradient) on the
              pubmed_real box and the clustered SBM-60k graph, plus the
              packed-int4 dense table.
5. models     one train step each of UniGIN and UniGCNII (PReLU).
6. serve      export for ``cuda``, load, predict.
7. --cards 4  DistTrainer step, halo train step and the sharded dense
              layer on a 4x1 mesh, each against the single-device oracle.

Every phase compares with the repository's plain reference and raises on
a mismatch.  The script never falls back to the CPU: it exits non-zero
before any phase when JAX reports no GPU.  The last line of its output
is one JSON object, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, as max|got - ref| / max|ref| over the whole output.
# bf16 backends (dense, precomp, aligned, multihot, bsr) cast matmul
# operands to bf16 by design and accumulate in f32: the reference's own
# check holds such kernels to 1e-2; two layers and a gradient widen it.
BF16_TOL = 2e-2
# f32 backends (xla, ell, tree) differ from the oracle only in summation
# order (atomic adds, tree levels).
F32_TOL = 1e-4
# cumsum takes segment sums as differences of a running f32 prefix, so
# its error grows with |prefix| (eps x nnz x value scale): 4.1e-3 for the
# max first stage on SBM-60k (CPU run), hence its own bound.
CUMSUM_TOL = 1e-2
# train-step losses and forwards through whole models: Adam normalises
# each update, so bf16 rounding in the aggregation reaches the loss at
# the bf16 level, not below it.
MODEL_TOL = 2e-2
BF16_BACKENDS = ("dense", "precomp", "aligned", "multihot", "bsr")

NEWS20 = dict(n=16242, e=100, avg=654.5, feat=100, classes=4, nhid=32)
PUBMED_REAL = dict(n=19717, e=7963, avg=10.8)
SBM60K = dict(n=60000, e=30000, comm=240, avg=12, noise=0.02)
CORA = dict(n=2708, e=2708, avg=4.0)
CLI_ARGS = ["--synthetic", "homophilic", "--n", "5000", "--e", "3000",
            "--epochs", "5"]


class PhaseFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise PhaseFailed(f"shape {got.shape} != reference {want.shape}")
    if not np.isfinite(got).all():
        raise PhaseFailed("non-finite values")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check(name: str, got, want, tol: float) -> float:
    err = rel_err(got, want)
    log(f"  {name}: rel err {err:.3e} (tol {tol:.0e})")
    if err > tol:
        raise PhaseFailed(f"{name}: rel err {err:.3e} > {tol:.0e}")
    return err


def highest():
    import jax

    return jax.default_matmul_precision("highest")


# ----------------------------------------------------------------------
# graphs
# ----------------------------------------------------------------------
def news20_problem(shape=NEWS20):
    from hypergef.data.synthetic import random_features, random_hypergraph
    from hypergef.train import rand_train_test_idx

    hg = random_hypergraph(shape["n"], shape["e"], avg_edge_size=shape["avg"],
                           seed=0, name="news20")
    x, y = random_features(hg.num_nodes, shape["feat"], shape["classes"], seed=1)
    return hg, x, y, rand_train_test_idx(y, seed=2)


def random_graph(shape, name):
    from hypergef.data.synthetic import random_hypergraph

    return random_hypergraph(shape["n"], shape["e"], avg_edge_size=shape["avg"],
                             seed=0, name=name)


def sbm_graph(shape=SBM60K):
    """Community graph from shuffled raw ids, reordered by coarsening
    (the clustered benchmark cell's pipeline)."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from experiments.clustered_bench import community_hypergraph
    from hypergef.sparse.reorder import apply_vertex_order, community_reorder

    hg = community_hypergraph(shape["n"], shape["e"], shape["comm"], shape["avg"],
                              shape["noise"], 0)
    perm = np.random.default_rng(7).permutation(hg.num_nodes)
    hg, _ = apply_vertex_order(hg, perm, sort_edges=False)
    hg, _ = community_reorder(hg, method="coarsen")
    return hg


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def device_phase(platform: str = "gpu", query_smi: bool = True) -> dict:
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[device] {info}")
    if info["platform"] != platform:
        raise PhaseFailed(f"JAX reports platform {info['platform']!r}, "
                          f"not {platform!r}")
    if query_smi:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        for line in out.stdout.strip().splitlines():
            log(f"[device] nvidia-smi: {line}")
    return info


def train_phase(shape=NEWS20, epochs=5, warmup=2, cli_args=CLI_ARGS) -> dict:
    import jax
    import numpy as np

    from hypergef.train import TrainConfig, Trainer
    from hypergef.train import cli

    hg, x, y, split = news20_problem(shape)
    cfg = TrainConfig(model="HGNN", nhid=shape["nhid"], nlayer=2, backend="auto",
                      epochs=epochs, warmup=warmup)
    tr = Trainer(cfg, hg, x, y)
    log(f"[train] {hg}; auto backend -> {tr.plan.preferred_backend}")
    res = tr.fit(split["train"], epochs=epochs, warmup=warmup)
    acc = tr.evaluate(split)
    log(f"[train] fit: {res}; evaluate: {acc}")
    if not np.isfinite(res["final_loss"]):
        raise PhaseFailed(f"train loss {res['final_loss']}")
    idx = jax.numpy.asarray(np.asarray(split["train"]), dtype=jax.numpy.int32)
    compiled = tr._train_step.lower(tr.params, tr.opt_state, jax.random.key(0),
                                    idx, tr.x, tr.y).compile()
    log(f"[train] train step memory_analysis: {compiled.memory_analysis()}")
    cres = cli.main(list(cli_args))
    log(f"[train] cli: final_loss {cres['final_loss']}")
    if not np.isfinite(cres["final_loss"]):
        raise PhaseFailed(f"cli loss {cres['final_loss']}")
    return {"backend": tr.plan.preferred_backend, "loss": res["final_loss"]}


def _losses(tr, params, opt_state, idx, steps):
    import jax

    rng = jax.random.key(7)
    losses = []
    for _ in range(steps):
        params, opt_state, rng, loss = tr._train_step(params, opt_state, rng, idx,
                                                      tr.x, tr.y)
        losses.append(float(loss))
    return losses, params


def compare_models(name, cfg_kw, problem, steps, tol=MODEL_TOL) -> dict:
    """``steps`` train steps of the auto backend against the xla oracle
    (under highest matmul precision), from one init and one dropout key;
    then both forwards at the oracle's final parameters.  (Adam
    normalises each update, so a parameter whose gradient is near zero
    can step either way under bf16 rounding: forwards at the two
    backends' own final parameters would measure that divergence, which
    the loss comparison already bounds, rather than the backend.)"""
    import jax
    import numpy as np

    from hypergef.train import TrainConfig, Trainer

    hg, x, y, split = problem
    idx = jax.numpy.asarray(np.asarray(split["train"]), dtype=jax.numpy.int32)
    tr = Trainer(TrainConfig(backend="auto", **cfg_kw), hg, x, y)
    with highest():
        ref = Trainer(TrainConfig(backend="xla", **cfg_kw), hg, x, y)
        ref_losses, ref_params = _losses(ref, tr.params, tr.opt_state, idx, steps)
        ref_out = ref._forward(ref_params, ref.x)
    losses, _ = _losses(tr, tr.params, tr.opt_state, idx, steps)
    out = tr._forward(ref_params, tr.x)
    log(f"  {name} losses auto {np.round(losses, 5).tolist()} "
        f"xla {np.round(ref_losses, 5).tolist()}")
    return {"loss": check(f"{name} losses", losses, ref_losses, tol),
            "forward": check(f"{name} forward", out, ref_out, tol)}


def reference_phase(shape=NEWS20, steps=5) -> dict:
    log("[reference] HGNN, backend auto vs xla")
    return compare_models(
        "HGNN", dict(model="HGNN", nhid=shape["nhid"], nlayer=2),
        news20_problem(shape), steps)


def models_phase(shape=NEWS20) -> dict:
    problem = news20_problem(shape)
    log("[models] UniGIN and UniGCNII (prelu), backend auto vs xla")
    return {
        "UniGIN": compare_models(
            "UniGIN", dict(model="UniGIN", nhid=shape["nhid"]), problem, 1),
        "UniGCNII": compare_models(
            "UniGCNII", dict(model="UniGCNII", nhid=shape["nhid"],
                             activation="prelu"), problem, 1),
    }


def backend_plans(hg) -> dict:
    """Each backend's plan, built explicitly; a plan whose own guard
    refuses the graph maps to the reason."""
    from hypergef.sparse import planner
    from hypergef.sparse.bsr import plan_bsr

    base = planner.plan_aggregation(hg, with_tile=True, with_multihot=True)
    plans = {"xla": None, "cumsum": base, "ell": base, "tree": base}
    ne = hg.num_nodes * hg.num_edges
    if base.dense is None and ne <= planner.DENSE_STREAM_MAX_ENTRIES:
        base.dense = planner.DenseIncidence.from_hypergraph(hg)
    plans["dense"] = base if base.dense is not None else (
        f"N*E = {ne} > DENSE_STREAM_MAX_ENTRIES")
    try:
        base.bsr = plan_bsr(hg, reorder=True)
        plans["bsr"] = base
    except MemoryError as e:
        plans["bsr"] = f"plan_bsr memory guard: {e}"
    if base.precomp is None and hg.num_nodes ** 2 <= planner.PRECOMP_MAX_ENTRIES:
        base.precomp = planner.DensePrecomp.from_hypergraph(hg)
    plans["precomp"] = base if base.precomp is not None else (
        f"N^2 = {hg.num_nodes ** 2} > PRECOMP_MAX_ENTRIES")
    plans["multihot"] = base if base.multihot is not None else (
        "plan_multihot padding guard")
    if base.aligned is None:
        try:
            base.aligned = planner.plan_aligned(hg)
        except (ValueError, MemoryError) as e:
            plans["aligned"] = f"plan_aligned guard: {str(e).splitlines()[0]}"
    if base.aligned is not None:
        plans["aligned"] = base
    return plans


def _agg_fns(backend, plan, ref):
    """{variant: jitted (out, dx) of vdot(out, cot)} for one backend."""
    import jax
    import jax.numpy as jnp

    from hypergef.ops import fused, refops

    def make(kind, arg):
        def f(x, cot, hgd):
            def loss(xv):
                if ref:
                    if kind == "hgnn":
                        out = refops.hgnn_aggregate_ref(hgd, xv, None, arg)
                    else:
                        out = refops.unignn_aggregate_ref(hgd, xv, arg)
                elif kind == "hgnn":
                    out = fused.hgnn_aggregate(hgd, xv, None, arg, plan=plan,
                                               backend=backend)
                else:
                    out = fused.unignn_aggregate(hgd, xv, arg, plan=plan,
                                                 backend=backend)
                return jnp.vdot(out, cot), out

            (_, out), dx = jax.value_and_grad(loss, has_aux=True)(x)
            return out, dx

        return jax.jit(f)

    return {"hgnn_sum": make("hgnn", "sum"), "hgnn_mean": make("hgnn", "mean"),
            "hgnn_max": make("hgnn", "max"), "unignn_deg": make("unignn", True)}


def check_backends(gname, hg, plans, feat=32) -> dict:
    import jax.numpy as jnp
    import numpy as np

    hgd = hg.device_data()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(hg.num_nodes, feat)).astype(np.float32))
    cot = jnp.asarray(rng.normal(size=(hg.num_nodes, feat)).astype(np.float32))
    with highest():
        refs = {k: f(x, cot, hgd)
                for k, f in _agg_fns("xla", None, True).items()}
    errs = {}
    for backend, plan in plans.items():
        if isinstance(plan, str):
            log(f"  {gname}/{backend}: refused by its plan ({plan}); "
                "run on the graph it accepts")
            continue
        tol = (BF16_TOL if backend in BF16_BACKENDS
               else CUMSUM_TOL if backend == "cumsum" else F32_TOL)
        t0 = time.time()
        for variant, f in _agg_fns(backend, plan, False).items():
            out, dx = f(x, cot, hgd)
            want_out, want_dx = refs[variant]
            errs[f"{backend}/{variant}"] = max(
                check(f"{gname}/{backend}/{variant} fwd", out, want_out, tol),
                check(f"{gname}/{backend}/{variant} grad", dx, want_dx, tol))
        log(f"  {gname}/{backend}: {time.time() - t0:.1f}s")
    return errs


def packed_int4_check(hg, feat=32) -> float:
    """The packed-int4 dense table through the dense backend."""
    import jax.numpy as jnp
    import numpy as np

    from hypergef.ops import fused, refops
    from hypergef.sparse import planner

    plan = planner.AggregationPlan(
        tree=None, dense=planner.DenseIncidence.from_hypergraph(hg, dtype=jnp.int4))
    hgd = hg.device_data()
    x = jnp.asarray(np.random.default_rng(1).normal(
        size=(hg.num_nodes, feat)).astype(np.float32))
    out = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="dense")
    with highest():
        want = refops.hgnn_aggregate_ref(hgd, x, None, "sum")
    return check("packed int4 dense", out, want, BF16_TOL)


def backends_phase(pubmed=PUBMED_REAL, sbm=SBM60K, cora=CORA, feat=32) -> dict:
    from hypergef.ops import fused

    names = [b for b in fused._VALID if b != "auto"]
    graphs = [("pubmed_real", random_graph(pubmed, "pubmed_real")),
              ("sbm60k", sbm_graph(sbm))]
    errs, covered = {}, set()
    for gname, hg in graphs:
        t0 = time.time()
        plans = backend_plans(hg)
        log(f"[backends] {gname}: {hg}; plans built in {time.time() - t0:.1f}s")
        e = check_backends(gname, hg, plans, feat)
        errs.update({f"{gname}/{k}": v for k, v in e.items()})
        covered |= {k.split("/")[0] for k in e}
    missing = [b for b in names if b not in covered]
    if missing:
        hg = random_graph(cora, "cora")
        plans = backend_plans(hg)
        log(f"[backends] cora-shaped {hg} for {missing}")
        e = check_backends("cora", hg, {b: plans[b] for b in missing}, feat)
        errs.update({f"cora/{k}": v for k, v in e.items()})
        covered |= {k.split("/")[0] for k in e}
    if set(names) - covered:
        raise PhaseFailed(f"backends never run: {sorted(set(names) - covered)}")
    errs["packed_int4"] = packed_int4_check(graphs[0][1], feat)
    return errs


def serve_phase(shape=NEWS20, platforms=("cuda",)) -> float:
    import numpy as np

    from hypergef import serve
    from hypergef.train import TrainConfig, Trainer

    hg, x, y, split = news20_problem(shape)
    tr = Trainer(TrainConfig(model="HGNN", nhid=shape["nhid"], epochs=2, warmup=0),
                 hg, x, y)
    tr.fit(split["train"])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.hgefsrv")
        meta = serve.export_trainer(tr, path, platforms=list(platforms))
        log(f"[serve] exported {meta['payload_bytes']} bytes for {meta['platforms']}")
        got = serve.ServingModel.load(path).predict(np.asarray(x))
    return check("served forward vs live forward", got,
                 tr._forward(tr.params, tr.x), MODEL_TOL)


# ----------------------------------------------------------------------
# phase 7: four cards
# ----------------------------------------------------------------------
def _oracle_hgnn_loss(nclass):
    import jax
    import jax.numpy as jnp

    from hypergef.ops import refops

    def loss(params, x, y, mask, hgd):
        h = jax.nn.relu(refops.hgnn_aggregate_ref(hgd, x @ params["W1"], None, "sum"))
        z = refops.hgnn_aggregate_ref(hgd, h @ params["W2"], None, "sum")[:, :nclass]
        logp = jax.nn.log_softmax(z, axis=1)
        picked = jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return -jnp.sum(picked * mask) / jnp.maximum(mask.sum(), 1.0)

    return loss


def _spread(name, arrays, n_dev):
    import jax

    for a in jax.tree_util.tree_leaves(arrays):
        if len(a.sharding.device_set) != n_dev:
            raise PhaseFailed(f"{name}: an array lives on {a.sharding.device_set}, "
                              f"not on all {n_dev} devices")
    log(f"  {name}: every array spans all {n_dev} devices")


def multicard_phase(sbm=SBM60K, n_cards=4, feat=32, nhid=32, classes=8) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypergef.data.synthetic import random_features
    from hypergef.ops import refops
    from hypergef.parallel import make_mesh, plan_sharded_dense
    from hypergef.parallel import sharded_dense_hgnn_aggregate
    from hypergef.parallel.dist_model import init_dist_params
    from hypergef.parallel.halo import plan_halo
    from hypergef.parallel.halo_aggr import (
        make_halo_train_step, shard_vertex_features)
    from hypergef.parallel.trainer import DistTrainer

    if len(jax.devices()) < n_cards:
        raise PhaseFailed(f"{n_cards} cards requested, JAX sees {len(jax.devices())}")
    hg = sbm_graph(sbm)
    x, y = random_features(hg.num_nodes, feat, classes, seed=1)
    hgd = hg.device_data()
    mask = (np.random.default_rng(2).random(hg.num_nodes) < 0.5).astype(np.float32)
    xj, yj, mj = jnp.asarray(x), jnp.asarray(y, dtype=jnp.int32), jnp.asarray(mask)
    oracle = jax.jit(jax.value_and_grad(_oracle_hgnn_loss(classes)))
    out = {}
    log(f"[cards] {hg} on a {n_cards}x1 mesh")
    with highest():
        # DistTrainer (replicated-X edge partition + psum)
        tr = DistTrainer(hg, x, y, nhid=nhid, n_shards=n_cards, seed=3)
        p0 = tr.params
        want_l, want_g = oracle(p0, xj, yj, mj, hgd)
        params, _, loss = tr.step(p0, tr.opt_state, tr.x, tr.y, mj)

        def dist_loss(p):
            logp = tr.forward(p, tr.x)
            picked = jnp.take_along_axis(logp, tr.y[:, None], axis=1)[:, 0]
            return -jnp.sum(picked * mj) / jnp.maximum(mj.sum(), 1.0)

        g = jax.jit(jax.grad(dist_loss))(p0)
        out["dist_loss"] = check("DistTrainer step loss", [float(loss)],
                                 [float(want_l)], F32_TOL)
        out["dist_grad"] = max(check(f"DistTrainer grad {k}", g[k], want_g[k], F32_TOL)
                               for k in ("W1", "W2"))
        _spread("DistTrainer step outputs", (params, tr.forward(params, tr.x)), n_cards)

        # fully-sharded halo train step (owner layout, two all_to_alls)
        mesh = make_mesh(n_cards, 1, devices=jax.devices()[:n_cards])
        plan = plan_halo(hg, n_cards)
        step, tx, forward = make_halo_train_step(mesh, plan, nclass=classes)
        hp = init_dist_params(jax.random.key(3), feat, nhid, classes)
        x_own = jnp.asarray(shard_vertex_features(plan, x))
        y_own = jnp.asarray(shard_vertex_features(plan, np.asarray(y)[:, None])[:, 0])
        m_own = jnp.asarray(shard_vertex_features(plan, mask[:, None])[:, 0])
        want_l, want_g = oracle(hp, xj, yj, mj, hgd)
        new_hp, _, hloss = step(hp, tx.init(hp), x_own, y_own, m_own)

        def halo_loss(p):
            logp = forward(p, x_own)
            picked = jnp.take_along_axis(logp, y_own[:, None], axis=1)[:, 0]
            return -jnp.sum(picked * m_own) / jnp.maximum(m_own.sum(), 1.0)

        hg_ = jax.jit(jax.grad(halo_loss))(hp)
        out["halo_loss"] = check("halo step loss", [float(hloss)], [float(want_l)],
                                 F32_TOL)
        out["halo_grad"] = max(check(f"halo grad {k}", hg_[k], want_g[k], F32_TOL)
                               for k in ("W1", "W2"))
        _spread("halo step outputs", (new_hp, forward(new_hp, x_own)), n_cards)

    # sharded int8 dense layer (bf16 operands by design)
    dplan = plan_sharded_dense(hg, n_cards)
    degV = jnp.asarray(hg.degV)
    cot = jnp.asarray(np.random.default_rng(4).normal(
        size=(hg.num_nodes, feat)).astype(np.float32))

    def dense_obj(xv):
        o = sharded_dense_hgnn_aggregate(dplan, mesh, xv, None, "sum", degV=degV)
        return jnp.vdot(o, cot), o

    (_, dout), dgrad = jax.jit(jax.value_and_grad(dense_obj, has_aux=True))(xj)
    def ref_obj(xv, hgd):
        o = refops.hgnn_aggregate_ref(hgd, xv, None, "sum")
        return jnp.vdot(o, cot), o

    with highest():
        (_, rout), rgrad = jax.jit(jax.value_and_grad(ref_obj, has_aux=True))(xj, hgd)
    out["dense_fwd"] = check("sharded dense forward", dout, rout, BF16_TOL)
    out["dense_grad"] = check("sharded dense grad", dgrad, rgrad, BF16_TOL)
    _spread("sharded dense outputs", (dout, dgrad), n_cards)
    return out


# ----------------------------------------------------------------------
def run(cards: int, platform: str = "gpu") -> dict:
    info = device_phase(platform, query_smi=(platform == "gpu"))
    sys.path.insert(0, ROOT)
    from hypergef.utils.cache import enable_compile_cache

    log(f"[device] compile cache: {enable_compile_cache()}")
    if cards > 1:
        phases = [("cards", lambda: multicard_phase(n_cards=cards))]
    else:
        phases = [("train", train_phase), ("reference", reference_phase),
                  ("backends", backends_phase), ("models", models_phase),
                  ("serve", serve_phase)]
    for name, fn in phases:
        t0 = time.time()
        fn()
        log(f"[{name}] passed in {time.time() - t0:.1f}s")
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phase, on four cards")
    args = ap.parse_args(argv)
    try:
        info = run(args.cards)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
