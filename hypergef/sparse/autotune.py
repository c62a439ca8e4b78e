"""Measured autotuner: per-graph backend/parameter sweep with persistence.

The reference tunes its partition size by measuring a 21-candidate sweep
per dataset (``source/aggr_proto.cu:72-80``; driver loop
``include/hgnnAgg.cuh:1171-1209``) and hard-codes the winners in
``partition_dict`` (``HyperGsys/hypergraph.py:74-76``).  Round 1 replaced
the lookup table with an analytic model (:func:`planner.choose_ngs`) and
hard-coded backend crossovers; this module adds the measured layer:

* :func:`sweep` times every (backend, params) candidate on the current
  device with the honest fenced protocol (``utils/timing``), on the real
  fused op at the real feature width;
* results persist to ``~/.cache/hypergef/tune/<key>.json`` keyed by
  graph shape + device kind, so subsequent runs plan instantly;
* :func:`autotune_plan` returns an :class:`planner.AggregationPlan`
  whose ``preferred_backend`` (and per-backend parameters) come from the
  measurement instead of the static ladder.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np


def _default_cache_dir() -> str:
    return os.environ.get(
        "HYPERGEF_TUNE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "hypergef", "tune"),
    )


def graph_key(hg, feature_size: int) -> str:
    """Stable identity of a tuning problem: graph shape + degree
    histogram + feature width + device kind."""
    import jax

    deg_e = np.diff(np.asarray(hg.ht_indptr))
    deg_v = np.diff(np.asarray(hg.h_indptr))
    h = hashlib.sha1()
    h.update(
        json.dumps(
            {
                "n": int(hg.num_nodes),
                "e": int(hg.num_edges),
                "nnz": int(hg.nnz),
                "f": int(feature_size),
                "deg_e_q": [int(x) for x in np.percentile(deg_e, [0, 25, 50, 75, 100])]
                if deg_e.size
                else [],
                "deg_v_q": [int(x) for x in np.percentile(deg_v, [0, 25, 50, 75, 100])]
                if deg_v.size
                else [],
                "dev": jax.devices()[0].device_kind,
            },
            sort_keys=True,
        ).encode()
    )
    name = getattr(hg, "name", None) or "graph"
    return f"{name}-{h.hexdigest()[:12]}"


@dataclasses.dataclass
class TuneResult:
    backend: str
    params: dict
    per_iter_s: float


def default_candidates(hg) -> list:
    """Candidate list mirroring the reference's sweep breadth: the
    backend ladder x partition-size grid (their 21 ngs candidates,
    aggr_proto.cu:72-80, become the ngs/tile_rows grid here)."""
    cands = [
        ("cumsum", {}),
        ("tree", {"ngs": 2}),
        ("tree", {"ngs": 4}),
        ("tree", {"ngs": 8}),
        ("tree", {"ngs": 16}),
        ("tree", {"ngs": 32}),
    ]
    n_entries = hg.num_nodes * hg.num_edges
    from hypergef.sparse import planner as _plc

    # small-dense gate OR the int8 dense-stream regime — sweep it
    # wherever the table fits, with a 2x looser ratio than the ladder's
    # gate so the sweep can catch shapes the constants mis-price
    if n_entries <= 32_000_000 or (
        n_entries <= _plc.DENSE_STREAM_MAX_ENTRIES
        and n_entries < 2 * _plc.DENSE_STREAM_VS_GATHER * max(hg.nnz, 1)
    ):
        cands.append(("dense", {}))
    if hg.num_nodes * hg.num_nodes <= 80_000_000:
        cands.append(("precomp", {}))
    for tr in (128, 256, 512):
        cands.append(("multihot", {"tile_rows": tr}))
        cands.append(("multihot", {"tile_rows": tr, "form": "multihot_precomp"}))
    from hypergef.sparse import planner as _pl

    spill = max(
        _pl.aligned_spill_stats(hg.ht_indptr, hg.ht_indices, hg.num_nodes,
                                window_blocks=8),
        _pl.aligned_spill_stats(hg.h_indptr, hg.h_indices, hg.num_edges,
                                window_blocks=8),
    )
    if spill <= 0.3:  # community-sorted graphs only (cheap pre-pass)
        cands.append(("aligned", {}))
    return cands


def _build_plan(hg, backend: str, params: dict):
    from hypergef.sparse import planner

    if backend in ("cumsum", "xla"):
        return planner.plan_tree(hg)  # plan unused by these backends
    if backend == "tree":
        return planner.plan_tree(hg, ngs=params.get("ngs"))
    if backend == "dense":
        tree = planner.plan_tree(hg)
        return planner.AggregationPlan(
            tree=tree, dense=planner.DenseIncidence.from_hypergraph(hg)
        )
    if backend == "precomp":
        tree = planner.plan_tree(hg)
        return planner.AggregationPlan(
            tree=tree, precomp=planner.DensePrecomp.from_hypergraph(hg)
        )
    if backend == "multihot":
        return planner.plan_multihot(
            hg,
            tile_rows=params.get("tile_rows", 256),
            ngs=params.get("ngs", 8),
            form=params.get("form", "multihot"),
        )
    if backend == "bsr":
        from hypergef.sparse.bsr import plan_bsr

        tree = planner.plan_tree(hg)
        return planner.AggregationPlan(tree=tree, bsr=plan_bsr(hg, reorder=True))
    if backend == "aligned":
        return planner.plan_aligned(
            hg, max_spill=params.get("max_spill", 0.35))
    raise ValueError(backend)


def sweep(
    hg,
    feature_size: int = 32,
    candidates: Optional[list] = None,
    iters: int = 20,
    first_aggr: str = "sum",
    verbose: bool = False,
) -> list:
    """Measure every candidate on the current device; returns the sorted
    list of :class:`TuneResult` (fastest first).  Failures (OOM, guard
    trips) are skipped."""
    import jax.numpy as jnp

    from hypergef.ops import fused
    from hypergef.utils.timing import device_time_per_iter

    hgd = hg.device_data()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(hg.num_nodes, feature_size)).astype(np.float32))
    results = []
    for backend, params in candidates or default_candidates(hg):
        try:
            plan = _build_plan(hg, backend, params)
            # tree-family plans ride as jit OPERANDS (devplan pytrees),
            # not as program constants
            if backend in ("tree", "multihot", "aligned"):
                pdev = plan.as_device()
            elif backend == "bsr":
                pdev = plan.bsr.as_device()
            else:
                pdev = None

            from hypergef.utils.timing import chain_fold

            if pdev is not None:
                def step(xv, hgd_, pd):
                    y = fused.hgnn_aggregate(
                        hgd_, xv, None, first_aggr, plan=pd, backend=backend
                    )
                    # full-shape fold: a scalar sum fold lets XLA hoist
                    # loop-invariant matmul work out of the timing loop
                    return chain_fold(y, xv)

                operands = (hgd, pdev)
            else:
                def step(xv, hgd_):
                    y = fused.hgnn_aggregate(
                        hgd_, xv, None, first_aggr, plan=plan, backend=backend
                    )
                    return chain_fold(y, xv)

                operands = (hgd,)

            t = device_time_per_iter(step, x, iters=iters, operands=operands)
            # Small-graph guard: for fast kernels the differenced window
            # can be the size of dispatch jitter, and one noisy sweep can
            # invert the ranking.  Widen iters until the chained window
            # sits ≥2× above dispatch.
            cur = iters
            while (
                cur < 4000
                and (t["noisy"] or t["per_iter_s"] * cur < 2.0 * t["dispatch_s"])
            ):
                cur *= 5
                if verbose:
                    print(f"  tune {backend} {params}: window below 2x "
                          f"dispatch — widening to {cur} iters", flush=True)
                t = device_time_per_iter(step, x, iters=cur, operands=operands)
            results.append(TuneResult(backend, params, t["per_iter_s"]))
            if verbose:
                print(
                    f"  tune {backend} {params}: {t['per_iter_s']*1e6:.1f} us",
                    flush=True,
                )
        except Exception as e:  # noqa: BLE001 — sweep must survive any candidate
            if verbose:
                print(f"  tune {backend} {params}: FAILED {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:120]}", flush=True)
    results.sort(key=lambda r: r.per_iter_s)
    return results


def load_cached(key: str, cache_dir: Optional[str] = None) -> Optional[dict]:
    path = os.path.join(cache_dir or _default_cache_dir(), f"{key}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def save_cached(key: str, record: dict, cache_dir: Optional[str] = None) -> str:
    d = cache_dir or _default_cache_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{key}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    return path


def autotune(
    hg,
    feature_size: int = 32,
    candidates: Optional[list] = None,
    iters: int = 20,
    cache: bool = True,
    cache_dir: Optional[str] = None,
    verbose: bool = False,
) -> TuneResult:
    """Measured best (backend, params) for this graph/feature width on
    this device — cached across processes."""
    key = graph_key(hg, feature_size)
    if cache:
        rec = load_cached(key, cache_dir)
        if rec is not None:
            return TuneResult(rec["backend"], rec["params"], rec["per_iter_s"])
    results = sweep(hg, feature_size, candidates, iters, verbose=verbose)
    if not results:
        return TuneResult("tree", {}, float("inf"))
    best = results[0]
    if cache:
        save_cached(
            key,
            {
                "backend": best.backend,
                "params": best.params,
                "per_iter_s": best.per_iter_s,
                "tuned_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                "all": [
                    {"backend": r.backend, "params": r.params, "per_iter_s": r.per_iter_s}
                    for r in results
                ],
            },
            cache_dir,
        )
    return best


def autotune_plan(
    hg,
    feature_size: int = 32,
    cache: bool = True,
    cache_dir: Optional[str] = None,
    verbose: bool = False,
):
    """Measured replacement for ``plan_aggregation``'s static ladder:
    returns an AggregationPlan whose preferred_backend and parameters
    come from (cached) measurement on this device."""
    from hypergef.sparse import planner

    best = autotune(hg, feature_size, cache=cache, cache_dir=cache_dir,
                    verbose=verbose)
    if best.backend == "tree":
        plan = planner.plan_aggregation(
            hg, ngs=best.params.get("ngs"), with_multihot=False
        )
        plan.preferred_backend = "tree"
        return plan
    if best.backend == "multihot":
        plan = planner.plan_aggregation(hg, with_multihot=False)
        plan.multihot = planner.plan_multihot(
            hg,
            tile_rows=best.params.get("tile_rows", 256),
            ngs=best.params.get("ngs", 8),
            form=best.params.get("form", "multihot"),
        )
        plan.preferred_backend = "multihot"
        return plan
    if best.backend == "aligned":
        plan = planner.plan_aggregation(hg, with_multihot=False)
        if plan.aligned is None:
            plan.aligned = planner.plan_aligned(
                hg, max_spill=best.params.get("max_spill", 0.35))
        plan.preferred_backend = "aligned"
        return plan
    plan = planner.plan_aggregation(hg)
    plan.preferred_backend = best.backend
    return plan
