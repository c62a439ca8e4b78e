"""Auto-selection optimality matrix (criterion:
"backend='auto' ties-or-beats every fixed backend across the bench
matrix").

For each workload: measure every applicable fixed backend plus the
ladder's auto pick, interleaved in one process (honest fencing), and
record auto's slowdown vs the best fixed backend.  Writes
experiments/out/auto_matrix.csv.

Run: python experiments/auto_matrix.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np
import jax.numpy as jnp

from hypergef.data.synthetic import random_hypergraph
from hypergef.ops import fused
from hypergef.sparse.planner import plan_aggregation
from hypergef.utils.timing import chain_fold, device_time_per_iter

F = 32


def workloads():
    yield "cora", random_hypergraph(2708, 2708, avg_edge_size=4.0, seed=0,
                                    name="cora")
    yield "20news", random_hypergraph(16242, 100, avg_edge_size=654.5,
                                      seed=0, name="20news")
    yield "pubmed_real", random_hypergraph(19717, 7963, avg_edge_size=10.8,
                                           seed=0, name="pubmed_real")
    yield "pubmed_sq", random_hypergraph(19717, 19717, avg_edge_size=4.3,
                                         seed=0, name="pubmed_sq")
    from clustered_bench import community_hypergraph
    from hypergef.sparse.reorder import apply_vertex_order

    sbm = community_hypergraph(60_000, 30_000, 240, 12, 0.02, 0)
    sbm, _ = apply_vertex_order(sbm, np.arange(sbm.num_nodes),
                                sort_edges=True)
    yield "sbm60k_sorted", sbm


def applicable_backends(plan):
    out = []
    if plan.precomp is not None:
        out.append("precomp")
    if plan.dense is not None:
        out.append("dense")
    if plan.aligned is not None:
        out.append("aligned")
    out += ["cumsum", "tree"]
    return out


def main():
    out_path = os.path.join(os.path.dirname(__file__), "out",
                            "auto_matrix.csv")
    rows = ["workload,nnz,auto_pick,auto_us,best_fixed,best_fixed_us,"
            "auto_over_best,tuned_pick,tuned_matches_best"]
    for name, hg in workloads():
        plan = plan_aggregation(hg)
        hgd = hg.device_data()
        x0 = jnp.asarray(np.random.default_rng(0)
                         .normal(size=(hg.num_nodes, F)).astype(np.float32))
        times = {}
        for backend in applicable_backends(plan):
            def step(a, b=backend):
                y = fused.hgnn_aggregate(hgd, a, None, "sum", plan=plan,
                                         backend=b)
                return chain_fold(y, a)
            try:
                # same min-window rule as sparse/autotune.sweep: widen
                # until the chained window sits ≥2× above dispatch — for
                # fast kernels a short window is inside dispatch jitter
                # and inverts rankings
                r = device_time_per_iter(step, x0, iters=20)
                cur = 20
                while cur < 4000 and (
                    r["noisy"] or r["per_iter_s"] * cur < 2.0 * r["dispatch_s"]
                ):
                    cur *= 5
                    r = device_time_per_iter(step, x0, iters=cur)
                times[backend] = r["per_iter_s"] * 1e6
            except Exception as ex:
                print(f"{name}/{backend}: FAILED {type(ex).__name__}",
                      flush=True)
        auto_pick = plan.preferred_backend
        auto_us = times.get(auto_pick, float("nan"))
        best = min(times, key=times.get)
        # the PRODUCT tuning path (what `--tune` runs —
        # sparse/autotune.autotune with persistence); its pick should
        # agree with the interleaved ground truth above
        from hypergef.sparse.autotune import autotune

        # cache=False: re-validate the tuner's min-window guard — a
        # cached pick would mask it
        tuned = autotune(hg, F, cache=False)
        near_best = [b for b, t in times.items()
                     if t <= times[best] * 1.15]  # within run-to-run jitter
        row = (f"{name},{hg.nnz},{auto_pick},{auto_us:.1f},{best},"
               f"{times[best]:.1f},{auto_us / times[best]:.3f},"
               f"{tuned.backend},{tuned.backend in near_best}")
        print(row, "|", {k: round(v, 1) for k, v in times.items()},
              flush=True)
        rows.append(row)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    print("wrote", out_path, flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    main()
