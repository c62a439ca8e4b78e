"""End-to-end training in the SPARSE regime: does the aligned backend's
kernel win survive a full train step?

The headline e2e number rides the dense backend; this artifact measures the full train epoch (fwd + NLL + bwd +
Adam, chained device time) on the SBM-60k clustered workload — beyond
the dense/precomp caps — across sparse backends.  The reference has no
clustered e2e analogue (its e2e suite is the 13 small datasets); the
yardstick here is backend-relative.

Output: experiments/out/clustered_e2e.csv

Run:
    python -u experiments/clustered_e2e.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from hypergef.utils.cache import enable_compile_cache  # noqa: E402

import numpy as np

from clustered_bench import community_hypergraph


def main():
    import jax

    from hypergef.sparse import planner
    from hypergef.sparse.reorder import apply_vertex_order
    from hypergef.train import TrainConfig, Trainer, rand_train_test_idx

    n, e, comm, avg, noise, f = 60_000, 30_000, 240, 12, 0.02, 32
    hg = community_hypergraph(n, e, comm, avg, noise, 0)
    hg, rank = apply_vertex_order(hg, np.arange(hg.num_nodes),
                                  sort_edges=True)
    rng = np.random.default_rng(1)
    # labels = community id bucketed to 8 classes; features = noisy
    # class centers (so accuracy is learnable, not just timeable)
    comm_of = (np.arange(n) * comm // n) % 8
    centers = rng.normal(size=(8, f)).astype(np.float32)
    x = centers[comm_of] + 0.7 * rng.normal(size=(n, f)).astype(np.float32)
    y = comm_of.astype(np.int32)
    split = rand_train_test_idx(y, seed=2)

    rows = [
        "# clustered e2e: HGNN train-epoch device time, SBM-60k f=32 nhid=32",
        f"# nnz={hg.nnz} dev={jax.devices()[0].platform}",
        "backend,epoch_us,test_acc",
    ]
    for backend in ("aligned", "tree", "cumsum"):
        try:
            cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, epochs=30,
                              backend=backend)
            plan = (planner.plan_aligned(hg) if backend == "aligned"
                    else None)
            tr = Trainer(cfg, hg, x, y, plan=plan)
            t_s = tr.epoch_device_time(split["train"], iters=30)
            # quick accuracy sanity (not a benchmark): 30 real epochs
            tr.fit(split["train"], epochs=cfg.epochs, warmup=0)
            acc = tr.evaluate({"test": split["test"]})["test_acc"]
            row = f"{backend},{t_s*1e6:.1f},{acc:.1f}"
        except Exception as exc:  # noqa: BLE001
            row = f"{backend},FAILED:{type(exc).__name__},"
        rows.append(row)
        print(row, flush=True)
    out = os.path.join(os.path.dirname(__file__), "out",
                       "clustered_e2e.csv")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    enable_compile_cache()
    main()
