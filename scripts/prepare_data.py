"""Dataset preparation driver — parity with ``HyperGsys/prepare_data.py``.

Processes every available named dataset (raw files under
``<root>/<name>/raw``) into the cached .npz form and exports the
incidence matrix as MatrixMarket for the native kernel benches
(the reference exports .mtx at prepare_data.py:209-235).

    python scripts/prepare_data.py --root data/ --mtx-out data/mtx_data/
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="data/")
    ap.add_argument("--mtx-out", default="data/mtx_data/")
    ap.add_argument("--datasets", default=None,
                    help="comma list; default = all 13")
    args = ap.parse_args()

    from hypergef.data.datasets import (
        EXISTING_DATASETS,
        DatasetNotAvailable,
        load_dataset,
    )
    from hypergef.sparse.stats import graph_stats

    names = args.datasets.split(",") if args.datasets else EXISTING_DATASETS
    os.makedirs(args.mtx_out, exist_ok=True)
    ok, missing = [], []
    for name in names:
        try:
            ds = load_dataset(name, root=args.root)
        except DatasetNotAvailable:
            missing.append(name)
            continue
        ds.hg.store_mtx(args.mtx_out + os.sep)
        stats = graph_stats(ds.hg)
        print(f"{name}: |V|={ds.hg.num_nodes} |E|={ds.hg.num_edges} "
              f"nnz={ds.hg.nnz} gini(edge)={stats['edge_size_gini']:.3f}")
        ok.append(name)
    print(f"prepared {len(ok)}/{len(names)}; missing raw data: {missing}")


if __name__ == "__main__":
    main()
