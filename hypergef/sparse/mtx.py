"""MatrixMarket incidence-matrix IO.

Counterpart of the reference's native loader (``include/dataloader/
dataloader.hpp:22-104`` + vendored ``mmio.hpp``): reads a .mtx file into
the |V|×|E| incidence CSR pair (symmetric files are expanded, 1-based
indices rebased — scipy's reader implements the same MatrixMarket
semantics).  A faster C++ parser lives in ``csrc/`` and is used when the
native library is built (:mod:`hypergef.sparse.native`).
"""

from __future__ import annotations

import numpy as np


def read_mtx(path: str, name: str | None = None):
    """Read a MatrixMarket file into a :class:`Hypergraph` (H = V×E)."""
    from hypergef.sparse.hypergraph import Hypergraph
    from hypergef.sparse import native

    if name is None:
        name = str(path).rsplit("/", 1)[-1].removesuffix(".mtx")
    if native.available():
        n, e, v_idx, e_idx = native.read_mtx_coo(path)
        return Hypergraph.from_coo(v_idx, e_idx, num_nodes=n, num_edges=e, name=name)
    import scipy.io

    H = scipy.io.mmread(str(path)).tocoo()
    return Hypergraph.from_coo(
        H.row, H.col, num_nodes=H.shape[0], num_edges=H.shape[1], name=name
    )


def write_mtx(path: str, hg) -> None:
    """Write H as a coordinate-pattern MatrixMarket file."""
    import scipy.io

    scipy.io.mmwrite(str(path), hg.to_scipy())


def _noop():  # pragma: no cover - keeps numpy import used when native path taken
    return np.int32
