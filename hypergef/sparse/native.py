"""ctypes bindings to the native C++ runtime library (``csrc/``).

The reference keeps its data loader and schedule builder in C++
(``include/dataloader/dataloader.hpp``, ``include/taskbalancer/``); this
package does the same for the host-side hot paths — MatrixMarket
parsing and ELL plan construction — exposed through a plain C ABI and
loaded with ctypes (no pybind11 in this environment).  Every entry point
has a NumPy twin (``mtx.py`` / ``planner.py``) used when the library is
not built; results are bit-identical (tested in
``tests/test_native.py``).

Build: ``make -C csrc`` (or ``python -m hypergef.sparse.native``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_SO = os.path.abspath(os.path.join(_CSRC, "libhypergef_native.so"))


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO):
        return None
    lib = ctypes.CDLL(_SO)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.hg_read_mtx_header.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
    lib.hg_read_mtx_header.restype = ctypes.c_int
    lib.hg_read_mtx_coo.argtypes = [ctypes.c_char_p, i32p, i32p, ctypes.c_int64]
    lib.hg_read_mtx_coo.restype = ctypes.c_int64

    lib.hg_build_ell.argtypes = [
        i64p,  # indptr
        i32p,  # indices
        ctypes.c_int64,  # num_rows
        ctypes.c_int64,  # nnz
        ctypes.c_int64,  # ngs
        ctypes.c_int64,  # c_pad
        i32p,  # gather_idx out [c_pad*ngs]
        f32p,  # mask out
        i32p,  # seg_ids out [c_pad]
        i64p,  # seg_ptr out [num_rows+1]
    ]
    lib.hg_build_ell.restype = ctypes.c_int64

    lib.hg_num_chunks.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64]
    lib.hg_num_chunks.restype = ctypes.c_int64

    lib.hg_coo_to_csr.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64,  # row, col, nnz, num_rows
        i64p, i32p,  # indptr out, indices out
    ]
    lib.hg_coo_to_csr.restype = ctypes.c_int

    if hasattr(lib, "hg_community_order"):
        lib.hg_community_order.argtypes = [
            ctypes.c_int64, ctypes.c_int64,  # n, e
            i64p, i32p,  # ht_indptr, ht_vertex (edge-major)
            i64p, i32p,  # h_indptr, h_edge (vertex-major)
            ctypes.c_int32,  # iters
            i32p,  # order out [n]
        ]
        lib.hg_community_order.restype = None
    if hasattr(lib, "hg_coarsen_order"):
        lib.hg_coarsen_order.argtypes = [
            ctypes.c_int64, ctypes.c_int64,  # n, e
            i64p, i32p,  # ht_indptr, ht_vertex (edge-major)
            ctypes.c_int64, ctypes.c_int64,  # edge_cap, max_levels
            i32p,  # order out [n]
        ]
        lib.hg_coarsen_order.restype = None
    if hasattr(lib, "hg_aligned_windows"):
        lib.hg_aligned_windows.argtypes = [
            ctypes.c_int64, i64p,  # n_groups, starts [n_groups+1]
            i64p, ctypes.c_int64,  # bs (group-sorted blocks), nb
            i64p, ctypes.c_int64,  # widths, n_widths
            ctypes.c_int64, ctypes.c_int64,  # block_cost, spill_cost
            i64p, i64p,  # off out, wid out
        ]
        lib.hg_aligned_windows.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def build(verbose: bool = False) -> bool:
    """Compile the native library in-place with make."""
    try:
        out = subprocess.run(
            ["make", "-C", os.path.abspath(_CSRC)],
            capture_output=True,
            text=True,
            timeout=240,
        )
        if verbose:
            print(out.stdout, out.stderr)
        global _TRIED
        _TRIED = False  # force reload attempt
        return out.returncode == 0 and available()
    except Exception:
        return False


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_mtx_coo(path: str) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """Parse a MatrixMarket file: returns (rows, cols, row_idx, col_idx)
    with symmetric entries expanded and indices rebased to 0."""
    lib = _load()
    assert lib is not None
    rows = np.zeros(1, dtype=np.int64)
    cols = np.zeros(1, dtype=np.int64)
    entries = np.zeros(1, dtype=np.int64)
    rc = lib.hg_read_mtx_header(
        path.encode(), _i64p(rows), _i64p(cols), _i64p(entries)
    )
    if rc != 0:
        raise IOError(f"native mtx header parse failed ({rc}) for {path}")
    cap = int(entries[0]) * 2  # symmetric expansion upper bound
    r = np.empty(cap, dtype=np.int32)
    c = np.empty(cap, dtype=np.int32)
    nnz = lib.hg_read_mtx_coo(path.encode(), _i32p(r), _i32p(c), cap)
    if nnz < 0:
        raise IOError(f"native mtx body parse failed ({nnz}) for {path}")
    return int(rows[0]), int(cols[0]), r[:nnz].copy(), c[:nnz].copy()


def build_ell_native(indptr: np.ndarray, indices: np.ndarray, ngs: int, pad_chunks_to: int = 8):
    """Native twin of :func:`hypergef.sparse.planner.build_ell`."""
    from hypergef.sparse.planner import EllTable, _round_up

    lib = _load()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    num_rows = indptr.shape[0] - 1
    num_chunks = int(lib.hg_num_chunks(_i64p(indptr), num_rows, ngs))
    c_pad = max(_round_up(max(num_chunks, 1), pad_chunks_to), pad_chunks_to)
    gather_idx = np.zeros((c_pad, ngs), dtype=np.int32)
    mask = np.zeros((c_pad, ngs), dtype=np.float32)
    seg_ids = np.full(c_pad, num_rows, dtype=np.int32)
    seg_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    got = lib.hg_build_ell(
        _i64p(indptr),
        _i32p(indices),
        num_rows,
        indices.shape[0],
        ngs,
        c_pad,
        _i32p(gather_idx),
        _f32p(mask),
        _i32p(seg_ids),
        _i64p(seg_ptr),
    )
    if got != num_chunks:
        raise RuntimeError("native ELL build inconsistency")
    return EllTable(
        gather_idx=gather_idx,
        mask=mask,
        seg_ids=seg_ids,
        seg_ptr=seg_ptr,
        num_chunks=num_chunks,
        num_segments=num_rows,
        ngs=ngs,
    )


if __name__ == "__main__":  # pragma: no cover
    ok = build(verbose=True)
    print("native build:", "ok" if ok else "FAILED")


def coarsen_order_native(hg, edge_cap: int = 64, max_levels: int = 40):
    """C++ multilevel coarsening order; None if lib unavailable.
    Bit-identical to :func:`hypergef.sparse.reorder.coarsen_order`."""
    lib = _load()
    if lib is None or not hasattr(lib, "hg_coarsen_order"):
        return None
    n, e = hg.num_nodes, hg.num_edges
    ht_indptr = np.ascontiguousarray(hg.ht_indptr, dtype=np.int64)
    ht_vertex = np.ascontiguousarray(hg.ht_indices, dtype=np.int32)
    order = np.empty(n, dtype=np.int32)
    lib.hg_coarsen_order(
        n, e, _i64p(ht_indptr), _i32p(ht_vertex),
        ctypes.c_int64(edge_cap), ctypes.c_int64(max_levels), _i32p(order),
    )
    return order


def community_order_native(hg, iters: int = 8):
    """C++ label-propagation community order; None if lib unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "hg_community_order"):
        return None
    n, e = hg.num_nodes, hg.num_edges
    ht_indptr = np.ascontiguousarray(hg.ht_indptr, dtype=np.int64)
    ht_vertex = np.ascontiguousarray(hg.ht_indices, dtype=np.int32)
    h_indptr = np.ascontiguousarray(hg.h_indptr, dtype=np.int64)
    h_edge = np.ascontiguousarray(hg.h_indices, dtype=np.int32)
    order = np.empty(n, dtype=np.int32)
    lib.hg_community_order(
        n, e, _i64p(ht_indptr), _i32p(ht_vertex),
        _i64p(h_indptr), _i32p(h_edge),
        ctypes.c_int32(iters), _i32p(order),
    )
    return order


def aligned_windows_native(starts, bs, nb, widths, block_cost, spill_cost):
    """C++ per-group window optimizer (planner._group_windows_opt twin);
    None if the lib is unavailable.  ``starts`` [n_groups+1] int64 group
    boundaries into ``bs`` (block ids sorted within each group)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hg_aligned_windows"):
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    bs = np.ascontiguousarray(bs, dtype=np.int64)
    widths = np.ascontiguousarray(widths, dtype=np.int64)
    n_groups = len(starts) - 1
    off = np.empty(n_groups, dtype=np.int64)
    wid = np.empty(n_groups, dtype=np.int64)
    lib.hg_aligned_windows(
        n_groups, _i64p(starts), _i64p(bs), ctypes.c_int64(nb),
        _i64p(widths), len(widths),
        ctypes.c_int64(block_cost), ctypes.c_int64(spill_cost),
        _i64p(off), _i64p(wid),
    )
    return off, wid
