"""Hypergraph data layer: incidence matrix in CSR both ways + degree vectors.

Counterpart of the reference's Python hypergraph object
(``HyperGsys/hypergraph.py:10-101``) and of its native CSR descriptor
(``include/dataloader/dataloader.hpp:143-165``).  Host state is NumPy; the
:meth:`Hypergraph.device_data` view is a pytree of ``jnp`` arrays that flows
through ``jit``.

Semantics locked to the reference (single-degV form used by the fused and
PyG backends — see SURVEY.md §0):

* ``H`` is the |V|×|E| incidence matrix built from a bipartite COO
  (vertex, hyperedge) list (``hypergraph.py:22-27``).
* ``degV = (Σ_e H[v,e])^(-1/2)`` with ``inf → 1`` for isolated vertices
  (``hypergraph.py:34-45``).
* ``degE = (Σ_v H[v,e])^(-1)`` per hyperedge (``hypergraph.py:35-41``).
  The reference does not guard empty hyperedges (it can't produce them);
  we additionally map ``inf → 1`` so synthetic graphs with empty edges
  remain finite.
* ``degD = degV^(-1)`` is kept for API parity (computed-but-unused in the
  reference, ``hypergraph.py:42``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class HypergraphData:
    """Device-side (jit-traversable) view of a hypergraph.

    All index arrays are int32 (the accelerator's native index width; the reference
    likewise converts CSR arrays to int32 before kernel launch,
    ``hypergraph.py:59-73``).

    ``ht_*`` arrays enumerate nnz in hyperedge-major (H^T CSR) order —
    the V→E stage reads them; ``h_*`` arrays enumerate nnz in
    vertex-major (H CSR) order — the E→V stage reads them.  Keeping both
    permutations means *both* segment reductions see sorted segment ids.

    Registered as a pytree with ``num_nodes``/``num_edges`` as *static*
    metadata, so instances can be jit arguments (the minibatch path
    passes a fresh batch per step) without the counts becoming tracers.
    """

    # nnz in edge-sorted order: entry k is (vertex ht_vertex[k]) ∈ (edge ht_segids[k])
    ht_vertex: "np.ndarray"  # [nnz] int32, member vertex ids
    ht_segids: "np.ndarray"  # [nnz] int32, owning hyperedge ids (non-decreasing)
    ht_indptr: "np.ndarray"  # [E+1] int32, CSR row pointer of H^T
    # nnz in vertex-sorted order
    h_edge: "np.ndarray"  # [nnz] int32, incident hyperedge ids
    h_segids: "np.ndarray"  # [nnz] int32, owning vertex ids (non-decreasing)
    h_indptr: "np.ndarray"  # [N+1] int32, CSR row pointer of H
    degV: "np.ndarray"  # [N, 1] f32
    degE: "np.ndarray"  # [E, 1] f32
    num_nodes: int = 0
    num_edges: int = 0


def _register_hypergraph_data():
    import jax

    jax.tree_util.register_dataclass(
        HypergraphData,
        data_fields=[
            "ht_vertex",
            "ht_segids",
            "ht_indptr",
            "h_edge",
            "h_segids",
            "h_indptr",
            "degV",
            "degE",
        ],
        meta_fields=["num_nodes", "num_edges"],
    )


_register_hypergraph_data()


@dataclasses.dataclass
class Hypergraph:
    """Host-side hypergraph: CSR of H and H^T plus degree vectors."""

    num_nodes: int
    num_edges: int
    # CSR of H (V×E): per-vertex sorted lists of incident hyperedges
    h_indptr: np.ndarray  # [N+1] int64
    h_indices: np.ndarray  # [nnz] int32
    # CSR of H^T (E×V): per-hyperedge sorted lists of member vertices
    ht_indptr: np.ndarray  # [E+1] int64
    ht_indices: np.ndarray  # [nnz] int32
    name: str = "unnamed"

    def __post_init__(self):
        self.h_indptr = np.asarray(self.h_indptr, dtype=np.int64)
        self.h_indices = np.asarray(self.h_indices, dtype=np.int32)
        self.ht_indptr = np.asarray(self.ht_indptr, dtype=np.int64)
        self.ht_indices = np.asarray(self.ht_indices, dtype=np.int32)
        if self.h_indptr.shape != (self.num_nodes + 1,):
            raise ValueError("h_indptr shape mismatch")
        if self.ht_indptr.shape != (self.num_edges + 1,):
            raise ValueError("ht_indptr shape mismatch")
        if self.h_indices.shape != self.ht_indices.shape:
            raise ValueError("nnz mismatch between H and H^T")
        self._degV: Optional[np.ndarray] = None
        self._degE: Optional[np.ndarray] = None
        self._data: Optional[HypergraphData] = None

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_coo(
        cls,
        vertex: np.ndarray,
        edge: np.ndarray,
        num_nodes: Optional[int] = None,
        num_edges: Optional[int] = None,
        name: str = "unnamed",
        dedup: bool = True,
    ) -> "Hypergraph":
        """Build from a bipartite COO membership list (vertex[k] ∈ edge[k]).

        Mirrors the scipy COO→CSR construction of ``hypergraph.py:22-27``
        (which implicitly sums duplicates; we deduplicate since H is 0/1).
        """
        vertex = np.asarray(vertex, dtype=np.int64)
        edge = np.asarray(edge, dtype=np.int64)
        if vertex.shape != edge.shape or vertex.ndim != 1:
            raise ValueError("vertex/edge must be equal-length 1-D arrays")
        if num_nodes is None:
            num_nodes = int(vertex.max()) + 1 if vertex.size else 0
        if num_edges is None:
            num_edges = int(edge.max()) + 1 if edge.size else 0
        if dedup and vertex.size:
            flat = vertex * num_edges + edge
            flat = np.unique(flat)
            vertex = flat // num_edges
            edge = flat % num_edges
        # CSR of H: sort by (vertex, edge)
        order_v = np.lexsort((edge, vertex))
        h_indices = edge[order_v].astype(np.int32)
        h_indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(h_indptr, vertex + 1, 1)
        np.cumsum(h_indptr, out=h_indptr)
        # CSR of H^T: sort by (edge, vertex)
        order_e = np.lexsort((vertex, edge))
        ht_indices = vertex[order_e].astype(np.int32)
        ht_indptr = np.zeros(num_edges + 1, dtype=np.int64)
        np.add.at(ht_indptr, edge + 1, 1)
        np.cumsum(ht_indptr, out=ht_indptr)
        return cls(
            num_nodes=num_nodes,
            num_edges=num_edges,
            h_indptr=h_indptr,
            h_indices=h_indices,
            ht_indptr=ht_indptr,
            ht_indices=ht_indices,
            name=name,
        )

    @classmethod
    def from_edge_index(
        cls,
        edge_index: np.ndarray,
        num_nodes: Optional[int] = None,
        name: str = "unnamed",
        compact: bool = False,
    ) -> "Hypergraph":
        """Build from a PyG/AllSet-style bipartite ``edge_index`` [2, M].

        Row 0 holds vertex ids then (past the split point) hyperedge ids
        offset by ``num_nodes``; the split is the first column whose row-0
        value equals ``num_nodes`` (``hypergraph.py:15-19``).  Only the
        V→E half is used.

        Hyperedge id-space semantics (fixed from the reference, whose
        ``hypergraph.py:18`` counts *unique* ids but indexes with *raw*
        values — silently wrong on non-dense id spaces):

        * ``compact=False`` (default): ids are kept raw after the
          ``- num_nodes`` rebase, ``num_edges = max_id + 1``; gaps in
          the id space become empty hyperedges (degree 0, aggregation
          output 0 — consistent everywhere).
        * ``compact=True``: unique ids are remapped to a dense
          ``0..k-1`` range, ``num_edges = k`` (no empty edges).
        """
        edge_index = np.asarray(edge_index, dtype=np.int64)
        if num_nodes is None:
            raise ValueError("num_nodes is required for edge_index input")
        split = np.nonzero(edge_index[0] == num_nodes)[0]
        c_idx = int(split.min()) if split.size else edge_index.shape[1]
        v = edge_index[0, :c_idx]
        e = edge_index[1, :c_idx] - num_nodes
        if e.size and e.min() < 0:
            raise ValueError(
                "hyperedge ids below num_nodes in edge_index row 1 — "
                "row 1 must hold ids offset by num_nodes"
            )
        if compact:
            uniq, e = np.unique(e, return_inverse=True)
            num_edges = int(uniq.size)
        else:
            num_edges = int(e.max()) + 1 if e.size else 0
        return cls.from_coo(v, e, num_nodes=num_nodes, num_edges=num_edges, name=name)

    @classmethod
    def from_scipy(cls, H, name: str = "unnamed") -> "Hypergraph":
        """Build from a scipy sparse |V|×|E| incidence matrix."""
        coo = H.tocoo()
        return cls.from_coo(coo.row, coo.col, num_nodes=H.shape[0], num_edges=H.shape[1], name=name)

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.h_indices.shape[0])

    @property
    def degV(self) -> np.ndarray:
        """[N,1] f32: rowsum(H)^(-1/2), inf→1 (hypergraph.py:34-45)."""
        if self._degV is None:
            rowsum = np.diff(self.h_indptr).astype(np.float64)
            with np.errstate(divide="ignore"):
                d = rowsum ** -0.5
            d[~np.isfinite(d)] = 1.0
            self._degV = d.astype(np.float32)[:, None]
        return self._degV

    @property
    def degE(self) -> np.ndarray:
        """[E,1] f32: colsum(H)^(-1), inf→1 (hypergraph.py:35-41 + guard)."""
        if self._degE is None:
            colsum = np.diff(self.ht_indptr).astype(np.float64)
            with np.errstate(divide="ignore"):
                d = 1.0 / colsum
            d[~np.isfinite(d)] = 1.0
            self._degE = d.astype(np.float32)[:, None]
        return self._degE

    @property
    def degD(self) -> np.ndarray:
        """[N,1] f32: degV^(-1) — kept for parity (hypergraph.py:42)."""
        with np.errstate(divide="ignore"):
            d = 1.0 / self.degV
        d[~np.isfinite(d)] = 1.0
        return d.astype(np.float32)

    def edge_sizes(self) -> np.ndarray:
        return np.diff(self.ht_indptr)

    def vertex_degrees(self) -> np.ndarray:
        return np.diff(self.h_indptr)

    # ------------------------------------------------------------------
    # device view
    # ------------------------------------------------------------------
    def device_data(self) -> HypergraphData:
        """jnp pytree of the arrays every backend consumes (cached)."""
        if self._data is None:
            import jax.numpy as jnp

            ht_segids = np.repeat(
                np.arange(self.num_edges, dtype=np.int32), self.edge_sizes()
            )
            h_segids = np.repeat(
                np.arange(self.num_nodes, dtype=np.int32), self.vertex_degrees()
            )
            self._data = HypergraphData(
                ht_vertex=jnp.asarray(self.ht_indices),
                ht_segids=jnp.asarray(ht_segids),
                ht_indptr=jnp.asarray(self.ht_indptr.astype(np.int32)),
                h_edge=jnp.asarray(self.h_indices),
                h_segids=jnp.asarray(h_segids),
                h_indptr=jnp.asarray(self.h_indptr.astype(np.int32)),
                degV=jnp.asarray(self.degV),
                degE=jnp.asarray(self.degE),
                num_nodes=self.num_nodes,
                num_edges=self.num_edges,
            )
        return self._data

    # ------------------------------------------------------------------
    # interop
    # ------------------------------------------------------------------
    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (
                np.ones(self.nnz, dtype=np.float32),
                self.h_indices.astype(np.int64),
                self.h_indptr,
            ),
            shape=(self.num_nodes, self.num_edges),
        )

    def store_mtx(self, path: str) -> str:
        """Export H as MatrixMarket (parity with ``hypergraph.py:79-81``)."""
        from hypergef.sparse import mtx

        file_name = str(path) + self.name + ".mtx"
        mtx.write_mtx(file_name, self)
        return file_name

    def __repr__(self) -> str:
        return (
            f"Hypergraph(name={self.name!r}, |V|={self.num_nodes}, "
            f"|E|={self.num_edges}, nnz={self.nnz})"
        )
