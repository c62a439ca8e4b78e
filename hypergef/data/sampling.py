"""Hyperedge-sampled minibatch training path.

A new capability demanded by BASELINE.json config #4 — the reference is
strictly full-batch (SURVEY.md §2.9).  Design:

* host-side sampler draws a set of hyperedges per step (uniform or
  nnz-weighted), induces the subgraph (sampled edges + their member
  vertices), relabels vertices compactly;
* every batch is padded to *static bucket shapes* (next power-of-two
  per dimension) so XLA re-uses a handful of compiled programs — the
  static-shape answer to dynamic batch shapes;
* padded CSR convention: one reserved trailing "ghost" row per
  direction absorbs all padded nnz slots (gather index 0), and its
  output row is masked — so the scatter-free cumsum backend works on
  batches unchanged, no plan construction per batch.

Degrees (degV/degE) are sliced from the *full* graph, matching
full-batch semantics on the sampled support (standard subgraph-sampling
estimator behavior).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from hypergef.sparse.hypergraph import Hypergraph, HypergraphData


def _bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two bucket (≥ minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class HyperedgeBatch:
    """A padded, jit-stable minibatch (bucketed static shapes).

    ``data`` is a :class:`HypergraphData` over the *local* (relabelled)
    subgraph with one ghost vertex row and one ghost hyperedge row;
    ``vertex_ids`` maps local rows to global vertex ids (ghost → 0);
    masks select real rows.
    """

    data: HypergraphData
    vertex_ids: np.ndarray  # [N_pad] int32 global ids
    vertex_mask: np.ndarray  # [N_pad] f32 (0 for padding/ghost)
    edge_ids: np.ndarray  # [E_pad] int32 global ids
    num_real_vertices: int
    num_real_edges: int


def _padded_csr(indptr, indices, rows_pad, nnz_pad, pad_index):
    """Pad a CSR to (rows_pad rows, nnz_pad entries): real rows first,
    ghost last row absorbs the padded entries.

    ``pad_index`` MUST be the *other side's ghost row* (its last padded
    row), not 0: the fused ops' scatter-free VJP
    (``ops.segments.incidence_gather_sum``) computes ``dx = Mᵀ ȳ`` by
    swapping the two CSRs, which is exact only when they encode exact
    transposes.  With pad entries at index 0 the encoded H carried a
    spurious [ghost_row, 0] entry of multiplicity ``nnz_pad - nnz``
    whose transpose lived at [other_ghost, 0] instead — injecting a
    pad-count-sized bogus gradient through row 0 into the weights
    (round-5 diagnosis of the minibatch convergence failure: the
    forward was exact, the gradient was off by ~90x).  Padding both
    sides with their ghost indices makes the extra mass a closed
    ghost↔ghost loop: both CSRs pad the same nnz to the same nnz_pad,
    so the [ghost, ghost] multiplicities agree and the pair is an exact
    transpose; the loop never touches a real row in value or gradient.
    """
    rows = len(indptr) - 1
    nnz = len(indices)
    out_ptr = np.zeros(rows_pad + 1, dtype=np.int64)
    out_ptr[1 : rows + 1] = indptr[1:]
    out_ptr[rows + 1 :] = nnz  # empty padding rows
    out_ptr[-1] = nnz_pad  # ghost row holds the padded slots
    out_idx = np.full(nnz_pad, pad_index, dtype=np.int32)
    out_idx[:nnz] = indices
    return out_ptr, out_idx


class HyperedgeSampler:
    """Iterates hyperedge-sampled minibatches of a large hypergraph."""

    def __init__(
        self,
        hg: Hypergraph,
        batch_edges: int,
        weighted: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        deg_correction: bool = True,
    ):
        """``deg_correction`` (default on) applies the Horvitz-Thompson
        1/p estimator to the E→V stage: a batch of b of E hyperedges
        sums only a p = b/E fraction of each vertex's incident edges,
        so without the E/b rescale train-time activations are
        systematically ~p× smaller than the full-graph forward used at
        evaluation (the round-4 minibatch runs plateaued 20-40% below
        band partly from this train/eval scale mismatch).  The rescale
        rides on degV — the per-vertex factor applied at the stage
        output — so it corrects every layer and stays exact (factor 1)
        when the batch covers all edges."""
        self.hg = hg
        self.batch_edges = batch_edges
        self.weighted = weighted
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.deg_correction = deg_correction
        sizes = hg.edge_sizes().astype(np.float64)
        self._probs = sizes / sizes.sum() if weighted else None

    def sample_batch(self, pad_to: Optional[tuple] = None) -> HyperedgeBatch:
        hg = self.hg
        edges = self.rng.choice(
            hg.num_edges, size=min(self.batch_edges, hg.num_edges),
            replace=False, p=self._probs,
        )
        edges = np.sort(edges)
        return self.induce(edges, pad_to=pad_to)

    def induce(self, edges: np.ndarray, pad_to: Optional[tuple] = None
               ) -> HyperedgeBatch:
        """Build the padded batch for an explicit sorted hyperedge set.

        ``pad_to=(n_pad, e_pad, nnz_pad)`` forces fixed shapes (the
        data-parallel path stacks one batch per device, so every batch
        of a step must share shapes); raises ``ValueError`` if the batch
        exceeds the caps."""
        import jax.numpy as jnp

        hg = self.hg
        sizes = hg.edge_sizes()[edges]
        member_lists = [
            hg.ht_indices[hg.ht_indptr[e] : hg.ht_indptr[e + 1]] for e in edges
        ]
        members = (
            np.concatenate(member_lists) if member_lists else np.zeros(0, np.int32)
        )
        verts = np.unique(members)
        local_of = np.full(hg.num_nodes, -1, dtype=np.int64)
        local_of[verts] = np.arange(len(verts))
        nnz = int(members.shape[0])

        # bucketed static shapes (+1 ghost row each side)
        if pad_to is not None:
            n_pad, e_pad, nnz_pad = pad_to
            if len(verts) + 1 > n_pad or len(edges) + 1 > e_pad or nnz > nnz_pad:
                raise ValueError(
                    f"batch ({len(verts)}v/{len(edges)}e/{nnz}nnz) exceeds "
                    f"pad_to={pad_to}"
                )
        else:
            n_pad = _bucket(len(verts) + 1)
            e_pad = _bucket(len(edges) + 1)
            nnz_pad = _bucket(max(nnz, 1), minimum=64)

        # local H^T CSR (edge-major)
        ht_indptr = np.zeros(len(edges) + 1, dtype=np.int64)
        np.cumsum(sizes, out=ht_indptr[1:])
        ht_indices = local_of[members].astype(np.int32)
        ht_ptr_p, ht_idx_p = _padded_csr(ht_indptr, ht_indices, e_pad,
                                         nnz_pad, pad_index=n_pad - 1)

        # local H CSR (vertex-major) from the COO
        e_local = np.repeat(np.arange(len(edges), dtype=np.int64), sizes)
        v_local = local_of[members]
        order = np.lexsort((e_local, v_local))
        h_indices = e_local[order].astype(np.int32)
        h_indptr = np.zeros(len(verts) + 1, dtype=np.int64)
        np.add.at(h_indptr, v_local + 1, 1)
        np.cumsum(h_indptr, out=h_indptr)
        h_ptr_p, h_idx_p = _padded_csr(h_indptr, h_indices, n_pad,
                                       nnz_pad, pad_index=e_pad - 1)

        # segment-id views (for the xla/oracle path)
        ht_seg = np.repeat(
            np.arange(e_pad, dtype=np.int32), np.diff(ht_ptr_p).astype(np.int64)
        )
        h_seg = np.repeat(
            np.arange(n_pad, dtype=np.int32), np.diff(h_ptr_p).astype(np.int64)
        )

        # degrees sliced from the full graph (ghost rows → 1)
        degV = np.ones((n_pad, 1), dtype=np.float32)
        degV[: len(verts)] = hg.degV[verts]
        if self.deg_correction and len(edges) < hg.num_edges:
            # Horvitz-Thompson 1/p on the E→V sum (see __init__)
            degV[: len(verts)] *= hg.num_edges / len(edges)
        degE = np.ones((e_pad, 1), dtype=np.float32)
        degE[: len(edges)] = hg.degE[edges]

        data = HypergraphData(
            ht_vertex=jnp.asarray(ht_idx_p),
            ht_segids=jnp.asarray(ht_seg),
            ht_indptr=jnp.asarray(ht_ptr_p.astype(np.int32)),
            h_edge=jnp.asarray(h_idx_p),
            h_segids=jnp.asarray(h_seg),
            h_indptr=jnp.asarray(h_ptr_p.astype(np.int32)),
            degV=jnp.asarray(degV),
            degE=jnp.asarray(degE),
            num_nodes=n_pad,
            num_edges=e_pad,
        )
        vertex_ids = np.zeros(n_pad, dtype=np.int32)
        vertex_ids[: len(verts)] = verts
        vertex_mask = np.zeros(n_pad, dtype=np.float32)
        vertex_mask[: len(verts)] = 1.0
        edge_ids = np.zeros(e_pad, dtype=np.int32)
        edge_ids[: len(edges)] = edges
        return HyperedgeBatch(
            data=data,
            vertex_ids=vertex_ids,
            vertex_mask=vertex_mask,
            edge_ids=edge_ids,
            num_real_vertices=len(verts),
            num_real_edges=len(edges),
        )

    def epoch(self, shuffle: bool = True,
              pad_to: Optional[tuple] = None) -> Iterator[HyperedgeBatch]:
        """One pass over all hyperedges in batches."""
        order = (
            self.rng.permutation(self.hg.num_edges)
            if shuffle
            else np.arange(self.hg.num_edges)
        )
        bs = self.batch_edges
        for i in range(0, len(order), bs):
            chunk = order[i : i + bs]
            if len(chunk) < bs and self.drop_last and i > 0:
                return
            yield self.induce(np.sort(chunk), pad_to=pad_to)

    def probe_pad_shapes(self, k: int = 8, margin: float = 1.5) -> tuple:
        """Conservative fixed bucket shapes for pad_to: max over ``k``
        sampled batches × ``margin``, re-bucketed to powers of two.  The
        data-parallel trainer uses this so every device's batch compiles
        to ONE program shape."""
        n = e = z = 1
        for _ in range(k):
            b = self.sample_batch()
            n = max(n, b.num_real_vertices + 1)
            e = max(e, b.num_real_edges + 1)
            z = max(z, int(b.data.ht_vertex.shape[0]))
        return (_bucket(int(n * margin)), _bucket(int(e * margin)),
                _bucket(int(z * margin), minimum=64))
