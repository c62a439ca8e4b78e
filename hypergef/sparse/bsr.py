"""Block-sparse (BSR) incidence representation for the matmul backend.

Random row gathers cost about the same per row regardless of width,
while matmul flops are cheap at these sizes.  The BSR backend exploits
both facts: H is tiled into 128×128 blocks, only nonzero blocks are
materialized (bf16), and each aggregation direction becomes

    gather X block-rows (16–64 KB each → gather cost amortized)
    → batched 128×128 matmuls per nonzero block
    → block-row combine via the reduction-tree machinery at block
      granularity.

Fill-in decides the cost, so the planner supports a bandwidth-reducing
**vertex/edge reordering** (reverse Cuthill-McKee on the bipartite
adjacency — making load-bearing what the reference ships as dead code,
its ``include/reorder/`` Rabbit-Order subsystem, SURVEY.md §1 orphan row).
A memory guard refuses the format when nonzero blocks exceed the budget
(auto-select then falls back to the tree backend).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from hypergef.sparse.planner import TreeStage, build_tree

BLOCK = 128


def rcm_bipartite_order(hg) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex and hyperedge permutations from reverse Cuthill-McKee on
    the bipartite graph [[0, H], [Hᵀ, 0]] — clusters incident
    vertices/edges together, raising BSR block fill."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    H = hg.to_scipy()
    n, e = hg.num_nodes, hg.num_edges
    bip = sp.bmat([[None, H], [H.T, None]], format="csr")
    order = np.asarray(reverse_cuthill_mckee(bip, symmetric_mode=True))
    vperm = order[order < n]
    eperm = order[order >= n] - n
    return vperm.astype(np.int64), eperm.astype(np.int64)


@dataclasses.dataclass
class BsrStage:
    """One aggregation direction as block-sparse matmul + block combine.

    y[brow-block] = Σ_{nonzero blocks b of that row} M_b @ x[bcol[b]]
    with the Σ computed by a TreeStage over block partials.
    """

    blocks: np.ndarray  # [NB, BLOCK, BLOCK] bf16-able f32 block data of M
    bcol: np.ndarray  # [NB] int32 — source block-column per block
    combine: TreeStage  # over NB block partials → num_row_blocks segments
    num_rows: int  # true output rows (≤ num_row_blocks*BLOCK)
    num_cols: int  # true input rows
    num_row_blocks: int
    num_col_blocks: int

    @property
    def nbytes_bf16(self) -> int:
        return self.blocks.shape[0] * BLOCK * BLOCK * 2


def build_bsr_stage(indptr, indices, num_rows, num_cols,
                    max_bytes: Optional[int] = None) -> BsrStage:
    """Build the BSR form of the CSR matrix M (rows × cols, 0/1).

    ``max_bytes``: raise MemoryError *before* materializing blocks when
    the bf16 block storage would exceed it.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    nrb = -(-num_rows // BLOCK)
    ncb = -(-num_cols // BLOCK)
    row_of = np.repeat(np.arange(num_rows, dtype=np.int64), np.diff(indptr))
    brow = row_of // BLOCK
    bcol_all = indices // BLOCK
    key = brow * ncb + bcol_all
    uniq, inv = np.unique(key, return_inverse=True)
    nb = len(uniq)
    if max_bytes is not None and nb * BLOCK * BLOCK * 2 > max_bytes:
        nnz = len(indices)
        raise MemoryError(
            f"BSR blocks need {nb * BLOCK * BLOCK * 2 / 1e9:.2f} GB > budget "
            f"{max_bytes / 1e9:.2f} GB (fill {nnz / (nb * BLOCK * BLOCK):.4f}); "
            "use the tree backend for this graph"
        )
    blocks = np.zeros((max(nb, 1), BLOCK, BLOCK), dtype=np.float32)
    r_in = (row_of % BLOCK).astype(np.int64)
    c_in = (indices % BLOCK).astype(np.int64)
    # accumulate duplicates (H is 0/1 so this just sets ones)
    np.add.at(blocks, (inv, r_in, c_in), 1.0)
    blocks = np.minimum(blocks, 1.0)
    ub_row = (uniq // ncb).astype(np.int64)
    ub_col = (uniq % ncb).astype(np.int32)
    # combine structure: blocks sorted by brow (np.unique sorts) →
    # block-level CSR over row-blocks
    rowptr = np.zeros(nrb + 1, dtype=np.int64)
    np.add.at(rowptr, ub_row + 1, 1)
    np.cumsum(rowptr, out=rowptr)
    combine = build_tree(
        rowptr, np.arange(max(nb, 1), dtype=np.int32), max(nb, 1),
        ngs=4, fan=8,
    )
    return BsrStage(
        blocks=blocks,
        bcol=ub_col,
        combine=combine,
        num_rows=num_rows,
        num_cols=num_cols,
        num_row_blocks=nrb,
        num_col_blocks=ncb,
    )


@dataclasses.dataclass
class BsrPlan:
    """Two-direction BSR plan (+ optional reordering permutations)."""

    edge_stage: BsrStage  # V→E (M = Hᵀ)
    vertex_stage: BsrStage  # E→V (M = H)
    vperm: Optional[np.ndarray] = None  # [N] vertex permutation
    eperm: Optional[np.ndarray] = None  # [E] hyperedge permutation
    _device: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def nbytes_bf16(self) -> int:
        return self.edge_stage.nbytes_bf16 + self.vertex_stage.nbytes_bf16

    def fill_fraction(self) -> float:
        nb = self.edge_stage.blocks.shape[0]
        nnz = float(self.edge_stage.blocks.sum())
        return nnz / (nb * BLOCK * BLOCK)

    @staticmethod
    def _stage_device(st: BsrStage):
        import jax.numpy as jnp

        from hypergef.sparse.planner import TreePlan

        return (
            jnp.asarray(st.blocks, dtype=jnp.bfloat16),
            jnp.asarray(st.bcol.astype(np.int32)),
            TreePlan._stage_device(st.combine),
        )

    def as_device(self):
        """Jit-argument pytree twin (:class:`ops.devplan.DevBsrPlan`) —
        BSR blocks are the biggest plan payload in the tree (hundreds of
        MB at ~0.1% fill), too big to embed as program constants."""
        from hypergef.ops.devplan import DevBsrPlan

        return DevBsrPlan(
            self.device(),
            e_rows=self.edge_stage.num_rows,
            v_rows=self.vertex_stage.num_rows,
        )

    def device(self):
        if self._device is None:
            import jax.numpy as jnp

            vp = ep = vinv = None
            if self.vperm is not None:
                vp = jnp.asarray(self.vperm.astype(np.int32))
                vinv_np = np.empty_like(self.vperm)
                vinv_np[self.vperm] = np.arange(len(self.vperm))
                vinv = jnp.asarray(vinv_np.astype(np.int32))
                ep = jnp.asarray(self.eperm.astype(np.int32))
            self._device = (
                self._stage_device(self.edge_stage),
                self._stage_device(self.vertex_stage),
                vp,
                vinv,
                ep,
            )
        return self._device


def plan_bsr(
    hg,
    reorder: bool = True,
    max_bytes: int = 2_000_000_000,
    method: str = "rcm",
) -> BsrPlan:
    """Build the BSR plan; raises MemoryError when blocks exceed budget.

    ``method``: "rcm" (bandwidth-minimizing bipartite RCM) or
    "community" (label-propagation community order from
    :mod:`hypergef.sparse.reorder` — typically higher block fill on
    clustered graphs, the Rabbit-Order rationale)."""
    vperm = eperm = None
    if reorder:
        if method == "community":
            from hypergef.sparse.reorder import community_order

            vperm = community_order(hg).astype(np.int64)
            # edges ordered by mean member rank (aligns edge blocks)
            vrank = np.empty_like(vperm)
            vrank[vperm] = np.arange(len(vperm))
            sums = np.zeros(hg.num_edges)
            sizes = hg.edge_sizes()
            np.add.at(sums, np.repeat(np.arange(hg.num_edges), sizes),
                      vrank[hg.ht_indices.astype(np.int64)])
            key = sums / np.maximum(sizes, 1)
            eperm = np.argsort(key, kind="stable")
        else:
            vperm, eperm = rcm_bipartite_order(hg)
        # permuted CSRs (vertices and edges relabelled)
        from hypergef.sparse.hypergraph import Hypergraph

        vinv = np.empty_like(vperm)
        vinv[vperm] = np.arange(len(vperm))
        einv = np.empty_like(eperm)
        einv[eperm] = np.arange(len(eperm))
        v_new = vinv[hg.ht_indices.astype(np.int64)]
        sizes = hg.edge_sizes()
        e_new = einv[np.repeat(np.arange(hg.num_edges, dtype=np.int64), sizes)]
        hg_p = Hypergraph.from_coo(
            v_new, e_new, num_nodes=hg.num_nodes, num_edges=hg.num_edges,
            name=hg.name + "+" + method, dedup=False,
        )
    else:
        hg_p = hg
    e_stage = build_bsr_stage(
        hg_p.ht_indptr, hg_p.ht_indices, hg_p.num_edges, hg_p.num_nodes,
        max_bytes=max_bytes // 2,
    )
    v_stage = build_bsr_stage(
        hg_p.h_indptr, hg_p.h_indices, hg_p.num_nodes, hg_p.num_edges,
        max_bytes=max_bytes // 2,
    )
    plan = BsrPlan(
        edge_stage=e_stage, vertex_stage=v_stage, vperm=vperm, eperm=eperm
    )
    if plan.nbytes_bf16 > max_bytes:
        raise MemoryError(
            f"BSR blocks need {plan.nbytes_bf16/1e9:.2f} GB > budget "
            f"{max_bytes/1e9:.2f} GB (fill {plan.fill_fraction():.4f}); "
            "use the tree backend for this graph"
        )
    plan.device()
    return plan
