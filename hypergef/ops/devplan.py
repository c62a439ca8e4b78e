"""Device-plan pytrees: jit-argument twins of the host planner objects.

The host plans (``planner.TreePlan``, ``bsr.BsrPlan``) are plain Python
objects; when an aggregation call that closes over one is jitted, the
plan's device arrays are baked into the program as *constants* — large
ones for big sparse plans (a 350k-nnz BSR plan is ~650 MB of bf16
blocks), which bloats compilation and the compiled program.

These wrappers are registered pytrees that carry the *device* arrays as
data and the slice bounds as static metadata, so a plan can be passed as
a real jit **argument**:

    pdev = plan.as_device()
    jax.jit(lambda x, p: fused.hgnn_aggregate(hgd, x, None, "sum",
                                              plan=p, backend="tree"))(x, pdev)

They duck-type the one method the op layer uses (``.device()``), so every
``fused.hgnn_aggregate``/``unignn_aggregate`` backend accepts them where
a raw per-backend plan is accepted.
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass(frozen=True)
class DevTreePlan:
    """Jit-argument form of :class:`planner.TreePlan` (tree / multihot /
    aligned stages alike — the stage tuples are already pytrees)."""

    stages: tuple  # (edge_stage_dev, vertex_stage_dev)

    def device(self):
        return self.stages


jax.tree_util.register_dataclass(
    DevTreePlan, data_fields=["stages"], meta_fields=[]
)


@dataclasses.dataclass(frozen=True)
class DevBsrPlan:
    """Jit-argument form of :class:`bsr.BsrPlan`; the true output row
    counts (slice bounds) ride as static metadata."""

    dev: tuple  # (e_stage_dev, v_stage_dev, vperm, vinv, eperm)
    e_rows: int
    v_rows: int

    def device(self):
        return self.dev


jax.tree_util.register_dataclass(
    DevBsrPlan, data_fields=["dev"], meta_fields=["e_rows", "v_rows"]
)
