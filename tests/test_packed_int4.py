"""Packed-int4 incidence tables: explicit opt-in correctness.

The packed form is not the production default (the S4 unpack runs
inside every consuming program), but the machinery stays available (``dtype=jnp.int4`` /
``plan_sharded_dense(packed=True)``) and must remain bit-correct:
these tests pin the nibble packing (low nibble = even column), the
barrier-guarded bitcast unpack (XLA mis-constant-folds S4 bitcasts of
closure-captured carriers — wrong nibble values on CPU without the
pre-barrier), odd-E slicing, and the gradient path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.ops import fused
from hypergef.sparse.planner import DenseIncidence, plan_aggregation


@pytest.fixture(scope="module")
def packed_plan(small_hg):
    plan = plan_aggregation(small_hg)
    assert plan.dense is not None and not plan.dense.packed
    plan.dense = DenseIncidence.from_hypergraph(small_hg, dtype=jnp.int4)
    return plan


def test_packed_carrier_shape_and_dtype(small_hg, packed_plan):
    d = packed_plan.dense
    assert d.packed and d.h.dtype == jnp.int8
    assert d.h.shape == (small_hg.num_nodes, -(-small_hg.num_edges // 2))


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_packed_forward_matches_int8_bitexact(small_hg, packed_plan, aggr):
    """Same bf16 dots, same 0/1 operand values → bit-identical output
    to the int8 table (both closure-captured, under jit — the regime
    where the constant-folding bug bites without the barrier)."""
    hgd = small_hg.device_data()
    i8 = plan_aggregation(small_hg)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(small_hg.num_nodes, 5)).astype(np.float32))

    def run(plan):
        return jax.jit(
            lambda xv: fused.hgnn_aggregate(
                hgd, xv, None, aggr, plan=plan, backend="dense")
        )(x)

    np.testing.assert_array_equal(np.asarray(run(packed_plan)),
                                  np.asarray(run(i8)))


def test_packed_grad_matches_int8_bitexact(small_hg, packed_plan):
    hgd = small_hg.device_data()
    i8 = plan_aggregation(small_hg)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(small_hg.num_nodes, 4)).astype(np.float32))

    def grad_of(plan):
        def f(xv):
            out = fused.hgnn_aggregate(
                hgd, xv, None, "sum", plan=plan, backend="dense")
            return jnp.sum(out ** 2)
        return np.asarray(jax.jit(jax.grad(f))(x))

    np.testing.assert_array_equal(grad_of(packed_plan), grad_of(i8))


def test_packed_rejects_multiplicity_over_7():
    from hypergef.sparse.hypergraph import Hypergraph

    v = np.zeros(9, np.int64)  # vertex 0 appears 9x in hyperedge 0
    e = np.zeros(9, np.int64)
    hg = Hypergraph.from_coo(v, e, num_nodes=2, num_edges=1, dedup=False)
    with pytest.raises(MemoryError):
        DenseIncidence.from_hypergraph(hg, dtype=jnp.int4)


def test_packed_sharded_dense_matches_unpacked(small_hg):
    """plan_sharded_dense(packed=True) opt-in: same psum result."""
    from hypergef.parallel import make_mesh
    from hypergef.parallel.dense_shard import (
        plan_sharded_dense,
        sharded_dense_hgnn_aggregate,
    )

    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(small_hg.num_nodes, 6)).astype(np.float32))
    degV = jnp.asarray(small_hg.degV)
    outs = []
    for packed in (False, True):
        plan = plan_sharded_dense(small_hg, 4, packed=packed)
        assert plan.packed == packed
        outs.append(np.asarray(sharded_dense_hgnn_aggregate(
            plan, mesh, x, None, "sum", degV)))
    np.testing.assert_array_equal(outs[0], outs[1])
