"""Device plans as jit arguments (ops/devplan).

Plans passed as closure constants embed their device arrays in the
compiled program — hundreds of MB for a mid-size BSR or multihot
plan.  These tests pin the jit-argument path: a DevTreePlan /
DevBsrPlan flows through ``jax.jit`` as a real operand and produces the
oracle answer, forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.data.synthetic import random_hypergraph
from hypergef.ops import fused
from hypergef.ops.devplan import DevBsrPlan, DevTreePlan
from hypergef.sparse.bsr import plan_bsr
from hypergef.sparse import planner

from conftest import dense_hgnn_oracle


@pytest.fixture(scope="module")
def case():
    hg = random_hypergraph(300, 180, avg_edge_size=4.0, seed=3)
    hg = hg[0] if isinstance(hg, tuple) else hg
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(hg.num_nodes, 8)).astype(np.float32))
    return hg, hg.device_data(), x


def _dev_plans(hg):
    return {
        "tree": planner.plan_tree(hg).as_device(),
        "multihot": planner.plan_multihot(hg, tile_rows=128).as_device(),
        "bsr": plan_bsr(hg, reorder=True).as_device(),
    }


def test_devplan_is_pytree(case):
    hg, _, _ = case
    for name, pd in _dev_plans(hg).items():
        leaves, treedef = jax.tree_util.tree_flatten(pd)
        assert leaves, name
        rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
        assert type(rebuilt) is type(pd)


@pytest.mark.parametrize("backend", ["tree", "multihot", "bsr"])
def test_devplan_as_jit_argument(case, backend):
    hg, hgd, x = case
    pd = _dev_plans(hg)[backend]
    oracle = dense_hgnn_oracle(hg, np.asarray(x), None, "sum")

    @jax.jit
    def run(xv, hgd_, pd_):
        return fused.hgnn_aggregate(hgd_, xv, None, "sum", plan=pd_,
                                    backend=backend)

    y = run(x, hgd, pd)
    tol = 6e-3 if backend in ("multihot", "bsr") else 1e-5  # bf16 paths
    np.testing.assert_allclose(np.asarray(y), oracle, rtol=tol, atol=tol)

    g = jax.jit(jax.grad(lambda xv: jnp.sum(run(xv, hgd, pd) ** 2)))(x)
    assert bool(jnp.all(jnp.isfinite(g)))


def test_devbsr_carries_static_bounds(case):
    hg, _, _ = case
    pd = plan_bsr(hg, reorder=True).as_device()
    assert isinstance(pd, DevBsrPlan)
    assert pd.e_rows == hg.num_edges and pd.v_rows == hg.num_nodes
    # meta fields survive flatten/unflatten (they are static jit keys)
    leaves, treedef = jax.tree_util.tree_flatten(pd)
    rb = jax.tree_util.tree_unflatten(treedef, leaves)
    assert rb.e_rows == pd.e_rows and rb.v_rows == pd.v_rows
