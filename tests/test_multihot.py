"""Multihot-matmul backend: tile-local multihot matmul level-0
(ops/tree._apply_tiled_multihot) vs the dense oracle, incl. gradients
and the fragmentation planner stat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.data.synthetic import (
    homophilic_hypergraph,
    powerlaw_hypergraph,
    random_hypergraph,
)
from hypergef.ops import fused
from hypergef.sparse.planner import plan_aggregation, plan_multihot

from conftest import dense_hgnn_oracle

CASES = [
    (random_hypergraph, 64, 40, dict(avg_edge_size=3.0)),
    (random_hypergraph, 300, 500, dict(avg_edge_size=2.0)),
    (powerlaw_hypergraph, 200, 150, dict(alpha=1.6)),
    (random_hypergraph, 777, 333, dict(avg_edge_size=5.0)),
]


def _case(i, form="multihot"):
    gen, n, e, kw = CASES[i]
    out = gen(n, e, seed=500 + i, **kw)
    hg = out[0] if isinstance(out, tuple) else out
    plan = plan_multihot(hg, tile_rows=64, form=form)
    return hg, hg.device_data(), plan


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("form", ["multihot", "multihot_batched"])
def test_multihot_forward_parity(case, form):
    hg, hgd, plan = _case(case, form)
    rng = np.random.default_rng(case)
    x = rng.normal(size=(hg.num_nodes, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)
    for aggr in ("sum", "mean"):
        want = dense_hgnn_oracle(hg, x, w, aggr)
        got = fused.hgnn_aggregate(
            hgd, x, jnp.asarray(w), aggr, plan=plan, backend="multihot"
        )
        # bf16 multihot matmul → dense-backend tolerance class
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=3e-2, atol=3e-2,
            err_msg=f"case {case} form {form} aggr {aggr}",
        )


@pytest.mark.parametrize("case", [0, 1, 2])
def test_multihot_grad_parity(case):
    hg, hgd, plan = _case(case)
    x = jnp.asarray(
        np.random.default_rng(case).normal(size=(hg.num_nodes, 3)).astype(np.float32)
    )

    def loss(backend, p):
        return lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=p, backend=backend) ** 2
        )

    ref = np.asarray(jax.grad(loss("xla", None))(x))
    got = np.asarray(jax.grad(loss("multihot", plan))(x))
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-2,
                               err_msg=f"case {case}")


def test_fragmentation_stat():
    """Clustered graphs fragment far less than uniform-random ones."""
    hg_rand = random_hypergraph(512, 300, avg_edge_size=6.0, seed=7)
    hg_rand = hg_rand[0] if isinstance(hg_rand, tuple) else hg_rand
    hg_clus, _ = homophilic_hypergraph(512, 300, 8, avg_edge_size=6.0,
                                       noise=0.0, seed=7)
    p_rand = plan_multihot(hg_rand, tile_rows=64)
    p_clus = plan_multihot(hg_clus, tile_rows=64)
    f_rand = p_rand.edge_stage.fragmentation()
    f_clus = p_clus.edge_stage.fragmentation()
    assert f_rand >= 1.0 and f_clus >= 1.0
    # homophilic edges draw members from one class → fewer tiles touched
    assert f_clus < f_rand, (f_clus, f_rand)


def test_multihot_in_aggregation_plan():
    """plan_aggregation exposes plan.multihot beyond the dense regime
    (forced small here via with_multihot=True)."""
    hg = random_hypergraph(128, 80, avg_edge_size=4.0, seed=3)
    hg = hg[0] if isinstance(hg, tuple) else hg
    plan = plan_aggregation(hg, with_multihot=True, multihot_tile_rows=64)
    assert plan.multihot is not None
    hgd = hg.device_data()
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, 4)).astype(np.float32)
    want = dense_hgnn_oracle(hg, x, None, "sum")
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="multihot")
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_multihot_precomp_parity(case):
    """Host-precomputed dense multihot blocks (streaming matmul form)."""
    hg, hgd, plan = _case(case, form="multihot_precomp")
    rng = np.random.default_rng(case)
    x = rng.normal(size=(hg.num_nodes, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)
    want = dense_hgnn_oracle(hg, x, w, "sum")
    got = fused.hgnn_aggregate(
        hgd, x, jnp.asarray(w), "sum", plan=plan, backend="multihot"
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-2, atol=3e-2)
    # gradient through the precomp form (tree VJP stage swap)
    g = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=plan,
                                 backend="multihot") ** 2
        )
    )(jnp.asarray(x))
    ref = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=None,
                                 backend="xla") ** 2
        )
    )(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g), np.asarray(ref), rtol=5e-2, atol=5e-2)


def test_multihot_precomp_downgrade():
    """Above the byte budget the precomp form downgrades per stage."""
    from hypergef.sparse.planner import plan_multihot

    hg = random_hypergraph(256, 150, avg_edge_size=4.0, seed=1)
    hg = hg[0] if isinstance(hg, tuple) else hg
    plan = plan_multihot(hg, tile_rows=64, form="multihot_precomp",
                         precomp_limit_bytes=16)
    assert plan.edge_stage.form == "multihot"
    assert plan.vertex_stage.form == "multihot"


@pytest.mark.parametrize("case", range(len(CASES)))
def test_multihot_nested_combine_parity(case):
    """Nested multihot-matmul combine (combine="multihot_precomp"): the
    flat-partial combine runs as a second tiled multihot stage instead
    of the gather tree — forward + grad must match the oracle."""
    gen, n, e, kw = CASES[case]
    out = gen(n, e, seed=500 + case, **kw)
    hg = out[0] if isinstance(out, tuple) else out
    hgd = hg.device_data()
    plan = plan_multihot(hg, tile_rows=64, form="multihot_precomp",
                         combine="multihot_precomp")
    from hypergef.sparse.planner import TiledStage

    assert isinstance(plan.edge_stage.combine, TiledStage)
    rng = np.random.default_rng(case)
    x = rng.normal(size=(hg.num_nodes, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)
    for aggr in ("sum", "mean"):
        want = dense_hgnn_oracle(hg, x, w, aggr)
        got = fused.hgnn_aggregate(
            hgd, x, jnp.asarray(w), aggr, plan=plan.as_device(),
            backend="multihot"
        )
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=3e-2, atol=3e-2,
            err_msg=f"case {case} aggr {aggr}",
        )
    g = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=plan.as_device(),
                                 backend="multihot") ** 2
        )
    )(jnp.asarray(x))
    ref = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=None,
                                 backend="xla") ** 2
        )
    )(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g), np.asarray(ref),
                               rtol=5e-2, atol=5e-2)
