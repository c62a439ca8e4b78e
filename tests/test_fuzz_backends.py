"""Property fuzz: every backend agrees with the dense oracle across a
sweep of random graph shapes/skews (the cross-backend consistency net
the reference never had — its backends genuinely disagreed, SURVEY.md
§2.8-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.data.synthetic import powerlaw_hypergraph, random_hypergraph
from hypergef.ops import fused
from hypergef.sparse.bsr import plan_bsr
from hypergef.sparse.planner import plan_aggregation, plan_tree

from conftest import dense_hgnn_oracle

CASES = [
    # (generator, n, e, kwargs)
    (random_hypergraph, 64, 40, dict(avg_edge_size=3.0)),
    (random_hypergraph, 300, 500, dict(avg_edge_size=2.0)),  # E > N
    (powerlaw_hypergraph, 200, 150, dict(alpha=1.6)),  # heavy tail
    (random_hypergraph, 50, 7, dict(avg_edge_size=20.0)),  # few giant edges
    (random_hypergraph, 777, 333, dict(avg_edge_size=5.0)),  # odd sizes
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_all_backends_agree(case):
    gen, n, e, kw = CASES[case]
    out = gen(n, e, seed=100 + case, **kw)
    hg = out[0] if isinstance(out, tuple) else out
    hgd = hg.device_data()
    plan = plan_aggregation(hg, with_tile=True)
    rng = np.random.default_rng(case)
    x = rng.normal(size=(hg.num_nodes, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)

    for aggr in ("sum", "mean"):
        want = dense_hgnn_oracle(hg, x, w, aggr)
        for backend in ("xla", "cumsum", "tree", "ell"):
            got = fused.hgnn_aggregate(
                hgd, x, jnp.asarray(w), aggr, plan=plan, backend=backend
            )
            np.testing.assert_allclose(
                np.asarray(got), want, rtol=1e-3, atol=1e-3,
                err_msg=f"case {case} backend {backend} aggr {aggr}",
            )
        if plan.dense is not None:
            got = fused.hgnn_aggregate(
                hgd, x, jnp.asarray(w), aggr, plan=plan, backend="dense"
            )
            np.testing.assert_allclose(
                np.asarray(got), want, rtol=3e-2, atol=3e-2,
                err_msg=f"case {case} dense aggr {aggr}",
            )
    # max: tree-max V→E + the auto backend's E→V (may be dense bf16 →
    # same 3e-2 tolerance as the dense sum path above)
    want = dense_hgnn_oracle(hg, x, w, "max")
    got = fused.hgnn_aggregate(hgd, x, jnp.asarray(w), "max", plan=plan, backend="auto")
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("case", [0, 2, 4])
def test_bsr_fuzz(case):
    gen, n, e, kw = CASES[case]
    out = gen(n, e, seed=100 + case, **kw)
    hg = out[0] if isinstance(out, tuple) else out
    hgd = hg.device_data()
    plan = plan_bsr(hg, reorder=(case % 2 == 0))
    x = np.random.default_rng(case).normal(size=(hg.num_nodes, 4)).astype(np.float32)
    want = dense_hgnn_oracle(hg, x, None, "sum")
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="bsr")
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("case", [0, 1, 3])
def test_grad_fuzz(case):
    gen, n, e, kw = CASES[case]
    out = gen(n, e, seed=100 + case, **kw)
    hg = out[0] if isinstance(out, tuple) else out
    hgd = hg.device_data()
    plan = plan_aggregation(hg)
    x = jnp.asarray(
        np.random.default_rng(case).normal(size=(hg.num_nodes, 3)).astype(np.float32)
    )

    def g(backend):
        return jax.grad(
            lambda xv: jnp.sum(
                fused.hgnn_aggregate(hgd, xv, None, "sum", plan=plan, backend=backend) ** 2
            )
        )(x)

    ref = np.asarray(g("xla"))
    for backend in ("cumsum", "tree"):
        np.testing.assert_allclose(
            np.asarray(g(backend)), ref, rtol=1e-3, atol=1e-3,
            err_msg=f"case {case} backend {backend}",
        )
