"""Halo (boundary all-to-all) fully-sharded aggregation tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.parallel import make_mesh
from hypergef.parallel.halo import plan_halo
from hypergef.parallel.halo_aggr import (
    halo_hgnn_aggregate,
    shard_vertex_features,
    unshard_vertex_features,
)

from conftest import dense_hgnn_oracle


def rand_x(hg, f=6, seed=0):
    return np.random.default_rng(seed).normal(size=(hg.num_nodes, f)).astype(np.float32)


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_halo_matches_oracle(skewed_hg, n_shards, aggr):
    hg = skewed_hg
    mesh = make_mesh(n_shards, 1, devices=jax.devices()[:n_shards])
    plan = plan_halo(hg, n_shards)
    x = rand_x(hg, seed=1)
    x_own = jnp.asarray(shard_vertex_features(plan, x))
    out_own = halo_hgnn_aggregate(plan, mesh, x_own, None, aggr)
    got = unshard_vertex_features(plan, out_own)
    want = dense_hgnn_oracle(hg, x, None, aggr)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_halo_max_matches_oracle(skewed_hg, n_shards):
    """first_aggr='max' on the fully-sharded path: interior+boundary
    V→E trees run in max-combine form (distributed analogue of the
    reference's record-table max kernels)."""
    hg = skewed_hg
    mesh = make_mesh(n_shards, 1, devices=jax.devices()[:n_shards])
    plan = plan_halo(hg, n_shards)
    x = rand_x(hg, seed=5)
    x_own = jnp.asarray(shard_vertex_features(plan, x))
    out_own = halo_hgnn_aggregate(plan, mesh, x_own, None, "max")
    got = unshard_vertex_features(plan, out_own)
    want = dense_hgnn_oracle(hg, x, None, "max")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_halo_max_grad_matches_oracle(small_hg):
    """Exact max gradients through the sharded program: d/dx of a
    scalar loss matches the dense-oracle gradient (cotangents routed
    only to winning members)."""
    hg = small_hg
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    plan = plan_halo(hg, 4)
    x = rand_x(hg, f=4, seed=6)
    cot = np.random.default_rng(7).normal(
        size=(hg.num_nodes, 4)).astype(np.float32)
    cot_own = jnp.asarray(shard_vertex_features(plan, cot))

    def loss(x_own):
        out = halo_hgnn_aggregate(plan, mesh, x_own, None, "max")
        return jnp.vdot(out, cot_own)

    got = np.asarray(jax.grad(loss)(jnp.asarray(shard_vertex_features(plan, x))))
    got = unshard_vertex_features(plan, got)

    # dense-oracle gradient via jax on a plain dense formulation
    from conftest import dense_incidence

    H = jnp.asarray(dense_incidence(hg).astype(np.float32))
    degE = jnp.asarray(hg.degE)
    degV = jnp.asarray(hg.degV)

    def oracle_loss(xf):
        xe = jnp.max(
            jnp.where(H.T[:, :, None] > 0, xf[None, :, :], -3.0e38), axis=1
        )
        xe = jnp.where(jnp.sum(H.T, axis=1)[:, None] > 0, xe, 0.0) * degE
        xv = H @ xe * degV
        return jnp.vdot(xv, jnp.asarray(cot))

    want = np.asarray(jax.grad(oracle_loss)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_halo_max_on_aligned_interior():
    """Round 3 (was a hard error): first_aggr='max' keeps the ALIGNED
    interior — masked argmax over the band (XLA) + record-routed VJP
    over the transpose aligned stage.  Forward and gradient must match
    the dense oracle."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "experiments"))
    from weak_scaling import clustered_hypergraph

    hg = clustered_hypergraph(4000, 2000, 8.0, seed=3)
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    plan = plan_halo(hg, 4, local_form="aligned")
    assert plan.local_form == "aligned"
    x = rand_x(hg, f=4, seed=8)
    x_own = jnp.asarray(shard_vertex_features(plan, x))
    out_own = halo_hgnn_aggregate(plan, mesh, x_own, None, "max")
    got = unshard_vertex_features(plan, out_own)
    want = dense_hgnn_oracle(hg, x, None, "max")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    cot = np.random.default_rng(9).normal(
        size=(hg.num_nodes, 4)).astype(np.float32)
    cot_own = jnp.asarray(shard_vertex_features(plan, cot))

    def loss(xo):
        return jnp.vdot(halo_hgnn_aggregate(plan, mesh, xo, None, "max"),
                        cot_own)

    got_g = unshard_vertex_features(
        plan, np.asarray(jax.grad(loss)(x_own)))

    from conftest import dense_incidence

    H = jnp.asarray(dense_incidence(hg).astype(np.float32))
    degE = jnp.asarray(hg.degE)
    degV = jnp.asarray(hg.degV)

    def oracle_loss(xf):
        xe = jnp.max(
            jnp.where(H.T[:, :, None] > 0, xf[None, :, :], -3.0e38), axis=1
        )
        xe = jnp.where(jnp.sum(H.T, axis=1)[:, None] > 0, xe, 0.0) * degE
        xv = H @ xe * degV
        return jnp.vdot(xv, jnp.asarray(cot))

    want_g = np.asarray(jax.grad(oracle_loss)(jnp.asarray(x)))
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-4)


def test_halo_with_wdiag(small_hg):
    hg = small_hg
    mesh = make_mesh(8, 1)
    plan = plan_halo(hg, 8)
    x = rand_x(hg, f=4, seed=2)
    w = np.random.default_rng(3).uniform(0.5, 1.5, (hg.num_edges, 1)).astype(np.float32)
    # wdiag stacked per edge shard
    from hypergef.parallel.partition import ShardedAggPlan

    w_stacked = np.zeros((8, plan.e_pad, 1), dtype=np.float32)
    for d in range(8):
        e0, e1 = int(plan.edge_bounds[d]), int(plan.edge_bounds[d + 1])
        w_stacked[d, : e1 - e0] = w[e0:e1]
    x_own = jnp.asarray(shard_vertex_features(plan, x))
    out_own = halo_hgnn_aggregate(plan, mesh, x_own, jnp.asarray(w_stacked), "sum")
    got = unshard_vertex_features(plan, out_own)
    want = dense_hgnn_oracle(hg, x, w, "sum")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_halo_comm_smaller_than_replication(skewed_hg):
    plan = plan_halo(skewed_hg, 8)
    # boundary exchange must move less than full replication
    assert plan.comm_fraction() < 1.0


def test_halo_interior_split(skewed_hg):
    """Interior/boundary split invariants: every local edge lands in
    exactly one bucket, interior edges' members are all owned, the halo
    direction ships no more rows than the return direction (interior-
    only vertices are never exchanged)."""
    hg = skewed_hg
    plan = plan_halo(hg, 8)
    assert 0.0 <= plan.interior_fraction() <= 1.0
    assert plan.halo_comm_fraction() <= plan.comm_fraction() + 1e-9
    n_bnd = plan.n_local_edges - plan.n_interior
    for d in range(8):
        slots = plan.asm_idx[d, : int(plan.n_local_edges[d])]
        n_int = int(plan.n_interior[d])
        assert (slots < plan.e_int_pad).sum() == n_int
        assert ((slots >= plan.e_int_pad)
                & (slots < plan.e_int_pad + plan.e_bnd_pad)).sum() == int(n_bnd[d])
        # padded slots all point at the zero row
        pad_slots = plan.asm_idx[d, int(plan.n_local_edges[d]):]
        assert (pad_slots == plan.e_int_pad + plan.e_bnd_pad).all()


def test_halo_interior_majority_on_clustered():
    """On a community-sorted graph the contiguous edge partition aligns
    with vertex ownership, so most edges are interior — the overlap
    budget the split exists for."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
    from weak_scaling import clustered_hypergraph

    hg = clustered_hypergraph(8000, 4000, 8.0, seed=0)
    plan = plan_halo(hg, 4)
    assert plan.interior_fraction() > 0.5
    # and the halo direction is much lighter than full replication
    assert plan.halo_comm_fraction() < 0.25


def test_interior_independent_of_halo_collective():
    """The overlap property, proven on the traced program: the interior
    V→E tree must have no data dependence on the halo all_to_all (that
    independence is what lets XLA's latency-hiding scheduler run it
    between the collective's start/done pair on real multi-device hardware),
    while the return all_to_all and the output must depend on it."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
    from weak_scaling import clustered_hypergraph

    from hypergef.parallel.halo_aggr import (
        halo_hgnn_aggregate, shard_vertex_features)
    from hypergef.parallel.mesh import make_mesh
    from hypergef.utils.introspect import collective_overlap_report

    hg = clustered_hypergraph(8000, 4000, 8.0, seed=0)
    plan = plan_halo(hg, 8)
    assert plan.interior_fraction() > 0.5
    mesh = make_mesh(8, 1)
    x = shard_vertex_features(
        plan, np.zeros((hg.num_nodes, 16), np.float32))
    rep = collective_overlap_report(
        lambda xo: halo_hgnn_aggregate(plan, mesh, xo), x)
    assert rep["n_collectives"] == 2
    assert rep["chain"]  # return a2a waits on halo a2a (two-phase)
    assert rep["output_depends_on_collective"]
    # the interior tree (gather + combine work) is collective-independent
    assert rep["independent_gather_rows"] > 0
    assert rep["independent_elems"] > 10_000


def test_halo_aligned_interior():
    """local_form="aligned": the interior V→E runs as banded matmuls
    (uniform aligned stages stacked across shards) with an exact-VJP
    transpose stage.  Checks: forward parity with the single-device
    oracle (bf16 tolerance), one train step produces the same parameter
    update as the tree-interior program, spill-heavy graphs fall back
    to trees, and the collective-independence property survives."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
    import jax.numpy as jnp
    import optax
    from weak_scaling import clustered_hypergraph

    from hypergef.data.synthetic import random_hypergraph
    from hypergef.ops import fused
    from hypergef.parallel.halo_aggr import (
        halo_hgnn_aggregate, make_halo_train_step, shard_vertex_features,
        unshard_vertex_features)
    from hypergef.parallel.mesh import make_mesh
    from hypergef.utils.introspect import collective_overlap_report

    hg = clustered_hypergraph(8000, 4000, 8.0, seed=0)
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, 16)).astype(
        np.float32)
    ref = np.asarray(fused.hgnn_aggregate(
        hg.device_data(), jnp.asarray(x), None, "sum", backend="cumsum"))
    mesh = make_mesh(8, 1)
    plan_a = plan_halo(hg, 8, local_form="aligned")
    assert plan_a.local_form == "aligned"
    x_own = jnp.asarray(shard_vertex_features(plan_a, x))
    out = unshard_vertex_features(
        plan_a, halo_hgnn_aggregate(plan_a, mesh, x_own))
    rel = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-9)
    assert rel < 5e-3, rel  # bf16 band matmuls

    # gradients match the tree-interior (f32) program to bf16 tolerance.
    # (NOT Adam-stepped params: near-zero grad elements flip Adam's
    # normalized step sign under bf16 rounding — a ±2·lr param diff with
    # no gradient bug. The bwd stage is the EXACT transpose: verified by
    # identity-probe A == Bᵀ during development; here to norm-scaled tol.)
    import jax

    plan_t = plan_halo(hg, 8, local_form="tree")
    rng = np.random.default_rng(1)
    params = {
        "W1": jnp.asarray(rng.normal(size=(16, 8)).astype(np.float32) * 0.1),
        "W2": jnp.asarray(rng.normal(size=(8, 4)).astype(np.float32) * 0.1),
    }
    n_tot = plan_a.n_shards * plan_a.n_own
    y_own = jnp.asarray(rng.integers(0, 4, size=n_tot).astype(np.int32))
    m_own = jnp.asarray((np.arange(n_tot) % 3 == 0).astype(np.float32))

    def grad_for(plan):
        _, _, fwd = make_halo_train_step(mesh, plan, nclass=4)

        def loss(p):
            logp = fwd(p, x_own)
            picked = jnp.take_along_axis(logp, y_own[:, None], axis=1)[:, 0]
            return -jnp.sum(picked * m_own) / jnp.maximum(m_own.sum(), 1.0)

        return jax.grad(loss)(params)

    ga, gt = grad_for(plan_a), grad_for(plan_t)
    for k in ("W1", "W2"):
        a, t = np.asarray(ga[k]), np.asarray(gt[k])
        scale = max(float(np.abs(t).max()), 1e-9)
        np.testing.assert_allclose(a, t, rtol=0.05, atol=0.03 * scale)

    # spill-heavy input falls back to trees: a 2-shard random graph has
    # wide owned blocks (≫ the 8-block window cap) with interior edges
    # scattered across them (8 shards of a tiny graph would NOT spill —
    # 2-block owned ranges are trivially window-coverable)
    hr = random_hypergraph(16000, 8000, avg_edge_size=6, seed=3,
                           name="rnd")
    assert plan_halo(hr, 2, local_form="aligned").local_form == "tree"

    # overlap property: interior matmuls stay collective-independent
    # (the aligned interior traces as ONE custom_vjp_call eqn, so the
    # element count is its output size, not the summed inner work)
    rep = collective_overlap_report(
        lambda xo: halo_hgnn_aggregate(plan_a, mesh, xo), x_own)
    assert rep["chain"]
    assert rep["independent_elems"] >= plan_a.e_int_pad * 16


def test_halo_grad_matches_single_device(skewed_hg):
    from hypergef.ops import fused
    from hypergef.sparse.planner import plan_tree

    hg = skewed_hg
    mesh = make_mesh(8, 1)
    plan = plan_halo(hg, 8)
    tplan = plan_tree(hg)
    hgd = hg.device_data()
    x = rand_x(hg, f=4, seed=5)
    x_own = jnp.asarray(shard_vertex_features(plan, x))

    g_halo = jax.grad(
        lambda xv: jnp.sum(halo_hgnn_aggregate(plan, mesh, xv, None, "sum") ** 2)
    )(x_own)
    g_single = jax.grad(
        lambda xv: jnp.sum(
            fused.hgnn_aggregate(hgd, xv, None, "sum", plan=tplan, backend="tree") ** 2
        )
    )(jnp.asarray(x))
    np.testing.assert_allclose(
        unshard_vertex_features(plan, g_halo), np.asarray(g_single),
        rtol=1e-3, atol=1e-3,
    )


def test_halo_under_jit(skewed_hg):
    hg = skewed_hg
    mesh = make_mesh(8, 1)
    plan = plan_halo(hg, 8)
    x_own = jnp.asarray(shard_vertex_features(plan, rand_x(hg, f=4, seed=6)))
    f = jax.jit(lambda xv: halo_hgnn_aggregate(plan, mesh, xv, None, "sum"))
    out = f(x_own)
    want = dense_hgnn_oracle(hg, rand_x(hg, f=4, seed=6), None, "sum")
    np.testing.assert_allclose(
        unshard_vertex_features(plan, out), want, rtol=1e-4, atol=1e-4
    )


def test_halo_unignn_matches_oracle(skewed_hg):
    """UniGNN forms on the halo program: plain HHᵀX and the degE/degV
    (UniGCNII) form, vs the dense oracle."""
    from conftest import dense_unignn_oracle

    from hypergef.parallel.halo_aggr import halo_unignn_aggregate

    hg = skewed_hg
    mesh = make_mesh(8, 1)
    plan = plan_halo(hg, 8)
    x = rand_x(hg, f=6, seed=9)
    x_own = jnp.asarray(shard_vertex_features(plan, x))
    for use_deg in (False, True):
        got = unshard_vertex_features(
            plan, halo_unignn_aggregate(plan, mesh, x_own, use_deg=use_deg))
        want = dense_unignn_oracle(hg, x, use_deg=use_deg)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_halo_unigin_unigcnii_train():
    """All three model families train on the fully-sharded halo design."""
    from hypergef.data.synthetic import homophilic_hypergraph
    from hypergef.parallel.dist_model import (
        init_unigcnii_params, init_unigin_params)
    from hypergef.parallel.halo_aggr import (
        make_halo_unigcnii_train_step, make_halo_unigin_train_step)
    from hypergef.train import rand_train_test_idx

    hg, y = homophilic_hypergraph(400, 250, 4, seed=9)
    x = np.random.default_rng(10).normal(size=(400, 12)).astype(np.float32)
    split = rand_train_test_idx(y, seed=11)
    mask = np.zeros(len(y), np.float32)
    mask[split["train"]] = 1.0
    mesh = make_mesh(8, 1)
    plan = plan_halo(hg, 8)
    pad = plan.n_shards * plan.n_own - hg.num_nodes
    x_own = jnp.asarray(shard_vertex_features(plan, x))
    y_own = jnp.asarray(np.pad(y, (0, pad)))
    m_own = jnp.asarray(np.pad(mask, (0, pad)))
    for fam in ("UniGIN", "UniGCNII"):
        if fam == "UniGIN":
            import jax as _jax

            params = init_unigin_params(_jax.random.PRNGKey(0), 12, 16, 4)
            step, tx, fwd = make_halo_unigin_train_step(mesh, plan, nclass=4)
        else:
            import jax as _jax

            params = init_unigcnii_params(_jax.random.PRNGKey(1), 12, 16, 4)
            step, tx, fwd = make_halo_unigcnii_train_step(mesh, plan, nclass=4)
        st = tx.init(params)
        params, st, l0 = step(params, st, x_own, y_own, m_own)
        for _ in range(25):
            params, st, loss = step(params, st, x_own, y_own, m_own)
        assert np.isfinite(float(loss)) and float(loss) < float(l0), (fam, l0, loss)
