"""Serialized halo TRAIN STEP correctness (round-5 mandate #7).

The serialized fwd+bwd over a HaloPlan (per-shard VJP programs glued by
host exchange transposes) must produce the same loss and weight
gradients as jax.grad through the single-chip full-graph oracle.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hypergef.data.synthetic import homophilic_hypergraph  # noqa: E402
from hypergef.ops import refops  # noqa: E402
from hypergef.parallel.halo import plan_halo  # noqa: E402
from hypergef.parallel.serial_halo_train import (  # noqa: E402
    serialized_halo_train_epochs, serialized_halo_train_step)


@pytest.fixture(scope="module", params=["tree", "aligned"])
def setup(request):
    if request.param == "aligned":
        # aligned interiors need a community-sorted graph (the 100M
        # scale plan's local_form — must be covered by the train step)
        import os
        import sys

        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "experiments"))
        from weak_scaling import clustered_hypergraph

        hg = clustered_hypergraph(4000, 2000, 8.0, seed=3)
        rng_y = np.random.default_rng(4)
        y = rng_y.integers(0, 4, size=hg.num_nodes).astype(np.int32)
    else:
        hg, y = homophilic_hypergraph(400, 260, 4, avg_edge_size=5.0,
                                      seed=9)
    plan = plan_halo(hg, 4, local_form=request.param)
    x = np.random.default_rng(1).normal(size=(hg.num_nodes, 12)).astype(
        np.float32)
    mask = np.zeros(hg.num_nodes, np.float32)
    mask[np.random.default_rng(2).choice(
        hg.num_nodes, hg.num_nodes // 2, replace=False)] = 1
    return hg, plan, x, y, mask


def _oracle_loss(hgd, params, x, y, mask):
    def f(p):
        h = jax.nn.relu(refops.hgnn_aggregate_ref(hgd, x @ p["w1"], None,
                                                  "sum"))
        z = refops.hgnn_aggregate_ref(hgd, h @ p["w2"], None, "sum")
        logp = jax.nn.log_softmax(z, axis=-1)
        picked = jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                     axis=1)[:, 0]
        m = jnp.asarray(mask)
        return -jnp.sum(picked * m) / jnp.maximum(m.sum(), 1.0)

    return f


def test_step_matches_oracle_grad(setup):
    hg, plan, x, y, mask = setup
    rng = np.random.default_rng(3)
    params = {
        "w1": rng.normal(size=(12, 8)).astype(np.float32) * 0.3,
        "w2": rng.normal(size=(8, 8)).astype(np.float32) * 0.3,
    }
    loss, grads = serialized_halo_train_step(plan, params, x, y, mask)

    hgd = hg.device_data()
    f = _oracle_loss(hgd, params, jnp.asarray(x), y, mask)
    want_loss, want_grads = jax.value_and_grad(f)(
        {k: jnp.asarray(v) for k, v in params.items()})
    # aligned interiors run their band dots in bf16 (same tolerance tier
    # as the forward serialized-vs-oracle test); the tree form is f32
    tol = 2e-2 if plan.local_form == "aligned" else 2e-4
    assert abs(loss - float(want_loss)) < tol * max(1.0, abs(float(want_loss)))
    for k in ("w1", "w2"):
        scale = float(jnp.max(jnp.abs(want_grads[k])))
        np.testing.assert_allclose(grads[k], np.asarray(want_grads[k]),
                                   atol=tol * max(scale, 1e-6), rtol=10 * tol)


def test_epochs_reduce_loss(setup):
    hg, plan, x, y, mask = setup
    stats = {}
    params, losses = serialized_halo_train_epochs(
        plan, x, y, mask, nhid=8, nclass=4, epochs=8, lr=0.02, stats=stats)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert len(stats["shard_s"]) == 2 * 8 * plan.n_shards  # 2 layers/step
