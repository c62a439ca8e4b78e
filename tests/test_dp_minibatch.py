"""Data-parallel minibatch composition (sampled batches over a mesh).

The reference is single-GPU full-batch; this is the new-design DP path
(SURVEY.md §2.9).  Invariants tested:

* sharded-vs-unsharded equivalence: the jitted DP step on a 4-device
  mesh produces the same loss and parameter update as the identical
  program on stacked (unsharded) batches — GSPMD partitioning must not
  change the math;
* fixed pad shapes: every sampled batch of a step compiles to ONE
  program shape;
* learning: loss decreases on a homophilic graph and full-graph eval
  beats chance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hypergef.data.sampling import HyperedgeSampler
from hypergef.data.synthetic import homophilic_hypergraph
from hypergef.train import TrainConfig, rand_train_test_idx
from hypergef.train.dp_minibatch import DPMinibatchTrainer, stack_batches


@pytest.fixture(scope="module")
def setup():
    hg, y = homophilic_hypergraph(900, 700, 4, avg_edge_size=6, seed=0)
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(4, 12))
    x = (centers[y] + 0.8 * rng.normal(size=(hg.num_nodes, 12))).astype(
        np.float32
    )
    split = rand_train_test_idx(y, seed=2)
    return hg, x, y, split


def test_fixed_pad_shapes(setup):
    hg, x, y, split = setup
    s = HyperedgeSampler(hg, 48, seed=0)
    pad_to = s.probe_pad_shapes()
    shapes = set()
    for _ in range(5):
        b = s.sample_batch(pad_to=pad_to)
        shapes.add((b.data.num_nodes, b.data.num_edges,
                    int(b.data.ht_vertex.shape[0])))
    assert len(shapes) == 1


def test_dp_step_matches_unsharded(setup):
    """One DP step on the mesh == the same step with no sharding."""
    hg, x, y, split = setup
    cfg = TrainConfig(model="HGNN", nhid=16, epochs=1, dropout=0.0,
                      input_drop=0.0)
    tr = DPMinibatchTrainer(cfg, hg, x, y, split["train"], batch_edges=32,
                            n_devices=4, sampler_seed=3)
    batches = [tr.sampler.sample_batch(pad_to=tr.pad_to) for _ in range(4)]
    data, vids, vmask = stack_batches(batches)
    rngs = jax.random.split(jax.random.key(0), 4)
    xb = jnp.asarray(tr.x[vids])
    yb = jnp.asarray(tr.y[vids])
    mask = jnp.asarray(vmask * tr.train_mask_global[vids])

    # unsharded: same jitted step on host-local stacked arrays
    p1, o1, loss1 = tr._step(tr.params, tr.opt_state, rngs, data, xb, yb, mask)
    # sharded: placed on the 4-device mesh edge axis
    data_s, xb_s, yb_s, mask_s = tr._place(data, vids, vmask)
    p2, o2, loss2 = tr._step(tr.params, tr.opt_state, rngs, data_s, xb_s,
                             yb_s, mask_s)
    assert np.isfinite(float(loss1))
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_dp_minibatch_learns(setup):
    hg, x, y, split = setup
    cfg = TrainConfig(model="HGNN", nhid=16, epochs=1, lr=0.02)
    tr = DPMinibatchTrainer(cfg, hg, x, y, split["train"], batch_edges=48,
                            n_devices=4, sampler_seed=4)
    first = tr.fit(steps=3)["mean_loss"]
    last = tr.fit(steps=25)["mean_loss"]
    assert last < first
    acc = tr.evaluate_full({"test": split["test"]})["test_acc"]
    assert acc > 40.0  # 4 classes, chance = 25%
