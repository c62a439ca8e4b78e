"""The ``.npz`` checkpoint: round trips of real optimizer state, step
bookkeeping, tree checks and re-sharding onto a mesh template."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from hypergef.train.checkpoint import restore_checkpoint, save_checkpoint
from hypergef.train.trainer import make_optimizer


def _state(seed=0):
    k = jax.random.key(seed)
    params = {"a": {"kernel": jax.random.normal(k, (4, 3))},
              "b": jnp.arange(3, dtype=jnp.float32)}
    tx = make_optimizer(0.01, 5e-4)
    opt = tx.init(params)
    g = jax.tree_util.tree_map(jnp.ones_like, params)
    upd, opt = tx.update(g, opt, params)
    return optax.apply_updates(params, upd), opt


def _equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) and x.dtype == y.dtype
        for x, y in zip(la, lb))


def test_roundtrip_with_adam_state(tmp_path):
    params, opt = _state()
    save_checkpoint(str(tmp_path), 11, params, opt)
    tp, to = _state(seed=1)
    step, p2, o2 = restore_checkpoint(str(tmp_path), tp, to)
    assert step == 11 and _equal(p2, params) and _equal(o2, opt)
    assert type(o2) is type(opt)  # optax namedtuple structure restored


def test_latest_step_explicit_step_and_pruning(tmp_path):
    params, opt = _state()
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, jax.tree_util.tree_map(lambda v: v + s, params),
                        opt, max_to_keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000003.npz", "step_000000004.npz"]
    step, p, _ = restore_checkpoint(str(tmp_path), params, opt)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(p["b"]), np.asarray(params["b"]) + 4)
    step, p, _ = restore_checkpoint(str(tmp_path), params, opt, step=3)
    np.testing.assert_array_equal(np.asarray(p["b"]), np.asarray(params["b"]) + 3)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), params, opt, step=1)


def test_mismatched_tree_is_refused(tmp_path):
    params, opt = _state()
    save_checkpoint(str(tmp_path), 0, params, opt)
    with pytest.raises(ValueError, match="does not match"):
        restore_checkpoint(str(tmp_path), {"other": params["b"]}, opt)
    wrong_shape = dict(params, b=jnp.zeros(5))
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), wrong_shape, opt)


def test_restore_onto_sharded_template(tmp_path):
    """Leaves land on the template's sharding (8-device CPU mesh)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("e", "f"))
    params = {"w": jnp.arange(32.0).reshape(8, 4), "r": jnp.ones(6)}
    opt = {"m": jnp.zeros((8, 4))}
    save_checkpoint(str(tmp_path), 5, params, opt)
    row = NamedSharding(mesh, P("e", "f"))
    rep = NamedSharding(mesh, P())
    tp = {"w": jax.device_put(jnp.zeros((8, 4)), row),
          "r": jax.device_put(jnp.zeros(6), rep)}
    to = {"m": jax.device_put(jnp.zeros((8, 4)), row)}
    step, p2, o2 = restore_checkpoint(str(tmp_path), tp, to)
    assert step == 5
    assert p2["w"].sharding == row and p2["r"].sharding == rep
    assert o2["m"].sharding == row
    assert len(p2["w"].sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(p2["w"]), np.asarray(params["w"]))
