"""The plain-JAX model zoo: parameter layout, initializers, dropout and
PReLU, and each model's forward against a NumPy forward built on the
``refops`` aggregations."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.data.synthetic import random_features, random_hypergraph
from hypergef.models import build_model
from hypergef.models.zoo import prelu
from hypergef.ops import refops

NFEAT, NHID, NCLASS = 7, 8, 3


@pytest.fixture(scope="module")
def graph():
    hg = random_hypergraph(60, 30, avg_edge_size=4.0, seed=5)
    x, _ = random_features(hg.num_nodes, NFEAT, NCLASS, seed=6)
    return hg, hg.device_data(), jnp.asarray(x)


def _np_log_softmax(z):
    z = z - z.max(axis=1, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=1, keepdims=True))


def _agg(hgd, h, kind):
    h = jnp.asarray(h, jnp.float32)
    if kind == "hgnn":
        out = refops.hgnn_aggregate_ref(hgd, h, None, "sum")
    else:
        out = refops.unignn_aggregate_ref(hgd, h, kind == "unignn_deg")
    return np.asarray(out, np.float64)


def _numpy_forward(model, p, x, hgd):
    x = np.asarray(x, np.float64)
    k = lambda d: np.asarray(d["kernel"], np.float64)  # noqa: E731
    if model == "HGNN":
        h = np.maximum(_agg(hgd, x @ k(p["HGNNConv_0"]["linear"]), "hgnn"), 0)
        z = _agg(hgd, h @ k(p["HGNNConv_1"]["linear"]), "hgnn")
    elif model == "UniGIN":
        def conv(h, q):
            hw = h @ k(q["linear"])
            return (1.0 + float(q["eps"][0])) * hw + _agg(hgd, hw, "unignn")

        z = conv(np.maximum(conv(x, p["UniGINConv_0"]), 0), p["UniGINConv_1"])
    else:
        h = np.maximum(x @ k(p["lin_in"]) + np.asarray(p["lin_in"]["bias"]), 0)
        h0 = h
        for i in range(2):
            beta = math.log(0.5 / (i + 1) + 1.0)
            hi = 0.9 * _agg(hgd, h, "unignn_deg") + 0.1 * h0
            h = np.maximum((1 - beta) * hi + beta * (hi @ k(p[f"UniGCNIIConv_{i}"]["W"])), 0)
        z = h @ k(p["lin_out"]) + np.asarray(p["lin_out"]["bias"])
    return _np_log_softmax(z)


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("model", ["HGNN", "UniGIN", "UniGCNII"])
def test_forward_matches_numpy_refops(graph, model, deterministic):
    """With dropout rates 0 the stochastic path must equal the
    deterministic one, and both must equal the NumPy forward."""
    hg, hgd, x = graph
    m = build_model(model, NFEAT, NHID, NCLASS, dropout=0.0, input_drop=0.0,
                    backend="xla")
    p = m.init({"params": jax.random.key(0)}, x, hgd, None)["params"]
    rngs = None if deterministic else {"dropout": jax.random.key(1)}
    got = m.apply({"params": p}, x, hgd, None, deterministic=deterministic, rngs=rngs)
    np.testing.assert_allclose(np.asarray(got), _numpy_forward(model, p, x, hgd),
                               rtol=1e-4, atol=1e-4)


_EXPECTED = {
    "HGNN": {"HGNNConv_0/linear/kernel": (NFEAT, NHID),
             "HGNNConv_1/linear/kernel": (NHID, NCLASS)},
    "UniGIN": {"UniGINConv_0/linear/kernel": (NFEAT, NHID),
               "UniGINConv_0/eps": (1,),
               "UniGINConv_1/linear/kernel": (NHID, NCLASS),
               "UniGINConv_1/eps": (1,)},
    "UniGCNII": {"lin_in/kernel": (NFEAT, NHID), "lin_in/bias": (NHID,),
                 "lin_out/kernel": (NHID, NCLASS), "lin_out/bias": (NCLASS,),
                 "UniGCNIIConv_0/W/kernel": (NHID, NHID),
                 "UniGCNIIConv_1/W/kernel": (NHID, NHID)},
    "UniGCNII-prelu": {"PReLU_0/negative_slope": ()},
}


def _flat(p):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        out["/".join(k.key for k in path)] = leaf
    return out


@pytest.mark.parametrize("model", list(_EXPECTED))
def test_param_tree_names_and_shapes(graph, model):
    hg, hgd, x = graph
    name, _, act = model.partition("-")
    m = build_model(name, NFEAT, NHID, NCLASS, activation=act or "relu")
    flat = _flat(m.init({"params": jax.random.key(0)}, x, hgd)["params"])
    want = dict(_EXPECTED[model])
    if act:
        want.update(_EXPECTED["UniGCNII"])
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert all(v.dtype == jnp.float32 for v in flat.values())


def test_initializer_families(graph):
    """Kernels: fan-in scaled normal (lecun); biases and UniGIN eps: 0;
    PReLU slope: 0.01; same key → same params, new key → new params."""
    hg, hgd, x = graph
    m = build_model("UniGCNII", NFEAT, 64, NCLASS, activation="prelu")
    p = m.init({"params": jax.random.key(0)}, x, hgd)["params"]
    w = np.asarray(p["UniGCNIIConv_0"]["W"]["kernel"])
    assert abs(w.std() - 1.0 / math.sqrt(64)) < 0.2 / math.sqrt(64)
    assert np.abs(w).max() <= 2.0 / math.sqrt(64) / 0.87 + 1e-6  # truncated at 2σ
    assert not np.asarray(p["lin_in"]["bias"]).any()
    assert float(p["PReLU_0"]["negative_slope"]) == pytest.approx(0.01)
    again = m.init({"params": jax.random.key(0)}, x, hgd)["params"]
    other = m.init({"params": jax.random.key(1)}, x, hgd)["params"]
    assert all(jnp.array_equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(again)))
    assert not jnp.array_equal(w, other["UniGCNIIConv_0"]["W"]["kernel"])
    u = build_model("UniGIN", NFEAT, NHID, NCLASS)
    assert not np.asarray(u.init({"params": jax.random.key(0)}, x, hgd)
                          ["params"]["UniGINConv_0"]["eps"]).any()


def test_prelu_values_and_slope_gradient():
    x = jnp.asarray([-2.0, -0.5, 0.0, 1.5])
    np.testing.assert_allclose(np.asarray(prelu(x, 0.25)), [-0.5, -0.125, 0.0, 1.5])
    g = jax.grad(lambda a: jnp.sum(prelu(x, a)))(0.25)
    assert float(g) == pytest.approx(-2.5)


def test_prelu_model_trains_its_slope(graph):
    hg, hgd, x = graph
    m = build_model("UniGCNII", NFEAT, NHID, NCLASS, activation="prelu",
                    dropout=0.0, backend="xla")
    p = m.init({"params": jax.random.key(0)}, x, hgd)["params"]
    g = jax.grad(lambda q: jnp.sum(m.apply({"params": q}, x, hgd) ** 2))(p)
    assert float(g["PReLU_0"]["negative_slope"]) != 0.0


def test_dropout_is_keyed_and_scaled(graph):
    hg, hgd, x = graph
    m = build_model("HGNN", NFEAT, NHID, NCLASS, dropout=0.5, input_drop=0.5,
                    backend="xla")
    p = m.init({"params": jax.random.key(0)}, x, hgd)["params"]

    def run(k):
        return np.asarray(m.apply({"params": p}, x, hgd, deterministic=False,
                                  rngs={"dropout": jax.random.key(k)}))

    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a, np.asarray(m.apply({"params": p}, x, hgd)))
    with pytest.raises(ValueError, match="dropout"):
        m.apply({"params": p}, x, hgd, deterministic=False)


def test_param_keys_follow_module_paths(graph):
    """Each kernel is drawn from the root key folded with the SHA-1 of
    its module path and draw count (the derivation earlier checkpoints
    were written under), so a seed keeps its parameters."""
    import hashlib

    hg, hgd, x = graph
    root = jax.random.key(7)
    p = build_model("HGNN", NFEAT, NHID, NCLASS).init({"params": root}, x, hgd)["params"]
    h = hashlib.sha1(b"HGNNConv_1" + b"linear" + (1).to_bytes(1, "big"))
    key = jax.random.fold_in(root, jnp.uint32(int.from_bytes(h.digest()[:4], "big")))
    want = jax.nn.initializers.lecun_normal()(key, (NHID, NCLASS), jnp.float32)
    np.testing.assert_array_equal(np.asarray(p["HGNNConv_1"]["linear"]["kernel"]),
                                  np.asarray(want))
