"""Independent-framework training parity (reference-semantics oracle).

The reference trains with torch: PyG-style gather/scatter convs
(`model/pygnn/hgnn.py:25-38`, `model/pygnn/unigcnii.py:23-36`), wrappers
(`model/gnn.py:110-134,176-208`), Adam(lr=0.01, weight_decay=5e-4) +
`F.nll_loss` (`hgsys.py:136,153`).  torch (CPU) is available here, so
these tests rebuild that exact pipeline *in torch* from the documented
math, copy this framework's initial weights into it, train BOTH stacks
for dozens of epochs, and assert the loss trajectories and final
predictions track — a far stronger oracle than loss-goes-down checks:
it validates the conv semantics, the
log_softmax/nll wiring, AND the optimizer equivalence
(optax add_decayed_weights+scale_by_adam == torch Adam(weight_decay=)).

Dropout is 0 so both sides are deterministic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypergef.data.synthetic import homophilic_hypergraph  # noqa: E402
from hypergef.train import TrainConfig, Trainer, rand_train_test_idx  # noqa: E402

EPOCHS = 40


@pytest.fixture(scope="module")
def problem():
    hg, y = homophilic_hypergraph(300, 150, 4, avg_edge_size=5.0, seed=0)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 12))
    x = (centers[y] + 0.7 * rng.normal(size=(300, 12))).astype(np.float32)
    split = rand_train_test_idx(y, seed=2)
    return hg, x, y, split


def _torch_incidence(hg):
    """(vertex, edge) COO int64 tensors + degE/degV columns."""
    vertex = np.repeat(np.arange(hg.num_edges), np.diff(hg.ht_indptr))
    # ht CSR rows are edges; indices are vertices
    edges = torch.as_tensor(vertex, dtype=torch.int64)
    verts = torch.as_tensor(np.asarray(hg.ht_indices), dtype=torch.int64)
    degE = torch.as_tensor(np.asarray(hg.degE), dtype=torch.float32)
    degV = torch.as_tensor(np.asarray(hg.degV), dtype=torch.float32)
    return verts, edges, degE, degV


def _two_stage_torch(x, verts, edges, degE, degV, num_nodes, num_edges):
    """sum-aggr two-stage propagation: diag(degV)·H·diag(degE)·Hᵀ·x."""
    xe = torch.zeros(num_edges, x.shape[1])
    xe.index_add_(0, edges, x[verts])
    xe = xe * degE
    xv = torch.zeros(num_nodes, x.shape[1])
    xv.index_add_(0, verts, xe[edges])
    return xv * degV


def _losses_torch(model_step, epochs):
    return np.array([model_step() for _ in range(epochs)], dtype=np.float64)


def _losses_ours(tr, train_idx, epochs):
    params, opt_state = tr.params, tr.opt_state
    rng = jax.random.PRNGKey(0)
    idx = jnp.asarray(train_idx)
    out = []
    for _ in range(epochs):
        params, opt_state, rng, loss = tr._train_step(params, opt_state, rng, idx, tr.x, tr.y)
        out.append(float(loss))
    return np.array(out, dtype=np.float64), params


def _final_preds_ours(tr, params):
    tr.params = params
    return np.asarray(tr._forward(params, tr.x)).argmax(axis=1)


def test_hgnn_training_parity_vs_torch_reference(problem):
    hg, x, y, split = problem
    cfg = TrainConfig(model="HGNN", nhid=8, nlayer=2, epochs=EPOCHS,
                      dropout=0.0, input_drop=0.0, lr=0.01, wd=5e-4)
    tr = Trainer(cfg, hg, x, y)

    # --- torch twin, initialized from OUR weights ---
    k0 = np.asarray(tr.params["HGNNConv_0"]["linear"]["kernel"])  # [in, out]
    k1 = np.asarray(tr.params["HGNNConv_1"]["linear"]["kernel"])
    lin0 = torch.nn.Linear(k0.shape[0], k0.shape[1], bias=False)
    lin1 = torch.nn.Linear(k1.shape[0], k1.shape[1], bias=False)
    with torch.no_grad():
        lin0.weight.copy_(torch.as_tensor(k0.T))
        lin1.weight.copy_(torch.as_tensor(k1.T))
    verts, edges, degE, degV = _torch_incidence(hg)
    xt = torch.as_tensor(x)
    yt = torch.as_tensor(np.asarray(y, dtype=np.int64))
    ti = torch.as_tensor(np.asarray(split["train"], dtype=np.int64))
    opt = torch.optim.Adam(
        list(lin0.parameters()) + list(lin1.parameters()),
        lr=0.01, weight_decay=5e-4,
    )

    def forward():
        h = _two_stage_torch(lin0(xt), verts, edges, degE, degV,
                             hg.num_nodes, hg.num_edges)
        h = torch.relu(h)
        h = _two_stage_torch(lin1(h), verts, edges, degE, degV,
                             hg.num_nodes, hg.num_edges)
        return torch.log_softmax(h, dim=1)

    def step():
        opt.zero_grad()
        loss = torch.nn.functional.nll_loss(forward()[ti], yt[ti])
        loss.backward()
        opt.step()
        return float(loss)

    torch_losses = _losses_torch(step, EPOCHS)
    our_losses, params = _losses_ours(tr, split["train"], EPOCHS)

    # trajectories must track epoch-by-epoch (f32 drift grows slowly)
    np.testing.assert_allclose(our_losses[:10], torch_losses[:10],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(our_losses, torch_losses, rtol=3e-2, atol=3e-3)

    # final predictions agree on ~all nodes
    with torch.no_grad():
        torch_pred = forward().argmax(dim=1).numpy()
    ours_pred = _final_preds_ours(tr, params)
    assert (ours_pred == torch_pred).mean() > 0.98


def test_unigcnii_training_parity_vs_torch_reference(problem):
    """Validates the α/β identity-mapping schedule end to end
    (β_i = log(λ/(i+1)+1), λ=0.5, α=0.1 — model/gnn.py:177,185)."""
    hg, x, y, split = problem
    cfg = TrainConfig(model="UniGCNII", nhid=8, nlayer=2, epochs=EPOCHS,
                      dropout=0.0, input_drop=0.0, lr=0.01, wd=5e-4)
    tr = Trainer(cfg, hg, x, y)
    p = tr.params

    lin_in = torch.nn.Linear(x.shape[1], 8)
    lin_out = torch.nn.Linear(8, 4)
    convw = []
    with torch.no_grad():
        lin_in.weight.copy_(torch.as_tensor(np.asarray(p["lin_in"]["kernel"]).T))
        lin_in.bias.copy_(torch.as_tensor(np.asarray(p["lin_in"]["bias"])))
        lin_out.weight.copy_(torch.as_tensor(np.asarray(p["lin_out"]["kernel"]).T))
        lin_out.bias.copy_(torch.as_tensor(np.asarray(p["lin_out"]["bias"])))
        for i in range(cfg.nlayer):
            w = torch.nn.Linear(8, 8, bias=False)
            w.weight.copy_(torch.as_tensor(
                np.asarray(p[f"UniGCNIIConv_{i}"]["W"]["kernel"]).T))
            convw.append(w)
    verts, edges, degE, degV = _torch_incidence(hg)
    xt = torch.as_tensor(x)
    yt = torch.as_tensor(np.asarray(y, dtype=np.int64))
    ti = torch.as_tensor(np.asarray(split["train"], dtype=np.int64))
    params = (list(lin_in.parameters()) + list(lin_out.parameters())
              + [q for w in convw for q in w.parameters()])
    opt = torch.optim.Adam(params, lr=0.01, weight_decay=5e-4)
    import math

    def forward():
        h = torch.relu(lin_in(xt))
        h0 = h
        for i, w in enumerate(convw):
            beta = math.log(0.5 / (i + 1) + 1.0)
            hv = _two_stage_torch(h, verts, edges, degE, degV,
                                  hg.num_nodes, hg.num_edges)
            hi = 0.9 * hv + 0.1 * h0
            h = torch.relu((1.0 - beta) * hi + beta * w(hi))
        return torch.log_softmax(lin_out(h), dim=1)

    def step():
        opt.zero_grad()
        loss = torch.nn.functional.nll_loss(forward()[ti], yt[ti])
        loss.backward()
        opt.step()
        return float(loss)

    torch_losses = _losses_torch(step, EPOCHS)
    our_losses, params_f = _losses_ours(tr, split["train"], EPOCHS)
    np.testing.assert_allclose(our_losses[:10], torch_losses[:10],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(our_losses, torch_losses, rtol=3e-2, atol=3e-3)
    with torch.no_grad():
        torch_pred = forward().argmax(dim=1).numpy()
    ours_pred = _final_preds_ours(tr, params_f)
    assert (ours_pred == torch_pred).mean() > 0.98


def test_unigin_training_parity_vs_torch_reference(problem):
    """(1+ε)·XW + H Hᵀ (XW), learnable scalar ε (unigin.py:17-26)."""
    hg, x, y, split = problem
    cfg = TrainConfig(model="UniGIN", nhid=8, nlayer=2, epochs=EPOCHS,
                      dropout=0.0, input_drop=0.0, lr=0.01, wd=5e-4)
    tr = Trainer(cfg, hg, x, y)
    p = tr.params
    k0 = np.asarray(p["UniGINConv_0"]["linear"]["kernel"])
    k1 = np.asarray(p["UniGINConv_1"]["linear"]["kernel"])
    lin0 = torch.nn.Linear(k0.shape[0], k0.shape[1], bias=False)
    lin1 = torch.nn.Linear(k1.shape[0], k1.shape[1], bias=False)
    eps0 = torch.nn.Parameter(torch.zeros(1))
    eps1 = torch.nn.Parameter(torch.zeros(1))
    with torch.no_grad():
        lin0.weight.copy_(torch.as_tensor(k0.T.copy()))
        lin1.weight.copy_(torch.as_tensor(k1.T.copy()))
    verts, edges, degE, degV = _torch_incidence(hg)
    xt = torch.as_tensor(x)
    yt = torch.as_tensor(np.asarray(y, dtype=np.int64))
    ti = torch.as_tensor(np.asarray(split["train"], dtype=np.int64))
    opt = torch.optim.Adam(
        list(lin0.parameters()) + list(lin1.parameters()) + [eps0, eps1],
        lr=0.01, weight_decay=5e-4,
    )
    ones_e = torch.ones(hg.num_edges, 1)
    ones_v = torch.ones(hg.num_nodes, 1)

    def conv(h, lin, eps):
        hw = lin(h)
        hv = _two_stage_torch(hw, verts, edges, ones_e, ones_v,
                              hg.num_nodes, hg.num_edges)
        return (1.0 + eps) * hw + hv

    def forward():
        h = torch.relu(conv(xt, lin0, eps0))
        return torch.log_softmax(conv(h, lin1, eps1), dim=1)

    def step():
        opt.zero_grad()
        loss = torch.nn.functional.nll_loss(forward()[ti], yt[ti])
        loss.backward()
        opt.step()
        return float(loss.detach())

    torch_losses = _losses_torch(step, EPOCHS)
    our_losses, params_f = _losses_ours(tr, split["train"], EPOCHS)
    np.testing.assert_allclose(our_losses[:10], torch_losses[:10],
                               # unnormalized HH^T: losses start ~100
                               rtol=6e-3, atol=1e-4)
    np.testing.assert_allclose(our_losses, torch_losses, rtol=3e-2, atol=3e-3)
    with torch.no_grad():
        torch_pred = forward().argmax(dim=1).numpy()
    ours_pred = _final_preds_ours(tr, params_f)
    assert (ours_pred == torch_pred).mean() > 0.98
