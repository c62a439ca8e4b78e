"""End-to-end hypergraph-GNN models (plain JAX).

Stack structure mirrors the reference wrappers exactly:

* :class:`HGNN` / :class:`UniGIN` ↔ ``model/gnn.py:110-134`` (the
  HGsysHGNN wrapper, identical to the PyG/DGL wrappers): input-dropout →
  [conv → activation → dropout]×(nlayer-1) → conv_out → log_softmax.
* :class:`UniGCNII` ↔ ``model/gnn.py:176-208``: Linear → nlayer
  UniGCNIIConv with α=0.1, β_i=log(λ/(i+1)+1), λ=0.5 → Linear, with
  dropout and ReLU as in the reference forward.

Every model is a frozen dataclass with the call shape of a linen module:
``model.init({"params": key}, x, hgd, plan)["params"]`` and
``model.apply({"params": p}, x, hgd, plan, deterministic=False,
rngs={"dropout": key})``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp

from hypergef.models.layers import (
    HGNNConv, KeyScope, UniGCNIIConv, UniGINConv, dense, dense_init,
)

_ACTS = {
    "relu": jax.nn.relu,
    "leaky_relu": lambda x: jax.nn.leaky_relu(x, negative_slope=0.01),
}


def prelu(x, slope):
    """PReLU with one shared learnable slope (ref gnn.py:152)."""
    return jnp.where(x >= 0, x, slope * x)


class _Dropout:
    """Inverted dropout.  The i-th call site of a forward pass is the
    module ``Dropout_i`` and draws its mask from that scope's key."""

    def __init__(self, key):
        self.key = key
        self.calls = 0

    def __call__(self, x, rate: float):
        site = KeyScope(self.key, (f"Dropout_{self.calls}",))
        self.calls += 1
        if self.key is None or rate == 0.0:
            return x
        if rate >= 1.0:
            return jnp.zeros_like(x)
        keep = jax.random.bernoulli(site.key(), 1.0 - rate, x.shape)
        return jnp.where(keep, x / (1.0 - rate), 0.0)


class _Model:
    def init(self, rngs, x, hgd, plan=None, deterministic: bool = True):
        """Returns ``{"params": ...}``; shapes follow ``x`` and ``hgd``."""
        del plan, deterministic
        return {"params": self.init_params(KeyScope(rngs["params"]), x.shape[-1],
                                           hgd.num_edges)}

    def apply(self, variables, x, hgd, plan=None, deterministic: bool = True,
              rngs=None):
        if deterministic:
            drop = _Dropout(None)
        elif rngs is None or "dropout" not in rngs:
            raise ValueError("deterministic=False needs rngs={'dropout': key}")
        else:
            drop = _Dropout(rngs["dropout"])
        return self.forward(variables["params"], x, hgd, plan, drop)


@dataclasses.dataclass(frozen=True)
class HGNN(_Model):
    nhid: int
    nclass: int
    nlayer: int = 2
    first_aggr: str = "sum"
    nhead: int = 1
    dropout: float = 0.6
    input_drop: float = 0.6
    activation: str = "relu"
    learn_wdiag: bool = False
    backend: Optional[str] = None

    def convs(self):
        hidden = HGNNConv(self.nhid, first_aggr=self.first_aggr, heads=self.nhead,
                          learn_wdiag=self.learn_wdiag, backend=self.backend)
        # DELIBERATE deviation from the reference: its conv_out keeps
        # heads=nhead, emitting nhead*nclass logits and softmaxing over
        # that widened vector (gnn.py conv_out quirk) — here the output
        # layer is heads=1 so logits == nclass for any nhead.  Defaults
        # (nhead=1) are identical.
        out = HGNNConv(self.nclass, first_aggr=self.first_aggr, heads=1,
                       learn_wdiag=self.learn_wdiag, backend=self.backend)
        return [hidden] * (self.nlayer - 1) + [out]

    def init_params(self, scope, nfeat, num_edges):
        params, fan_in = {}, nfeat
        for i, conv in enumerate(self.convs()):
            name = f"HGNNConv_{i}"
            params[name] = conv.init(scope.child(name), fan_in, num_edges)
            fan_in = conv.heads * conv.out_features
        return params

    def forward(self, params, x, hgd, plan, drop):
        act = _ACTS[self.activation]
        x = drop(x, self.input_drop)
        convs = self.convs()
        for i, conv in enumerate(convs[:-1]):
            x = drop(act(conv(params[f"HGNNConv_{i}"], x, hgd, plan)), self.dropout)
        x = convs[-1](params[f"HGNNConv_{len(convs) - 1}"], x, hgd, plan)
        return jax.nn.log_softmax(x, axis=1)


@dataclasses.dataclass(frozen=True)
class UniGIN(_Model):
    nhid: int
    nclass: int
    nlayer: int = 2
    nhead: int = 1
    dropout: float = 0.6
    input_drop: float = 0.6
    activation: str = "relu"
    backend: Optional[str] = None

    def convs(self):
        hidden = UniGINConv(self.nhid, heads=self.nhead, backend=self.backend)
        out = UniGINConv(self.nclass, heads=1, backend=self.backend)
        return [hidden] * (self.nlayer - 1) + [out]

    def init_params(self, scope, nfeat, num_edges):
        params, fan_in = {}, nfeat
        for i, conv in enumerate(self.convs()):
            name = f"UniGINConv_{i}"
            params[name] = conv.init(scope.child(name), fan_in, num_edges)
            fan_in = conv.heads * conv.out_features
        return params

    def forward(self, params, x, hgd, plan, drop):
        act = _ACTS[self.activation]
        x = drop(x, self.input_drop)
        convs = self.convs()
        for i, conv in enumerate(convs[:-1]):
            x = drop(act(conv(params[f"UniGINConv_{i}"], x, hgd, plan)), self.dropout)
        x = convs[-1](params[f"UniGINConv_{len(convs) - 1}"], x, hgd, plan)
        return jax.nn.log_softmax(x, axis=1)


@dataclasses.dataclass(frozen=True)
class UniGCNII(_Model):
    nhid: int
    nclass: int
    nlayer: int = 2
    nhead: int = 1
    dropout: float = 0.6
    activation: str = "relu"
    lamda: float = 0.5
    alpha: float = 0.1
    backend: Optional[str] = None

    def init_params(self, scope, nfeat, num_edges):
        nhid = self.nhid * self.nhead
        params = {
            "lin_in": dense_init(scope.child("lin_in"), nfeat, nhid, bias=True),
            "lin_out": dense_init(scope.child("lin_out"), nhid, self.nclass, bias=True),
        }
        for i in range(self.nlayer):
            name = f"UniGCNIIConv_{i}"
            params[name] = UniGCNIIConv(nhid).init(scope.child(name), nhid, num_edges)
        if self.activation == "prelu":
            params["PReLU_0"] = {"negative_slope": jnp.asarray(0.01, jnp.float32)}
        return params

    def forward(self, params, x, hgd, plan, drop):
        if self.activation == "prelu":
            slope = params["PReLU_0"]["negative_slope"]
            act = lambda v: prelu(v, slope)  # noqa: E731
        else:
            act = _ACTS[self.activation]
        conv = UniGCNIIConv(self.nhid * self.nhead, backend=self.backend)
        x = drop(x, self.dropout)
        x = act(dense(params["lin_in"], x))
        x0 = x
        for i in range(self.nlayer):
            x = drop(x, self.dropout)
            beta = math.log(self.lamda / (i + 1) + 1.0)
            x = act(conv(params[f"UniGCNIIConv_{i}"], x, x0, self.alpha, beta, hgd, plan))
        x = drop(x, self.dropout)
        return jax.nn.log_softmax(dense(params["lin_out"], x), axis=1)


def build_model(
    model: str,
    nfeat: int,
    nhid: int,
    nclass: int,
    nlayer: int = 2,
    first_aggr: str = "sum",
    nhead: int = 1,
    dropout: float = 0.6,
    input_drop: float = 0.6,
    activation: str = "relu",
    backend: Optional[str] = None,
):
    """Model registry — the analogue of ``model/gnn.py:15-28`` dicts
    collapsed across backends (backend is an op-level choice here)."""
    del nfeat  # shapes are inferred at init time
    if model == "HGNN":
        return HGNN(
            nhid=nhid,
            nclass=nclass,
            nlayer=nlayer,
            first_aggr=first_aggr,
            nhead=nhead,
            dropout=dropout,
            input_drop=input_drop,
            activation=activation,
            backend=backend,
        )
    if model == "UniGIN":
        return UniGIN(
            nhid=nhid,
            nclass=nclass,
            nlayer=nlayer,
            nhead=nhead,
            dropout=dropout,
            input_drop=input_drop,
            activation=activation,
            backend=backend,
        )
    if model == "UniGCNII":
        return UniGCNII(
            nhid=nhid,
            nclass=nclass,
            nlayer=nlayer,
            nhead=nhead,
            dropout=dropout,
            activation=activation,
            backend=backend,
        )
    raise ValueError(f"unknown model {model!r} (HGNN | UniGIN | UniGCNII)")
