"""Hypergraph convolution layers (plain JAX).

One implementation per conv family — there is no per-backend model code
as in the reference (which triplicates every conv across pyg/dgl/ugsys,
``model/gnn.py:15-28``); the aggregation backend is selected underneath
by :mod:`hypergef.ops.fused`, so every layer runs on the oracle XLA
path or any planned backend unchanged.

Each layer is a frozen dataclass of hyperparameters with two methods:
``init(scope, in_features, num_edges) -> params`` (a nested dict whose
names match the ``HGNNConv_0/linear/kernel`` layout callers index) and
``__call__(params, ...)``, the forward pass.

Semantics parity:

* :class:`HGNNConv` ↔ ``model/ugsys/hgnn.py:7-27`` / ``model/pygnn/
  hgnn.py:25-38`` (projection then fused aggregation with per-hyperedge
  diagonal weight; ``Wdiag`` is a ones buffer in the reference, here
  optionally learnable).
* :class:`UniGINConv` ↔ ``model/pygnn/unigin.py:17-26``:
  ``(1+ε)·XW + H Hᵀ (XW)`` with learnable scalar ε (init 0).
* :class:`UniGCNIIConv` ↔ ``model/pygnn/unigcnii.py:23-36``: degree-
  scaled propagation plus α/β identity-mapping residuals.  (The
  reference's own fused UniGCNII path is dead code — SURVEY.md §2.8-2 —
  so the PyG semantics are the ground truth.)
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import jax
import jax.numpy as jnp

from hypergef.ops import fused

# fan-in truncated normal, the usual default for dense kernels
_kernel_init = jax.nn.initializers.lecun_normal()


@dataclasses.dataclass(frozen=True)
class KeyScope:
    """A root key plus a module path.  ``key(n)`` is the key of the n-th
    random draw in that module: the first 4 bytes of the SHA-1 of the
    path and n, folded into the root key.  This is the derivation of
    ``flax.linen``, under which this package's checkpoints were first
    written, so the same seed gives the same parameters and dropout
    masks as before."""

    root: object
    path: tuple = ()

    def child(self, name: str) -> "KeyScope":
        return KeyScope(self.root, self.path + (name,))

    def key(self, n: int = 1):
        h = hashlib.sha1()
        for x in self.path + (n,):
            h.update(x.encode() if isinstance(x, str)
                     else x.to_bytes((x.bit_length() + 7) // 8, "big"))
        return jax.random.fold_in(
            self.root, jnp.uint32(int.from_bytes(h.digest()[:4], "big")))


def dense_init(scope: KeyScope, fan_in: int, fan_out: int, bias: bool = False) -> dict:
    p = {"kernel": _kernel_init(scope.key(), (fan_in, fan_out), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((fan_out,), jnp.float32)
    return p


def dense(p: dict, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


@dataclasses.dataclass(frozen=True)
class HGNNConv:
    out_features: int
    first_aggr: str = "sum"
    heads: int = 1
    learn_wdiag: bool = False
    backend: Optional[str] = None

    def init(self, scope: KeyScope, in_features: int, num_edges: int) -> dict:
        p = {"linear": dense_init(scope.child("linear"), in_features,
                                  self.heads * self.out_features)}
        if self.learn_wdiag:
            p["wdiag"] = jnp.ones((num_edges, 1), jnp.float32)
        return p

    def __call__(self, params, x, hgd, plan=None):
        x = dense(params["linear"], x)
        # frozen Wdiag ≡ ones: pass None so backends that fold the
        # scaling ahead of time (precomp) stay applicable
        wdiag = params.get("wdiag")
        return fused.hgnn_aggregate(
            hgd, x, wdiag, self.first_aggr, plan=plan, backend=self.backend
        )


@dataclasses.dataclass(frozen=True)
class UniGINConv:
    out_features: int
    heads: int = 1
    backend: Optional[str] = None

    def init(self, scope: KeyScope, in_features: int, num_edges: int) -> dict:
        del num_edges
        return {
            "linear": dense_init(scope.child("linear"), in_features,
                                 self.heads * self.out_features),
            "eps": jnp.zeros((1,), jnp.float32),
        }

    def __call__(self, params, x, hgd, plan=None):
        x = dense(params["linear"], x)
        xv = fused.unignn_aggregate(hgd, x, use_deg=False, plan=plan, backend=self.backend)
        return (1.0 + params["eps"]) * x + xv


@dataclasses.dataclass(frozen=True)
class UniGCNIIConv:
    out_features: int
    backend: Optional[str] = None

    def init(self, scope: KeyScope, in_features: int, num_edges: int) -> dict:
        del num_edges
        return {"W": dense_init(scope.child("W"), in_features, self.out_features)}

    def __call__(self, params, x, x0, alpha, beta, hgd, plan=None):
        xv = fused.unignn_aggregate(hgd, x, use_deg=True, plan=plan, backend=self.backend)
        xi = (1.0 - alpha) * xv + alpha * x0
        return (1.0 - beta) * xi + beta * dense(params["W"], xi)
