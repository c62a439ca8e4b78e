"""Data-parallel minibatch training: sampled batches over a device mesh.

Composes the two round-1/2 subsystems that were previously separate
(SURVEY.md §2.9 "DP applies to the minibatch/sampled path"; reference has
neither — it is strictly single-GPU full-batch):

* the hyperedge sampler (:mod:`hypergef.data.sampling`) draws one
  padded batch PER DEVICE per step, all forced to one static shape
  (``pad_to`` from :meth:`HyperedgeSampler.probe_pad_shapes`) so the
  whole step is a single compiled program;
* batches stack on a leading device axis sharded over the mesh's edge
  axis; parameters stay replicated.  The per-device forward runs under
  ``jax.vmap`` and GSPMD partitions it along the batch axis with zero
  communication until the loss/gradient reduction — the gradient psum is
  inserted automatically by XLA when the sharded loss is differentiated
  w.r.t. replicated parameters.

Loss semantics: the global masked-mean NLL over all devices' batches
(identical math to running the same batches sequentially and averaging
by mask weight), so DP training is step-equivalent to large-batch
single-device training — tested in tests/test_dp_minibatch.py.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from hypergef.data.sampling import HyperedgeSampler
from hypergef.models.zoo import build_model
from hypergef.parallel.mesh import EDGE_AXIS, make_mesh
from hypergef.train.trainer import TrainConfig, make_optimizer


def stack_batches(batches):
    """Stack same-shape HyperedgeBatch pytrees on a leading device axis.
    Returns (data_stack, vertex_ids [D, N_pad], vertex_mask [D, N_pad])."""
    data = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[b.data for b in batches]
    )
    vids = np.stack([b.vertex_ids for b in batches])
    vmask = np.stack([b.vertex_mask for b in batches])
    return data, vids, vmask


class DPMinibatchTrainer:
    """Minibatch trainer running one sampled batch per mesh device."""

    def __init__(
        self,
        cfg: TrainConfig,
        hg,
        x: np.ndarray,
        y: np.ndarray,
        train_idx: np.ndarray,
        batch_edges: int = 64,
        n_devices: Optional[int] = None,
        nclass: Optional[int] = None,
        sampler_seed: int = 0,
        mesh=None,
    ):
        self.cfg = cfg
        self.hg = hg
        self.x = np.asarray(x, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.int32)
        self.nclass = int(nclass if nclass is not None else self.y.max() + 1)
        self.train_mask_global = np.zeros(hg.num_nodes, dtype=np.float32)
        self.train_mask_global[np.asarray(train_idx)] = 1.0
        n_dev = n_devices if n_devices is not None else len(jax.devices())
        self.mesh = mesh if mesh is not None else make_mesh(
            n_dev, 1, devices=jax.devices()[:n_dev]
        )
        self.n_dev = self.mesh.devices.shape[0]
        self.sampler = HyperedgeSampler(hg, batch_edges, seed=sampler_seed)
        self.pad_to = self.sampler.probe_pad_shapes()
        self.model = build_model(
            cfg.model,
            nfeat=self.x.shape[1],
            nhid=cfg.nhid,
            nclass=self.nclass,
            nlayer=cfg.nlayer,
            first_aggr=cfg.first_aggr,
            nhead=cfg.nhead,
            dropout=cfg.dropout,
            input_drop=cfg.input_drop,
            activation=cfg.activation,
            backend="cumsum",  # plan-free: works on any padded batch
        )
        b0 = self.sampler.sample_batch(pad_to=self.pad_to)
        self.params = self.model.init(
            {"params": jax.random.key(cfg.seed)},
            jnp.asarray(self.x[b0.vertex_ids]), b0.data, None,
            deterministic=True,
        )["params"]
        self.tx = make_optimizer(cfg.lr, cfg.wd)
        self.opt_state = self.tx.init(self.params)
        self._step = self._build_step()

    def _build_step(self):
        from jax.sharding import NamedSharding, PartitionSpec as P

        model, tx = self.model, self.tx
        batch_sharding = NamedSharding(self.mesh, P(EDGE_AXIS))
        replicated = NamedSharding(self.mesh, P())
        self._batch_sharding = batch_sharding

        def loss_fn(params, rngs, data_stack, xb, yb, mask):
            # vmap over the device axis; GSPMD splits it across the mesh
            def one(rng, data, xbi, ybi, mi):
                z = model.apply(
                    {"params": params}, xbi, data, None, deterministic=False,
                    rngs={"dropout": rng},
                )
                picked = jnp.take_along_axis(z, ybi[:, None], axis=1)[:, 0]
                return -jnp.sum(picked * mi), mi.sum()

            nll, cnt = jax.vmap(one)(rngs, data_stack, xb, yb, mask)
            # global masked mean across ALL devices' batches
            return jnp.sum(nll) / jnp.maximum(jnp.sum(cnt), 1.0)

        @jax.jit
        def step(params, opt_state, rngs, data_stack, xb, yb, mask):
            loss, grads = jax.value_and_grad(loss_fn)(
                params, rngs, data_stack, xb, yb, mask
            )
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        self._replicated = replicated
        return step

    def _place(self, data, vids, vmask):
        """Shard the stacked batch on the mesh's edge axis."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = self._batch_sharding
        data = jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), data)
        xb = jax.device_put(jnp.asarray(self.x[vids]), sh)
        yb = jax.device_put(jnp.asarray(self.y[vids]), sh)
        mask = jax.device_put(
            jnp.asarray(vmask * self.train_mask_global[vids]), sh
        )
        return data, xb, yb, mask

    def step_once(self, rng):
        batches = [
            self.sampler.sample_batch(pad_to=self.pad_to)
            for _ in range(self.n_dev)
        ]
        data, vids, vmask = stack_batches(batches)
        data, xb, yb, mask = self._place(data, vids, vmask)
        rngs = jax.random.split(rng, self.n_dev)
        self.params, self.opt_state, loss = self._step(
            self.params, self.opt_state, rngs, data, xb, yb, mask
        )
        return loss

    def fit(self, steps: int = 10) -> Dict[str, float]:
        rng = jax.random.key(self.cfg.seed + 1)
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            rng, sub = jax.random.split(rng)
            losses.append(self.step_once(sub))
        final = float(losses[-1])  # device fence
        return {
            "final_loss": final,
            "mean_loss": float(np.mean([float(l) for l in losses[-10:]])),
            "steps": steps,
            "devices": self.n_dev,
            "time_s": time.perf_counter() - t0,
        }

    def evaluate_full(self, split_idx, plan=None) -> Dict[str, float]:
        """Full-graph evaluation with the trained DP params."""
        from hypergef.train.splits import accuracy

        hgd = self.hg.device_data()
        z = np.asarray(
            self.model.apply(
                {"params": self.params}, jnp.asarray(self.x), hgd, plan,
                deterministic=True,
            )
        )
        out = {}
        for name, idx in split_idx.items():
            idx = np.asarray(idx)
            if idx.size:
                out[f"{name}_acc"] = accuracy(z[idx], self.y[idx])
        return out
