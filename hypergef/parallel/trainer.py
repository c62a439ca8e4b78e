"""Distributed trainer: edge-partitioned full-batch training on a mesh.

BASELINE config #5 driver: train the 2-layer HGNN with the sharded
aggregation program, reference timing protocol, usable on the simulated
CPU mesh (tests / dry-runs) and on real multi-chip meshes unchanged.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hypergef.parallel.dist_model import init_dist_params, make_dist_train_step
from hypergef.parallel.mesh import make_mesh
from hypergef.parallel.partition import plan_sharded_aggregation
from hypergef.train.splits import accuracy


class DistTrainer:
    def __init__(
        self,
        hg,
        x: np.ndarray,
        y: np.ndarray,
        nhid: int = 32,
        nclass: Optional[int] = None,
        n_shards: Optional[int] = None,
        n_feature: int = 1,
        lr: float = 0.01,
        wd: float = 5e-4,
        seed: int = 1,
        mesh=None,
        model: str = "HGNN",
        first_aggr: str = "sum",
    ):
        n_dev = len(jax.devices())
        if mesh is None:
            if n_shards is None:
                n_shards = n_dev // n_feature
            mesh = make_mesh(n_shards, n_feature,
                             devices=jax.devices()[: n_shards * n_feature])
        self.mesh = mesh
        self.n_shards = mesh.devices.shape[0]
        self.plan = plan_sharded_aggregation(hg, self.n_shards)
        self.x = jnp.asarray(x, dtype=jnp.float32)
        self.y = jnp.asarray(np.asarray(y), dtype=jnp.int32)
        self.nclass = int(nclass if nclass is not None else int(np.asarray(y).max()) + 1)
        self.degV = jnp.asarray(hg.degV)
        n_f = mesh.devices.shape[1]
        if nhid % n_f != 0:
            raise ValueError(f"nhid={nhid} must be divisible by the feature-mesh axis ({n_f})")
        self.model = model
        if model == "HGNN":
            self.step, self.tx, self.forward, self.run_epochs = make_dist_train_step(
                mesh, self.plan, self.degV, lr=lr, wd=wd, first_aggr=first_aggr,
                feature_sharded=(n_f > 1), nclass=self.nclass,
            )
            self.params = init_dist_params(
                jax.random.key(seed), self.x.shape[1], nhid, self.nclass,
                class_pad=n_f,
            )
        elif model == "UniGIN":
            if first_aggr != "sum":
                raise ValueError(
                    "DistTrainer(model='UniGIN') supports first_aggr='sum' "
                    f"only (got {first_aggr!r}); the UniGNN family is a plain "
                    "H·Hᵀ sum aggregation (SURVEY §0)")
            from hypergef.parallel.dist_model import (
                init_unigin_params, make_dist_unigin_train_step)

            self.step, self.tx, self.forward, self.run_epochs = (
                make_dist_unigin_train_step(
                    mesh, self.plan, lr=lr, wd=wd,
                    feature_sharded=(n_f > 1), nclass=self.nclass))
            self.params = init_unigin_params(
                jax.random.key(seed), self.x.shape[1], nhid, self.nclass,
                class_pad=n_f)
        elif model == "UniGCNII":
            if first_aggr != "sum":
                raise ValueError(
                    "DistTrainer(model='UniGCNII') supports first_aggr='sum' "
                    f"only (got {first_aggr!r}); UniGCNII's V→E stage is a "
                    "degE-scaled sum (SURVEY §0)")
            from hypergef.parallel.dist_model import (
                init_unigcnii_params, make_dist_unigcnii_train_step)

            self.step, self.tx, self.forward, self.run_epochs = (
                make_dist_unigcnii_train_step(
                    mesh, self.plan, self.degV, lr=lr, wd=wd,
                    feature_sharded=(n_f > 1), nclass=self.nclass))
            self.params = init_unigcnii_params(
                jax.random.key(seed), self.x.shape[1], nhid, self.nclass,
                class_pad=n_f)
        else:
            raise ValueError(f"unknown distributed model {model!r}")
        self.opt_state = self.tx.init(self.params)

    def fit(self, train_idx, epochs: int = 100, warmup: int = 10,
            fence_every: int = 0, chained: bool = True) -> Dict[str, float]:
        """Default (``chained=True``): all epochs run as ONE jitted
        ``lax.scan`` program — a single dispatch, so dispatch latency is
        excluded by construction and the simulated CPU mesh's async
        dispatch queue (which intermittently SIGABRTs with many in-flight
        multi-device programs — round-1's ``fence_every`` workaround)
        never holds more than one program.  The first call compiles and
        serves as warm-up; the second identical call is timed.

        ``chained=False`` restores the per-step dispatch loop
        (``fence_every > 0`` synchronizes every N steps)."""
        mask = np.zeros(self.x.shape[0], dtype=np.float32)
        mask[np.asarray(train_idx)] = 1.0
        mask = jnp.asarray(mask)
        params, opt_state = self.params, self.opt_state
        if chained:
            params, opt_state, loss = self.run_epochs(
                params, opt_state, self.x, self.y, mask, n=epochs
            )
            jax.block_until_ready(loss)  # compile + warm-up
            t0 = time.perf_counter()
            params, opt_state, loss = self.run_epochs(
                params, opt_state, self.x, self.y, mask, n=epochs
            )
            jax.block_until_ready(loss)
            dt = time.perf_counter() - t0
        else:
            loss = jnp.zeros(())
            for i in range(warmup):
                params, opt_state, loss = self.step(
                    params, opt_state, self.x, self.y, mask
                )
                if fence_every and (i + 1) % fence_every == 0:
                    jax.block_until_ready(loss)
            jax.block_until_ready(loss)
            t0 = time.perf_counter()
            for i in range(epochs):
                params, opt_state, loss = self.step(
                    params, opt_state, self.x, self.y, mask
                )
                if fence_every and (i + 1) % fence_every == 0:
                    jax.block_until_ready(loss)
            jax.block_until_ready(loss)
            dt = time.perf_counter() - t0
        self.params, self.opt_state = params, opt_state
        return {
            "train_epoch_time_s": dt / max(epochs, 1),
            "final_loss": float(loss),
            "n_shards": self.n_shards,
        }

    def evaluate(self, split_idx) -> Dict[str, float]:
        z = np.asarray(self.forward(self.params, self.x))
        y = np.asarray(self.y)
        return {
            f"{name}_acc": accuracy(z[np.asarray(idx)], y[np.asarray(idx)])
            for name, idx in split_idx.items()
            if np.asarray(idx).size
        }

    # ------------------------------------------------------------------
    def save(self, directory: str, step: int = 0) -> None:
        """Checkpoint the distributed training state (train.checkpoint;
        a restore re-shards onto the live mesh).  Resume across restarts
        is a subsystem the reference lacks entirely (SURVEY §5)."""
        from hypergef.train.checkpoint import save_checkpoint

        save_checkpoint(directory, step, self.params, self.opt_state)

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        """Restore (params, opt_state) in place from the latest (or given)
        step; the current state pytrees serve as sharding templates so
        restored arrays land with the trainer's mesh placement."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from hypergef.train.checkpoint import restore_checkpoint

        step, params, opt_state = restore_checkpoint(
            directory, self.params, self.opt_state, step=step
        )
        # the step program consumes params/opt_state replicated across
        # the mesh — place them so shard_map sees mesh-consistent inputs.
        rep = NamedSharding(self.mesh, P())
        put = lambda v: jax.device_put(v, rep)  # noqa: E731
        self.params = jax.tree_util.tree_map(put, params)
        self.opt_state = jax.tree_util.tree_map(put, opt_state)
        return step
