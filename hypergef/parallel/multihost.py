"""Multi-host execution layer: process initialization + hybrid meshes.

The reference is single-GPU; SURVEY.md §5 names a distributed
communication backend (fast links within a host, the network across
hosts) as part of the design.  This module is that layer:

* :func:`init_distributed` — wraps ``jax.distributed.initialize`` with
  env-var autodetection (works for GPU clusters and the multi-process
  CPU harness the tests use);
* :func:`make_hybrid_mesh` — a process-aware mesh factory that puts the
  edge-partition axis on the fast interconnect (within a process / host)
  and the data/batch axis across processes: collectives that move
  per-nnz halo traffic must ride the fast links, only gradient/parameter
  reductions cross hosts;
* :func:`local_shard_info` — which global mesh rows this process owns
  (for feeding process-local data into ``jax.make_array_from_callback``).

Validated by a real 2-process × 4-device CPU run
(``tests/test_multihost.py`` spawns worker processes that rendezvous via
a localhost coordinator and run a psum across process boundaries).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from hypergef.parallel.mesh import EDGE_AXIS, FEATURE_AXIS

DATA_AXIS = "d"  # DCN-crossing axis (gradient/batch reductions)

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize the JAX distributed runtime for this process.

    All arguments default from the standard env vars
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``)
    so launchers only need to export them.  Safe to call when
    single-process (no coordinator configured → no-op).
    """
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return  # single-process run
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def make_hybrid_mesh(
    n_edge: Optional[int] = None,
    n_feature: int = 1,
    n_data: Optional[int] = None,
) -> Mesh:
    """Process-aware (d, e, f) mesh.

    Axis layout follows the ICI/DCN recipe: devices of one process (one
    ICI domain in the multi-host setting) stay contiguous along the
    ``e``/``f`` axes, and the ``d`` axis crosses processes.  With
    ``n_data = jax.process_count()`` (the default in multi-process runs)
    every halo ``all_to_all`` over ``e`` is process-local (ICI) and only
    ``psum`` over ``d`` (gradients) crosses DCN.

    Single-process: degenerates to ``d=1`` over the local devices, so
    callers can use one code path everywhere.
    """
    devices = jax.devices()
    n_proc = jax.process_count()
    n_local = len(devices) // n_proc
    if n_data is None:
        n_data = n_proc if n_proc > 1 else 1
    per_data = len(devices) // n_data
    if n_edge is None:
        n_edge = per_data // n_feature
    if n_data * n_edge * n_feature != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_edge}x{n_feature} does not cover "
            f"{len(devices)} devices"
        )
    # order devices so each d-row is one process's devices (jax.devices()
    # is already process-major: process 0's local devices first)
    if n_data == n_proc and per_data == n_local:
        arr = np.asarray(devices).reshape(n_data, n_edge, n_feature)
    else:
        arr = np.asarray(devices).reshape(n_data, n_edge, n_feature)
    return Mesh(arr, (DATA_AXIS, EDGE_AXIS, FEATURE_AXIS))


def local_shard_info(mesh: Mesh, axis: str = EDGE_AXIS) -> dict:
    """Which slots along ``axis`` this process's devices occupy.

    Used to feed process-local shards into
    ``jax.make_array_from_callback`` without materializing global arrays
    on every host.
    """
    local = set(jax.local_devices())
    axes = list(mesh.axis_names)
    ai = axes.index(axis)
    coords = []
    it = np.ndindex(*mesh.devices.shape)
    for idx in it:
        if mesh.devices[idx] in local:
            coords.append(idx[ai])
    return {
        "axis_size": mesh.devices.shape[ai],
        "local_slots": sorted(set(coords)),
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
    }
