"""Multi-host layer validation: a REAL 2-process × 4-device CPU run.

Spawns two worker processes that rendezvous through jax.distributed on a
localhost coordinator, build the hybrid (d, e, f) mesh, and run psums
across the process boundary (the reference has no
jax.distributed equivalent anywhere).
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_mesh():
    port = _free_port()
    workers = []
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            JAX_PLATFORMS="cpu",
        )
        # drop any single-process device-count forcing from the parent
        env.pop("PYTEST_XDIST_WORKER", None)
        workers.append(
            subprocess.Popen(
                [sys.executable, worker],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in workers:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out[-3000:]}"
        assert "WORKER_OK" in out, out[-3000:]


def test_single_process_defaults():
    """init_distributed is a no-op without a coordinator; hybrid mesh
    degenerates to d=1 over local devices."""
    from hypergef.parallel import multihost

    multihost.init_distributed()  # no env → no-op
    mesh = multihost.make_hybrid_mesh(n_edge=4, n_feature=2)
    assert mesh.devices.shape == (1, 4, 2)
    info = multihost.local_shard_info(mesh)
    assert info["process_count"] == 1
    assert info["local_slots"] == [0, 1, 2, 3]
