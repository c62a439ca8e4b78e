"""Smoke tests for the experiment harness scripts (tiny settings, CPU)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    XLA_FLAGS="--xla_force_host_platform_device_count=8",
    PYTHONPATH=ROOT,
)


def run(script, *args, timeout=360):
    cmd = [sys.executable, os.path.join(ROOT, "experiments", script), *args]
    return subprocess.run(cmd, env=ENV, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)


@pytest.fixture(autouse=True)
def _force_cpu_in_scripts(monkeypatch):
    yield


def test_fig7_9_smoke(tmp_path):
    r = run("fig7_9.py", "--configs", "cora", "--backends", "cumsum,tree",
            "--iters", "3", "--out", str(tmp_path / "f.csv"))
    assert r.returncode == 0, r.stderr[-2000:]
    body = open(tmp_path / "f.csv").read()
    assert "cumsum" in body and "tree" in body


def test_fig10_smoke(tmp_path):
    r = run("fig10.py", "--config", "cora", "--ngs", "8,16", "--iters", "3",
            "--out", str(tmp_path / "f.csv"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ngs=8" in open(tmp_path / "f.csv").read()


def test_fig8_smoke(tmp_path):
    r = run("fig8.py", "--configs", "cora", "--out", str(tmp_path / "f.csv"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "bytes=" in open(tmp_path / "f.csv").read()


def test_weak_scaling_smoke(tmp_path):
    r = run("weak_scaling.py", "--shards", "1,2", "--nnz-per-shard", "5000",
            "--iters", "2", "--link-gbps", "450", "--ns-per-nnz", "2",
            "--ns-per-nnz-aligned", "1", "--out", str(tmp_path / "ws.csv"))
    assert r.returncode == 0, r.stderr[-2000:]
    body = open(tmp_path / "ws.csv").read()
    # plan-derived traffic schema (round 2): comm fraction + per-link
    # bytes + modeled link time, for random AND clustered graphs
    assert "comm_frac" in body and "max_link_MB" in body
    assert "clustered,2," in body and "random,2," in body


def test_bench_kernel_smoke(tmp_path):
    cmd = [sys.executable, os.path.join(ROOT, "bench.py"), "--mode", "kernel",
           "--config", "cora", "--backend", "tree", "--iters", "3"]
    r = subprocess.run(cmd, env=ENV, capture_output=True, text=True,
                       timeout=360, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"vs_baseline"' in r.stdout


def test_fig7_9_realistic_smoke(tmp_path):
    """Round-4 realistic fig7/9 driver: production pipeline from raw
    (shuffle -> coarsen reorder -> ladder) on a small real-dims name."""
    r = run("fig7_9_realistic.py", "--configs", "zoo", "--iters", "3",
            "--out", str(tmp_path / "f.csv"))
    assert r.returncode == 0, r.stderr[-2000:]
    body = open(tmp_path / "f.csv").read()
    assert "SUMMARY,zoo" in body and "xla" in body
    assert "reorder=" in body and "plan=" in body


def test_minibatch_bench_smoke(tmp_path):
    """Config-#4 perf driver: full-batch vs minibatch time-to-band rows
    with the compile-count column."""
    import experiments.minibatch_bench as mb

    mb.WORKLOADS["tiny"] = (600, 300, 3, 5.0, 8)
    try:
        sys.argv = ["minibatch_bench.py", "--workloads", "tiny",
                    "--epochs", "20", "--batch-edges", "64",
                    "--eval-every", "10",
                    "--out", str(tmp_path / "mb.csv")]
        mb.main()
    finally:
        del mb.WORKLOADS["tiny"]
    body = open(tmp_path / "mb.csv").read()
    assert "tiny,full_batch," in body
    assert "tiny,minibatch_be64," in body
    # compile-count column present and small for the minibatch row
    mb_row = [l for l in body.splitlines() if "minibatch_be64" in l][0]
    assert int(mb_row.split(",")[-1]) <= 3


def test_serve_bench_smoke(tmp_path):
    """Serving-path perf driver: export/load/latency row with the
    artifact-vs-live parity column (asserted < 1e-4 inside the driver)."""
    import experiments.serve_bench as sb

    sb.WORKLOADS["tiny"] = (600, 300, 3, 5.0, 8)
    try:
        sys.argv = ["serve_bench.py", "--workloads", "tiny",
                    "--epochs", "10", "--calls", "8",
                    "--artifact-dir", str(tmp_path),
                    "--out", str(tmp_path / "serve.csv")]
        sb.main()
    finally:
        del sb.WORKLOADS["tiny"]
    body = open(tmp_path / "serve.csv").read()
    assert body.startswith("workload,nnz,feat,backend,export_s,artifact_mb,")
    row = [l for l in body.splitlines() if l.startswith("tiny,")][0]
    cols = row.split(",")
    assert float(cols[5]) > 0          # artifact_mb
    assert float(cols[8]) > 0          # warm_ms_median
    assert float(cols[12]) > 0         # dev_us_forward
    assert float(cols[-1]) < 1e-4      # parity_max_abs


def test_scale_serialized_smoke(tmp_path):
    """Serialized halo measurement driver (100M artifact) at toy scale."""
    r = run("scale_serialized.py", "--nodes", "4000", "--edges", "2000",
            "--comm", "10", "--shards", "2", "--iters", "2",
            "--link-gbps", "450", "--plan-cache", str(tmp_path / "pc"),
            "--out", str(tmp_path / "s.csv"), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    body = open(tmp_path / "s.csv").read()
    assert "MEASURED(serialized)" in body
    assert "halo_buffer" in body and "link_transfer" in body
