"""``chip_smoke.py``: its phases at tiny sizes on the CPU (with the
device check pointed at the CPU), its refusal to run without a GPU, and
the full script on a GPU when one is present."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

NEWS = dict(n=400, e=30, avg=25.0, feat=10, classes=4, nhid=8)
PUBMED = dict(n=600, e=250, avg=8.0)
SBM = dict(n=1500, e=800, comm=10, avg=8, noise=0.02)
CORA = dict(n=200, e=200, avg=4.0)


def test_device_phase_checks_the_platform():
    assert cs.device_phase("cpu", query_smi=False)["platform"] == "cpu"
    with pytest.raises(cs.PhaseFailed, match="not 'gpu'"):
        cs.device_phase("gpu", query_smi=False)


def test_check_rejects_mismatch_and_nonfinite():
    assert cs.check("same", [1.0, 2.0], [1.0, 2.0], 1e-6) == 0.0
    with pytest.raises(cs.PhaseFailed):
        cs.check("off", [1.0, 2.1], [1.0, 2.0], 1e-3)
    with pytest.raises(cs.PhaseFailed, match="non-finite"):
        cs.check("nan", [float("nan")], [1.0], 1.0)
    with pytest.raises(cs.PhaseFailed, match="shape"):
        cs.check("shape", [1.0], [1.0, 2.0], 1.0)


def test_train_phase_tiny():
    res = cs.train_phase(NEWS, epochs=2, warmup=1, cli_args=[
        "--synthetic", "homophilic", "--n", "200", "--e", "120", "--epochs", "2"])
    assert res["backend"] == "dense"


def test_reference_phase_tiny():
    errs = cs.reference_phase(NEWS, steps=2)
    assert errs["loss"] < cs.MODEL_TOL and errs["forward"] < cs.MODEL_TOL


def test_models_phase_tiny():
    assert set(cs.models_phase(NEWS)) == {"UniGIN", "UniGCNII"}


def test_backends_phase_covers_every_backend():
    from hypergef.ops import fused

    errs = cs.backends_phase(PUBMED, SBM, CORA, feat=4)
    ran = {k.split("/")[1] for k in errs if "/" in k}
    assert ran == set(fused._VALID) - {"auto"}
    assert "packed_int4" in errs


def test_backend_plans_report_refusals():
    # random (not community-sorted) and wide enough to spill the band
    plans = cs.backend_plans(cs.random_graph(dict(n=3000, e=1200, avg=10.8), "p"))
    assert isinstance(plans["aligned"], str) and "guard" in plans["aligned"]
    assert plans["xla"] is None and not isinstance(plans["tree"], str)


def test_serve_phase_exports_for_cuda_and_cpu():
    assert cs.serve_phase(NEWS, platforms=("cuda", "cpu")) < cs.MODEL_TOL


def test_multicard_phase_on_four_cpu_devices():
    errs = cs.multicard_phase(SBM, n_cards=4, feat=8, nhid=8, classes=4)
    assert errs["dist_grad"] < cs.F32_TOL and errs["halo_grad"] < cs.F32_TOL
    assert errs["dense_fwd"] < cs.BF16_TOL


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` on the card")


@pytest.mark.gpu
def test_full_smoke_on_gpu(gpu):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is True
