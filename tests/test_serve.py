"""Serving / AOT-export tests (hypergef.serve).

The reference has no serving or persistence subsystem (SURVEY.md §5) —
these tests cover the new capability: a trained forward exports to one
self-contained artifact that reproduces the live model's outputs exactly
and loads in a fresh process without any model/planner code paths.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from hypergef import serve
from hypergef.data.synthetic import homophilic_hypergraph, random_features
from hypergef.train import TrainConfig, Trainer, rand_train_test_idx


@pytest.fixture(scope="module")
def trained():
    hg, y = homophilic_hypergraph(150, 90, 3, avg_edge_size=5.0, seed=4)
    x, _ = random_features(hg.num_nodes, 16, 3, seed=5)
    split = rand_train_test_idx(y, seed=6)
    tr = Trainer(TrainConfig(model="HGNN", nhid=16, epochs=5, warmup=0), hg, x, y)
    tr.fit(split["train"], epochs=5, warmup=0)
    return tr, x


def test_export_roundtrip_exact(trained, tmp_path):
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    meta = serve.export_trainer(tr, path)
    assert meta["model"] == "HGNN"
    assert meta["nclass"] == tr.nclass
    assert os.path.getsize(path) > len(serve._MAGIC) + 4

    m = serve.ServingModel.load(path)
    got = np.asarray(m.predict(x))
    want = np.asarray(tr._forward(tr.params, tr.x))
    # same program, same platform → bit-identical is the expectation;
    # allow float tolerance for compiler-version drift
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # log-softmax outputs: rows are log-probabilities
    assert np.allclose(np.exp(got).sum(axis=1), 1.0, atol=1e-4)


def test_cuda_and_cpu_artifact_predicts_on_cpu(trained, tmp_path):
    """One artifact lowered for the GPU and the CPU loads and predicts
    here; the GPU lowering needs no GPU at export time."""
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    meta = serve.export_trainer(tr, path, platforms=["cuda", "cpu"])
    assert meta["platforms"] == ["cuda", "cpu"]
    got = np.asarray(serve.ServingModel.load(path).predict(x))
    np.testing.assert_allclose(got, np.asarray(tr._forward(tr.params, tr.x)),
                               rtol=1e-6, atol=1e-6)


def test_metadata_inspection_without_deserialize(trained, tmp_path):
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    serve.export_trainer(tr, path)
    meta, payload = serve.read_artifact(path)
    assert meta["input_shape"] == list(tr.x.shape)
    assert meta["output_shape"] == [tr.hg.num_nodes, tr.nclass]
    assert meta["payload_bytes"] == len(payload)
    assert meta["format_version"] == serve._FORMAT_VERSION


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"NOTANARTIFACT")
    with pytest.raises(ValueError, match="bad magic"):
        serve.read_artifact(str(p))


def test_truncated_artifact_rejected(trained, tmp_path):
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    serve.export_trainer(tr, path)
    data = open(path, "rb").read()
    for cut in (len(serve._MAGIC) + 2, len(serve._MAGIC) + 4 + 5):
        p = tmp_path / "trunc.bin"
        p.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="truncated"):
            serve.read_artifact(str(p))


def test_future_format_version_rejected(trained, tmp_path):
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    serve.export_trainer(tr, path)
    meta, payload = serve.read_artifact(path)
    meta["format_version"] = serve._FORMAT_VERSION + 1
    p = str(tmp_path / "future.hgefsrv")
    # save_artifact re-stamps format_version; write the header by hand
    import json as _json
    import struct as _struct

    hdr = _json.dumps(meta).encode()
    with open(p, "wb") as f:
        f.write(serve._MAGIC)
        f.write(_struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload)
    with pytest.raises(ValueError, match="format_version"):
        serve.ServingModel.load(p)


def test_shape_mismatch_rejected(trained, tmp_path):
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    serve.export_trainer(tr, path)
    m = serve.ServingModel.load(path)
    with pytest.raises(ValueError, match="static-shape"):
        m.predict(jnp.zeros((7, x.shape[1]), jnp.float32))


def test_predict_labels_match_argmax(trained, tmp_path):
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    serve.export_trainer(tr, path)
    m = serve.ServingModel.load(path)
    labels = m.predict_labels(x)
    assert labels.shape == (tr.hg.num_nodes,)
    assert labels.dtype.kind == "i"
    np.testing.assert_array_equal(
        labels, np.argmax(np.asarray(m.predict(x)), axis=1)
    )


def test_unignn_families_export(tmp_path):
    hg, y = homophilic_hypergraph(120, 70, 3, avg_edge_size=4.0, seed=7)
    x, _ = random_features(hg.num_nodes, 12, 3, seed=8)
    for fam in ("UniGIN", "UniGCNII"):
        tr = Trainer(TrainConfig(model=fam, nhid=12, epochs=2, warmup=0), hg, x, y)
        path = str(tmp_path / f"{fam}.hgefsrv")
        serve.export_trainer(tr, path)
        m = serve.ServingModel.load(path)
        got = np.asarray(m.predict(x))
        want = np.asarray(tr._forward(tr.params, tr.x))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


_FRESH_PROCESS_PROG = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import numpy as np
from hypergef import serve
m = serve.ServingModel.load({path!r})
x = np.load({xpath!r})
out = np.asarray(m.predict(x))
np.save({outpath!r}, out)
print("OK", out.shape)
"""


def test_fresh_process_load(trained, tmp_path):
    """The deployment property: a process that never saw the model code
    path (no Trainer, no planner, no graph) serves from the artifact."""
    tr, x = trained
    path = str(tmp_path / "m.hgefsrv")
    serve.export_trainer(tr, path)
    xpath = str(tmp_path / "x.npy")
    outpath = str(tmp_path / "out.npy")
    np.save(xpath, np.asarray(x))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = _FRESH_PROCESS_PROG.format(
        repo=repo, path=path, xpath=xpath, outpath=outpath
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=300, env=env,
    )
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    got = np.load(outpath)
    want = np.asarray(tr._forward(tr.params, tr.x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


_NO_FLATBUFFERS_PROG = """
import sys
sys.modules["flatbuffers"] = None  # any import of it now fails
sys.path.insert(0, {repo!r})
import numpy as np
from hypergef import serve
from hypergef.data.synthetic import random_features, random_hypergraph
from hypergef.train import TrainConfig, Trainer
hg = random_hypergraph(40, 20, avg_edge_size=4.0, seed=1)
x, y = random_features(40, 5, 3, seed=2)
tr = Trainer(TrainConfig(nhid=4, epochs=1, warmup=0), hg, x, y)
serve.export_trainer(tr, {path!r}, platforms=["cuda", "cpu"])
got = np.asarray(serve.ServingModel.load({path!r}).predict(x))
np.testing.assert_allclose(got, np.asarray(tr._forward(tr.params, tr.x)),
                           rtol=1e-6, atol=1e-6)
print("served")
"""


def test_export_and_load_need_no_flatbuffers(tmp_path):
    """jax.export's own serializer needs the optional flatbuffers
    package; artifacts are written and read without it."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = _NO_FLATBUFFERS_PROG.format(repo=repo, path=str(tmp_path / "m.hgefsrv"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0 and "served" in r.stdout, r.stderr[-3000:]
