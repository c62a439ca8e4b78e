"""AOT export / serving: package a trained forward pass as a single
self-contained artifact.

The reference has **no serving story**: models retrain from scratch each
run and nothing is persisted but CSVs (SURVEY.md §5 "Checkpoint / resume:
none"; ``hgsys.py:207-211``).  For a framework intended for production
deployment this is the missing last mile, and it is where the XLA stack
has a structural advantage worth exposing: ``jax.export`` lowers the
*entire* jitted forward — weights, incidence tables, the planner's
schedule constants, every fused elementwise chain — into one serialized
StableHLO program.  A serving process then needs **no model code, no
planner, no graph data, and no tracing**: it deserializes and calls.

Artifact layout (one file)::

    magic "HGEFSRV1" | u32 header_len | header JSON (utf-8) | payload

where the payload is the program's StableHLO bytecode (from
``jax.export``) and the header carries human-readable metadata (model
family, shapes, class count, export platforms, package version) plus
the program's calling signature, so an artifact is self-describing
without loading the program.

Typical flow::

    tr = Trainer(cfg, hg, x, y); tr.fit(split["train"])
    serve.export_trainer(tr, "model.hgefsrv", platforms=["cuda", "cpu"])
    ...
    m = serve.ServingModel.load("model.hgefsrv")
    logp = m.predict(x)            # jitted AOT call, zero retracing

Cross-platform note: pass ``platforms=["cuda", "cpu"]`` to emit a single
artifact loadable on both (XLA lowers per platform at export time); the
default exports for the platform the export process runs on.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np

_MAGIC = b"HGEFSRV1"
_FORMAT_VERSION = 2


def export_forward(
    model,
    params,
    hgd,
    plan,
    example_x,
    platforms: Optional[Sequence[str]] = None,
):
    """Lower ``model.apply(params, x, hgd, plan, deterministic=True)`` to
    an AOT ``jax.export.Exported`` over a single runtime argument ``x``.

    Weights and graph/schedule tables enter as closure constants — they
    ARE the model being deployed; ``x`` is the only thing a serving
    request supplies.
    """
    from jax import export as jax_export

    def fwd(x):
        return model.apply({"params": params}, x, hgd, plan, deterministic=True)

    spec = jax.ShapeDtypeStruct(
        tuple(example_x.shape), jax.numpy.asarray(example_x).dtype
    )
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = list(platforms)
    return jax_export.export(jax.jit(fwd), **kwargs)(spec)


# The artifact stores the program as its StableHLO bytecode plus the few
# ``Exported`` fields a one-argument, one-result, single-device program
# needs, so loading needs nothing beyond JAX itself (``Exported.serialize``
# would add a flatbuffers dependency).
def _program_record(exported) -> Dict[str, Any]:
    tu = jax.tree_util
    if (exported.in_tree != tu.tree_structure(((0,), {}))
            or exported.out_tree != tu.tree_structure(0)
            or exported.nr_devices != 1
            or exported.ordered_effects or exported.unordered_effects
            or any(s is not None for s in
                   exported.in_shardings_hlo + exported.out_shardings_hlo)):
        raise ValueError("a serving program maps one array to one array on "
                         "one device, without effects or shardings")

    def aval(a):
        return {"shape": list(a.shape), "dtype": str(a.dtype)}

    return {
        "fun_name": exported.fun_name,
        "in": aval(exported.in_avals[0]),
        "out": aval(exported.out_avals[0]),
        "platforms": list(exported.platforms),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }


def _program_from_record(rec: Dict[str, Any], payload: bytes):
    from jax import export as jax_export

    def aval(d):
        return jax.core.ShapedArray(tuple(d["shape"]), np.dtype(d["dtype"]))

    tu = jax.tree_util
    return jax_export.Exported(
        fun_name=rec["fun_name"],
        in_tree=tu.tree_structure(((0,), {})),
        in_avals=(aval(rec["in"]),),
        out_tree=tu.tree_structure(0),
        out_avals=(aval(rec["out"]),),
        _has_named_shardings=True,
        _in_named_shardings=(None,),
        _out_named_shardings=(None,),
        in_shardings_hlo=(None,),
        out_shardings_hlo=(None,),
        nr_devices=1,
        platforms=tuple(rec["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=payload,
        calling_convention_version=int(rec["calling_convention_version"]),
        module_kept_var_idx=tuple(rec["module_kept_var_idx"]),
        uses_global_constants=bool(rec["uses_global_constants"]),
        _get_vjp=None,
    )


def save_artifact(path: str, payload: bytes, meta: Dict[str, Any]) -> None:
    header = dict(meta)
    header["format_version"] = _FORMAT_VERSION
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload)


def read_artifact(path: str):
    """Returns ``(meta, payload_bytes)`` without deserializing the
    program — cheap metadata inspection for artifact management."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(
                f"{path}: not a hypergef serving artifact (bad magic {magic!r})"
            )
        raw_len = f.read(4)
        if len(raw_len) != 4:
            raise ValueError(f"{path}: truncated artifact (missing header length)")
        (hlen,) = struct.unpack("<I", raw_len)
        raw_hdr = f.read(hlen)
        if len(raw_hdr) != hlen:
            raise ValueError(
                f"{path}: truncated artifact (header {len(raw_hdr)}/{hlen} bytes)"
            )
        try:
            meta = json.loads(raw_hdr.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt artifact header ({e})") from e
        payload = f.read()
    return meta, payload


def export_trainer(
    trainer,
    path: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
):
    """Export a trained :class:`~hypergef.train.Trainer`'s forward.

    Writes the artifact to ``path`` (if given) and returns the metadata
    dict — always the dict, never the payload; callers that want the
    program without a file use :func:`export_forward` directly
    (``path=None`` is a dry-run that still exercises the full lowering).
    The exported program computes full-graph log-probabilities for
    the graph the trainer was built on — the deployment unit of the
    reference's workload class (transductive node classification, one
    fixed hypergraph per model)."""
    cfg = trainer.cfg
    exported = export_forward(
        trainer.model,
        trainer.params,
        trainer.hgd,
        trainer.plan,
        trainer.x,
        platforms=platforms,
    )
    payload = exported.mlir_module_serialized
    from hypergef import __version__

    meta = {
        "model": cfg.model,
        "nhid": cfg.nhid,
        "nlayer": cfg.nlayer,
        "nhead": cfg.nhead,
        "first_aggr": cfg.first_aggr,
        "nclass": trainer.nclass,
        "input_shape": list(trainer.x.shape),
        "input_dtype": str(trainer.x.dtype),
        "output_shape": [int(trainer.x.shape[0]), trainer.nclass],
        "graph": getattr(trainer.hg, "name", None),
        "num_nodes": int(trainer.hg.num_nodes),
        "num_edges": int(trainer.hg.num_edges),
        "nnz": int(trainer.hg.nnz),
        "platforms": list(platforms) if platforms else None,
        "hypergef_version": __version__,
        "payload_bytes": len(payload),
        "program": _program_record(exported),
    }
    if path is not None:
        save_artifact(path, payload, meta)
    return meta


@dataclasses.dataclass
class ServingModel:
    """A loaded serving artifact: ``predict`` runs the AOT program.

    Loading does **not** retrace or re-lower the model — the program is
    compiled from the serialized StableHLO on first call and cached by
    jit thereafter (the analogue of loading a TorchScript/engine
    file; the reference framework has no equivalent)."""

    meta: Dict[str, Any]
    _call: Any

    @classmethod
    def load(cls, path: str) -> "ServingModel":
        meta, payload = read_artifact(path)
        ver = meta.get("format_version", 0)
        if ver > _FORMAT_VERSION:
            raise ValueError(
                f"{path}: artifact format_version {ver} is newer than this "
                f"library supports ({_FORMAT_VERSION}); upgrade hypergef"
            )
        exported = _program_from_record(meta["program"], payload)
        return cls(meta=meta, _call=jax.jit(exported.call))

    def predict(self, x):
        """Full-graph log-probabilities ``[num_nodes, nclass]``."""
        x = jax.numpy.asarray(x)
        expect = tuple(self.meta["input_shape"])
        if tuple(x.shape) != expect:
            raise ValueError(
                f"serving input shape {tuple(x.shape)} != exported shape "
                f"{expect} (AOT programs are static-shape; re-export for a "
                "different graph)"
            )
        return self._call(x)

    def predict_labels(self, x) -> np.ndarray:
        return np.asarray(jax.numpy.argmax(self.predict(x), axis=1))
