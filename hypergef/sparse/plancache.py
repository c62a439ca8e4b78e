"""Persistent plan serialization — build schedules once, reuse across runs.

The host-side schedule construction (``plan_aggregation``: tree levels,
aligned band tables, multihot tiles) is deliberately front-loaded work,
but at scale it is *real* work (tens of seconds for the aligned plan
at 10M nnz, host time), and the reference amortizes its analogous
cost by pickling processed datasets to ``.pt`` files
(``HyperGsys/dataloader.py``: the ``p2raw``/processed cache).  This module
is the plan-level analogue: an :class:`AggregationPlan` (or any nested
structure of plan NamedTuples/dataclasses + numpy/jax arrays) round-trips
to one compressed ``.npz``, keyed by the graph's *content* hash so a
stale cache can never be served for a different graph.

Design notes:

* arrays dominate (band tables are 100s of MB at 10M nnz) — they go into
  the npz as native numpy blocks, deduplicated by identity;
  ``bfloat16`` (an ml_dtypes extension dtype ``np.save`` rejects) rides
  as a ``uint16`` view with a dtype tag;
* device (``jax.Array``) leaves are pulled to host on save and re-placed
  with ``jnp.asarray`` on load — a loaded plan behaves exactly like a
  freshly built one (``TreePlan._device`` is skipped and lazily rebuilt);
* reconstruction resolves classes by qualified name but ONLY from
  ``hypergef.*`` modules — no pickle, no arbitrary code execution
  from a cache file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
from typing import Any, Optional

import numpy as np

# bump when plan layouts change incompatibly — old cache files miss
PLAN_FORMAT_VERSION = 2

_BF16_TAG = "bfloat16"


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _class_path(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def _resolve_class(path: str):
    mod_name, _, qual = path.partition(":")
    if mod_name != "hypergef" and not mod_name.startswith("hypergef."):
        raise ValueError(
            f"plan cache refuses to resolve class outside hypergef: {path!r}"
        )
    mod = importlib.import_module(mod_name)
    obj = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _encode(obj, arrays: dict, seen: dict) -> Any:
    """Recursively encode ``obj`` into a JSON-able spec; ndarray payloads
    land in ``arrays`` (deduplicated by id)."""
    import jax

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "v", "v": obj}
    if isinstance(obj, (np.integer,)):
        return {"t": "v", "v": int(obj)}
    if isinstance(obj, (np.floating,)):
        return {"t": "v", "v": float(obj)}
    if isinstance(obj, jax.Array) or isinstance(obj, np.ndarray):
        is_dev = not isinstance(obj, np.ndarray)
        arr = np.asarray(obj)
        key = seen.get(id(obj))
        if key is None:
            key = f"a{len(arrays)}"
            seen[id(obj)] = key
            dt = str(arr.dtype)
            if dt == _BF16_TAG:
                arrays[key] = arr.view(np.uint16)
            else:
                arrays[key] = arr
        else:
            dt = str(arr.dtype)
        return {"t": "jx" if is_dev else "nd", "k": key, "dt": dt}
    if _is_namedtuple(obj):
        return {
            "t": "nt",
            "c": _class_path(obj),
            "f": {n: _encode(getattr(obj, n), arrays, seen) for n in obj._fields},
        }
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {}
        for f in dataclasses.fields(obj):
            if f.name.startswith("_"):
                continue  # derived caches (e.g. TreePlan._device) rebuild lazily
            fields[f.name] = _encode(getattr(obj, f.name), arrays, seen)
        return {"t": "dc", "c": _class_path(obj), "f": fields}
    if isinstance(obj, tuple):
        return {"t": "tu", "i": [_encode(x, arrays, seen) for x in obj]}
    if isinstance(obj, list):
        return {"t": "li", "i": [_encode(x, arrays, seen) for x in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("plan cache supports str dict keys only")
        return {"t": "di", "f": {k: _encode(v, arrays, seen) for k, v in obj.items()}}
    raise TypeError(f"plan cache cannot serialize {type(obj)!r}")


def _decode(spec: Any, arrays) -> Any:
    t = spec["t"]
    if t == "v":
        return spec["v"]
    if t in ("nd", "jx"):
        arr = arrays[spec["k"]]
        if spec["dt"] == _BF16_TAG:
            import ml_dtypes

            arr = arr.view(ml_dtypes.bfloat16)
        if t == "jx":
            import jax.numpy as jnp

            return jnp.asarray(arr)
        return arr
    if t == "tu":
        return tuple(_decode(x, arrays) for x in spec["i"])
    if t == "li":
        return [_decode(x, arrays) for x in spec["i"]]
    if t == "di":
        return {k: _decode(v, arrays) for k, v in spec["f"].items()}
    if t == "nt":
        cls = _resolve_class(spec["c"])
        return cls(**{k: _decode(v, arrays) for k, v in spec["f"].items()})
    if t == "dc":
        cls = _resolve_class(spec["c"])
        return cls(**{k: _decode(v, arrays) for k, v in spec["f"].items()})
    raise ValueError(f"unknown plan-cache node type {t!r}")


def save_plan(plan, path: str) -> str:
    """Serialize any plan structure to one compressed ``.npz``."""
    arrays: dict = {}
    spec = _encode(plan, arrays, seen={})
    manifest = json.dumps({"version": PLAN_FORMAT_VERSION, "root": spec})
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh, __manifest__=np.frombuffer(manifest.encode(), dtype=np.uint8),
            **arrays,
        )
    os.replace(tmp, path)  # atomic: concurrent readers never see a partial file
    return path


def load_plan(path: str):
    """Load a plan saved by :func:`save_plan`."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        if manifest["version"] != PLAN_FORMAT_VERSION:
            raise ValueError(
                f"plan cache format {manifest['version']} != "
                f"{PLAN_FORMAT_VERSION} — rebuild ({path})"
            )
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    return _decode(manifest["root"], arrays)


def plan_key(hg, **kwargs) -> str:
    """Content hash of the graph + builder kwargs: the cache can never
    serve a plan for a different graph or build configuration."""
    h = hashlib.sha256()
    h.update(f"v{PLAN_FORMAT_VERSION}".encode())
    h.update(np.ascontiguousarray(hg.h_indptr).tobytes())
    h.update(np.ascontiguousarray(hg.h_indices).tobytes())
    h.update(f"{hg.num_nodes}x{hg.num_edges}".encode())
    for k in sorted(kwargs):
        h.update(f"|{k}={kwargs[k]!r}".encode())
    return h.hexdigest()[:24]


def _default_cache_dir() -> str:
    return os.environ.get(
        "HYPERGEF_PLAN_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "hypergef", "plans"),
    )


def cached_plan_aggregation(hg, cache_dir: Optional[str] = None, **kwargs):
    """``plan_aggregation`` with a persistent on-disk cache.

    First call for a given (graph content, kwargs) builds and saves; every
    later call — including in a fresh process — loads in ~npz-read time.
    A corrupt/incompatible file falls back to a rebuild (and overwrites).
    """
    from hypergef.sparse.planner import plan_aggregation

    d = cache_dir or _default_cache_dir()
    path = os.path.join(d, f"plan_{plan_key(hg, **kwargs)}.npz")
    if os.path.exists(path):
        try:
            return load_plan(path)
        except Exception:
            pass  # stale format / partial file: rebuild below
    plan = plan_aggregation(hg, **kwargs)
    save_plan(plan, path)
    return plan


def cached_plan_halo(hg, n_shards: int, cache_dir: Optional[str] = None,
                     **kwargs):
    """:func:`hypergef.parallel.halo.plan_halo` behind the same
    content-keyed cache — the distributed plan build (per-shard interior
    trees / aligned tables + exchange maps) is the multi-chip analogue of
    the single-chip schedule cost and amortizes identically."""
    from hypergef.parallel.halo import plan_halo

    d = cache_dir or _default_cache_dir()
    path = os.path.join(
        d, f"halo_{plan_key(hg, n_shards=n_shards, **kwargs)}.npz"
    )
    if os.path.exists(path):
        try:
            return load_plan(path)
        except Exception:
            pass
    plan = plan_halo(hg, n_shards, **kwargs)
    save_plan(plan, path)
    return plan
