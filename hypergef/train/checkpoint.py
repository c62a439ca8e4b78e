"""Checkpoint / resume — a subsystem the reference lacks entirely
(SURVEY.md §5: models are trained from scratch each run).

Each step is one ``step_<N>.npz``: the flattened leaves of
``(params, opt_state)`` plus the step and a text form of the tree
structure.  A restore checks that structure against the caller's
templates and puts every leaf back onto its template's sharding, so
mesh-sharded trainers resume with their placement.  Single-process:
every leaf must be fully addressable from this process.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import jax
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _NAME.match(f)))


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.npz")


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Any,
    max_to_keep: int = 3,
) -> None:
    """Write ``(params, opt_state)`` at ``step``; keeps the newest
    ``max_to_keep`` steps.  The write is synchronous and atomic via
    rename."""
    leaves, treedef = jax.tree_util.tree_flatten((params, opt_state))
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, step=np.int64(step), treedef=np.str_(str(treedef)),
                 **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def restore_checkpoint(
    directory: str,
    params_template: Any,
    opt_state_template: Any,
    step: Optional[int] = None,
) -> Tuple[int, Any, Any]:
    """Restore the latest (or given) step; returns (step, params, opt_state).
    Raises FileNotFoundError when no checkpoint exists, ValueError when
    the saved tree does not match the templates."""
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        step = steps[-1]
    path = _path(directory, step)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    templates, treedef = jax.tree_util.tree_flatten(
        (params_template, opt_state_template))
    with np.load(path) as z:
        if str(z["treedef"]) != str(treedef):
            raise ValueError(
                f"checkpoint tree {z['treedef']} does not match the "
                f"template tree {treedef}")
        values = [z[f"leaf_{i}"] for i in range(len(templates))]
    for t, v in zip(templates, values):
        if tuple(np.shape(t)) != v.shape:
            raise ValueError(f"leaf shape {v.shape} != template {np.shape(t)}")

    def put(t, v):
        sharding = getattr(t, "sharding", None)
        return jax.device_put(v, sharding) if sharding is not None else v

    params, opt_state = jax.tree_util.tree_unflatten(
        treedef, [put(t, v) for t, v in zip(templates, values)])
    return int(step), params, opt_state
