"""Program-structure introspection: overlap analysis for collectives.

The halo design (``parallel/halo_aggr.py``) splits each worker's local
edges into *interior* (members all owned → computable from the owned
X block alone) and *boundary* (need halo'd rows).  The interior V→E
tree therefore has **no data dependence** on the halo ``all_to_all`` —
on real multi-device hardware, XLA's latency-hiding scheduler can hoist
the collective-start before the independent compute and sink the done
after it, hiding link latency behind the interior tree (single-process
CPU lowers sync all-to-alls, so the *schedulable* property is what is
verified here).

:func:`collective_overlap_report` proves the property mechanically on
the traced program: forward-reachability over the (topologically
ordered) jaxpr equations from the first collective's outputs, counting
the FLOP-bearing work that is NOT downstream of it — the scheduler's
overlap budget.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.extend.core import Literal as _Literal

_COMPUTE_PRIMS = {
    "gather", "take", "dot_general", "reduce_sum", "add", "mul",
    "concatenate", "convert_element_type", "jit", "pjit", "closed_call",
    "custom_vjp_call", "custom_vjp_call_jaxpr", "custom_jvp_call",
}


def _contains_gather(eq) -> bool:
    """True if the eqn is a gather/take or a call wrapping one."""
    if eq.primitive.name in ("gather", "take"):
        return True
    for v in eq.params.values():
        sub = v if hasattr(v, "eqns") else getattr(v, "jaxpr", None)
        if sub is not None and hasattr(sub, "eqns"):
            if any(_contains_gather(e) for e in sub.eqns):
                return True
    return False


def _find_body(jaxpr, prim: str):
    """Innermost sub-jaxpr whose own eqn list contains ``prim``."""
    names = [e.primitive.name for e in jaxpr.eqns]
    if prim in names:
        return jaxpr
    for eq in jaxpr.eqns:
        for v in eq.params.values():
            sub = None
            if hasattr(v, "eqns"):
                sub = v
            elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
                sub = v.jaxpr
            if sub is not None:
                hit = _find_body(sub, prim)
                if hit is not None:
                    return hit
    return None


def collective_overlap_report(fn, *args, prim: str = "all_to_all") -> dict:
    """Trace ``fn(*args)`` and analyze dependence on the FIRST ``prim``.

    Returns a dict:

    * ``n_collectives`` — number of ``prim`` eqns in the body;
    * ``independent_eqns`` / ``downstream_eqns`` — eqns after the first
      collective that do not / do depend on its outputs;
    * ``independent_gather_rows`` — summed output rows of independent
      gather/take eqns (the interior tree's level work);
    * ``independent_elems`` / ``downstream_elems`` — summed output
      element counts of compute-bearing eqns in each class (the
      overlap-budget proxy the latency-hiding scheduler sees);
    * ``chain`` — True if a later ``prim`` eqn is downstream of the
      first (the return all_to_all must wait; expected True for halo).
    """
    jaxpr = jax.make_jaxpr(fn)(*args)
    body = _find_body(jaxpr.jaxpr, prim)
    if body is None:
        raise ValueError(f"no '{prim}' equation found in the traced program")
    eqns = body.eqns
    first = next(i for i, e in enumerate(eqns) if e.primitive.name == prim)
    reach = set(map(id, eqns[first].outvars))
    n_coll, chain = 1, False
    ind_eqns = down_eqns = 0
    ind_rows = ind_elems = down_elems = 0
    for eq in eqns[first + 1:]:
        dep = any(
            id(v) in reach
            for v in eq.invars
            if not isinstance(v, _Literal)
        )
        if eq.primitive.name == prim:
            n_coll += 1
            chain = chain or dep
        elems = sum(
            int(getattr(v.aval, "size", 0)) for v in eq.outvars
        )
        if dep:
            reach.update(map(id, eq.outvars))
            down_eqns += 1
            if eq.primitive.name in _COMPUTE_PRIMS:
                down_elems += elems
        else:
            ind_eqns += 1
            if eq.primitive.name in _COMPUTE_PRIMS:
                ind_elems += elems
            if _contains_gather(eq):
                shp = getattr(eq.outvars[0].aval, "shape", ())
                ind_rows += int(shp[0]) if shp else 0
    out_dep = any(
        id(v) in reach
        for v in body.outvars
        if not isinstance(v, _Literal)
    )
    return {
        "n_collectives": n_coll,
        "independent_eqns": ind_eqns,
        "downstream_eqns": down_eqns,
        "independent_gather_rows": ind_rows,
        "independent_elems": ind_elems,
        "downstream_elems": down_elems,
        "chain": chain,
        "output_depends_on_collective": out_dep,
    }
