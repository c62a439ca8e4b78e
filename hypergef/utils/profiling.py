"""Profiling / traffic analysis — the fig8 analogue.

The reference measures DRAM-sector traffic with Nsight Compute
(``experiment/fig8.py:33-110``).  The equivalents here:

* :func:`cost_analysis` — XLA's own per-program flops / bytes-accessed
  estimate (``jax.stages.Compiled.cost_analysis()``), giving the
  fused-vs-baseline traffic ratio without hardware counters;
* :func:`trace` — context manager around ``jax.profiler`` emitting a
  Perfetto/XProf trace directory;
* :func:`traffic_report` — compares bytes-accessed across backends for
  the same op (the fig8 table).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import jax


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """Compile ``fn`` and return XLA's cost analysis (flops,
    bytes accessed, etc.)."""
    compiled = jax.jit(fn).lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):  # older jax returns [dict]
        ca = ca[0]
    return dict(ca) if ca else {}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with XProf/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def traffic_report(make_step: Dict[str, Callable], *args) -> Dict[str, Dict[str, float]]:
    """fig8 analogue: per-backend {flops, bytes_accessed} for one op.

    ``make_step`` maps backend name → callable(*args).  Returns metrics
    plus ``ratio_vs_<first>`` of bytes accessed.
    """
    out: Dict[str, Dict[str, float]] = {}
    base_bytes = None
    for name, fn in make_step.items():
        ca = cost_analysis(fn, *args)
        flops = float(ca.get("flops", 0.0))
        byts = float(ca.get("bytes accessed", ca.get("bytes_accessed", 0.0)))
        row = {"flops": flops, "bytes_accessed": byts}
        if base_bytes is None:
            base_bytes = byts or None
        elif base_bytes:
            row["bytes_ratio_vs_baseline"] = byts / base_bytes
        out[name] = row
    return out
