"""Kernel timing utilities (analogue of ``util::gpuTimer``,
``include/util/gpuTimer.cuh:7-28``).

Kernel times are derived from two jitted ``fori_loop`` chains (1
iteration vs K iterations): the difference isolates device time per
iteration, the same amortize-over-ITER protocol as the reference
benchmarks (``include/hgnnAgg.cuh:14`` ITER=100), with host dispatch
cost cancelled out.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def chain_fold(y, xv):
    """Fold a step's output back into the loop carry WITHOUT letting XLA
    optimize the step away.

    A scalar fold (``xv + 1e-30 * jnp.sum(y)``) is NOT safe for timing:
    the reduction is linear, so the AlgebraicSimplifier rewrites
    ``reduce(dot(B, W))`` into ``dot(reduce(B), W)`` and then hoists the
    loop-invariant table contraction OUT of the timing fori_loop — a
    band-matmul stage times as zero under the scalar fold.  Gather-form
    stages are not rewritten (XLA does not push reductions through
    gathers).

    Safe folds: a full-shape linear carry (every output element feeds
    the next iteration — nothing can be hoisted because the carry
    changes), or a quadratic scalar (no linear rewrite exists through
    ``y*y``) when shapes differ.
    """
    if getattr(y, "shape", None) == getattr(xv, "shape", None):
        return xv + 1e-30 * y
    return xv + 1e-30 * jnp.sum(y * y)


class Timer:
    """Simple wall-clock bracket with block_until_ready semantics."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def device_time_per_iter(
    step: Callable[..., jax.Array],
    x: jax.Array,
    iters: int = 50,
    repeats: int = 5,
    operands: tuple = (),
    dynamic_iters: bool = False,
) -> dict:
    """Measure per-iteration device time of ``step`` (shape-preserving
    in its first argument).

    Chains ``step`` inside ``lax.fori_loop`` so the K-iteration program
    is one dispatch; reports ``(T(K+1) − T(1)) / K`` minimized over
    ``repeats`` runs, plus the compile time of the long program.

    ``operands``: extra pytrees passed as real jit arguments — use them
    for large arrays (plans, dense H) so they are not embedded in the
    program as constants.

    ``dynamic_iters``: pass the trip count as a device scalar so every
    window length shares ONE compiled program (fori_loop lowers to
    while_loop).  Use for wide sweeps where per-trip-count compiles
    dominate.
    """

    def loop(x0, n, *ops):
        return jax.lax.fori_loop(0, n, lambda i, a: step(a, *ops), x0)

    if dynamic_iters:
        jf = jax.jit(loop)

        def f(x0, n, *ops):
            return jf(x0, jnp.int32(n), *ops)
    else:
        f = jax.jit(loop, static_argnums=1)
    t0 = time.perf_counter()
    jax.block_until_ready(f(x, 1, *operands))
    compile_short = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(f(x, iters + 1, *operands))
    compile_long = time.perf_counter() - t0

    def timed(n):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x, n, *operands))
            best = min(best, time.perf_counter() - t0)
        return best

    t_short = timed(1)
    t_long = timed(iters + 1)
    # when the chained compute window is not comfortably above the
    # dispatch time the difference is noise (can even clamp to 0) — flag
    # it so callers re-run with more iters
    window = t_long - t_short
    return {
        "per_iter_s": max(window, 0.0) / iters,
        "dispatch_s": t_short,
        "compile_s": compile_short + compile_long,
        "noisy": bool(window < 0.5 * t_short),
    }
