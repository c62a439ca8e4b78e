"""Scatter-free sorted segment reductions.

Because the hypergraph layer keeps nnz in CSR order for *both*
aggregation directions, every segment reduction here sees sorted segment
ids with known boundaries (the CSR indptr) — which admits a fully
vectorized formulation without scatter-add:

    C    = exclusive-cumsum(vals, axis=0)            # log-depth scan
    y[s] = C[indptr[s+1]] - C[indptr[s]]             # two row gathers

No scatters anywhere: dense vectorized work plus row gathers, combining
per-chunk partials without write conflicts (the role atomics play in
the reference's fused kernel, ``hgnnaggr_cuda.cu:14-47``).

The scan itself is *not* ``jnp.cumsum`` for large f32 inputs: the prefix
is computed blockwise — a [128, 128] lower-triangular matmul per 128-row
block plus a short cumsum over the per-block totals.
``Precision.HIGHEST`` keeps the matmul at f32 accuracy (a bf16-rounded
values operand gives 7.6e-2 segment error — unusable).

Numerical note: the blockwise form is also better conditioned than a
global f32 cumsum: within-block prefixes restart at zero every 128
rows, and the only globally-accumulated quantity is the [nnz/128]
carry of block totals, so segment differences whose endpoints share a
block cancel the carry exactly.  The remaining error still grows with
the carry's magnitude, which is why ``ops.fused`` routes large nnz to
the tree backend.  Validated against the scatter oracle in tests.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# block-scan parameters: below _SCAN_MIN_ROWS the padding/transpose
# overhead exceeds what the matmul saves over a plain log-tree cumsum.
_SCAN_BLOCK = 128
_SCAN_MIN_ROWS = 4096


def _prefix_sum(vals: jax.Array) -> jax.Array:
    """Inclusive prefix sum of ``vals`` [n, F] along axis 0.

    Large f32 inputs take the blockwise matmul path; everything else
    (small n, non-f32, non-2D) falls back to ``jnp.cumsum``.
    """
    if (
        vals.ndim != 2
        or vals.dtype != jnp.float32
        or vals.shape[0] < _SCAN_MIN_ROWS
    ):
        return jnp.cumsum(vals, axis=0, dtype=vals.dtype)
    n, f = vals.shape
    blk_n = _SCAN_BLOCK
    nb = -(-n // blk_n)
    vp = jnp.pad(vals, ((0, nb * blk_n - n), (0, 0)))
    blk = vp.reshape(nb, blk_n, f)
    lt = jnp.asarray(np.tril(np.ones((blk_n, blk_n), np.float32)))
    # within-block inclusive prefix as one batched triangular matmul:
    # [blk_n, blk_n] · [nb, blk_n, f] → [blk_n, nb, f]
    pre = jax.lax.dot_general(
        lt,
        blk,
        (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    pre = jnp.transpose(pre, (1, 0, 2))  # [nb, blk_n, f]
    tot = blk.sum(axis=1)  # [nb, f]
    carry = jnp.cumsum(tot, axis=0) - tot  # exclusive carry per block
    return (pre + carry[:, None, :]).reshape(nb * blk_n, f)[:n]


def segment_sum_sorted(vals: jax.Array, indptr: jax.Array) -> jax.Array:
    """Sum ``vals`` within segments delimited by ``indptr``.

    vals: [nnz, F] in segment order; indptr: [S+1] int32 with
    indptr[0]==0, indptr[S]==nnz.  Returns [S, F].
    """
    csum = _prefix_sum(vals)
    padded = jnp.concatenate([jnp.zeros_like(csum[:1]), csum], axis=0)  # [nnz+1, F]
    return jnp.take(padded, indptr[1:], axis=0) - jnp.take(padded, indptr[:-1], axis=0)


def segment_mean_sorted(vals: jax.Array, indptr: jax.Array) -> jax.Array:
    s = segment_sum_sorted(vals, indptr)
    cnt = (indptr[1:] - indptr[:-1]).astype(vals.dtype)
    return s / jnp.maximum(cnt, 1.0)[:, None]


def gather_segment_sum_sorted(
    x: jax.Array, gather_ids: jax.Array, indptr: jax.Array
) -> jax.Array:
    """Fused gather + sorted segment sum: y[s] = Σ_{k ∈ seg s} x[gather_ids[k]]."""
    return segment_sum_sorted(jnp.take(x, gather_ids, axis=0), indptr)


@jax.custom_vjp
def incidence_gather_sum(x, g_fwd, p_fwd, g_bwd, p_bwd):
    """Incidence-matrix product ``y = M x`` as gather + sorted segment sum,
    with a scatter-free adjoint.

    ``(g_fwd, p_fwd)`` is the CSR of M (rows = output segments) in the
    gather formulation; ``(g_bwd, p_bwd)`` is the CSR of Mᵀ.  Because M
    is a 0/1 incidence matrix, the VJP ``dx = Mᵀ ȳ`` is *the same op*
    with the index sets swapped — the transpose-of-gather scatter that
    plain autodiff would emit never appears, in forward or backward, to
    any differentiation order.
    """
    return segment_sum_sorted(jnp.take(x, g_fwd, axis=0), p_fwd)


def _igs_fwd(x, g_fwd, p_fwd, g_bwd, p_bwd):
    return incidence_gather_sum(x, g_fwd, p_fwd, g_bwd, p_bwd), (
        g_fwd,
        p_fwd,
        g_bwd,
        p_bwd,
    )


def _igs_bwd(res, g):
    g_fwd, p_fwd, g_bwd, p_bwd = res
    dx = incidence_gather_sum(g, g_bwd, p_bwd, g_fwd, p_fwd)
    return dx, None, None, None, None


incidence_gather_sum.defvjp(_igs_fwd, _igs_bwd)
