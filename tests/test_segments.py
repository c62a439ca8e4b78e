"""Tests for the scatter-free (cumsum) segment backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef.ops import fused, segments
from conftest import dense_hgnn_oracle, dense_unignn_oracle


def test_segment_sum_sorted_basic():
    vals = jnp.asarray(np.arange(12, dtype=np.float32).reshape(6, 2))
    indptr = jnp.asarray(np.array([0, 2, 2, 5, 6], dtype=np.int32))
    out = np.asarray(segments.segment_sum_sorted(vals, indptr))
    want = np.stack(
        [
            vals[0:2].sum(0),
            np.zeros(2),
            vals[2:5].sum(0),
            vals[5:6].sum(0),
        ]
    )
    np.testing.assert_allclose(out, want)


def test_mxu_block_scan_path_matches_oracle():
    """Exercise the blockwise matmul prefix path (rows >= _SCAN_MIN_ROWS),
    including a non-multiple-of-128 length and empty segments."""
    rng = np.random.default_rng(3)
    nnz = segments._SCAN_MIN_ROWS + 517  # force the matmul path, ragged tail
    f = 5
    vals = rng.normal(size=(nnz, f)).astype(np.float32)
    bounds = np.sort(rng.choice(nnz, size=299, replace=False))
    indptr = np.concatenate([[0], bounds, bounds[-1:], [nnz]]).astype(np.int32)
    out = np.asarray(
        segments.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(indptr))
    )
    want = np.add.reduceat(
        np.concatenate([vals, np.zeros((1, f), np.float32)]), indptr[:-1], axis=0
    )
    # reduceat yields the next segment's value for empty segments; fix those up
    empty = indptr[1:] == indptr[:-1]
    want[empty] = 0.0
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    # the small-input path (plain cumsum) agrees with the same oracle
    small = np.asarray(
        segments.segment_sum_sorted(
            jnp.asarray(vals[:1000]),
            jnp.asarray(np.array([0, 3, 3, 700, 1000], np.int32)),
        )
    )
    want_small = np.stack(
        [vals[0:3].sum(0), np.zeros(f), vals[3:700].sum(0), vals[700:1000].sum(0)]
    )
    np.testing.assert_allclose(small, want_small, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_cumsum_backend_matches_xla(skewed_hg, aggr):
    hg = skewed_hg
    hgd = hg.device_data()
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, 10)).astype(np.float32)
    want = dense_hgnn_oracle(hg, x, None, aggr)
    got = fused.hgnn_aggregate(hgd, x, None, aggr, backend="cumsum")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_cumsum_backend_unignn(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    x = np.random.default_rng(1).normal(size=(hg.num_nodes, 5)).astype(np.float32)
    want = dense_unignn_oracle(hg, x, use_deg=True)
    got = fused.unignn_aggregate(hgd, x, use_deg=True, backend="cumsum")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_cumsum_grad_matches_xla_grad(skewed_hg):
    hg = skewed_hg
    hgd = hg.device_data()
    x = jnp.asarray(
        np.random.default_rng(2).normal(size=(hg.num_nodes, 4)).astype(np.float32)
    )

    def loss(backend):
        return jax.grad(
            lambda xv: jnp.sum(
                fused.hgnn_aggregate(hgd, xv, None, "sum", backend=backend) ** 2
            )
        )(x)

    np.testing.assert_allclose(
        np.asarray(loss("cumsum")), np.asarray(loss("xla")), rtol=1e-3, atol=1e-3
    )


def test_cumsum_bwd_contains_no_scatter(small_hg):
    """The design guarantee: no scatter op in the lowered backward HLO."""
    hg = small_hg
    hgd = hg.device_data()
    x = jnp.ones((hg.num_nodes, 4), dtype=jnp.float32)

    def f(xv):
        return jnp.sum(fused.hgnn_aggregate(hgd, xv, None, "sum", backend="cumsum"))

    hlo = jax.jit(jax.grad(f)).lower(x).as_text()
    assert "scatter" not in hlo


def test_second_order_grad_works(small_hg):
    hg = small_hg
    hgd = hg.device_data()
    x = jnp.ones((hg.num_nodes, 3), dtype=jnp.float32)

    def f(xv):
        return jnp.sum(fused.hgnn_aggregate(hgd, xv, None, "sum", backend="cumsum") ** 3)

    # linear op: hvp well-defined through the recursive custom vjp
    g = jax.grad(lambda xv: jnp.sum(jax.grad(f)(xv)))(x)
    assert np.isfinite(np.asarray(g)).all()
