"""Element-level CSR SpGEMM in pure JAX — the correctness-oracle path.

BASELINE.json config 1: "A^2 of a small SuiteSparse matrix in plain CSR on
CPU via jax CPU backend, exact C_nnz check vs scipy".  This is the same
expand-sort-reduce strategy as the tiled symbolic phase (ops/symbolic.py),
applied at the element level: every (A element, B row-element) product is
materialized, sorted by output coordinate, and duplicate coordinates are
segment-summed.  O(flop log flop) work — fine as an oracle and for small
matrices; the tiled pipeline is the production path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pem_spgemm.config import round_up_pow2
from pem_spgemm.formats.coo import COOMatrix

INT32_MAX = jnp.int32(0x7FFFFFFF)


@partial(jax.jit, static_argnames=("n_rows_b",))
def _row_structure(b_rows, n_rows_b):
    """CSR row pointer of B from row-sorted COO rows."""
    counts = jnp.bincount(b_rows, length=n_rows_b)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts, dtype=jnp.int32)])


@jax.jit
def _product_offsets(a_cols, b_rowptr):
    cnt = b_rowptr[a_cols + 1] - b_rowptr[a_cols]
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(cnt, dtype=jnp.int32)])


@partial(jax.jit, static_argnames=("p_cap",))
def _expand_products(offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols,
                     b_vals, n_products, p_cap):
    """All scalar products, sorted by (row, col), reduced by coordinate."""
    p = jnp.arange(p_cap, dtype=jnp.int32)
    valid = p < n_products
    a = jnp.clip(jnp.searchsorted(offsets, p, side="right").astype(jnp.int32)
                 - 1, 0, a_rows.shape[0] - 1)
    b = b_rowptr[a_cols[a]] + (p - offsets[a])
    b = jnp.clip(b, 0, b_cols.shape[0] - 1)
    ci = jnp.where(valid, a_rows[a], INT32_MAX)
    cj = jnp.where(valid, b_cols[b], INT32_MAX)
    cv = jnp.where(valid, a_vals[a] * b_vals[b], 0)
    ci, cj, cv = lax.sort((ci, cj, cv), num_keys=2)
    new = jnp.concatenate([
        jnp.ones((1,), jnp.int32),
        ((ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])).astype(jnp.int32)])
    out_id = (jnp.cumsum(new) - 1).astype(jnp.int32)
    c_nnz = jnp.where(n_products > 0,
                      out_id[jnp.maximum(n_products - 1, 0)] + 1, 0)
    out_id = jnp.where(valid, out_id, INT32_MAX)
    return ci, cj, cv, out_id, c_nnz


@partial(jax.jit, static_argnames=("c_cap",))
def _reduce_products(ci, cj, cv, out_id, c_cap):
    oid = jnp.minimum(out_id, c_cap)
    rows = jnp.full((c_cap,), INT32_MAX).at[oid].set(ci, mode="drop")
    cols = jnp.full((c_cap,), INT32_MAX).at[oid].set(cj, mode="drop")
    vals = jax.ops.segment_sum(
        jnp.where(out_id < c_cap, cv, 0), jnp.minimum(oid, c_cap - 1),
        num_segments=c_cap)
    return rows, cols, vals


def csr_spgemm(a: COOMatrix, b: COOMatrix, dtype=jnp.float32) -> COOMatrix:
    """C = A @ B via element-level expand-sort-reduce. Canonical COO out."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    # Sort A arbitrarily, B by row (needed for the rowptr join).
    b_order = np.lexsort((b.cols, b.rows))
    a_rows = jnp.asarray(a.rows)
    a_cols = jnp.asarray(a.cols)
    a_vals = jnp.asarray(a.vals.astype(np.float64), dtype)
    b_rows = jnp.asarray(b.rows[b_order])
    b_cols = jnp.asarray(b.cols[b_order])
    b_vals = jnp.asarray(b.vals[b_order].astype(np.float64), dtype)
    b_rowptr = _row_structure(b_rows, b.shape[0])
    offsets = _product_offsets(a_cols, b_rowptr)
    n_products = int(offsets[-1])
    if n_products == 0:
        return COOMatrix(np.zeros(0, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.float64),
                         (a.shape[0], b.shape[1]))
    p_cap = round_up_pow2(n_products)
    ci, cj, cv, out_id, c_nnz_dev = _expand_products(
        offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
        jnp.int32(n_products), p_cap)
    c_nnz = int(c_nnz_dev)
    c_cap = round_up_pow2(c_nnz)
    rows, cols, vals = _reduce_products(ci, cj, cv, out_id, c_cap)
    return COOMatrix(np.asarray(rows)[:c_nnz], np.asarray(cols)[:c_nnz],
                     np.asarray(vals)[:c_nnz], (a.shape[0], b.shape[1]))
