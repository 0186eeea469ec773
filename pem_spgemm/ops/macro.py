"""Macro128 engine: SpGEMM as batched dense 128x128 matmuls.

The third tier of the engine hierarchy (see formats/macro.py).  Pipeline
shape is identical to the Tile16 fused engine — pair expansion sorted by C
tile, fused numeric + 0/1 structural accumulation, exact-nnz structure —
but at 128 granularity every op is large and regular:

  * operand gathers move contiguous 64KB tiles;
  * the batched (chunk,128,128) matmul is a dense batched GEMM;
  * the structural pattern is a bf16 0/1 matmul (counts <= 128, exact);
  * C tiles are dense (c_cap,128,128) — written once, no bitmask machinery.

Counterpart of reference steps 1-3 at a granularity the reference does not
use (its 16x16 tiles are sized for one warp).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from pem_spgemm.ops import symbolic


@partial(jax.jit, static_argnames=("c_cap", "chunk", "acc_dtype",
                                   "precision"))
def accumulate_macro(a_dense, b_dense, a_idx, b_idx, c_tile_id,
                     c_cap, chunk, acc_dtype, precision="highest"):
    """Fused numeric + structural accumulation over macro-tile pairs.

    a_dense/b_dense: (T+1, 128, 128) tables (zero tile at T).
    Returns (c_dense (c_cap,128,128) acc_dtype, c_counts (c_cap,128,128)
    bf16 — structural product counts; (count > 0) is exact).
    """
    p_cap = a_idx.shape[0]
    assert p_cap % chunk == 0, (p_cap, chunk)
    n_chunks = p_cap // chunk
    seg = jnp.minimum(c_tile_id, c_cap)

    def body(i, carry):
        c_dense, c_cnt = carry
        sl = i * chunk
        a_c = lax.dynamic_slice_in_dim(a_idx, sl, chunk)
        b_c = lax.dynamic_slice_in_dim(b_idx, sl, chunk)
        s_c = lax.dynamic_slice_in_dim(seg, sl, chunk)
        ad = a_dense[a_c].astype(acc_dtype)
        bd = b_dense[b_c].astype(acc_dtype)
        prod = jnp.einsum("pij,pjk->pik", ad, bd,
                          preferred_element_type=acc_dtype,
                          precision=precision)
        # bf16 counts: a positive integer sum never rounds to zero, and
        # only (count > 0) is consumed downstream — halves C-side memory.
        pat = jnp.einsum("pij,pjk->pik",
                         (ad != 0).astype(jnp.bfloat16),
                         (bd != 0).astype(jnp.bfloat16),
                         preferred_element_type=jnp.bfloat16)
        c_dense = c_dense.at[s_c].add(prod, mode="drop",
                                      indices_are_sorted=True)
        c_cnt = c_cnt.at[s_c].add(pat, mode="drop", indices_are_sorted=True)
        return c_dense, c_cnt

    init = (jnp.zeros((c_cap, 128, 128), acc_dtype),
            jnp.zeros((c_cap, 128, 128), jnp.bfloat16))
    return lax.fori_loop(0, n_chunks, body, init)


@jax.jit
def macro_structure(c_counts):
    """Exact per-tile nnz scan from the structural counts.

    Returns cptr (c_cap+1,) i32 with cptr[-1] = exact C nnz.
    """
    per_tile = jnp.sum((c_counts > 0).astype(jnp.int32), axis=(1, 2),
                       dtype=jnp.int32)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(per_tile, dtype=jnp.int32)])


@partial(jax.jit, static_argnames=("p_cap", "c_cap", "chunk", "acc_dtype",
                                   "precision", "packed", "packed_coords"))
def macro_spgemm_fixed(a_tile_row, a_tile_col, a_dense,
                       b_tile_rowptr, b_tile_col, b_dense,
                       ntiles_a, *, p_cap, c_cap, chunk,
                       acc_dtype=jnp.float32, precision="highest",
                       packed=True, packed_coords=False):
    """One-dispatch macro SpGEMM at static capacities.

    Returns (c_tile_row,
    c_tile_col, c_dense, c_counts, cptr, c_nnz, overflow); c_counts is
    bf16.  `overflow` True => a capacity was exceeded and the result is
    truncated; re-plan with larger caps (bench/harness.py does).
    """
    from pem_spgemm.ops import cstruct
    offsets = symbolic.pair_counts(a_tile_col, b_tile_rowptr, ntiles_a)
    n_pairs = jnp.minimum(offsets[-1], p_cap)
    c_row, c_col, a_idx, b_idx, c_tile_id, cnt = symbolic.expand_pairs(
        offsets, a_tile_row, a_tile_col, b_tile_rowptr, b_tile_col,
        n_pairs, p_cap, packed)
    c_dense, c_counts = accumulate_macro(
        a_dense, b_dense, a_idx, b_idx, c_tile_id, c_cap, chunk,
        acc_dtype, precision)
    c_tile_row, c_tile_col = cstruct.c_tile_coords(
        c_tile_id, c_row, c_col, c_cap, packed_coords)
    cptr = macro_structure(c_counts)
    overflow = (offsets[-1] > p_cap) | (cnt > c_cap)
    return c_tile_row, c_tile_col, c_dense, c_counts, cptr, cptr[-1], overflow


def assemble_macro_coo(c_tile_row, c_tile_col, c_dense, c_counts, c_nnz):
    """Untimed assembly: macro tiles -> sorted global COO (host numpy).

    Counterpart of reference sanitize_C + sort (spgemm.cu:1493-1560).
    Structural zeros (count > 0 but value cancelled to 0.0) are kept,
    matching the reference's exact-structure semantics.
    """
    import numpy as np
    cnt = np.asarray(c_counts)
    tr = np.asarray(c_tile_row)
    tc = np.asarray(c_tile_col)
    vals = np.asarray(c_dense)
    t, r, c = np.nonzero(cnt > 0)
    rows = tr[t] * 128 + r
    cols = tc[t] * 128 + c
    v = vals[t, r, c]
    order = np.lexsort((cols, rows))
    assert len(rows) == int(c_nnz), (len(rows), int(c_nnz))
    return rows[order], cols[order], v[order]
