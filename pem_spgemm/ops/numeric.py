"""Numeric phase: per-C-tile accumulation — the FLOP-carrying step.

Re-design of reference step 3 (pem_spgemm_step3_accumulate,
spgemm.cu:593-661).  The reference assigns one warp per C tile and, for each
C nonzero, gathers the matching A/B values via popcount prefixes of the
bitmasks and FMAs serially over pairs.  Here the scalar gather-FMA becomes
batched dense work:

  * operand tiles are densified once per pipeline run into (cap, 16, 16)
    value tensors (a single scatter — the tile-major element order makes the
    scatter index just elem_tile*256 + rowcol);
  * each pair contributes a dense 16x16 matmul A_tile @ B_tile, batched over
    a chunk of pairs;
  * contributions are scatter-added into dense C tiles.  Pairs of one C tile
    are contiguous (symbolic sort), and each (pair, C tile) pair is touched
    by exactly one chunk position — exclusive ownership by construction, the
    same atomic-freedom argument as the reference's warp-per-tile design;
  * compressed C values are extracted by one gather using the structure from
    the cstruct phase.

Zero-padding makes every padded lane a no-op: padded pairs target segment
c_cap (dropped) and padded tiles are all-zero.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@partial(jax.jit, static_argnames=("tile_cap",))
def densify_tiles(vals, rowcol, elem_tile, tile_cap):
    """Scatter tile-major element values into dense (tile_cap, 16, 16)."""
    pos = elem_tile * 256 + rowcol
    out = jnp.zeros((tile_cap * 256,), vals.dtype).at[pos].set(
        vals, mode="drop")
    return out.reshape(tile_cap, 16, 16)


@partial(jax.jit, static_argnames=("tile_cap",))
def densify_tiles_flat(vals, rowcol, elem_tile, tile_cap):
    """Dense value tiles in FLAT (tile_cap + 1, 2, 128) layout.

    The flat layout keeps each tile one contiguous 1 KB row, so a tile
    gather is one row gather.  Row ``tile_cap`` is an
    all-zero tile that padding pairs index (their contributions vanish).
    """
    pos = elem_tile * 256 + rowcol
    out = jnp.zeros(((tile_cap + 1) * 256,), vals.dtype).at[pos].set(
        vals, mode="drop")
    return out.reshape(tile_cap + 1, 2, 128)


@partial(jax.jit, static_argnames=("c_cap", "chunk", "acc_dtype",
                                   "precision"))
def accumulate_fused_flat(a_flat, b_flat, a_idx, b_idx, c_tile_id,
                          c_cap, chunk, acc_dtype, precision="highest"):
    """Flat-layout fused numeric+structural accumulation (XLA engine).

    Same contract as accumulate_fused but on (T+1, 2, 128) operand tables
    (zero tile at index T for padding pairs) and (c_cap, 2, 128) outputs:
      * operand gathers move 1KB dense rows (not lane-padded tiles);
      * the numeric matmul and the 0/1 structural matmul share one batched
        einsum call (stacked along the batch dim);
      * scatter-adds accumulate flat rows.
    Returns (c_dense, c_counts): both (c_cap, 256), counts in f32.
    """
    p_cap = a_idx.shape[0]
    assert p_cap % chunk == 0, (p_cap, chunk)
    n_chunks = p_cap // chunk
    seg = jnp.minimum(c_tile_id, c_cap)  # padding -> c_cap -> dropped
    # 2D (rows, 256) shapes for the gathers and scatters: row-granular
    # gathers and scatters of contiguous 1 KB rows.
    a2 = a_flat.reshape(a_flat.shape[0], 256)
    b2 = b_flat.reshape(b_flat.shape[0], 256)

    def body(i, carry):
        c_dense, c_cnt = carry
        sl = i * chunk
        a_c = lax.dynamic_slice_in_dim(a_idx, sl, chunk)
        b_c = lax.dynamic_slice_in_dim(b_idx, sl, chunk)
        s_c = lax.dynamic_slice_in_dim(seg, sl, chunk)
        ad = a2[a_c].reshape(chunk, 16, 16).astype(acc_dtype)
        bd = b2[b_c].reshape(chunk, 16, 16).astype(acc_dtype)
        lhs = jnp.concatenate([ad, (ad != 0).astype(acc_dtype)], axis=0)
        rhs = jnp.concatenate([bd, (bd != 0).astype(acc_dtype)], axis=0)
        both = jnp.einsum("pij,pjk->pik", lhs, rhs,
                          preferred_element_type=acc_dtype,
                          precision=precision)            # (2*chunk, 16, 16)
        both = both.reshape(2 * chunk, 256)
        c_dense = c_dense.at[s_c].add(both[:chunk], mode="drop",
                                      indices_are_sorted=True)
        c_cnt = c_cnt.at[s_c].add(both[chunk:].astype(jnp.float32),
                                  mode="drop", indices_are_sorted=True)
        return c_dense, c_cnt

    init = (jnp.zeros((c_cap, 256), acc_dtype),
            jnp.zeros((c_cap, 256), jnp.float32))
    return lax.fori_loop(0, n_chunks, body, init)


@partial(jax.jit, static_argnames=("c_cap", "chunk", "acc_dtype", "precision"))
def accumulate_dense(a_dense, b_dense, a_idx, b_idx, c_tile_id,
                     c_cap, chunk, acc_dtype, precision="highest"):
    """C_dense[t] = sum over pairs p of tile t: A[a_idx[p]] @ B[b_idx[p]].

    Chunked over pairs: each chunk gathers its operand tiles, runs one
    batched 16x16 matmul, and scatter-adds into the dense C tiles.
    """
    p_cap = a_idx.shape[0]
    assert p_cap % chunk == 0, (p_cap, chunk)
    n_chunks = p_cap // chunk
    seg = jnp.minimum(c_tile_id, c_cap)  # padding -> c_cap -> dropped

    def body(i, c_dense):
        sl = i * chunk
        a_c = lax.dynamic_slice_in_dim(a_idx, sl, chunk)
        b_c = lax.dynamic_slice_in_dim(b_idx, sl, chunk)
        s_c = lax.dynamic_slice_in_dim(seg, sl, chunk)
        ad = a_dense[a_c].astype(acc_dtype)
        bd = b_dense[b_c].astype(acc_dtype)
        prod = jnp.einsum("pij,pjk->pik", ad, bd,
                          preferred_element_type=acc_dtype,
                          precision=precision)
        return c_dense.at[s_c].add(prod, mode="drop")

    c_dense = jnp.zeros((c_cap, 16, 16), acc_dtype)
    return lax.fori_loop(0, n_chunks, body, c_dense)


@partial(jax.jit, static_argnames=("c_cap", "chunk", "acc_dtype",
                                   "precision"))
def accumulate_fused(a_dense, b_dense, a_idx, b_idx, c_tile_id,
                     c_cap, chunk, acc_dtype, precision="highest"):
    """One chunked pass producing BOTH the numeric C tiles and the exact
    structural pattern.

    The structural contribution of a pair is the boolean product of its
    operand patterns — computed as a second batched matmul on 0/1 operands
    (bf16 in, f32 accumulate: product counts are small integers, exact).
    This reuses the dense-tile gathers of the numeric matmul, so the whole
    reference step 2b (C masks + exact nnz, spgemm.cu:499-550) collapses
    into two extra matmuls per chunk instead of 16 segment reductions over
    every pair's bitmasks.  Structural nnz stays exact under numeric
    cancellation because the pattern accumulator is separate.

    Returns (c_dense, c_counts): both (c_cap, 16, 16); c_counts[t, r, c] is
    the number of structural products hitting C[t][r, c] (> 0 == nonzero).
    """
    p_cap = a_idx.shape[0]
    assert p_cap % chunk == 0, (p_cap, chunk)
    n_chunks = p_cap // chunk
    seg = jnp.minimum(c_tile_id, c_cap)  # padding -> c_cap -> dropped

    def body(i, carry):
        c_dense, c_cnt = carry
        sl = i * chunk
        a_c = lax.dynamic_slice_in_dim(a_idx, sl, chunk)
        b_c = lax.dynamic_slice_in_dim(b_idx, sl, chunk)
        s_c = lax.dynamic_slice_in_dim(seg, sl, chunk)
        ad = a_dense[a_c]
        bd = b_dense[b_c]
        prod = jnp.einsum("pij,pjk->pik", ad.astype(acc_dtype),
                          bd.astype(acc_dtype),
                          preferred_element_type=acc_dtype,
                          precision=precision)
        pat = jnp.einsum("pij,pjk->pik",
                         (ad != 0).astype(jnp.bfloat16),
                         (bd != 0).astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
        c_dense = c_dense.at[s_c].add(prod, mode="drop",
                                      indices_are_sorted=True)
        c_cnt = c_cnt.at[s_c].add(pat, mode="drop", indices_are_sorted=True)
        return c_dense, c_cnt

    init = (jnp.zeros((c_cap, 16, 16), acc_dtype),
            jnp.zeros((c_cap, 16, 16), jnp.float32))
    return lax.fori_loop(0, n_chunks, body, init)


@jax.jit
def counts_to_masks(c_counts):
    """Pack the structural counts into per-tile row bitmasks + nnz scan.

    Returns (cmask (c_cap, 16) i32, cptr (c_cap+1,) i32).
    """
    bits = (c_counts > 0).astype(jnp.int32)          # (c_cap, 16, 16)
    shifts = jnp.arange(16, dtype=jnp.int32)[None, None, :]
    cmask = jnp.sum(bits << shifts, axis=2, dtype=jnp.int32)
    per_tile = jnp.sum(bits, axis=(1, 2), dtype=jnp.int32)
    cptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(per_tile, dtype=jnp.int32)])
    return cmask, cptr


@jax.jit
def extract_values(c_dense, c_rowcol, c_elem_tile):
    """Gather compressed tile-major C values from the dense C tiles."""
    c_cap = c_dense.shape[0]
    pos = jnp.minimum(c_elem_tile * 256 + c_rowcol, c_cap * 256 - 1)
    return c_dense.reshape(-1)[pos]
