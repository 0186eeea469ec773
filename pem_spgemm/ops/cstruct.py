"""C structure phase: tile masks, exact per-tile nnz, intra-tile coordinates.

Counterpart of reference steps 2b + 2c:
  * pem_spgemm_step2_compute_CMasksAndOffsets (spgemm.cu:499-550): per pair,
    C row-mask bit c is set iff (A row bitmap AND B transposed column-c
    bitmap) is nonzero; OR-accumulated over the pairs of each C tile; then
    popcounts -> exact per-tile nnz -> exclusive scan -> total C nnz.  Here
    the per-pair mask math is one vector bit-expression over all pairs, and
    the OR-accumulation is 16 bit-plane segment_max reductions (pairs of a
    C tile are contiguous after the symbolic sort).
  * pem_spgemm_step2_compute_CrowColIdx (spgemm.cu:552-591): set bits are
    enumerated via a global cumsum over the tile-major bit tensor, whose
    running rank IS the output position (no per-tile scan needed).

This phase realizes the reference's "two-pass exact allocation": the total
C nnz crosses to the host (the reference's third D2H sync, spgemm.cu:1291)
before any C value memory is allocated.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@partial(jax.jit, static_argnames=("c_cap", "packed"))
def c_tile_coords(c_tile_id, c_row, c_col, c_cap, packed=False):
    """Scatter per-pair C tile keys into dense (c_cap,) coordinate arrays.

    With packed=True (caller guarantees row values < 2^15 and col values
    < 2^16) the two scatters fuse into one on a packed
    (row<<16)|col word — scatters are the cost here (~2x on chip).  The
    packed sentinel 0x7FFF_FFFF unpacks to per-field sentinels 0x7FFF /
    0xFFFF, distinct from any real coordinate under the size guarantee.
    """
    valid = c_tile_id < c_cap
    cid_drop = jnp.where(valid, c_tile_id, c_cap)
    if packed:
        word = (c_row << 16) | (c_col & 0xFFFF)
        both = jnp.full((c_cap,), 0x7FFFFFFF, jnp.int32).at[cid_drop].set(
            word, mode="drop")
        return (both >> 16) & 0xFFFF, both & 0xFFFF
    c_tile_row = jnp.full((c_cap,), 0x7FFFFFFF, jnp.int32).at[cid_drop].set(
        c_row, mode="drop")
    c_tile_col = jnp.full((c_cap,), 0x7FFFFFFF, jnp.int32).at[cid_drop].set(
        c_col, mode="drop")
    return c_tile_row, c_tile_col


@partial(jax.jit, static_argnames=("c_cap",))
def c_masks(a_masks, b_tmasks, a_idx, b_idx, c_tile_id, c_row, c_col, c_cap):
    """Per-C-tile bitmasks and exact nnz counts.

    Returns (c_tile_row, c_tile_col, cmask, cptr, pair_ptr):
      c_tile_row/col: (c_cap,) i32 (sentinel INT32_MAX on padding);
      cmask: (c_cap, 16) i32 row bitmaps of C tiles;
      cptr:  (c_cap+1,) i32 exclusive scan of per-tile nnz (cptr[-1] = C_nnz);
      pair_ptr: (c_cap+1,) i32 exclusive scan of per-tile pair counts.
    """
    p_cap = a_idx.shape[0]
    valid = c_tile_id < c_cap
    # Two padding-safe id variants: cid_drop targets index c_cap so scatters
    # with mode="drop" discard padding; cid_seg clamps into range for segment
    # reductions, whose padded contributions are zeroed values (harmless for
    # sum and for max over 0/1 bit planes).
    cid_drop = jnp.where(valid, c_tile_id, c_cap)
    cid_seg = jnp.minimum(cid_drop, c_cap - 1)

    c_tile_row = jnp.full((c_cap,), 0x7FFFFFFF, jnp.int32).at[cid_drop].set(
        c_row, mode="drop")
    c_tile_col = jnp.full((c_cap,), 0x7FFFFFFF, jnp.int32).at[cid_drop].set(
        c_col, mode="drop")

    pairs_per_tile = jax.ops.segment_sum(
        valid.astype(jnp.int32), cid_seg, num_segments=c_cap)
    pair_ptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                jnp.cumsum(pairs_per_tile, dtype=jnp.int32)])

    am = a_masks[a_idx]      # (p_cap, 16) row bitmaps over k
    bt = b_tmasks[b_idx]     # (p_cap, 16) column bitmaps over k
    # packed[p, r] bit c == (am[p, r] & bt[p, c]) != 0  (structural product)
    packed = jnp.zeros((p_cap, 16), jnp.int32)
    for c in range(16):
        hit = (am & bt[:, c:c + 1]) != 0
        packed = packed | (hit.astype(jnp.int32) << c)
    packed = jnp.where(valid[:, None], packed, 0)

    # Segmented OR via 16 bit-plane segment_max reductions.
    cmask = jnp.zeros((c_cap, 16), jnp.int32)
    for c in range(16):
        plane = (packed >> c) & 1
        acc = jax.ops.segment_max(plane, cid_seg, num_segments=c_cap)
        # segment_max over an empty segment yields dtype-min: clamp.
        acc = jnp.maximum(acc, 0)
        cmask = cmask | (acc << c)

    per_tile_nnz = jnp.sum(lax.population_count(cmask), axis=1,
                           dtype=jnp.int32)
    cptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(per_tile_nnz, dtype=jnp.int32)])
    return c_tile_row, c_tile_col, cmask, cptr, pair_ptr


@partial(jax.jit, static_argnames=("c_nnz_cap",))
def c_rowcol(cmask, cptr, c_nnz_cap):
    """Enumerate C's set bits: packed intra-tile coords + owning tile index.

    Returns (rowcol, elem_tile): both (c_nnz_cap,) i32, tile-major intra-tile
    row-major order — exactly the value order the numeric phase produces.

    Gather-formulated: each output slot k locates its tile via a scatter+
    cumsum over cptr, its row via the tile's mask-popcount scan, and its
    column via a 16-step bit-rank select — O(c_nnz) vector work, no
    (c_cap*256)-sized scatter.
    """
    from pem_spgemm.ops import scanops
    c_cap = cmask.shape[0]
    t = scanops.segment_ids_from_offsets(cptr, c_nnz_cap)
    t = jnp.clip(t, 0, c_cap - 1)
    j = jnp.arange(c_nnz_cap, dtype=jnp.int32) - cptr[t]
    pcc = jnp.cumsum(lax.population_count(cmask), axis=1,
                     dtype=jnp.int32)              # (c_cap, 16) inclusive
    rowcum = pcc[t]                                # (c_nnz_cap, 16)
    r = jnp.sum((rowcum <= j[:, None]).astype(jnp.int32), axis=1)
    r = jnp.clip(r, 0, 15)
    prev = jnp.where(
        r > 0,
        jnp.take_along_axis(rowcum, jnp.maximum(r - 1, 0)[:, None],
                            axis=1)[:, 0], 0)
    jr = j - prev                                  # bit rank within the row
    m = cmask[t, r]
    col = jnp.zeros_like(m)
    cnt = jnp.zeros_like(m)
    for c in range(16):
        bit = (m >> c) & 1
        col = jnp.where((bit == 1) & (cnt == jr), c, col)
        cnt = cnt + bit
    return ((r << 4) | col).astype(jnp.int32), t


@partial(jax.jit, static_argnames=("c_nnz_cap",))
def c_rowcol_scatter(cmask, c_nnz_cap):
    """Scatter-formulated variant of c_rowcol (kept for cross-checking)."""
    c_cap = cmask.shape[0]
    shifts = jnp.arange(16, dtype=jnp.int32)
    bits = (cmask[:, :, None] >> shifts[None, None, :]) & 1   # (c_cap,16,16)
    flat = bits.reshape(-1)
    rank = jnp.cumsum(flat, dtype=jnp.int32) - 1              # output slot
    r = jax.lax.broadcasted_iota(jnp.int32, (c_cap, 16, 16), 1)
    c = jax.lax.broadcasted_iota(jnp.int32, (c_cap, 16, 16), 2)
    t = jax.lax.broadcasted_iota(jnp.int32, (c_cap, 16, 16), 0)
    intra = ((r << 4) | c).reshape(-1)
    tidx = t.reshape(-1)
    slot = jnp.where(flat == 1, rank, c_nnz_cap)              # OOB -> dropped
    rowcol = jnp.zeros((c_nnz_cap,), jnp.int32).at[slot].set(intra,
                                                             mode="drop")
    elem_tile = jnp.zeros((c_nnz_cap,), jnp.int32).at[slot].set(tidx,
                                                                mode="drop")
    return rowcol, elem_tile
