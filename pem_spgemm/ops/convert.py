"""COO -> Tile16 conversion, device-native.

Replaces the reference's GPU-native conversion (decide_which_tile
spgemm.cu:112-135, thrust census spgemm.cu:866-928, generate_tiles_csr
spgemm.cu:137-226, __transpose_B_mask spgemm.cu:228-258, high-level CSR
spgemm.cu:985-1031) with an XLA-first design:

  * one lexicographic 3-key sort (tile_row, tile_col, intra-coord) replaces
    the reference's two sorts (tile keys + zipped element triplets);
  * tile census / per-tile nnz / masks are segment reductions over the sorted
    stream (thrust reduce_by_key -> jax.ops.segment_sum);
  * the per-tile interior build (256 binary searches per tile in the
    reference) disappears entirely: after the 3-key sort the elements are
    already in tile-major intra-tile CSR order, and masks are one scatter-add
    of single-bit integers;
  * the 16x16 bitmask transpose is a butterfly network of vector bit-ops
    over all tiles at once (no per-tile kernel).

Dynamic sizes cross to the host exactly once (the tile count), mirroring the
reference's single D2H size feedback per matrix; tile arrays are padded to a
power-of-two bucket (config.round_up_bucket).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pem_spgemm.config import round_up_bucket
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.formats.tiled import TiledMatrix, cdiv


@jax.jit
def _sort_phase(rows, cols, vals):
    """Sort elements into tile-major intra-tile CSR order; label tiles.

    Returns sorted (tile_row, tile_col, intra, vals, tile_id) and the tile
    count as a device scalar.
    """
    tr = (rows >> 4).astype(jnp.int32)
    tc = (cols >> 4).astype(jnp.int32)
    intra = (((rows & 15) << 4) | (cols & 15)).astype(jnp.int32)
    tr, tc, intra, vals = lax.sort((tr, tc, intra, vals), num_keys=3)
    same_tile = (tr[1:] == tr[:-1]) & (tc[1:] == tc[:-1])
    new_tile = jnp.concatenate([
        jnp.ones((1,), jnp.int32), (~same_tile).astype(jnp.int32)])
    tile_id = jnp.cumsum(new_tile) - 1
    cnt = tile_id[-1] + 1
    # Duplicate coordinates would double-add mask bits; detect them here
    # (adjacent after the sort) so the caller can fail fast.
    n_dup = jnp.sum((same_tile & (intra[1:] == intra[:-1])).astype(jnp.int32))
    return tr, tc, intra, vals, tile_id.astype(jnp.int32), cnt, n_dup


@partial(jax.jit, static_argnames=("tile_cap", "n_tile_rows", "n_tile_cols"))
def _build_phase(tr, tc, intra, tile_id, tile_cap, n_tile_rows, n_tile_cols):
    """Census + masks + high-level CSR at a fixed tile capacity."""
    nnz = tr.shape[0]
    ones = jnp.ones((nnz,), jnp.int32)
    per_tile = jax.ops.segment_sum(ones, tile_id, num_segments=tile_cap)
    ptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                           jnp.cumsum(per_tile, dtype=jnp.int32)])
    # All elements of a tile scatter the same value: last-write-wins is fine.
    tile_row = jnp.full((tile_cap,), n_tile_rows, jnp.int32).at[tile_id].set(tr)
    tile_col = jnp.full((tile_cap,), n_tile_cols, jnp.int32).at[tile_id].set(tc)
    # Row bitmaps: one scatter-add of single-bit integers per element.
    seg = tile_id * 16 + (intra >> 4)
    bit = (jnp.int32(1) << (intra & 15))
    masks = jax.ops.segment_sum(bit, seg, num_segments=tile_cap * 16)
    masks = masks.reshape(tile_cap, 16)
    # High-level CSR over tiles (tiles are sorted by row-major tile key).
    counts = jnp.bincount(tile_row, length=n_tile_rows + 1)[:n_tile_rows]
    tile_rowptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                   jnp.cumsum(counts, dtype=jnp.int32)])
    return tile_row, tile_col, ptr, masks, tile_rowptr


@jax.jit
def transpose_masks(masks):
    """Bit-transpose every 16x16 tile bitmask: out[:, c] bit r = in[:, r] bit c.

    Butterfly (Hacker's-Delight-style) 16x16 bit-matrix transpose, vectorized
    across all tiles — the XLA replacement for the reference's
    __transpose_B_mask kernel (spgemm.cu:228-258).
    """
    a = [masks[:, r] for r in range(16)]
    j, m = 8, jnp.int32(0x00FF)
    while j != 0:
        k = 0
        while k < 16:
            t = ((a[k] >> j) ^ a[k + j]) & m
            a[k + j] = a[k + j] ^ t
            a[k] = a[k] ^ (t << j)
            k = (k + j + 1) & ~j
        j >>= 1
        m = m ^ (m << j) if j else m
    return jnp.stack(a, axis=1)


@jax.jit
def _macro_sort_phase(rows, cols, vals):
    """Sort elements into macro-tile-major order via one packed-key sort."""
    from pem_spgemm.ops.scanops import pack_key
    tr = (rows >> 7).astype(jnp.int32)
    tc = (cols >> 7).astype(jnp.int32)
    intra = (((rows & 127) << 7) | (cols & 127)).astype(jnp.int32)
    key = pack_key(tr, tc)
    key, intra, vals = lax.sort((key, intra, vals), num_keys=2)
    same_tile = key[1:] == key[:-1]
    new_tile = jnp.concatenate([
        jnp.ones((1,), jnp.int32), (~same_tile).astype(jnp.int32)])
    tile_id = (jnp.cumsum(new_tile) - 1).astype(jnp.int32)
    cnt = tile_id[-1] + 1
    # Duplicate coordinates would silently last-write-win in the dense
    # scatter; detect them (adjacent after the 2-key sort) to fail fast.
    n_dup = jnp.sum((same_tile & (intra[1:] == intra[:-1])).astype(jnp.int32))
    return key, intra, vals, tile_id, cnt, n_dup


@partial(jax.jit, static_argnames=("tile_cap", "n_macro_rows",
                                   "n_macro_cols"))
def _macro_build_phase(key, intra, vals, tile_id, tile_cap, n_macro_rows,
                       n_macro_cols):
    from pem_spgemm.ops.scanops import unpack_key
    tr, tc = unpack_key(key)
    tile_row = jnp.full((tile_cap,), n_macro_rows, jnp.int32).at[tile_id].set(
        tr.astype(jnp.int32))
    tile_col = jnp.full((tile_cap,), n_macro_cols, jnp.int32).at[tile_id].set(
        tc.astype(jnp.int32))
    # Tiles beyond an undersized tile_cap must be DROPPED, not folded into
    # the reserved all-zero padding tile at index tile_cap (pair reads of
    # padding depend on it staying zero): route them out of range.
    pos = jnp.where(tile_id < tile_cap, tile_id * (128 * 128) + intra,
                    (tile_cap + 1) * (128 * 128))
    dense = jnp.zeros(((tile_cap + 1) * 128 * 128,), vals.dtype).at[pos].set(
        vals, mode="drop").reshape(tile_cap + 1, 128, 128)
    counts = jnp.bincount(tile_row, length=n_macro_rows + 1)[:n_macro_rows]
    tile_rowptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                   jnp.cumsum(counts, dtype=jnp.int32)])
    return tile_row, tile_col, tile_rowptr, dense


def coo_to_macro(coo: COOMatrix, dtype=jnp.float32,
                 tile_cap: int | None = None) -> "MacroMatrix":
    """Convert host COO to the dense 128x128 macro-tile format."""
    from pem_spgemm.formats.macro import MacroMatrix
    from pem_spgemm.ops.scanops import can_pack
    if coo.nnz == 0:
        raise ValueError("empty matrix")
    n_mr = cdiv(coo.shape[0], 128)
    n_mc = cdiv(coo.shape[1], 128)
    if not can_pack(n_mr, n_mc):
        raise ValueError(f"macro grid {n_mr}x{n_mc} exceeds packed-key "
                         "range (matrix > ~8.4M rows/cols)")
    rows = jnp.asarray(coo.rows, jnp.int32)
    cols = jnp.asarray(coo.cols, jnp.int32)
    vals = jnp.asarray(coo.vals, dtype)
    key, intra, vals_s, tile_id, cnt, n_dup = _macro_sort_phase(
        rows, cols, vals)
    ntiles = int(cnt)  # single D2H size feedback
    if int(n_dup):
        raise ValueError(
            f"{int(n_dup)} duplicate coordinates; the dense macro format "
            "requires canonical COO — call COOMatrix.sum_duplicates() first")
    cap = tile_cap if tile_cap is not None else round_up_bucket(ntiles)
    tile_row, tile_col, tile_rowptr, dense = _macro_build_phase(
        key, intra, vals_s, tile_id, cap, n_mr, n_mc)
    return MacroMatrix(tile_row=tile_row, tile_col=tile_col,
                       tile_rowptr=tile_rowptr, dense=dense,
                       shape=tuple(coo.shape), ntiles=ntiles, nnz=coo.nnz)


def tiled_to_macro(t: TiledMatrix, tile_cap: int | None = None):
    """Build the macro form from an existing Tile16 matrix (no COO reread)."""
    from pem_spgemm.formats.macro import MacroMatrix
    from pem_spgemm.ops.scanops import can_pack
    n_mr = cdiv(t.shape[0], 128)
    n_mc = cdiv(t.shape[1], 128)
    if not can_pack(n_mr, n_mc):
        raise ValueError("macro grid exceeds packed-key range")
    rows, cols = t.element_coords()
    key, intra, vals_s, tile_id, cnt, _n_dup = _macro_sort_phase(
        rows, cols, t.vals)   # t is canonical by construction
    ntiles = int(cnt)
    cap = tile_cap if tile_cap is not None else round_up_bucket(ntiles)
    tile_row, tile_col, tile_rowptr, dense = _macro_build_phase(
        key, intra, vals_s, tile_id, cap, n_mr, n_mc)
    return MacroMatrix(tile_row=tile_row, tile_col=tile_col,
                       tile_rowptr=tile_rowptr, dense=dense,
                       shape=tuple(t.shape), ntiles=ntiles, nnz=t.nnz)


def coo_to_tiled(coo: COOMatrix, dtype=jnp.float32, with_tmasks: bool = False,
                 tile_cap: int | None = None) -> TiledMatrix:
    """Convert host COO triplets to a device TiledMatrix.

    Requires canonical COO (no duplicate coordinates); use
    COOMatrix.sum_duplicates() first if unsure.
    """
    if coo.nnz == 0:
        raise ValueError("empty matrix")
    n_tile_rows = cdiv(coo.shape[0], 16)
    n_tile_cols = cdiv(coo.shape[1], 16)
    rows = jnp.asarray(coo.rows, jnp.int32)
    cols = jnp.asarray(coo.cols, jnp.int32)
    vals = jnp.asarray(coo.vals, dtype)
    tr, tc, intra, vals_s, tile_id, cnt, n_dup = _sort_phase(rows, cols, vals)
    ntiles = int(cnt)  # the single D2H size feedback of the conversion
    if int(n_dup):
        raise ValueError(
            f"{int(n_dup)} duplicate coordinates; the bitmask tile format "
            "requires canonical COO — call COOMatrix.sum_duplicates() first")
    cap = tile_cap if tile_cap is not None else round_up_bucket(ntiles)
    tile_row, tile_col, ptr, masks, tile_rowptr = _build_phase(
        tr, tc, intra, tile_id, cap, n_tile_rows, n_tile_cols)
    tmasks = transpose_masks(masks) if with_tmasks else None
    return TiledMatrix(
        tile_row=tile_row, tile_col=tile_col, ptr=ptr, masks=masks,
        vals=vals_s, rowcol=intra, elem_tile=tile_id,
        tile_rowptr=tile_rowptr, tmasks=tmasks,
        shape=tuple(coo.shape), ntiles=ntiles)
