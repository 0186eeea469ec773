"""Symbolic phase: tile-pair generation + C tile structure.

This single sort-based phase subsumes three reference components:
  * step 1 (tile-grid symbolic multiply, spgemm.cu:261-384),
  * the NSPARSE hash fallback for wide B (NSPARSE/spgemm_nsparse_kernel.h,
    dispatched at spgemm.cu:1142-1151) — a sort has no shared-memory width
    limit, so no fallback is needed, and
  * step 2a (pair search, spgemm.cu:387-497) — pairs are generated directly
    by joining A tiles against B's tile-row CSR, instead of intersecting
    per-C-tile lists, so B's tile CSC + offset permutation are unnecessary.

Shape protocol: `pair_counts` returns the total pair count P to the host
(the analog of the reference's first two D2H size feedbacks); `expand_pairs`
then runs at a bucketed static capacity P_cap >= P.  Invalid (padding) pairs
carry INT32_MAX sort keys so they land at the end of the sorted stream.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

INT32_MAX = jnp.int32(0x7FFFFFFF)


@jax.jit
def pair_counts(a_tile_col, b_tile_rowptr, ntiles_a):
    """Per-A-tile pair counts and their exclusive scan.

    a_tile_col: (capA,) i32 — A tiles' column index = B tile-row to join.
    b_tile_rowptr: (n_tile_rows_B + 1,) i32.
    ntiles_a: device scalar i32 — true A tile count (capA - ntiles_a padded).

    Returns offsets (capA+1,) i32; offsets[-1] is the total pair count P.
    """
    cap = a_tile_col.shape[0]
    valid = jnp.arange(cap, dtype=jnp.int32) < ntiles_a
    k = jnp.where(valid, a_tile_col, 0)
    cnt = jnp.where(valid, b_tile_rowptr[k + 1] - b_tile_rowptr[k], 0)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(cnt, dtype=jnp.int32)])


@partial(jax.jit, static_argnames=("p_cap", "packed"))
def expand_pairs(offsets, a_tile_row, a_tile_col, b_tile_rowptr, b_tile_col,
                 n_pairs, p_cap, packed=False):
    """Materialize all (A tile, B tile) products, sorted by C tile key.

    Returns (c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c):
      c_row/c_col: (p_cap,) i32 C tile coordinates (padding sorts last);
      a_idx/b_idx: (p_cap,) i32 operand tile indices;
      c_tile_id:   (p_cap,) i32 dense C tile rank (pairs of one C tile are
                   contiguous); padding pairs get INT32_MAX;
      cnt_c:       device scalar i32 — number of distinct C tiles.

    packed=True (valid when both tile-grid dims are < 2^16, see
    scanops.can_pack) sorts ONE packed int32 key + a permutation instead of
    a 4-operand 2-key sort — roughly half the sort traffic.
    """
    from pem_spgemm.ops import scanops
    p = jnp.arange(p_cap, dtype=jnp.int32)
    valid = p < n_pairs
    # Which A tile does product p belong to? (scatter+cumsum, no search)
    a_idx = scanops.segment_ids_from_offsets(offsets, p_cap)
    a_idx = jnp.clip(a_idx, 0, offsets.shape[0] - 2)
    k = a_tile_col[a_idx]
    b_idx = b_tile_rowptr[jnp.clip(k, 0, b_tile_rowptr.shape[0] - 2)] \
        + (p - offsets[a_idx])
    b_idx = jnp.clip(b_idx, 0, b_tile_col.shape[0] - 1)
    c_row = a_tile_row[a_idx]
    c_col = b_tile_col[b_idx]
    # Padding pairs target the all-zero tile row appended by the flat
    # densifiers (densify_tiles_flat), so engines without scatter-drop
    # semantics (the Pallas kernel) accumulate exact zeros for them.
    a_idx = jnp.where(valid, a_idx, a_tile_row.shape[0])
    b_idx = jnp.where(valid, b_idx, b_tile_col.shape[0])
    if packed:
        key = jnp.where(valid, scanops.pack_key(c_row, c_col), INT32_MAX)
        # operand indices ride the sort as payloads: ~20x cheaper than
        # applying the permutation with scalar gathers afterwards
        key, a_idx, b_idx = lax.sort((key, a_idx, b_idx), num_keys=1)
        c_row, c_col = scanops.unpack_key(key)
        new_tile = jnp.concatenate([
            jnp.ones((1,), jnp.int32),
            (key[1:] != key[:-1]).astype(jnp.int32)])
    else:
        c_row = jnp.where(valid, c_row, INT32_MAX)
        c_col = jnp.where(valid, c_col, INT32_MAX)
        c_row, c_col, a_idx, b_idx = lax.sort(
            (c_row, c_col, a_idx, b_idx), num_keys=2)
        new_tile = jnp.concatenate([
            jnp.ones((1,), jnp.int32),
            ((c_row[1:] != c_row[:-1]) | (c_col[1:] != c_col[:-1]))
            .astype(jnp.int32)])
    c_tile_id = (jnp.cumsum(new_tile) - 1).astype(jnp.int32)
    cnt_c = jnp.where(n_pairs > 0, c_tile_id[jnp.maximum(n_pairs - 1, 0)] + 1,
                      0)
    c_tile_id = jnp.where(p < n_pairs, c_tile_id, INT32_MAX)
    return c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c
