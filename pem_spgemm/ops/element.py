"""Element-level SpGEMM engine — the hypersparse regime.

The dense-tile numeric phase does 2*16^3 matmul flops per tile pair regardless
of fill; on matrices averaging ~1-2 nonzeros per tile (web graphs, uniform
random) that is a >1000x dense-work blowup AND the tile-pair count exceeds
the element product count.  This engine is the flop-proportional
alternative: expand every scalar product, sort by output coordinate, and
segment-reduce — all vector ops, no per-tile blowup.

This plays the role of the reference's NSPARSE fallback (dispatched by
structure at spgemm.cu:1142): a second engine behind the same API, selected
by a structural heuristic (config.engine="auto" uses mean nnz/tile).

Phase mapping for benchmark parity: step1 = product counting/expansion,
step2 = coordinate sort + boundary detection (structure, exact C nnz),
step3 = value segment-reduction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

INT32_MAX = jnp.int32(0x7FFFFFFF)


@jax.jit
def element_coords(tile_row, tile_col, elem_tile, rowcol):
    """Global (row, col) of every element of a TiledMatrix."""
    rows = tile_row[elem_tile] * 16 + (rowcol >> 4)
    cols = tile_col[elem_tile] * 16 + (rowcol & 15)
    return rows, cols


@partial(jax.jit, static_argnames=("n_rows",))
def build_element_csr(tile_row, tile_col, elem_tile, rowcol, vals, n_rows):
    """Row-sorted element triplets + row pointer (the element-level CSR the
    reference builds during conversion, spgemm.cu:894-928)."""
    rows, cols = element_coords(tile_row, tile_col, elem_tile, rowcol)
    rows, cols, vals = lax.sort((rows, cols, vals), num_keys=2)
    counts = jnp.bincount(rows, length=n_rows)
    rowptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts, dtype=jnp.int32)])
    return rowptr, rows, cols, vals


@jax.jit
def product_offsets(a_cols, b_row_nnz):
    cnt = b_row_nnz[a_cols]
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(cnt, dtype=jnp.int32)])


@partial(jax.jit, static_argnames=("p_cap",))
def expand_sorted_products(offsets, a_rows, a_cols, a_vals, b_rowptr,
                           b_cols, b_vals, n_products, p_cap):
    """Scalar products sorted by (row, col) with boundary flags.

    Returns (ci, cj, cv, out_id, c_nnz_dev): coordinates, product values,
    dense output rank per product (INT32_MAX on padding), distinct count.
    """
    from pem_spgemm.ops import scanops
    p = jnp.arange(p_cap, dtype=jnp.int32)
    valid = p < n_products
    a = jnp.clip(scanops.segment_ids_from_offsets(offsets, p_cap),
                 0, a_rows.shape[0] - 1)
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


@partial(jax.jit, static_argnames=("p_cap", "fill_rounds", "merge_rounds",
                                   "sum_rounds"))
def expand_reduce_products(offsets, a_rows, a_cols, a_vals, b_rowptr,
                           b_cols, b_vals, n_products, p_cap,
                           fill_rounds=None, merge_rounds=None,
                           sum_rounds=None):
    """Gather-free product expansion + grouping + reduction.

    Per-product scalar gathers (~6 per product) are the dominant cost of
    the naive expansion; this version moves data exclusively with
    sorts-with-payloads, forward-fill scans (scanops.fill_*), and
    cumulative sums:

      1. A-side terms reach the product stream via forward fills from
         segment starts (rows/offsets are monotone -> delta-scatter+cumsum;
         values/B-row-bases are arbitrary -> guarded associative scan).
      2. B-side terms attach by ONE merge sort: the B element table (keys
         2*i) and the product stream (keys 2*b(p)+1) sort together; each
         query then forward-fills (col, val) from the nearest table entry
         above it.  Payload slots are shared: a table entry carries
         (col, val-bits) in the same two slots where a query carries
         (row, A-val-bits).
      3. Products group by one 2-key (row, col) sort; per-group sums use a
         segmented Hillis-Steele scan (log2 rounds of masked shifted adds,
         so the first product of each group holds the group total).

    Returns C in STREAM FORM: (rows, cols, vals, first, c_nnz) of length
    p_cap + nnz_b + 1, row-major sorted, where `first` flags the leading
    product of each distinct (row, col) group and `vals` at a flagged
    position holds that group's exact total.  Every C value is computed
    and the structural count is exact; densifying the stream to compact
    COO is format conversion, done by the untimed assembly step
    (compact_stream / SpGEMMResult.to_coo) — exactly as the tiled engines'
    timed product is dense value tiles + masks and the reference's COO
    emission lives in the untimed sanitize_C (spgemm.cu:1493-1560).
    """
    from pem_spgemm.ops import scanops
    nnz_b = b_cols.shape[0]
    starts = offsets[:-1]
    p = jnp.arange(p_cap, dtype=jnp.int32)
    valid = p < n_products

    # --- 1. A-side fills ---
    ci = scanops.fill_monotone_i32(starts, a_rows, p_cap)
    off = scanops.fill_monotone_i32(starts, starts, p_cap)
    b_base_e = b_rowptr[a_cols]                      # (nnz_a,) small gather
    # fill_rounds bounds the scan depth by log2(max B-row nnz) — the
    # longest expansion segment (host-computed, exact bound)
    bb, va = scanops.fill_any_multi(
        starts, (b_base_e, _f2i(a_vals)), p_cap, rounds=fill_rounds)
    b = bb + (p - off)
    b = jnp.where(valid, jnp.clip(b, 0, nnz_b - 1), nnz_b)
    ci = jnp.where(valid, ci, INT32_MAX)

    # --- 2. merge sort with the B table ---
    tkey = jnp.arange(nnz_b + 1, dtype=jnp.int32) * 2        # tables even
    qkey = b * 2 + 1                                         # queries odd
    key = jnp.concatenate([tkey, qkey])
    pl1 = jnp.concatenate([jnp.append(b_cols, INT32_MAX), ci])
    pl2 = jnp.concatenate([_f2i(jnp.append(b_vals, 0.0)), va])
    key, pl1, pl2 = lax.sort((key, pl1, pl2), num_keys=1)
    n2 = key.shape[0]
    is_table = (key & 1) == 0
    pos = jnp.arange(n2, dtype=jnp.int32)
    guard = jnp.where(is_table, pos, -1)

    def comb(a_, b_):
        ga, c1a, c2a = a_
        gb, c1b, c2b = b_
        t = gb >= ga
        return (jnp.where(t, gb, ga), jnp.where(t, c1b, c1a),
                jnp.where(t, c2b, c2a))

    # merge_rounds bounds the query->table gap by log2(max products per
    # B element + 1) (= max A column count, host-computed)
    _, fill_col, fill_valbits = scanops.fori_scan(
        comb, (guard, pl1, pl2), (-1, 0, 0), rounds=merge_rounds)

    q_ci = pl1                                       # queries' row
    q_va = _i2f(pl2)
    q_cj = fill_col
    q_vb = _i2f(fill_valbits)
    live = jnp.logical_not(is_table) & (q_ci != INT32_MAX)
    cv = jnp.where(live, q_va * q_vb, 0.0)
    ci2 = jnp.where(live, q_ci, INT32_MAX)
    cj2 = jnp.where(live, q_cj, INT32_MAX)

    # --- 3. group by (row, col); segmented sum via log-shift scan ---
    ci2, cj2, cv = lax.sort((ci2, cj2, cv), num_keys=2)
    new = jnp.concatenate([
        jnp.ones((1,), jnp.int32),
        ((ci2[1:] != ci2[:-1]) | (cj2[1:] != cj2[:-1])).astype(jnp.int32)])
    out_id = (jnp.cumsum(new, dtype=jnp.int32) - 1)
    c_nnz = jnp.where(
        n_products > 0,
        out_id[jnp.clip(n_products - 1, 0, n2 - 1)] + 1, 0)
    # Per-group totals at the FIRST element of each group: one segmented
    # inclusive-sum scan over the reversed stream (standard associative
    # segmented-scan operator), then reverse back.
    last = jnp.concatenate([(out_id[1:] != out_id[:-1]).astype(jnp.int32),
                            jnp.ones((1,), jnp.int32)])
    f_rev = last[::-1]
    v_rev = cv[::-1]

    def segsum(a_, b_):
        fa, va_ = a_
        fb, vb_ = b_
        return fa | fb, vb_ + jnp.where(fb == 1, 0.0, va_)

    # sum_rounds bounds group sizes by log2(max A row nnz) (a C group
    # (i, j) has at most nnz_row_i(A) contributing products)
    _, summed_rev = scanops.fori_scan(segsum, (f_rev, v_rev), (0, 0.0),
                                      rounds=sum_rounds)
    cv = summed_rev[::-1]

    return ci2, cj2, cv, new, c_nnz


def scan_round_bounds(a_rows_np, a_cols_np, b_row_nnz_np):
    """Host-computed static scan-depth bounds (see expand_reduce_products).

    Returns (fill_rounds, merge_rounds, sum_rounds), each rounded up to an
    even count so plan shapes bucket coarsely.
    """
    import numpy as np

    def ceil_log2(x):
        return max(1, int(x - 1).bit_length()) if x > 1 else 1

    def even(r):
        return r + (r & 1)

    max_brow = int(b_row_nnz_np.max()) if len(b_row_nnz_np) else 1
    arow_cnt = np.bincount(a_rows_np) if len(a_rows_np) else np.array([1])
    max_arow = int(arow_cnt.max())
    acol_cnt = np.bincount(a_cols_np) if len(a_cols_np) else np.array([1])
    max_acol = int(acol_cnt.max())
    return (even(ceil_log2(max_brow) + 1),
            even(ceil_log2(max_acol) + 2),
            even(ceil_log2(max_arow) + 1))


@jax.jit
def compact_stream(rows, cols, vals, first):
    """Untimed assembly: stream form -> compact sorted COO (device).

    One 1-key sort by (is_first ? rank : rank | 1<<30) — a scatter-free
    stream compaction; flagged entries land in the leading c_nnz slots in
    row-major order.
    """
    out_id = jnp.cumsum(first, dtype=jnp.int32) - 1
    ckey = jnp.where(first == 1, out_id, out_id | (1 << 30))
    _, r, c, v = lax.sort((ckey, rows, cols, vals), num_keys=1)
    return r, c, v


def _f2i(x):
    return lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)


def _i2f(x):
    return lax.bitcast_convert_type(x, jnp.float32)


@partial(jax.jit, static_argnames=("p_cap", "c_cap", "fill_rounds",
                                   "merge_rounds", "sum_rounds"))
def element_fixed(a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
                  *, p_cap, c_cap, fill_rounds=None, merge_rounds=None,
                  sum_rounds=None):
    """One-shot element-level SpGEMM at static capacities — no host syncs.

    The element-engine analog of ops/fixed.spgemm_fixed: product counting,
    gather-free expansion (expand_reduce_products), and compaction compose
    into ONE dispatch once p_cap >= products is known from a first
    interactive run.  Mirrors the reference's steady-state repeat loop,
    which re-runs its three steps with unchanged sizes (spgemm.cu:1133-1357).

    Returns C in stream form (see expand_reduce_products) plus an overflow
    flag: (rows, cols, vals, first, c_nnz, overflow).  overflow True =>
    p_cap < true product count and the result is truncated; the caller
    must re-plan with a larger capacity (bench/harness.py does).  (c_cap
    is accepted for plan compatibility; outputs are sized
    p_cap + nnz_b + 1.)
    """
    del c_cap
    if jnp.dtype(a_vals.dtype).itemsize > 4:
        raise TypeError(
            "element_fixed moves value bits as f32 and would silently "
            f"downcast {a_vals.dtype}; wide dtypes must use "
            "element_fixed_wide")
    b_row_nnz = b_rowptr[1:] - b_rowptr[:-1]
    offsets = product_offsets(a_cols, b_row_nnz)
    n_products = jnp.minimum(offsets[-1], p_cap)
    out = expand_reduce_products(
        offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
        n_products, p_cap, fill_rounds, merge_rounds, sum_rounds)
    return out + (offsets[-1] > p_cap,)


@partial(jax.jit, static_argnames=("p_cap", "c_cap"))
def element_fixed_wide(a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
                       *, p_cap, c_cap):
    """Wide-dtype (f64 parity) fixed element step — no host syncs.

    Composes the interactive wide branch (expand_sorted_products +
    reduce_products, ops/spgemm._element) into one dispatch: the value
    stream keeps its native dtype end to end (true double accumulation,
    matching the reference's ValueType=double, spgemm.cu:728), unlike
    element_fixed whose merge pipeline bit-packs values as f32.

    Returns stream-compatible (rows, cols, vals, first, c_nnz, overflow):
    compact COO in the leading c_nnz slots, `first` all-ones (each output
    is its own group).
    """
    b_row_nnz = b_rowptr[1:] - b_rowptr[:-1]
    offsets = product_offsets(a_cols, b_row_nnz)
    n_products = jnp.minimum(offsets[-1], p_cap)
    ci, cj, cv, out_id, c_nnz = expand_sorted_products(
        offsets, a_rows, a_cols, a_vals, b_rowptr, b_cols, b_vals,
        n_products, p_cap)
    rows, cols, vals = reduce_products(ci, cj, cv, out_id, c_cap)
    first = (rows != INT32_MAX).astype(jnp.int32)
    overflow = (offsets[-1] > p_cap) | (c_nnz > c_cap)
    return rows, cols, vals, first, c_nnz, overflow


@partial(jax.jit, static_argnames=("c_cap",))
def reduce_products(ci, cj, cv, out_id, c_cap):
    """Coordinates + summed values of distinct outputs (padding INT32_MAX)."""
    oid = jnp.minimum(out_id, c_cap)
    rows = jnp.full((c_cap,), INT32_MAX).at[oid].set(
        ci, mode="drop", indices_are_sorted=True)
    cols = jnp.full((c_cap,), INT32_MAX).at[oid].set(
        cj, mode="drop", indices_are_sorted=True)
    vals = jax.ops.segment_sum(
        jnp.where(out_id < c_cap, cv, 0), jnp.minimum(oid, c_cap - 1),
        num_segments=c_cap, indices_are_sorted=True)
    return rows, cols, vals
