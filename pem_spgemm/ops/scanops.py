"""Scan-based building blocks shared by the expansion phases.

Vector formulations of patterns that would otherwise be per-slot searches
or per-product gathers:

  * segment_ids_from_offsets — turns an exclusive-scan offset table into
    per-slot segment ids with a scatter + cumsum (O(n) vector work) instead
    of a binary search per slot.
  * pack_sort_pairs / unpack — lexicographic (hi, lo) sort as a single
    int32 key sort when both fields fit in 16 bits, using the sign-bit
    flip to make signed comparison match unsigned order.
"""

from __future__ import annotations

import jax.numpy as jnp


def fori_scan(combine, xs, identities, rounds=None):
    """Inclusive scan of `combine` over tuple-of-arrays `xs` (axis 0).

    Hillis-Steele with a lax.fori_loop body (one dynamic-slice shift per
    round): O(log n) rounds, COMPACT HLO.  jax.lax.associative_scan unrolls
    its log-depth tree into the graph, which at ~50M elements makes XLA's
    own compilation blow past the compile-helper memory budget; this form
    compiles in O(1) graph size.

    combine((a1..ak), (b1..bk)) -> (c1..ck) must be associative;
    `identities` are per-array left-identity scalars.  `rounds` (static)
    may cap the passes when the caller can bound the maximum dependency
    distance by 2**rounds (e.g. a known maximum segment length); None
    scans the full length.
    """
    import jax
    from jax import lax
    n = xs[0].shape[0]
    full = max(1, (n - 1).bit_length())
    rounds = full if rounds is None else min(full, max(1, rounds))
    pads = tuple(jnp.full((n,), idv, x.dtype)
                 for x, idv in zip(xs, identities))

    def body(r, xs_):
        sh = jnp.int32(1) << r

        def shifted(x, pad):
            return lax.dynamic_slice_in_dim(
                jnp.concatenate([pad, x]), n - sh, n)

        left = tuple(shifted(x, p) for x, p in zip(xs_, pads))
        return combine(left, xs_)

    return jax.lax.fori_loop(0, rounds, body, tuple(xs))


# Forward fills: expand per-segment values to a product stream WITHOUT
# per-product gathers: one small scatter + one cumulative pass.

def fill_monotone_i32(starts, values, total_cap: int):
    """stream[k] = values[s] for the largest s with starts[s] <= k.

    Requires `values` NONDECREASING in s (rows, offsets, ...).  Exact:
    scatter per-segment deltas at the start positions, cumulative-sum.
    Empty segments (duplicate starts) resolve to the largest s (scatter-add
    accumulates all deltas at the shared position).
    """
    deltas = jnp.concatenate([values[:1], values[1:] - values[:-1]])
    st = jnp.minimum(starts, total_cap)
    acc = jnp.zeros((total_cap + 1,), jnp.int32).at[st].add(
        deltas, mode="drop")
    return jnp.cumsum(acc[:-1], dtype=jnp.int32)


def fill_any_32(starts, value_bits, total_cap: int):
    """stream[k] = value_bits[s] for the largest s with starts[s] <= k.

    Single-payload wrapper around fill_any_multi.
    """
    return fill_any_multi(starts, (value_bits,), total_cap)[0]


def fill_any_multi(starts, value_bits_tuple, total_cap: int,
                   rounds=None):
    """Forward-fill SEVERAL per-segment int32 bit patterns in one scan.

    stream_j[k] = value_bits_tuple[j][s] for the largest s with
    starts[s] <= k.  Exact for arbitrary bit patterns (use
    float32.view(int32) for floats) and without gathers or int64: scatter
    each segment's bits at its start position (duplicate starts from empty
    segments collapse to the last segment; `starts` must be nondecreasing
    so duplicates are adjacent), then ONE associative scan over the
    (guard, bits...) tuple whose combiner keeps the entry with the larger
    guard (= most recent scattered position).  Scanning all payloads
    together amortizes the scan's shift/concat passes.
    """
    st = jnp.minimum(starts, total_cap)
    last_of_start = jnp.concatenate([
        st[1:] != st[:-1], jnp.ones((1,), bool)])
    st_eff = jnp.where(last_of_start, st, total_cap)   # dups -> dropped
    guard = jnp.full((total_cap + 1,), -1, jnp.int32).at[st_eff].set(
        st, mode="drop")
    bits = tuple(
        jnp.zeros((total_cap + 1,), jnp.int32).at[st_eff].set(
            vb, mode="drop")
        for vb in value_bits_tuple)

    def comb(a, b):
        take_b = b[0] >= a[0]
        return tuple(jnp.where(take_b, xb, xa) for xa, xb in zip(a, b))

    out = fori_scan(comb, (guard[:-1],) + tuple(x[:-1] for x in bits),
                    (-1,) + (0,) * len(bits), rounds=rounds)
    return out[1:]


def segment_ids_from_offsets(offsets, total_cap: int):
    """offsets: (n_seg+1,) exclusive scan. Returns (total_cap,) i32 segment
    id per slot: id[k] = the segment s with offsets[s] <= k < offsets[s+1].

    Slots beyond offsets[-1] get id >= n_seg (clamp/mask downstream).
    Empty segments are handled: several segments starting at one slot
    accumulate in the scatter-add, so the cumsum skips them correctly.
    """
    starts = jnp.minimum(offsets[:-1], total_cap)
    ind = jnp.zeros((total_cap + 1,), jnp.int32).at[starts].add(
        1, mode="drop")
    return (jnp.cumsum(ind[:-1], dtype=jnp.int32) - 1).astype(jnp.int32)


# 16-bit packed lexicographic sort keys ------------------------------------

PACK_LIMIT = 1 << 16


def can_pack(n_hi: int, n_lo: int) -> bool:
    """True when fields in [0, n_hi) x [0, n_lo) pack losslessly AND the
    all-ones sentinel (0xFFFF, 0xFFFF) stays reserved for padding."""
    return n_hi < PACK_LIMIT and n_lo < PACK_LIMIT


def pack_key(hi, lo):
    """(hi, lo) -> single int32 whose SIGNED order equals the lexicographic
    order of the unsigned fields (sign-bit flip trick)."""
    return ((hi << 16) | (lo & 0xFFFF)) ^ jnp.int32(-0x80000000)


def unpack_key(key):
    k = key ^ jnp.int32(-0x80000000)
    hi = (k >> 16) & 0xFFFF
    lo = k & 0xFFFF
    return hi, lo
