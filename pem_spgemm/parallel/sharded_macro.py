"""Multi-device Macro128 SpGEMM: row-sharded A, ring-exchanged B macro tiles.

The macro analog of parallel/sharded.py — the regime where multi-chip
matters most, because the B operand is dense 64KB macro tiles (the heavy
data).  Schedule: C macro tiles partition into contiguous per-device
ranges balanced by pair count; B's dense tiles shard into n contiguous
chunks that travel the ring via ppermute, one stage per device, overlapped
by XLA with the current stage's batched 128x128 matmuls.  The exact
structural pattern accumulates locally as a second 0/1 matmul (bf16
counts), so no extra collective traffic is needed for structure.

PLANNING IS DEVICE-NATIVE: pair expansion reuses the jitted
symbolic phase (ops/symbolic), and the ring schedule — device cuts, stage
assignment, group layout, operand sharding — is two jitted phases with
only O(n_devices) scalars crossing to the host (bounds, caps).  Host
memory is O(n_devices), not O(matrix); the round-2 planner densified BOTH
operands on the host (hundreds of GB at the billion-nnz target).  Same
pattern as ops/binned.build_plan_device.

The reference has no distributed component at all (SURVEY.md section 2.3);
this is the new scaling axis.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from pem_spgemm.config import round_up_bucket
from pem_spgemm.formats.macro import MacroMatrix
from pem_spgemm.ops import symbolic
from pem_spgemm.ops.scanops import can_pack
from pem_spgemm.parallel.sharded import AXIS, make_mesh

SENT = np.int32(0x7FFFFFFF)


@dataclasses.dataclass
class ShardedMacroPlan:
    """Device-built static plan for one sharded macro multiply.

    Arrays are jax device arrays with a leading device axis; only the
    per-device scalar metadata (c_counts_dev, n_pairs) lives on host.
    """

    n_devices: int
    a_dense: jax.Array       # (n, a_cap+1, 128, 128) local A slices (+zero)
    b_dense: jax.Array       # (n, b_chunk, 128, 128) stage-0 B chunks
    pairs_a: jax.Array       # (n, stages, stage_cap) local A tile index
    pairs_b: jax.Array       # (n, stages, stage_cap) index within B chunk
    seg: jax.Array           # (n, stages, stage_cap) local C tile id
    c_cap: int
    c_tile_row: jax.Array    # (n, c_cap) global macro coords (pad sentinel)
    c_tile_col: jax.Array    # (n, c_cap)
    c_counts_dev: np.ndarray  # (n,) true local C tile counts
    n_pairs: int

    @property
    def stages(self) -> int:
        return self.pairs_a.shape[1]


@partial(jax.jit, static_argnames=("p_cap", "n", "b_chunk"))
def _plan_schedule(c_row, c_col, a_idx, b_idx, seg, n_pairs, cnt_c,
                   *, p_cap, n, b_chunk):
    """Jitted phase 1: device cuts, stage keys, group layout stats.

    Returns small stats (D2H: bounds, caps) + the key-sorted pair stream
    and group pointers for the layout phase.
    """
    valid = jnp.arange(p_cap, dtype=jnp.int32) < n_pairs
    segc = jnp.minimum(seg, jnp.int32(p_cap))
    tile_pairs = jnp.zeros((p_cap + 1,), jnp.int32).at[segc].add(
        valid.astype(jnp.int32), mode="drop")
    pair_cum = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                jnp.cumsum(tile_pairs, dtype=jnp.int32)])
    # balanced contiguous C ranges by pair count; split the product so
    # k * n_pairs never overflows int32 (exact floor(k*n_pairs/n))
    k = jnp.arange(1, n, dtype=jnp.int32)
    targets = k * (n_pairs // n) + (k * (n_pairs % n)) // n
    cuts = jnp.searchsorted(pair_cum, targets)
    c_bounds = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                cuts.astype(jnp.int32),
                                cnt_c[None].astype(jnp.int32)])
    p_bounds = pair_cum[c_bounds]

    dev = jnp.searchsorted(cuts.astype(jnp.int32), segc, side="right"
                           ).astype(jnp.int32)
    dev = jnp.where(valid, dev, n)
    owner = jnp.minimum(b_idx // b_chunk, n - 1)
    stage = jnp.where(valid, (dev - owner) % n, n * n)
    key = jnp.where(valid, dev * n + stage, jnp.int32(n * n))

    # per-(device, stage) group sizes and pointers
    gcnt = jnp.zeros((n * n + 1,), jnp.int32).at[
        jnp.minimum(key, n * n)].add(1, mode="drop")
    gptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(gcnt, dtype=jnp.int32)])
    stage_cap = jnp.max(gcnt[:n * n])

    # per-device A slice bounds
    a_lo = jnp.full((n + 1,), SENT, jnp.int32).at[
        jnp.minimum(dev, n)].min(
        jnp.where(valid, a_idx, SENT), mode="drop")
    a_hi = jnp.full((n + 1,), -1, jnp.int32).at[
        jnp.minimum(dev, n)].max(
        jnp.where(valid, a_idx, -1), mode="drop")

    # stable key sort with payloads: pairs of one group stay C-sorted
    key_s, a_s, b_s, seg_s = lax.sort(
        (key, a_idx, b_idx, segc), dimension=0, num_keys=1, is_stable=True)

    # per-tile coordinates (first = any pair's coords; constant per tile)
    t_row = jnp.full((p_cap + 1,), SENT, jnp.int32).at[segc].min(
        jnp.where(valid, c_row, SENT), mode="drop")
    t_col = jnp.full((p_cap + 1,), SENT, jnp.int32).at[segc].min(
        jnp.where(valid, c_col, SENT), mode="drop")

    stats = jnp.concatenate([
        c_bounds, p_bounds, a_lo[:n], a_hi[:n], stage_cap[None]])
    return stats, key_s, a_s, b_s, seg_s, gptr, t_row, t_col, c_bounds


@partial(jax.jit, static_argnames=("p_cap", "n", "b_chunk", "stage_cap",
                                   "a_cap", "c_cap"))
def _plan_layout(key_s, a_s, b_s, seg_s, gptr, t_row, t_col, c_bounds,
                 a_lo_dev, a_dense, b_dense, n_btiles,
                 *, p_cap, n, b_chunk, stage_cap, a_cap, c_cap):
    """Jitted phase 2: padded schedule tables + operand shards."""
    flat = n * n * stage_cap
    pos = jnp.arange(p_cap, dtype=jnp.int32)
    live = key_s < n * n
    rank = pos - gptr[jnp.minimum(key_s, n * n)]
    dst = jnp.where(live & (rank < stage_cap),
                    key_s * stage_cap + rank, flat)
    dev_s = jnp.minimum(key_s // n, n - 1)
    pa = jnp.full((flat,), a_cap, jnp.int32).at[dst].set(
        a_s - a_lo_dev[dev_s], mode="drop")
    pb = jnp.zeros((flat,), jnp.int32).at[dst].set(
        b_s % b_chunk, mode="drop")
    sg = jnp.full((flat,), c_cap, jnp.int32).at[dst].set(
        seg_s - c_bounds[dev_s], mode="drop")

    # A shards: (n, a_cap+1) gather of 64KB rows; zero tile rides the
    # operand table's own zero row (dense[cap])
    zero_row = jnp.int32(a_dense.shape[0] - 1)
    cols = jnp.arange(a_cap + 1, dtype=jnp.int32)[None, :]
    idx = a_lo_dev[:, None] + cols
    a_span = jnp.where((cols < a_cap) & (idx < zero_row)
                       & (a_lo_dev[:, None] <= idx),
                       jnp.minimum(idx, zero_row), zero_row)
    A = a_dense[a_span]

    # B chunks: contiguous split, zero-padded tail
    bidx = jnp.arange(n * b_chunk, dtype=jnp.int32)
    B = b_dense[jnp.where(bidx < n_btiles, bidx,
                          jnp.int32(b_dense.shape[0] - 1))]

    # local C tile coordinates
    t = jnp.arange(p_cap + 1, dtype=jnp.int32)
    dev_t = jnp.searchsorted(c_bounds[1:-1], t, side="right"
                             ).astype(jnp.int32)
    local = t - c_bounds[dev_t]
    cdst = jnp.where((t_row != SENT) & (local < c_cap),
                     dev_t * c_cap + local, n * c_cap)
    CR = jnp.full((n * c_cap,), SENT, jnp.int32).at[cdst].set(
        t_row, mode="drop")
    CC = jnp.full((n * c_cap,), SENT, jnp.int32).at[cdst].set(
        t_col, mode="drop")

    return (pa.reshape(n, n, stage_cap), pb.reshape(n, n, stage_cap),
            sg.reshape(n, n, stage_cap),
            A.reshape(n, a_cap + 1, 128, 128),
            B.reshape(n, b_chunk, 128, 128),
            CR.reshape(n, c_cap), CC.reshape(n, c_cap))


def plan_sharded_macro(a: MacroMatrix, b: MacroMatrix,
                       n_devices: int) -> ShardedMacroPlan:
    """Device planner: O(pairs) work on device, O(n_devices) host ints."""
    n = n_devices
    offsets = symbolic.pair_counts(a.tile_col, b.tile_rowptr,
                                   jnp.int32(a.ntiles))
    n_pairs = int(offsets[-1])                      # D2H feedback #1
    p_cap = round_up_bucket(max(1, n_pairs))
    packed = can_pack(a.n_macro_rows, b.n_macro_cols)
    c_row, c_col, a_idx, b_idx, seg, cnt_c = symbolic.expand_pairs(
        offsets, a.tile_row, a.tile_col, b.tile_rowptr, b.tile_col,
        jnp.int32(n_pairs), p_cap, packed)

    b_chunk = max(1, -(-b.ntiles // n))
    stats, key_s, a_s, b_s, seg_s, gptr, t_row, t_col, c_bounds = \
        _plan_schedule(c_row, c_col, a_idx, b_idx, seg,
                       jnp.int32(n_pairs), cnt_c,
                       p_cap=p_cap, n=n, b_chunk=b_chunk)

    stats_h = np.asarray(stats)                     # D2H feedback #2 (O(n))
    c_bounds_h = stats_h[:n + 1]
    a_lo_h = stats_h[2 * (n + 1):2 * (n + 1) + n]
    a_hi_h = stats_h[2 * (n + 1) + n:2 * (n + 1) + 2 * n]
    stage_cap = int(stats_h[-1])
    a_lo_h = np.where(a_lo_h == SENT, 0, a_lo_h)
    a_caps = np.maximum(1, a_hi_h - a_lo_h + 1)
    a_cap = round_up_bucket(int(a_caps.max()))
    c_counts = np.diff(c_bounds_h).astype(np.int64)
    c_cap = max(1, int(c_counts.max()))
    stage_cap = max(1, round_up_bucket(stage_cap))

    pa, pb, sg, A, B, CR, CC = _plan_layout(
        key_s, a_s, b_s, seg_s, gptr, t_row, t_col, c_bounds,
        jnp.asarray(a_lo_h, jnp.int32), a.dense,
        b.dense if b is not a else a.dense, jnp.int32(b.ntiles),
        p_cap=p_cap, n=n, b_chunk=b_chunk, stage_cap=stage_cap,
        a_cap=a_cap, c_cap=c_cap)

    return ShardedMacroPlan(
        n_devices=n, a_dense=A, b_dense=B, pairs_a=pa, pairs_b=pb, seg=sg,
        c_cap=c_cap, c_tile_row=CR, c_tile_col=CC,
        c_counts_dev=c_counts, n_pairs=n_pairs)


def _local_macro(a_dense, b_chunk0, pairs_a, pairs_b, seg, *,
                 n_stages, c_cap, precision):
    """Per-device body: ring over B macro chunks, batched 128x128 matmuls
    + 0/1 structural matmuls."""
    axis_n = lax.axis_size(AXIS)
    perm = [(i, (i + 1) % axis_n) for i in range(axis_n)]

    def stage(s, carry):
        b_cur, c_dense, c_cnt = carry
        pa = lax.dynamic_index_in_dim(pairs_a, s, keepdims=False)
        pb = lax.dynamic_index_in_dim(pairs_b, s, keepdims=False)
        sg = lax.dynamic_index_in_dim(seg, s, keepdims=False)
        ad = a_dense[pa]
        bd = b_cur[pb]
        prod = jnp.einsum("pij,pjk->pik", ad, bd,
                          preferred_element_type=jnp.float32,
                          precision=precision)
        pat = jnp.einsum("pij,pjk->pik", (ad != 0).astype(jnp.bfloat16),
                         (bd != 0).astype(jnp.bfloat16),
                         preferred_element_type=jnp.bfloat16)
        c_dense = c_dense.at[sg].add(prod, mode="drop")
        c_cnt = c_cnt.at[sg].add(pat, mode="drop")
        b_nxt = lax.ppermute(b_cur, AXIS, perm)
        return b_nxt, c_dense, c_cnt

    acc_dtype = jnp.float32
    c_dense = lax.pcast(jnp.zeros((c_cap, 128, 128), acc_dtype), (AXIS,),
                        to='varying')
    c_cnt = lax.pcast(jnp.zeros((c_cap, 128, 128), jnp.bfloat16), (AXIS,),
                      to='varying')
    _, c_dense, c_cnt = lax.fori_loop(0, n_stages, stage,
                                      (b_chunk0, c_dense, c_cnt))
    return c_dense, c_cnt


def sharded_macro_numeric(plan: ShardedMacroPlan, mesh: Mesh,
                          precision="highest", as_numpy: bool = True):
    """Run the sharded macro numeric phase.

    Returns (c_dense, c_counts) with leading device axis — host numpy by
    default (assembly path); as_numpy=False leaves them on device."""
    spec = P(AXIS)
    fn = partial(_local_macro, n_stages=plan.stages, c_cap=plan.c_cap,
                 precision=precision)
    shard_fn = jax.shard_map(
        lambda *xs: fn(*(x[0] for x in xs)),
        mesh=mesh, in_specs=(spec,) * 5, out_specs=(spec, spec))
    c_dense, c_cnt = jax.jit(shard_fn)(
        plan.a_dense, plan.b_dense, plan.pairs_a, plan.pairs_b, plan.seg)
    n = plan.n_devices
    if not as_numpy:
        return c_dense, c_cnt
    return (np.asarray(c_dense).reshape(n, plan.c_cap, 128, 128),
            np.asarray(c_cnt, dtype=np.float32).reshape(
                n, plan.c_cap, 128, 128))


def assemble_sharded_macro(plan: ShardedMacroPlan, c_dense, c_counts):
    """Host assembly: per-device macro C tiles -> global COO triplets."""
    ctr = np.asarray(plan.c_tile_row)
    ctc = np.asarray(plan.c_tile_col)
    rows_l, cols_l, vals_l = [], [], []
    for d in range(plan.n_devices):
        nc = int(plan.c_counts_dev[d])
        cnt = c_counts[d, :nc]
        t, r, c = np.nonzero(cnt > 0)
        rows_l.append(ctr[d, t] * 128 + r)
        cols_l.append(ctc[d, t] * 128 + c)
        vals_l.append(c_dense[d, t, r, c])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]
