"""Multi-device tiled SpGEMM: row-sharded A, ring-exchanged B tiles.

The reference is strictly single-GPU (SURVEY.md section 2.3); this is the
new scaling axis from BASELINE.json: "A row/block-partitioned over hosts, B
tiles fetched via all-gather/all-to-all collectives overlapped with per-tile
numeric compute".

Design (SpGEMM analog of ring attention's pass-blocks-while-computing):
  * C tile rows follow A tile rows, so C tiles are partitioned into
    contiguous ranges balanced by pair count; each device owns the A tiles
    and C tiles of its range (tile-row locality makes both contiguous).
  * B's dense tile values — the heavy data — are sharded into n contiguous
    chunks.  The numeric phase runs n stages: at stage s device d holds B
    chunk (d - s) mod n, multiplies the pairs whose B tile lives in that
    chunk, and ppermutes the chunk to its right neighbor.  XLA overlaps the
    collective-permute with the batched matmuls of the current stage.
  * PLANNING IS DEVICE-NATIVE: the jitted symbolic phase
    (ops/symbolic) expands pairs, ops/cstruct builds the exact C bitmask
    structure, and the ring schedule reuses the jitted phases of
    parallel/sharded_macro — O(pairs) device work, O(n_devices) host ints
    (the round-2 planner densified both operands on the host).

Structural metadata (masks, pointers) is tiny compared to values, so the
plan replicates it implicitly inside the per-device index arrays.
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
from pem_spgemm.formats.tiled import TiledMatrix
from pem_spgemm.ops import cstruct, symbolic
from pem_spgemm.ops.scanops import can_pack

AXIS = "d"
SENT = np.int32(0x7FFFFFFF)


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    return Mesh(np.array(devs[:n]), (AXIS,))


@dataclasses.dataclass
class ShardedPlan:
    """Device-built static plan for one sharded multiply."""

    n_devices: int
    # device inputs, leading axis = device
    a_dense: jax.Array       # (n, a_cap+1, 16, 16) local A slices (+zero)
    b_dense: jax.Array       # (n, b_chunk, 16, 16) stage-0 chunks
    pairs_a: jax.Array       # (n, stages, stage_cap) local A tile index
    pairs_b: jax.Array       # (n, stages, stage_cap) index within B chunk
    seg: jax.Array           # (n, stages, stage_cap) local C tile id (pad=c_cap)
    rowcol: jax.Array        # (n, nnz_cap) intra-tile coords of local C
    elem_tile: jax.Array     # (n, nnz_cap) local C tile index
    c_cap: int
    # host-side assembly info (device arrays; converted at assembly)
    c_tile_row: jax.Array    # (n, c_cap)
    c_tile_col: jax.Array    # (n, c_cap)
    c_nnz_per_dev: np.ndarray  # (n,)
    c_nnz: int
    n_pairs: int

    @property
    def stages(self) -> int:
        return self.pairs_a.shape[1]


@partial(jax.jit, static_argnames=("p_cap", "n", "b_chunk", "stage_cap",
                                   "a_cap", "c_cap", "nnz_cap"))
def _plan_layout16(key_s, a_s, b_s, seg_s, gptr, t_row, t_col, c_bounds,
                   a_lo_dev, a_flat, b_flat, n_btiles,
                   rowcol_g, elem_t_g, cptr, c_nnz,
                   *, p_cap, n, b_chunk, stage_cap, a_cap, c_cap, nnz_cap):
    """Jitted layout: padded schedule tables, operand shards (16x16), and
    the per-device element structure (intra-tile coords + local tile)."""
    flat = n * n * stage_cap
    pos = jnp.arange(p_cap, dtype=jnp.int32)
    live = key_s < n * n
    rank = pos - gptr[jnp.minimum(key_s, n * n)]
    dst = jnp.where(live & (rank < stage_cap),
                    key_s * stage_cap + rank, flat)
    dev_s = jnp.minimum(key_s // n, n - 1)
    pa = jnp.zeros((flat,), jnp.int32).at[dst].set(
        a_s - a_lo_dev[dev_s], mode="drop")
    pb = jnp.zeros((flat,), jnp.int32).at[dst].set(
        b_s % b_chunk, mode="drop")
    sg = jnp.full((flat,), c_cap, jnp.int32).at[dst].set(
        seg_s - c_bounds[dev_s], mode="drop")

    # A shards: gather 1KB flat rows, zero row at the table's own tail
    zero_row = jnp.int32(a_flat.shape[0] - 1)
    cols = jnp.arange(a_cap + 1, dtype=jnp.int32)[None, :]
    idx = a_lo_dev[:, None] + cols
    a_span = jnp.where((cols < a_cap) & (idx < zero_row),
                       jnp.minimum(idx, zero_row), zero_row)
    A = a_flat[a_span].reshape(n, a_cap + 1, 16, 16)

    bidx = jnp.arange(n * b_chunk, dtype=jnp.int32)
    B = b_flat[jnp.where(bidx < n_btiles, bidx,
                         jnp.int32(b_flat.shape[0] - 1))].reshape(
        n, b_chunk, 16, 16)

    # local C tile coordinates
    t = jnp.arange(cptr.shape[0] - 1, dtype=jnp.int32)
    dev_t = jnp.searchsorted(c_bounds[1:-1], t, side="right"
                             ).astype(jnp.int32)
    local_t = t - c_bounds[dev_t]
    real_t = t_row[t] != SENT
    cdst = jnp.where(real_t & (local_t < c_cap),
                     dev_t * c_cap + local_t, n * c_cap)
    CR = jnp.full((n * c_cap,), SENT, jnp.int32).at[cdst].set(
        t_row[t], mode="drop")
    CC = jnp.full((n * c_cap,), SENT, jnp.int32).at[cdst].set(
        t_col[t], mode="drop")

    # per-device element structure: the global tile-major stream slices
    # contiguously per device (tiles sorted, device ranges contiguous)
    epos = jnp.arange(rowcol_g.shape[0], dtype=jnp.int32)
    te = jnp.minimum(elem_t_g, cptr.shape[0] - 2)
    dev_e = jnp.searchsorted(c_bounds[1:-1], te, side="right"
                             ).astype(jnp.int32)
    local_e = epos - cptr[c_bounds[dev_e]]
    edst = jnp.where((epos < c_nnz) & (local_e < nnz_cap),
                     dev_e * nnz_cap + local_e, n * nnz_cap)
    RC = jnp.zeros((n * nnz_cap,), jnp.int32).at[edst].set(
        rowcol_g, mode="drop")
    ET = jnp.zeros((n * nnz_cap,), jnp.int32).at[edst].set(
        te - c_bounds[dev_e], mode="drop")

    return (pa.reshape(n, n, stage_cap), pb.reshape(n, n, stage_cap),
            sg.reshape(n, n, stage_cap), A, B,
            RC.reshape(n, nnz_cap), ET.reshape(n, nnz_cap),
            CR.reshape(n, c_cap), CC.reshape(n, c_cap))


def plan_sharded_spgemm(a: TiledMatrix, b: TiledMatrix, n_devices: int,
                        dtype=np.float32) -> ShardedPlan:
    """Device planner: pair expansion (jitted symbolic phase), exact C
    bitmask structure (ops/cstruct), ring schedule (shared jitted phase
    with the macro planner).  Host traffic: three O(n_devices) D2Hs."""
    from pem_spgemm.ops.convert import transpose_masks
    from pem_spgemm.parallel.sharded_macro import _plan_schedule
    n = n_devices
    del dtype                 # value dtype rides the operands' dense_flat

    offsets = symbolic.pair_counts(a.tile_col, b.tile_rowptr,
                                   jnp.int32(a.ntiles))
    n_pairs = int(offsets[-1])                      # D2H #1
    p_cap = round_up_bucket(max(1, n_pairs))
    packed = can_pack(a.n_tile_rows, b.n_tile_cols)
    c_row, c_col, a_idx, b_idx, seg, cnt_c = symbolic.expand_pairs(
        offsets, a.tile_row, a.tile_col, b.tile_rowptr, b.tile_col,
        jnp.int32(n_pairs), p_cap, packed)

    b_chunk = max(1, -(-b.ntiles // n))
    stats, key_s, a_s, b_s, seg_s, gptr, t_row, t_col, c_bounds = \
        _plan_schedule(c_row, c_col, a_idx, b_idx, seg,
                       jnp.int32(n_pairs), cnt_c,
                       p_cap=p_cap, n=n, b_chunk=b_chunk)
    stats_h = np.asarray(stats)                     # D2H #2 (O(n))
    c_bounds_h = stats_h[:n + 1].astype(np.int64)
    a_lo_h = stats_h[2 * (n + 1):2 * (n + 1) + n]
    a_hi_h = stats_h[2 * (n + 1) + n:2 * (n + 1) + 2 * n]
    stage_cap = max(1, round_up_bucket(int(stats_h[-1])))
    a_lo_h = np.where(a_lo_h == SENT, 0, a_lo_h)
    a_caps = np.maximum(1, a_hi_h - a_lo_h + 1)
    a_cap = round_up_bucket(int(a_caps.max()))
    n_c = int(c_bounds_h[-1])
    c_counts = np.diff(c_bounds_h)
    c_cap = round_up_bucket(max(1, int(c_counts.max())))

    # exact C structure (device): bitmasks + per-tile nnz + set-bit coords
    b_tmasks = b.tmasks if b.tmasks is not None else transpose_masks(b.masks)
    cm_cap = round_up_bucket(max(1, n_c))
    _ctr, _ctc, cmask, cptr, _pp = cstruct.c_masks(
        a.masks, b_tmasks, a_idx, b_idx, seg, c_row, c_col, cm_cap)
    nnz_dev = cptr[jnp.asarray(c_bounds_h, jnp.int32)]
    nnz_dev_h = np.diff(np.asarray(nnz_dev).astype(np.int64))  # D2H #3
    c_nnz = int(nnz_dev_h.sum())
    nnz_cap = round_up_bucket(max(1, int(nnz_dev_h.max())))
    c_nnz_cap = round_up_bucket(max(1, c_nnz))
    rowcol_g, elem_t_g = cstruct.c_rowcol(cmask, cptr, c_nnz_cap)

    pa, pb, sg, A, B, RC, ET, CR, CC = _plan_layout16(
        key_s, a_s, b_s, seg_s, gptr, t_row, t_col, c_bounds,
        jnp.asarray(a_lo_h, jnp.int32),
        a.dense_flat(), b.dense_flat(), jnp.int32(b.ntiles),
        rowcol_g, elem_t_g, cptr, jnp.int32(c_nnz),
        p_cap=p_cap, n=n, b_chunk=b_chunk, stage_cap=stage_cap,
        a_cap=a_cap, c_cap=c_cap, nnz_cap=nnz_cap)

    return ShardedPlan(
        n_devices=n, a_dense=A, b_dense=B, pairs_a=pa, pairs_b=pb, seg=sg,
        rowcol=RC, elem_tile=ET, c_cap=c_cap, c_tile_row=CR, c_tile_col=CC,
        c_nnz_per_dev=nnz_dev_h, c_nnz=c_nnz, n_pairs=n_pairs)


def _local_numeric(a_dense, b_chunk0, pairs_a, pairs_b, seg, rowcol,
                   elem_tile, *, n_stages, c_cap, acc_dtype, precision):
    """Per-device body: ring over B chunks, batched 16x16 matmuls."""
    axis_n = lax.axis_size(AXIS)
    perm = [(i, (i + 1) % axis_n) for i in range(axis_n)]

    def stage(s, carry):
        b_cur, c_dense = carry
        pa = lax.dynamic_index_in_dim(pairs_a, s, keepdims=False)
        pb = lax.dynamic_index_in_dim(pairs_b, s, keepdims=False)
        sg = lax.dynamic_index_in_dim(seg, s, keepdims=False)
        ad = a_dense[pa].astype(acc_dtype)
        bd = b_cur[pb].astype(acc_dtype)
        prod = jnp.einsum("pij,pjk->pik", ad, bd,
                          preferred_element_type=acc_dtype,
                          precision=precision)
        c_dense = c_dense.at[sg].add(prod, mode="drop")
        # Pass the chunk along the ring; XLA overlaps this with the matmuls.
        # (Unconditional: the final shift is unused but keeps the loop free
        # of collectives-under-conditionals.)
        b_nxt = lax.ppermute(b_cur, AXIS, perm)
        return b_nxt, c_dense

    # Mark the accumulator device-varying up front so the loop carry type is
    # stable (it becomes varying after the first scatter-add anyway).
    c_dense = lax.pcast(jnp.zeros((c_cap, 16, 16), acc_dtype), (AXIS,),
                        to='varying')
    _, c_dense = lax.fori_loop(0, n_stages, stage, (b_chunk0, c_dense))
    pos = jnp.minimum(elem_tile * 256 + rowcol, c_cap * 256 - 1)
    return c_dense.reshape(-1)[pos]


def sharded_numeric(plan: ShardedPlan, mesh: Mesh,
                    acc_dtype=jnp.float32, precision="highest"):
    """Run the sharded numeric phase. Returns per-device C values
    (n_devices, nnz_cap) on the host."""
    spec = P(AXIS)
    fn = partial(_local_numeric, n_stages=plan.stages, c_cap=plan.c_cap,
                 acc_dtype=acc_dtype, precision=precision)
    shard_fn = jax.shard_map(
        lambda *xs: fn(*(x[0] for x in xs)),   # drop the leading dev axis
        mesh=mesh,
        in_specs=(spec,) * 7,
        out_specs=spec)

    out = jax.jit(shard_fn)(
        plan.a_dense, plan.b_dense, plan.pairs_a, plan.pairs_b, plan.seg,
        plan.rowcol, plan.elem_tile)
    return np.asarray(out).reshape(plan.n_devices, -1)


def assemble_sharded(plan: ShardedPlan, c_vals_dev: np.ndarray):
    """Host assembly of per-device values into global COO triplets."""
    rowcol = np.asarray(plan.rowcol)
    elem_tile = np.asarray(plan.elem_tile)
    ctr = np.asarray(plan.c_tile_row)
    ctc = np.asarray(plan.c_tile_col)
    rows_l, cols_l, vals_l = [], [], []
    for d in range(plan.n_devices):
        nv = int(plan.c_nnz_per_dev[d])
        rc = rowcol[d, :nv]
        et = elem_tile[d, :nv]
        rows_l.append(ctr[d, et] * 16 + (rc >> 4))
        cols_l.append(ctc[d, et] * 16 + (rc & 15))
        vals_l.append(c_vals_dev[d, :nv])
    return (np.concatenate(rows_l), np.concatenate(cols_l),
            np.concatenate(vals_l))
