"""Multi-device element-level SpGEMM: column-sharded B, replicated A.

The distributed path for the hypersparse regime (binned element engine,
ops/binned.py).  The decomposition differs from the tiled rings
(parallel/sharded.py, sharded_macro.py) on purpose:

  * In the hypersparse regime BOTH operands are small (the values are the
    nonzeros themselves, no dense tiles), so the heavy thing to scale is
    the INTERMEDIATE PRODUCT STREAM, not operand storage.
  * Partitioning B by COLUMN ranges (balanced by nnz) partitions the
    products exactly: device d computes C[:, j_d:j_{d+1}] = A @ B[:, j_d:],
    a complete local binned multiply.  j-ranges are disjoint, so there is
    no cross-device duplicate merging — exactness is by construction, and
    the only collectives are a (tiny) A broadcast and the final c_nnz
    psum.  This is the 1.5D SpGEMM decomposition with the cheap operand
    replicated — the analog of how the reference's NSPARSE fallback would
    scale, were the reference multi-GPU.

Per-device bucket layouts are padded to common shapes (max over shards
per class) so one shard_map program serves every device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from pem_spgemm.ops import binned
from pem_spgemm.parallel.sharded import AXIS, make_mesh


class _CsrView:
    """Minimal element-CSR operand adapter for ops/binned (a B column
    shard is not a TiledMatrix; it only needs .element_csr() + a cache
    slot)."""

    def __init__(self, rowptr, rows, cols, vals, shape):
        self._ecsr = (rowptr, rows, cols, vals)
        self.shape = shape

    def element_csr(self):
        return self._ecsr


@dataclasses.dataclass
class ShardedElementPlan:
    """Per-device binned plans padded to common shapes."""

    n_devices: int
    table: jax.Array         # (n, NC_cap+1, 2W) per-device chunk tables
    bucket_src: tuple        # per class: (n, R, m) i32
    bucket_avals: tuple      # per class: (n, R, m) f32
    bucket_rows: tuple       # per class: (n, R) i32
    bucket_meta: tuple       # per class: (m, single)
    res_src: jax.Array       # (n, RC)
    res_avals: jax.Array     # (n, RC)
    res_rows: jax.Array      # (n, RC)
    col_bounds: np.ndarray   # (n+1,) j-range boundaries
    w: int
    n_products: int


def plan_sharded_element(a, b, n_devices: int) -> ShardedElementPlan:
    """Build per-shard binned plans (B column-sharded, A replicated)."""
    n = n_devices
    b_rowptr, b_rows, b_cols, b_vals = b.element_csr()
    cols_np = np.asarray(b_cols, np.int64)
    rows_np = np.asarray(b_rows, np.int64)
    vals_np = np.asarray(b_vals)

    # balance j-ranges by B nnz
    hist = np.bincount(cols_np, minlength=b.shape[1])
    cum = np.concatenate([[0], np.cumsum(hist)])
    targets = np.arange(1, n) * (len(cols_np) / n)
    cuts = np.searchsorted(cum, targets)
    col_bounds = np.concatenate([[0], cuts, [b.shape[1]]]).astype(np.int64)

    # per-shard B element CSR (row-major order is preserved by a stable
    # filter) -> per-shard binned plan via the shared machinery
    plans = []
    w = binned.chunk_b(b).w          # one width for all shards
    for d in range(n):
        sel = (cols_np >= col_bounds[d]) & (cols_np < col_bounds[d + 1])
        rs = rows_np[sel]
        counts = np.bincount(rs, minlength=b.shape[0])
        rowptr_d = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        bd = _CsrView(jnp.asarray(rowptr_d),
                      jnp.asarray(rs.astype(np.int32)),
                      jnp.asarray(cols_np[sel].astype(np.int32)),
                      jnp.asarray(vals_np[sel]), b.shape)
        plans.append(binned.build_plan(a, bd, w=w))

    # pad per-class shapes to the max over shards; absent classes on a
    # shard contribute all-dummy rows
    classes = {}
    for p in plans:
        for bk in p.buckets:
            key = (bk.m, bk.single)
            r = bk.src.shape[0]
            classes[key] = max(classes.get(key, 0), r)
    nc_cap = max(p.table.shape[0] for p in plans)
    rc_cap = max(p.res_src.shape[0] for p in plans)

    tables, res_s, res_a, res_r = [], [], [], []
    per_class = {k: ([], [], []) for k in classes}
    for p in plans:
        nc = p.table.shape[0]
        tab = jnp.concatenate([
            p.table[:-1],
            jnp.tile(p.table[-1:], (nc_cap - nc + 1, 1))])
        tables.append(tab)
        dummy = nc_cap - 1               # sentinel row of the padded table
        # remap chunk indices: shard dummies pointed at nc-1; repoint all
        # indices >= nc-1 to the padded sentinel
        by_key = {(bk.m, bk.single): bk for bk in p.buckets}
        for key, r_cap in classes.items():
            m, _single = key
            srcs, avs, rws = per_class[key]
            if key in by_key:
                bk = by_key[key]
                src = jnp.where(bk.src >= nc - 1, dummy, bk.src)
                pad_r = r_cap - bk.src.shape[0]
                src = jnp.concatenate(
                    [src, jnp.full((pad_r, m), dummy, jnp.int32)])
                av = jnp.concatenate(
                    [bk.avals, jnp.zeros((pad_r, m), jnp.float32)])
                rw = jnp.concatenate(
                    [bk.seg_rows,
                     jnp.full((pad_r,), binned.SENTINEL, jnp.int32)])
            else:
                src = jnp.full((r_cap, m), dummy, jnp.int32)
                av = jnp.zeros((r_cap, m), jnp.float32)
                rw = jnp.full((r_cap,), binned.SENTINEL, jnp.int32)
            srcs.append(src)
            avs.append(av)
            rws.append(rw)
        pad_rc = rc_cap - p.res_src.shape[0]
        res_s.append(jnp.concatenate(
            [jnp.where(p.res_src >= nc - 1, dummy, p.res_src),
             jnp.full((pad_rc,), dummy, jnp.int32)]))
        res_a.append(jnp.concatenate(
            [p.res_avals, jnp.zeros((pad_rc,), jnp.float32)]))
        res_r.append(jnp.concatenate(
            [p.res_rows, jnp.full((pad_rc,), binned.SENTINEL, jnp.int32)]))

    keys = sorted(classes)
    return ShardedElementPlan(
        n_devices=n,
        table=jnp.stack(tables),
        bucket_src=tuple(jnp.stack(per_class[k][0]) for k in keys),
        bucket_avals=tuple(jnp.stack(per_class[k][1]) for k in keys),
        bucket_rows=tuple(jnp.stack(per_class[k][2]) for k in keys),
        bucket_meta=tuple(keys),
        res_src=jnp.stack(res_s), res_avals=jnp.stack(res_a),
        res_rows=jnp.stack(res_r),
        col_bounds=col_bounds, w=w,
        n_products=sum(p.n_products for p in plans))


def sharded_element_multiply(plan: ShardedElementPlan, mesh: Mesh):
    """Run all shards under shard_map.  Returns (per-class (keys, vals,
    first) tuples with leading device axis, residual tuple, global c_nnz).
    """
    spec = P(AXIS)
    n_buckets = len(plan.bucket_meta)

    def body(table, res_src, res_avals, res_rows, *bucket_arrays):
        table = table[0]
        outs = []
        total = jnp.zeros((), jnp.int32)
        for i in range(n_buckets):
            m, single = plan.bucket_meta[i]
            src = bucket_arrays[i][0]
            av = bucket_arrays[n_buckets + i][0]
            fn = (binned.bucket_multiply_single if single
                  else binned.bucket_multiply)
            k, v, f, cnt = fn(table, src, av, m, plan.w)
            outs.append((k[None], v[None], f[None]))
            total = total + cnt
        rr, rc, rv, rf, rcnt = binned.residual_multiply(
            table, res_src[0], res_avals[0], res_rows[0], plan.w)
        total = total + rcnt
        total = lax.psum(total, AXIS)
        flat = []
        for k, v, f in outs:
            flat += [k, v, f]
        return tuple(flat) + (rr[None], rc[None], rv[None], rf[None],
                              total[None])

    in_specs = (spec,) * (4 + 2 * n_buckets)
    out_specs = (spec,) * (3 * n_buckets + 4) + (spec,)
    shard_fn = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs)
    args = ([plan.table, plan.res_src, plan.res_avals, plan.res_rows]
            + list(plan.bucket_src) + list(plan.bucket_avals))
    out = jax.jit(shard_fn)(*args)
    per_class = [(out[3 * i], out[3 * i + 1], out[3 * i + 2])
                 for i in range(n_buckets)]
    res = out[3 * n_buckets:3 * n_buckets + 4]
    c_nnz = int(out[-1][0])
    return per_class, res, c_nnz


def assemble_sharded_element(plan: ShardedElementPlan, per_class, res):
    """Host assembly: flagged group totals -> global sorted COO."""
    rs, cs, vs = [], [], []
    for i, (k3, v3, f3) in enumerate(per_class):
        rows_dev = np.asarray(plan.bucket_rows[i])
        k3, v3, f3 = np.asarray(k3), np.asarray(v3), np.asarray(f3)
        for d in range(plan.n_devices):
            fm = f3[d]
            rs.append(np.broadcast_to(rows_dev[d][:, None],
                                      fm.shape)[fm])
            cs.append(k3[d][fm])
            vs.append(v3[d][fm])
    rr, rc, rv, rf = (np.asarray(x) for x in res)
    for d in range(plan.n_devices):
        fm = rf[d]
        rs.append(rr[d][fm])
        cs.append(rc[d][fm])
        vs.append(rv[d][fm])
    rows = np.concatenate(rs)
    cols = np.concatenate(cs)
    vals = np.concatenate(vs)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]
