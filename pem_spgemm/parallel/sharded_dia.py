"""Multi-device DIA SpGEMM: column-block sharding with halo exchange.

The DIA engine's multiply (ops/dia.py) is pure band-offset algebra:

    C[d1 + d2][i]  +=  A[d1][i] * B[d2][i + d1]

The natural decomposition shards the length-n axis into contiguous
column blocks — every output column i needs only B columns
[i + min(offs_a), i + max(offs_a)], so each device exchanges a fixed
HALO of width max|offs_a| with its two ring neighbors (two `ppermute`s
of edge slices, overlapped by XLA with the local shifted-FMA streams)
and computes its C block with NO other communication.  This is the
SpGEMM analog of halo-exchange stencil parallelism, and the fourth
decomposition next to the tile16/macro rings and the column-sharded
element engine.

The reference has no distributed component (SURVEY.md section 2.3).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from pem_spgemm.formats.dia import DiaMatrix
from pem_spgemm.ops.dia import _plan_maps
from pem_spgemm.parallel.sharded import AXIS, make_mesh


def _local_dia(a_blk, b_blk, *, offs_a, idx_map, dc_count, hl, hr):
    """Per-device body: halo exchange + shifted-FMA band accumulation."""
    n_dev = lax.axis_size(AXIS)
    l = a_blk.shape[1]
    # halo exchange: left halo comes FROM the left neighbor (d-1 -> d),
    # right halo from the right neighbor (d+1 -> d).  Non-cyclic perms:
    # edge devices receive zeros — exactly the out-of-matrix padding the
    # band algebra needs.
    if hl > 0:
        left = lax.ppermute(b_blk[:, l - hl:], AXIS,
                            [(i, i + 1) for i in range(n_dev - 1)])
    else:
        left = jnp.zeros((b_blk.shape[0], 0), b_blk.dtype)
    if hr > 0:
        right = lax.ppermute(b_blk[:, :hr], AXIS,
                             [(i + 1, i) for i in range(n_dev - 1)])
    else:
        right = jnp.zeros((b_blk.shape[0], 0), b_blk.dtype)
    bp = jnp.concatenate([left, b_blk, right], axis=1)
    bm = (bp != 0).astype(jnp.float32)

    c = jnp.zeros((dc_count, l), a_blk.dtype)
    cnt = jnp.zeros((dc_count, l), jnp.float32)
    for k1, d1 in enumerate(offs_a):
        s = hl + d1
        sl = lax.slice(bp, (0, s), (bp.shape[0], s + l))
        slm = lax.slice(bm, (0, s), (bm.shape[0], s + l))
        a_row = a_blk[k1][None, :]
        rows = jnp.asarray(idx_map[k1], jnp.int32)
        c = c.at[rows].add(a_row * sl)
        cnt = cnt.at[rows].add((a_row != 0).astype(jnp.float32) * slm)
    return c, cnt


def sharded_dia_multiply(a: DiaMatrix, b: DiaMatrix,
                         mesh: Mesh | None = None):
    """Sharded DIA multiply over the mesh's devices.

    Returns (c_bands (dc, n), c_counts (dc, n), dc_list) as host arrays
    (column-sharded on device during compute; gathered at the end for
    assembly parity with ops/dia.dia_to_coo).
    """
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    dc_list, idx_map = _plan_maps(a.offsets, b.offsets)
    hl = max(0, -min(a.offsets))
    hr = max(0, max(a.offsets))
    n = a.shape[0]
    n_k = b.bands.shape[1]
    l = -(-max(n, n_k) // n_dev)
    pad_n = n_dev * l

    ab = jnp.pad(a.bands, ((0, 0), (0, pad_n - a.bands.shape[1])))
    bb = jnp.pad(b.bands, ((0, 0), (0, pad_n - n_k)))
    # halos wider than a block would need multi-hop exchange; the DIA
    # dispatch caps the band census far below that regime
    assert hl <= l and hr <= l, (hl, hr, l)

    fn = partial(_local_dia, offs_a=a.offsets, idx_map=idx_map,
                 dc_count=len(dc_list), hl=hl, hr=hr)
    shard_fn = jax.shard_map(fn, mesh=mesh,
                             in_specs=(P(None, AXIS), P(None, AXIS)),
                             out_specs=(P(None, AXIS), P(None, AXIS)))
    c, cnt = jax.jit(shard_fn)(ab, bb)
    return (np.asarray(c)[:, :n], np.asarray(cnt)[:, :n], dc_list)
