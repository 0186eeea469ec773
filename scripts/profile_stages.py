"""Pipelined per-stage profile of the binned hypersparse engine.

Usage: python scripts/profile_stages.py [rmat|powerlaw|uniform] [reps]

Times each stage of the binned multiply on the GPU with the PIPELINED
protocol (queue `reps` dispatch sets back-to-back, ONE final sync,
wall/reps), so the per-call host sync does not floor small stages.
Stages:

  takes      table[src] row gathers + reshape + aval multiply (sort path)
  +sort      takes + the batched per-segment lax.sort
  full-sort  takes + sort + dedup scan + count (bucket_multiply)
  singles    the flat sort-free dispatch (all single buckets)
  window     the consec-singles aligned window stream
  residual   the flat residual sort
  fused      the whole production multiply (one jit)

Each stage's cost is the SUM across its buckets, measured in one
pipelined batch.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "powerlaw"
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    import jax
    import jax.numpy as jnp
    from pem_spgemm.utils.runtime import enable_compile_cache, require_gpu
    print("devices:", require_gpu())
    enable_compile_cache()

    from functools import partial
    from jax import lax
    from pem_spgemm.models import synthetic
    from pem_spgemm.ops.convert import coo_to_tiled
    from pem_spgemm.ops import binned

    if which == "rmat":
        coo = synthetic.rmat(scale=16, edge_factor=8, seed=7)
    elif which == "powerlaw":
        coo = synthetic.power_law(n=1_000_000, nnz=3_000_000, seed=42,
                                  hub_correlation=0.1)
    else:
        coo = synthetic.uniform_random(n_rows=1_000_000, n_cols=1_000_000,
                                       nnz=4_000_000, seed=3)
    print(f"{which}: shape={coo.shape} nnz={coo.nnz}")
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo, dtype=np.float32)
    plan = binned.build_plan_device(a, b)
    print(f"w={plan.w} products={plan.n_products}")

    @partial(jax.jit, static_argnames=("m", "w"))
    def take_only(table, src, avals, m, w):
        r = src.shape[0]
        raw = table[src]
        cols = raw[:, :, :w].reshape(r, m * w)
        bvals = lax.bitcast_convert_type(raw[:, :, w:],
                                         jnp.float32).reshape(r, m * w)
        vals = bvals * jnp.repeat(avals, w, axis=1)
        return cols, vals

    @partial(jax.jit, static_argnames=("m", "w"))
    def take_sort(table, src, avals, m, w):
        cols, vals = take_only(table, src, avals, m, w)
        return lax.sort((cols, vals), num_keys=1, dimension=1)

    sort_b = [bk for bk in plan.buckets if not bk.single]
    single_b = [bk for bk in plan.buckets if bk.single]
    tbl = plan.table

    def pipe(label, fn_once, n=reps):
        out = fn_once()           # warm/compile
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn_once()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / n * 1e3
        print(f"{label:>42}: {dt:8.2f} ms", flush=True)
        return dt

    if sort_b:
        pipe(f"takes (sort path, {len(sort_b)} buckets)",
             lambda: [take_only(tbl, bk.src, bk.avals, bk.m, plan.w)
                      for bk in sort_b][-1])
        pipe("takes+sort (sort path)",
             lambda: [take_sort(tbl, bk.src, bk.avals, bk.m, plan.w)
                      for bk in sort_b][-1])
        pipe("full sort buckets (take+sort+dedup)",
             lambda: [binned.bucket_multiply(tbl, bk.src, bk.avals, bk.m,
                                             plan.w, bk.rounds)
                      for bk in sort_b][-1])
    if single_b:
        pipe(f"singles flat ({len(single_b)} buckets)",
             lambda: binned.singles_multiply_flat(
                 tbl,
                 tuple(bk.src for bk in single_b),
                 tuple(bk.avals for bk in single_b),
                 tuple(bk.seg_rows for bk in single_b),
                 tuple(bk.m for bk in single_b), plan.w))
    if plan.win is not None:
        pipe(f"window stream ({plan.win[0].shape[0]} windows)",
             lambda: binned.singles_window_multiply(
                 plan.wintab, *plan.win))
    pipe(f"residual ({plan.res_src.shape[0]} chunks)",
         lambda: binned.residual_multiply(tbl, plan.res_src,
                                          plan.res_avals, plan.res_rows,
                                          plan.w))
    pipe("FUSED whole multiply",
         lambda: binned.binned_multiply(plan).c_nnz)


if __name__ == "__main__":
    main()
