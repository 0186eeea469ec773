"""Fixed-capacity single-dispatch pipeline: parity with the interactive one."""

import numpy as np

import jax

from conftest import random_sparse
from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.ops.convert import coo_to_tiled
from pem_spgemm.ops.fixed import make_plan
from pem_spgemm.ops.spgemm import SpGEMM


def test_planned_matches_interactive():
    m = random_sparse(500, 500, 0.01, seed=4)
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo, dtype=np.float32)
    cfg = SpGEMMConfig(numeric_chunk=1 << 10, engine="fused")
    res = SpGEMM(cfg)(a, b)
    plan = make_plan(res, cfg, a, b)
    out = plan.run(a, b)
    jax.block_until_ready(out)
    (c_tile_row, c_tile_col, cmask, cptr, c_rowcol, c_elem_tile, c_vals,
     c_nnz, overflow) = out
    assert int(c_nnz) == res.c_nnz
    assert not bool(overflow)
    n = res.c_nnz
    assert (np.asarray(cmask) == np.asarray(res.cmask)).all()
    assert (np.asarray(c_rowcol)[:n] == np.asarray(res.rowcol)[:n]).all()
    np.testing.assert_allclose(np.asarray(c_vals)[:n],
                               np.asarray(res.vals)[:n], rtol=1e-6)


def test_plan_overflow_flag_and_regrow():
    """An undersized plan must TRIP the overflow flag, and grown() plans
    must converge to a correct run (the silent-truncation guard)."""
    import dataclasses
    m = random_sparse(400, 400, 0.01, seed=11)
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, dtype=np.float32)
    cfg = SpGEMMConfig(numeric_chunk=1 << 10, engine="fused")
    res = SpGEMM(cfg)(a, a)
    plan = make_plan(res, cfg, a, a)
    small = dataclasses.replace(plan, p_cap=1 << 10,
                                c_cap=max(256, plan.c_cap // 4),
                                c_nnz_cap=max(1024, plan.c_nnz_cap // 4))
    out = small.run(a, a)
    assert bool(out[-1]), "undersized plan must report overflow"
    grown = small
    for _ in range(8):
        out = grown.run(a, a)
        if not bool(out[-1]):
            break
        grown = grown.grown()
    assert not bool(out[-1])
    assert int(out[-2]) == res.c_nnz


def test_planned_element_matches_scipy():
    # legacy merge-sort element engine (the f64-parity implementation)
    m = random_sparse(700, 700, 0.002, seed=9)   # hypersparse -> element
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo, dtype=np.float32)
    cfg = SpGEMMConfig(numeric_chunk=1 << 10, engine="element",
                       element_impl="merge")
    res = SpGEMM(cfg)(a, b)
    plan = make_plan(res, cfg, a, b)
    rows, cols, vals, first, c_nnz, overflow = plan.run(a, b)
    jax.block_until_ready(vals)
    assert int(c_nnz) == res.c_nnz
    assert not bool(overflow)
    want = (m @ m).tocoo()
    want.sum_duplicates()
    n = int(c_nnz)
    assert want.nnz == n
    # untimed assembly: compact the flagged group stream
    from pem_spgemm.ops.element import compact_stream
    rows, cols, vals = compact_stream(rows, cols, vals, first)
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(np.asarray(rows)[:n], want.row[order])
    np.testing.assert_array_equal(np.asarray(cols)[:n], want.col[order])
    np.testing.assert_allclose(np.asarray(vals)[:n], want.data[order],
                               rtol=1e-5, atol=1e-6)


def test_planned_element_wide_keeps_f64():
    # ADVICE round 2 (medium): an f64 ElementPlan must not silently route
    # values through the f32 bit-packed merge pipeline.  The wide fixed
    # step keeps native-dtype accumulation; values must match an f64
    # scipy oracle tighter than f32 could.
    m = random_sparse(500, 500, 0.003, seed=11, dtype=np.float64)
    # scale values so f32 rounding is visible
    m.data = m.data * 1e8 + 1.0
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, dtype=np.float64)
    b = coo_to_tiled(coo, dtype=np.float64)
    cfg = SpGEMMConfig(numeric_chunk=1 << 10, engine="element",
                       element_impl="merge", dtype=np.float64)
    res = SpGEMM(cfg)(a, b)
    plan = make_plan(res, cfg, a, b)
    assert plan.wide
    rows, cols, vals, first, c_nnz, overflow = plan.run(a, b)
    jax.block_until_ready(vals)
    assert int(c_nnz) == res.c_nnz
    assert not bool(overflow)
    assert vals.dtype == np.float64 if jax.config.jax_enable_x64 \
        else vals.dtype != np.float16   # dtype preserved modulo x64 mode
    want = (m @ m).tocoo()
    want.sum_duplicates()
    n = int(c_nnz)
    assert want.nnz == n
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(np.asarray(rows)[:n], want.row[order])
    np.testing.assert_array_equal(np.asarray(cols)[:n], want.col[order])
    # x64 off in-process: still f32-tight; the true f64 parity is measured
    # by tests/test_f64.py in an x64 subprocess
    np.testing.assert_allclose(np.asarray(vals)[:n], want.data[order],
                               rtol=1e-5)


def test_scanops():
    import jax.numpy as jnp
    from pem_spgemm.ops import scanops
    offsets = jnp.array([0, 3, 3, 5, 9], jnp.int32)  # one empty segment
    ids = np.asarray(scanops.segment_ids_from_offsets(offsets, 12))
    assert ids[:9].tolist() == [0, 0, 0, 2, 2, 3, 3, 3, 3]
    # packed key order == lexicographic order
    rs = np.random.default_rng(0)
    hi = rs.integers(0, 1 << 16, 1000).astype(np.int32)
    lo = rs.integers(0, 1 << 16, 1000).astype(np.int32)
    keys = np.asarray(scanops.pack_key(jnp.asarray(hi), jnp.asarray(lo)))
    order = np.argsort(keys, kind="stable")
    lex = np.lexsort((lo, hi))
    assert (hi[order] == hi[lex]).all() and (lo[order] == lo[lex]).all()
    h2, l2 = scanops.unpack_key(jnp.asarray(keys))
    assert (np.asarray(h2) == hi).all() and (np.asarray(l2) == lo).all()
