"""Macro128 engine: exact structure + values vs scipy, plan parity."""

import numpy as np
import jax.numpy as jnp

from conftest import random_sparse
from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.models.synthetic import banded
from pem_spgemm.ops.convert import coo_to_tiled, coo_to_macro
from pem_spgemm.ops.fixed import make_plan, MacroPlan
from pem_spgemm.ops.macro import macro_structure, assemble_macro_coo
from pem_spgemm.ops.spgemm import SpGEMM


def _check_macro(coo, cfg):
    s = coo.to_scipy().tocsr()
    a = coo_to_tiled(coo, dtype=np.float32)
    res = SpGEMM(cfg)(a, a)
    assert res.engine == "macro"
    want = (s @ s).tocoo()
    want.sum_duplicates()
    assert res.c_nnz == want.nnz, (res.c_nnz, want.nnz)
    got = res.to_coo()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(got.rows, want.row[order])
    np.testing.assert_array_equal(got.cols, want.col[order])
    np.testing.assert_allclose(got.vals, want.data[order],
                               rtol=1e-4, atol=1e-4)
    return a, res


def test_macro_banded_matches_scipy():
    coo = banded(n=1500, bands=(0, 1, -1, 2, -2, 40, -40), seed=1)
    _check_macro(coo, SpGEMMConfig(engine="macro", macro_chunk=32))


def test_macro_dense_blocks():
    # block-dense: a few fully dense 128x128 blocks
    rs = np.random.default_rng(0)
    blocks = [(0, 0), (0, 1), (1, 1), (2, 0), (2, 2)]
    rows_l, cols_l, vals_l = [], [], []
    for (br, bc) in blocks:
        r, c = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
        rows_l.append((br * 128 + r).ravel())
        cols_l.append((bc * 128 + c).ravel())
        vals_l.append(rs.standard_normal(128 * 128))
    coo = COOMatrix(np.concatenate(rows_l).astype(np.int32),
                    np.concatenate(cols_l).astype(np.int32),
                    np.concatenate(vals_l), (384, 384)).sum_duplicates()
    _check_macro(coo, SpGEMMConfig(engine="macro", macro_chunk=32))


def test_macro_auto_dispatch():
    dense_band = banded(n=1024, bands=tuple(range(-12, 13)), seed=2)
    a = coo_to_tiled(dense_band, dtype=np.float32)
    eng = SpGEMM(SpGEMMConfig(macro_threshold=512)).pick_engine(a, a)
    assert eng == "macro", a.macro_stats()
    sparse = COOMatrix.from_scipy(random_sparse(2000, 2000, 0.001, seed=3))
    b = coo_to_tiled(sparse, dtype=np.float32)
    assert SpGEMM(SpGEMMConfig()).pick_engine(b, b) == "element"


def test_macro_plan_matches_interactive():
    coo = banded(n=1200, bands=(0, 3, -3, 64, -64), seed=4)
    cfg = SpGEMMConfig(engine="macro", macro_chunk=32)
    a, res = _check_macro(coo, cfg)
    plan = make_plan(res, cfg, a, a)
    assert isinstance(plan, MacroPlan)
    (c_tile_row, c_tile_col, c_dense, c_counts, cptr, c_nnz,
     overflow) = plan.run(a, a)
    assert int(c_nnz) == res.c_nnz
    assert not bool(overflow)
    rows, cols, vals = assemble_macro_coo(c_tile_row, c_tile_col, c_dense,
                                          c_counts, c_nnz)
    ref = res.to_coo()
    np.testing.assert_array_equal(rows, ref.rows)
    np.testing.assert_allclose(vals, ref.vals, rtol=1e-5, atol=1e-5)


def test_macro_conversion_roundtrip():
    coo = banded(n=700, bands=(0, 5, -9), seed=5)
    m = coo_to_macro(coo, dtype=np.float32)
    dense = np.zeros(coo.shape, np.float32)
    d = np.asarray(m.dense)
    tr = np.asarray(m.tile_row)[:m.ntiles]
    tc = np.asarray(m.tile_col)[:m.ntiles]
    for t in range(m.ntiles):
        r0, c0 = tr[t] * 128, tc[t] * 128
        h = min(128, coo.shape[0] - r0)
        w = min(128, coo.shape[1] - c0)
        dense[r0:r0 + h, c0:c0 + w] = d[t][:h, :w]
    np.testing.assert_allclose(dense, coo.to_scipy().toarray(), rtol=1e-6)
