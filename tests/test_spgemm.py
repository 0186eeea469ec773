"""End-to-end tiled SpGEMM vs scipy: exact C_nnz, values to float tolerance."""

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import random_sparse
from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.ops.convert import coo_to_tiled
from pem_spgemm.ops.spgemm import SpGEMM

CFG = SpGEMMConfig(numeric_chunk=1 << 10)


def run_square(m, cfg=CFG):
    a = coo_to_tiled(COOMatrix.from_scipy(m), dtype=cfg.dtype)
    b = coo_to_tiled(COOMatrix.from_scipy(m), dtype=cfg.dtype,
                     with_tmasks=True)
    return SpGEMM(cfg)(a, b)


def check_against_scipy(result, want):
    """want: scipy sparse (float64). Exact structure, tolerant values."""
    want = want.tocsr()
    want.sum_duplicates()
    # scipy keeps explicit zeros from numeric cancellation out only with
    # eliminate_zeros; structural nnz comparison must keep them.
    got = result.to_coo().to_scipy().tocsr()
    assert result.c_nnz == want.nnz, (result.c_nnz, want.nnz)
    assert (got.indptr == want.indptr).all()
    assert (got.indices == want.indices).all()
    np.testing.assert_allclose(got.data, want.data, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,density,seed", [
    (64, 0.05, 0), (256, 0.02, 1), (1000, 0.003, 2), (333, 0.01, 3),
])
def test_a_squared(n, density, seed):
    m = random_sparse(n, n, density, seed)
    check_against_scipy(run_square(m), m @ m)


def test_a_at():
    m = random_sparse(300, 120, 0.02, seed=5)  # rectangular: A@A.T mode
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo.transpose(), dtype=np.float32, with_tmasks=True)
    result = SpGEMM(CFG)(a, b)
    check_against_scipy(result, m @ m.T)


def test_banded_matrix():
    # Diagonal-ish structure: many single-entry tiles.
    n = 500
    diags = sp.diags([np.arange(1, n + 1), np.ones(n - 2), 2 * np.ones(n - 7)],
                     [0, 2, 7], shape=(n, n), format="coo")
    check_against_scipy(run_square(diags), diags @ diags)


def test_dense_block():
    # One fully dense 32x32 corner inside a sparse matrix.
    rs = np.random.default_rng(8)
    dense = np.zeros((100, 100))
    dense[:32, :32] = rs.standard_normal((32, 32))
    dense[60, 90] = 3.0
    m = sp.coo_matrix(dense)
    check_against_scipy(run_square(m), m @ m)


def test_structural_vs_numeric_zeros():
    # Numeric cancellation must NOT reduce structural C_nnz.
    a = sp.coo_matrix(np.array([[1.0, -1.0], [0.0, 0.0]]))
    want_nnz = 1  # C[0,0] = 1*1 + (-1)*0 ... compute explicitly below
    m = np.array([[1.0, -1.0], [1.0, 0.0]])
    a = sp.coo_matrix(m)
    result = run_square(a)
    # structural product has nnz of boolean product
    bool_nnz = int(((m != 0).astype(int) @ (m != 0).astype(int) != 0).sum())
    assert result.c_nnz == bool_nnz
    got = result.to_coo().to_scipy().toarray()
    np.testing.assert_allclose(got, m @ m, atol=1e-6)
    del want_nnz


def test_engines_agree():
    # fused (0/1-matmul structure) and masks (bit-plane) engines must
    # produce identical structure and values
    m = random_sparse(400, 400, 0.01, seed=21)
    r_fused = run_square(m, CFG.with_(engine="fused"))
    r_masks = run_square(m, CFG.with_(engine="masks"))
    assert r_fused.c_nnz == r_masks.c_nnz
    assert (np.asarray(r_fused.cmask) == np.asarray(r_masks.cmask)).all()
    a = r_fused.to_coo().to_scipy().tocsr()
    b = r_masks.to_coo().to_scipy().tocsr()
    assert (a.indices == b.indices).all()
    np.testing.assert_allclose(a.data, b.data, rtol=1e-5, atol=1e-6)
    check_against_scipy(r_fused, m @ m)


def test_element_engine():
    m = random_sparse(700, 700, 0.002, seed=33)  # hypersparse
    r = run_square(m, CFG.with_(engine="element"))
    assert r.engine == "element"
    check_against_scipy(r, m @ m)


def test_auto_dispatch():
    from pem_spgemm.ops.spgemm import SpGEMM
    from pem_spgemm.formats.coo import COOMatrix
    from pem_spgemm.ops.convert import coo_to_tiled
    eng = SpGEMM(CFG.with_(engine="auto"))
    from pem_spgemm.models.synthetic import banded
    sparse = random_sparse(700, 700, 0.002, seed=1)   # ~1 nnz/tile
    dense = random_sparse(100, 100, 0.3, seed=1)      # 1 macro tile, 3k nnz
    mid = banded(n=2000, bands=(0, 1, -1), seed=1)    # fill16 ~24, fill_m<512
    ts = coo_to_tiled(COOMatrix.from_scipy(sparse))
    td = coo_to_tiled(COOMatrix.from_scipy(dense))
    tm = coo_to_tiled(mid)
    assert eng.pick_engine(ts, ts) == "element"
    assert eng.pick_engine(td, td) == "macro"
    # the fused tier is explicit opt-in (measured 17x slower than the
    # element engine at mid fill, see config.element_threshold)
    assert eng.pick_engine(tm, tm) == "element"
    eng2 = SpGEMM(SpGEMMConfig(element_threshold=6.0))
    assert eng2.pick_engine(tm, tm) == "fused"
    r = eng(td, td)
    check_against_scipy(r, dense @ dense)
