"""Plain CSR SpGEMM oracle path (BASELINE.json config 1) vs scipy."""

import numpy as np
import pytest

from conftest import random_sparse
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.ops.csr import csr_spgemm


@pytest.mark.parametrize("n,density,seed", [
    (50, 0.1, 0), (300, 0.01, 1), (128, 0.05, 2),
])
def test_csr_squared(n, density, seed):
    m = random_sparse(n, n, density, seed)
    got = csr_spgemm(COOMatrix.from_scipy(m),
                     COOMatrix.from_scipy(m)).to_scipy().tocsr()
    want = (m @ m).tocsr()
    want.sum_duplicates()
    assert got.nnz == want.nnz
    assert (got.indices == want.indices).all()
    np.testing.assert_allclose(got.data, want.data, rtol=1e-4, atol=1e-5)


def test_csr_rectangular():
    a = random_sparse(40, 90, 0.05, 3)
    b = random_sparse(90, 25, 0.08, 4)
    got = csr_spgemm(COOMatrix.from_scipy(a),
                     COOMatrix.from_scipy(b)).to_scipy().toarray()
    np.testing.assert_allclose(got, (a @ b).toarray(), rtol=1e-4, atol=1e-5)


def test_csr_empty_product():
    a = COOMatrix(np.array([0]), np.array([5]), np.array([1.0]), (8, 8))
    b = COOMatrix(np.array([0]), np.array([5]), np.array([1.0]), (8, 8))
    got = csr_spgemm(a, b)
    assert got.nnz == 0


def test_csr_matches_tiled_pipeline():
    from pem_spgemm.config import SpGEMMConfig
    from pem_spgemm.ops.convert import coo_to_tiled
    from pem_spgemm.ops.spgemm import SpGEMM
    m = random_sparse(200, 200, 0.02, 7)
    coo = COOMatrix.from_scipy(m)
    oracle = csr_spgemm(coo, coo).to_scipy().tocsr()
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo, dtype=np.float32, with_tmasks=True)
    tiled = SpGEMM(SpGEMMConfig(numeric_chunk=1 << 10))(a, b)
    got = tiled.to_coo().to_scipy().tocsr()
    assert tiled.c_nnz == oracle.nnz
    np.testing.assert_allclose(got.data, oracle.data, rtol=1e-4, atol=1e-5)
