"""Edge cases across engines: rectangular A@A.T, empty products,
sentinel-adjacent sizes, macro conversion guards."""

import numpy as np
import pytest
import jax.numpy as jnp

from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.models.synthetic import banded
from pem_spgemm.ops.convert import coo_to_tiled, coo_to_macro
from pem_spgemm.ops.spgemm import SpGEMM


def _coo(rows, cols, vals, shape):
    return COOMatrix(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                     np.asarray(vals, np.float64), shape)


@pytest.mark.parametrize("engine", ["fused", "element", "macro"])
def test_rectangular_aat(engine):
    rs = np.random.default_rng(5)
    nr, nc, nnz = 300, 700, 4000
    coo = _coo(rs.integers(0, nr, nnz), rs.integers(0, nc, nnz),
               rs.standard_normal(nnz), (nr, nc)).sum_duplicates()
    s = coo.to_scipy().tocsr()
    want = (s @ s.T).tocoo()
    want.sum_duplicates()
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo.transpose(), dtype=np.float32, with_tmasks=True)
    cfg = SpGEMMConfig(numeric_chunk=1 << 10, macro_chunk=16, engine=engine)
    r = SpGEMM(cfg)(a, b)
    assert r.c_nnz == want.nnz, (engine, r.c_nnz, want.nnz)
    got = r.to_coo().to_scipy()
    np.testing.assert_allclose(got.toarray(), want.toarray(),
                               rtol=1e-4, atol=1e-4)


def test_structurally_empty_product():
    # A's columns never hit an occupied B row: the reference emits an empty
    # C and still reports (spgemm.cu:1133-1357) — must not raise.
    a = _coo([0, 1], [40, 41], [1.0, 2.0], (64, 64))
    b = _coo([0, 1], [3, 4], [1.0, 2.0], (64, 64))
    ta = coo_to_tiled(a, dtype=np.float32)
    tb = coo_to_tiled(b, dtype=np.float32)
    for eng in ("fused", "element"):
        r = SpGEMM(SpGEMMConfig(engine=eng))(ta, tb)
        assert r.c_nnz == 0 and r.n_pairs == 0
        got = r.to_coo()
        assert got.nnz == 0 and got.shape == (64, 64)


def test_single_element_matrix():
    coo = _coo([5], [7], [3.0], (16, 16))
    t = coo_to_tiled(coo, dtype=np.float32)
    # tile-level pair exists but the element product is empty: exact nnz 0
    r0 = SpGEMM(SpGEMMConfig(engine="fused"))(t, t)
    assert r0.c_nnz == 0
    # the element engine counts products directly -> structurally empty
    r1 = SpGEMM(SpGEMMConfig(engine="element"))(t, t)
    assert r1.c_nnz == 0 and r1.to_coo().nnz == 0
    coo2 = _coo([7], [7], [3.0], (16, 16))
    t2 = coo_to_tiled(coo2, dtype=np.float32)
    r = SpGEMM(SpGEMMConfig(engine="fused"))(t2, t2)
    assert r.c_nnz == 1
    got = r.to_coo()
    assert got.rows[0] == 7 and got.cols[0] == 7
    np.testing.assert_allclose(got.vals[0], 9.0, rtol=1e-6)


def test_identity_macro():
    n = 256
    coo = _coo(np.arange(n), np.arange(n), np.ones(n), (n, n))
    m = coo_to_macro(coo, dtype=np.float32)
    r = SpGEMM(SpGEMMConfig(engine="macro", macro_chunk=16))(m, m)
    assert r.c_nnz == n
    got = r.to_coo().to_scipy().toarray()
    np.testing.assert_allclose(got, np.eye(n), rtol=1e-6)


def test_non_multiple_of_tile_shapes():
    # n not a multiple of 16 or 128: border tiles are partial
    coo = banded(n=333, bands=(0, 1, -1, 17, -17), seed=2)
    s = coo.to_scipy().tocsr()
    want = s @ s
    for engine in ("fused", "element", "macro"):
        if engine == "macro":
            op = coo_to_macro(coo, dtype=np.float32)
        else:
            op = coo_to_tiled(coo, dtype=np.float32)
        r = SpGEMM(SpGEMMConfig(numeric_chunk=1 << 10, macro_chunk=16,
                                engine=engine))(op, op)
        assert r.c_nnz == want.nnz, engine
        np.testing.assert_allclose(r.to_coo().to_scipy().toarray(),
                                   want.toarray(), rtol=1e-4, atol=1e-4)


def test_values_bf16_dtype():
    coo = banded(n=200, bands=(0, 1, -1), seed=3)
    t = coo_to_tiled(coo, dtype=jnp.bfloat16)
    r = SpGEMM(SpGEMMConfig(engine="fused", dtype=jnp.bfloat16,
                            acc_dtype=jnp.float32,
                            numeric_chunk=1 << 10))(t, t)
    s = coo.to_scipy().tocsr()
    assert r.c_nnz == (s @ s).nnz
    c = r.to_coo()
    dense = np.zeros(c.shape, np.float32)
    dense[c.rows, c.cols] = np.asarray(c.vals, np.float32)
    np.testing.assert_allclose(dense, (s @ s).toarray(), rtol=2e-2,
                               atol=1e-2)
