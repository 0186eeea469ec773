"""Binned element engine (ops/binned.py): exactness vs scipy."""

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import random_sparse
from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.models.synthetic import power_law
from pem_spgemm.ops.convert import coo_to_tiled
from pem_spgemm.ops.spgemm import SpGEMM
from pem_spgemm.ops import binned


def _check(coo, b_coo=None, **plan_kw):
    a = coo_to_tiled(coo, dtype=np.float32)
    b = a if b_coo is None else coo_to_tiled(b_coo, dtype=np.float32)
    sa = coo.to_scipy().tocsr()
    sb = sa if b_coo is None else b_coo.to_scipy().tocsr()
    want = (sa @ sb).tocoo()
    want.sum_duplicates()
    plan = binned.build_plan(a, b, **plan_kw)
    stream = binned.binned_multiply(plan)
    stream.c_nnz = int(stream.c_nnz)
    assert stream.c_nnz == want.nnz, (stream.c_nnz, want.nnz)
    rows, cols, vals = stream.to_coo_arrays()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(rows, want.row[order])
    np.testing.assert_array_equal(cols, want.col[order])
    np.testing.assert_allclose(vals, want.data[order], rtol=1e-5, atol=1e-6)
    return plan


def test_binned_power_law():
    coo = power_law(n=3000, nnz=9000, seed=3, hub_correlation=0.1)
    _check(coo)


def test_binned_uniform():
    m = random_sparse(900, 900, 0.003, seed=7)
    _check(COOMatrix.from_scipy(m))


def test_binned_rectangular():
    a = COOMatrix.from_scipy(random_sparse(300, 500, 0.01, seed=1))
    b = COOMatrix.from_scipy(random_sparse(500, 200, 0.01, seed=2))
    _check(a, b)


def test_binned_residual_path():
    # tiny max_chunks forces most rows through the residual stream
    coo = power_law(n=2000, nnz=8000, seed=5, hub_correlation=0.2)
    plan = _check(coo, max_chunks=2)
    assert plan.n_res_chunks > 0, "expected residual rows at max_chunks=2"


def test_binned_cancellation_keeps_structure():
    # +1 and -1 products on the same (i, j): value 0.0 but structurally
    # present (exact-structure semantics, like the reference)
    rows = np.array([0, 0, 1, 2], np.int32)
    cols = np.array([1, 2, 3, 3], np.int32)
    vals = np.array([1.0, 1.0, 1.0, -1.0], np.float32)
    coo = COOMatrix(rows, cols, vals, (4, 4))
    a = coo_to_tiled(coo, dtype=np.float32)
    plan = binned.build_plan(a, a)
    stream = binned.binned_multiply(plan)
    stream.c_nnz = int(stream.c_nnz)
    # structural nnz = nnz of the boolean product (scipy may prune the
    # cancelled zero, so compare against the pattern product)
    m = coo.to_scipy().toarray()
    want_nnz = int((((m != 0).astype(int) @ (m != 0).astype(int)) != 0).sum())
    assert stream.c_nnz == want_nnz
    r, c, v = stream.to_coo_arrays()
    # C[0,3] = 1*1 + 1*(-1) = 0.0, structurally present
    i = np.nonzero((r == 0) & (c == 3))[0]
    assert len(i) == 1 and v[i[0]] == 0.0


def test_binned_through_spgemm_api():
    coo = power_law(n=4000, nnz=14000, seed=11, hub_correlation=0.15)
    cfg = SpGEMMConfig(engine="element")
    a = coo_to_tiled(coo, dtype=np.float32)
    r = SpGEMM(cfg)(a, a)
    assert r.binned is not None, "f32 element path must use the binned impl"
    s = coo.to_scipy().tocsr()
    want = (s @ s).tocoo()
    want.sum_duplicates()
    assert r.c_nnz == want.nnz
    got = r.to_coo().to_scipy()
    np.testing.assert_allclose(got.toarray(), want.toarray(),
                               rtol=1e-5, atol=1e-6)


def test_binned_empty_b_rows():
    # A columns referencing empty B rows produce nothing
    a = COOMatrix(np.array([0, 1], np.int32), np.array([10, 11], np.int32),
                  np.array([2.0, 3.0], np.float32), (32, 32))
    b = COOMatrix(np.array([10], np.int32), np.array([5], np.int32),
                  np.array([4.0], np.float32), (32, 32))
    ta = coo_to_tiled(a, dtype=np.float32)
    tb = coo_to_tiled(b, dtype=np.float32)
    plan = binned.build_plan(ta, tb)
    assert plan.n_products == 1
    stream = binned.binned_multiply(plan)
    assert int(stream.c_nnz) == 1
    r, c, v = stream.to_coo_arrays()
    assert r[0] == 0 and c[0] == 5 and v[0] == 8.0


def test_device_plan_matches_host_plan():
    """build_plan_device must produce the same C as the host build_plan."""
    coo = power_law(n=3000, nnz=10000, seed=21, hub_correlation=0.2)
    a = coo_to_tiled(coo, dtype=np.float32)
    hp = binned.build_plan(a, a)
    dp = binned.build_plan_device(a, a)
    assert dp.n_products == hp.n_products
    hs = binned.binned_multiply(hp)
    ds = binned.binned_multiply(dp)
    hs.c_nnz = int(hs.c_nnz)
    ds.c_nnz = int(ds.c_nnz)
    assert ds.c_nnz == hs.c_nnz
    hr, hc, hv = hs.to_coo_arrays()
    dr, dc, dv = ds.to_coo_arrays()
    np.testing.assert_array_equal(dr, hr)
    np.testing.assert_array_equal(dc, hc)
    # duplicate groups sum in different member order on the two paths
    # (the device plan pre-sorts packed segments with value-bit
    # payloads): fp-tolerant, not bit-equal
    np.testing.assert_allclose(dv, hv, rtol=1e-5, atol=1e-6)


def test_device_plan_residual():
    coo = power_law(n=2000, nnz=8000, seed=5, hub_correlation=0.2)
    a = coo_to_tiled(coo, dtype=np.float32)
    dp = binned.build_plan_device(a, a, max_chunks=2)
    assert dp.n_res_chunks > 0
    ds = binned.binned_multiply(dp)
    ds.c_nnz = int(ds.c_nnz)
    s = coo.to_scipy().tocsr()
    want = (s @ s).tocoo()
    want.sum_duplicates()
    assert ds.c_nnz == want.nnz
    r, c, v = ds.to_coo_arrays()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(r, want.row[order])
    np.testing.assert_allclose(v, want.data[order], rtol=1e-5, atol=1e-6)


def test_dup_free_split_exact():
    # the plan must route duplicate-free products to the sort-free
    # streams (fine routed tables / coarse chunk-flat remainder) and
    # keep truly-colliding chunks on narrow sort sub-buckets, staying
    # exact on a hub-heavy matrix where both paths carry real rows
    coo = power_law(n=3000, nnz=15000, seed=9, hub_correlation=0.3)
    a = coo_to_tiled(coo, dtype=np.float32)
    plan = binned.build_plan_device(a, a)
    assert plan.fine or plan.coarse is not None, \
        "no dup-free stream (fine/coarse) was split out"
    assert plan.packed, \
        "no packed collision class survived (test matrix too easy)"
    assert all(p.rounds >= 1 for p in plan.packed)
    stream = binned.binned_multiply(plan)
    stream.c_nnz = int(stream.c_nnz)
    s = coo.to_scipy().tocsr()
    want = (s @ s).tocoo()
    want.sum_duplicates()
    assert stream.c_nnz == want.nnz
    r, c, v = stream.to_coo_arrays()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(r, want.row[order])
    np.testing.assert_array_equal(c, want.col[order])
    np.testing.assert_allclose(v, want.data[order], rtol=1e-5, atol=1e-6)


def test_window_singles_path_exact():
    # rows with ONE A element hitting long B rows (m >= WIN_MIN_M chunks)
    # route through the element-window stream (plan.win); exactness vs
    # scipy incl. rows straddling multiple windows and short-tail windows
    import scipy.sparse as sp
    from pem_spgemm.formats.coo import COOMatrix
    from pem_spgemm.ops.convert import coo_to_tiled

    rs = np.random.default_rng(21)
    n = 4000
    rows_l, cols_l = [], []
    # a few hub B rows of assorted lengths (incl. exactly WIN and WIN+1)
    for hub, ln in [(7, 500), (11, 128), (13, 129), (17, 1000), (23, 37)]:
        rows_l.append(np.full(ln, hub))
        cols_l.append(rs.choice(n, ln, replace=False))
    # single-element A rows pointing at the hubs
    for i, hub in zip(range(100, 400), [7, 11, 13, 17, 23] * 60):
        rows_l.append([i])
        cols_l.append([hub])
    rows = np.concatenate(rows_l).astype(np.int64)
    cols = np.concatenate([np.asarray(c) for c in cols_l]).astype(np.int64)
    m = sp.coo_matrix((rs.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, n))
    m.sum_duplicates()
    coo = COOMatrix.from_scipy(m)
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo, dtype=np.float32, with_tmasks=True)
    plan = binned.build_plan_device(a, b)
    assert plan.win is not None          # the path actually engaged
    stream = binned.binned_multiply(plan)
    want = (m.tocsr() @ m.tocsr())
    assert int(stream.c_nnz) == want.nnz
    r, c, v = stream.to_coo_arrays()
    wc = want.tocoo()
    wc.sum_duplicates()
    order = np.lexsort((wc.col, wc.row))
    np.testing.assert_array_equal(r, wc.row[order])
    np.testing.assert_array_equal(c, wc.col[order])
    np.testing.assert_allclose(v, wc.data[order].astype(np.float32),
                               rtol=1e-5, atol=1e-6)


def test_packed_collision_exact():
    # the packed collision classes (plan-materialized element-exact
    # sort segments) must reproduce the chunk-granular sort path's
    # result exactly (same C structure, fp-tolerant values)
    coo = power_law(n=3000, nnz=18000, seed=21, hub_correlation=0.35)
    a = coo_to_tiled(coo, dtype=np.float32)
    p1 = binned.build_plan_device(a, a)
    p0 = binned.build_plan_device(a, a, pack=False)
    assert p1.packed, "packing produced no classes"
    assert not [b for b in p1.buckets if not b.single]
    s = coo.to_scipy().tocsr()
    want = (s @ s).tocoo()
    want.sum_duplicates()
    for plan in (p0, p1):
        st = binned.binned_multiply(plan)
        st.c_nnz = int(st.c_nnz)
        assert st.c_nnz == want.nnz
        r, c, v = st.to_coo_arrays()
        order = np.lexsort((want.col, want.row))
        np.testing.assert_array_equal(r, want.row[order])
        np.testing.assert_array_equal(c, want.col[order])
        np.testing.assert_allclose(v, want.data[order], rtol=1e-5,
                                   atol=1e-6)
