"""DIA engine: diagonal-band SpGEMM vs scipy oracles.

The DIA tier (formats/dia.py, ops/dia.py) replaces the reference's tiled
pipeline for banded structure (spgemm.cu:499-661) with shifted vector FMA
streams; these tests pin exact structural nnz, exact coordinates, and
value parity against scipy, plus the dispatch/fallback edges.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.ops.spgemm import SpGEMM
from pem_spgemm.ops.dia import (coo_to_dia, detect_dia, diag_offsets,
                                make_dia_plan, dia_to_coo)
from pem_spgemm.ops.fixed import make_plan


def _banded_coo(n, bands, seed=0, n_cols=None):
    rs = np.random.default_rng(seed)
    n_cols = n_cols or n
    rows_l, cols_l = [], []
    for d in bands:
        lo, hi = max(0, -d), min(n, n_cols - d)
        i = np.arange(lo, hi)
        rows_l.append(i)
        cols_l.append(i + d)
    rows = np.concatenate(rows_l).astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    vals = rs.standard_normal(len(rows))
    return COOMatrix(rows, cols, vals, (n, n_cols))


def _check_product(coo, b_coo=None, engine="dia"):
    b_coo = b_coo or coo
    a = coo_to_dia(coo, dtype=np.float32)
    b = a if b_coo is coo else coo_to_dia(b_coo, dtype=np.float32)
    assert a is not None and b is not None
    cfg = SpGEMMConfig(engine=engine)
    res = SpGEMM(cfg)(a, b)
    want = (coo.to_scipy() @ b_coo.to_scipy()).tocoo()
    want.sum_duplicates()
    assert res.c_nnz == want.nnz
    got = res.to_coo()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(got.rows, want.row[order])
    np.testing.assert_array_equal(got.cols, want.col[order])
    np.testing.assert_allclose(got.vals, want.data[order].astype(np.float32),
                               rtol=2e-5, atol=1e-5)
    return res, a, b, cfg


def test_round_trip():
    coo = _banded_coo(300, (-7, -1, 0, 2, 11))
    d = coo_to_dia(coo, dtype=np.float32)
    assert d.offsets == (-7, -1, 0, 2, 11)
    r, c, v = d.to_coo_numpy()
    order = np.lexsort((coo.cols, coo.rows))
    np.testing.assert_array_equal(r, coo.rows[order])
    np.testing.assert_array_equal(c, coo.cols[order])
    np.testing.assert_allclose(v, coo.vals[order].astype(np.float32),
                               rtol=1e-6)


def test_square_tridiagonal():
    _check_product(_banded_coo(257, (-1, 0, 1)))


def test_sparse_nonuniform_offsets():
    # pairbands-like: non-dense offset set
    _check_product(_banded_coo(400, (0, 1, 60, 61, -60, -61)))


def test_wide_dense_band():
    _check_product(_banded_coo(300, tuple(range(-9, 10))))


def test_asymmetric_offsets():
    _check_product(_banded_coo(200, (-3, 0, 5, 17)))


def test_a_times_b_different_offsets():
    a_coo = _banded_coo(256, (0, 1, 2), seed=1)
    b_coo = _banded_coo(256, (-5, 0, 9), seed=2)
    _check_product(a_coo, b_coo)


def test_rectangular_aat():
    # A (200x300) @ A.T (300x200): offsets differ per operand
    a_coo = _banded_coo(200, (0, 4, 50), n_cols=300, seed=3)
    b_coo = a_coo.transpose()
    a = coo_to_dia(a_coo, dtype=np.float32)
    b = coo_to_dia(b_coo, dtype=np.float32)
    res = SpGEMM(SpGEMMConfig())(a, b)
    want = (a_coo.to_scipy() @ b_coo.to_scipy()).tocoo()
    want.sum_duplicates()
    assert res.c_nnz == want.nnz
    got = res.to_coo()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(got.rows, want.row[order])
    np.testing.assert_array_equal(got.cols, want.col[order])
    np.testing.assert_allclose(got.vals, want.data[order].astype(np.float32),
                               rtol=2e-5, atol=1e-5)


def test_structural_nnz_survives_cancellation():
    # A values engineered so a C entry sums to exactly zero numerically;
    # structural counts must keep it (reference parity: presence algebra)
    n = 64
    rows = np.array([0, 0, 1, 2], np.int32)
    cols = np.array([1, 2, 3, 3], np.int32)
    vals = np.array([1.0, 1.0, 1.0, -1.0])
    coo = COOMatrix(rows, cols, vals, (n, n))
    a = coo_to_dia(coo, dtype=np.float32)
    res = SpGEMM(SpGEMMConfig())(a, a)
    # C[0,3] = 1*1 + 1*(-1) = 0 numerically but structurally present
    s = coo.to_scipy()
    pattern = ((s != 0).astype(np.int64) @ (s != 0).astype(np.int64))
    assert res.c_nnz == pattern.nnz
    nonzero = (s @ s).tocoo()
    nonzero.eliminate_zeros()
    assert pattern.nnz > nonzero.nnz  # cancellation actually happened


def test_detect_rejects_explicit_zero():
    coo = _banded_coo(100, (0, 1))
    coo.vals[3] = 0.0
    assert detect_dia(coo) is None


def test_detect_rejects_many_diagonals():
    rs = np.random.default_rng(5)
    n = 2000
    rows = rs.integers(0, n, 4000).astype(np.int32)
    cols = rs.integers(0, n, 4000).astype(np.int32)
    coo = COOMatrix(rows, cols, np.ones(4000), (n, n)).sum_duplicates()
    assert detect_dia(coo, max_bands=64) is None
    assert len(diag_offsets(coo)) > 64


def test_fixed_plan_replay_matches_interactive():
    coo = _banded_coo(333, (-2, 0, 3, 40))
    res, a, b, cfg = _check_product(coo)
    plan = make_plan(res, cfg, a, b)
    out = plan.run(a, b)
    assert int(out[2]) == res.c_nnz
    assert not bool(out[3])
    r, c, v = dia_to_coo(out[0], out[1], plan.dc_list, res.shape,
                         res.c_nnz)
    got = res.to_coo()
    np.testing.assert_array_equal(r, got.rows)
    np.testing.assert_allclose(v, got.vals, rtol=1e-6)


def test_harness_runs_dia_engine():
    from pem_spgemm.bench.harness import run_benchmark
    coo = _banded_coo(500, (0, 1, 30, 31))
    cfg = SpGEMMConfig(engine="dia", warmup=1, repeat=2)
    record, result = run_benchmark(coo, "dia-banded", cfg, verbose=False)
    assert result.engine == "dia"
    s = coo.to_scipy()
    want = (s @ s).tocoo()
    want.sum_duplicates()
    assert record.c_nnz == want.nnz
    got = result.to_coo()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_allclose(got.vals, want.data[order].astype(np.float32),
                               rtol=2e-5, atol=1e-5)


def test_harness_auto_detects_dia():
    from pem_spgemm.bench.harness import run_benchmark
    coo = _banded_coo(500, (-1, 0, 1))
    cfg = SpGEMMConfig(engine="auto", warmup=0, repeat=1)
    record, result = run_benchmark(coo, "dia-auto", cfg, verbose=False)
    assert result.engine == "dia"


def test_harness_auto_falls_back_for_scattered():
    from pem_spgemm.bench.harness import run_benchmark
    rs = np.random.default_rng(6)
    n = 600
    rows = rs.integers(0, n, 1200).astype(np.int32)
    cols = rs.integers(0, n, 1200).astype(np.int32)
    coo = COOMatrix(rows, cols, rs.standard_normal(1200),
                    (n, n)).sum_duplicates()
    cfg = SpGEMMConfig(engine="auto", warmup=0, repeat=1,
                       dia_max_bands=16)
    record, result = run_benchmark(coo, "dia-fallback", cfg, verbose=False)
    assert result.engine != "dia"


def test_sharded_dia_matches_single_device():
    # halo-exchange column sharding (parallel/sharded_dia.py) vs the
    # single-device XLA path and scipy, on the virtual 8-device mesh
    import jax
    from pem_spgemm.parallel.sharded import make_mesh
    from pem_spgemm.parallel.sharded_dia import sharded_dia_multiply
    from pem_spgemm.ops.dia import _dia_multiply_xla, _plan_maps, \
        dia_to_coo
    coo = _banded_coo(1000, (-7, -1, 0, 2, 11), seed=13)
    a = coo_to_dia(coo, dtype=np.float32)
    mesh = make_mesh(8)
    c, cnt, dc_list = sharded_dia_multiply(a, a, mesh)
    dl, idx_map = _plan_maps(a.offsets, a.offsets)
    cx, nx = _dia_multiply_xla(a.bands, a.bands, offs_a=a.offsets,
                               idx_map=idx_map, dc_count=len(dl),
                               n_out=a.shape[0])
    assert dc_list == dl
    np.testing.assert_allclose(c, np.asarray(cx), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cnt > 0, np.asarray(nx) > 0)
    # scipy end-to-end through assembly
    s = coo.to_scipy()
    want = (s.tocsr() @ s.tocsr()).tocoo()
    want.sum_duplicates()
    r, col, v = dia_to_coo(c, cnt, dc_list, coo.shape)
    assert len(r) == want.nnz
    order = np.lexsort((want.col, want.row))
    np.testing.assert_allclose(v, want.data[order].astype(np.float32),
                               rtol=2e-5, atol=1e-5)


def test_fixed_plan_count_cache_second_run():
    # DiaPlan caches the static structural counts after the first run;
    # the second (values-only) run must return identical values, counts
    # and nnz (ops/dia.DiaPlan.run).
    coo = _banded_coo(400, (-3, 0, 2, 25), seed=17)
    res, a, b, cfg = _check_product(coo)
    plan = make_plan(res, cfg, a, b)
    out1 = plan.run(a, b)
    assert getattr(plan, "_cnt_cache", None) is not None
    out2 = plan.run(a, b)
    np.testing.assert_array_equal(np.asarray(out2[0]), np.asarray(out1[0]))
    np.testing.assert_array_equal(np.asarray(out2[1]), np.asarray(out1[1]))
    assert int(out2[2]) == int(out1[2]) == res.c_nnz


@pytest.mark.parametrize("offs_a,offs_b,n", [
    (tuple(range(-8, 8)), tuple(range(-8, 8)), 700),
    (tuple(range(3, 9)), tuple(range(-5, 2)), 500),     # A above, B mixed
    (tuple(range(-12, -2)), tuple(range(0, 20)), 300),  # A below diagonal
])
def test_dia_kernel_interpret_matches_xla(offs_a, offs_b, n):
    # ops/dia_kernel in Pallas interpret mode vs the XLA path: values to
    # float32 rounding, structural counts exactly, values-only replay
    from pem_spgemm.ops.dia import _dia_multiply_xla, _plan_maps
    from pem_spgemm.ops.dia_kernel import dia_multiply_kernel
    a = coo_to_dia(_banded_coo(n, offs_a, seed=8), dtype=np.float32)
    b = coo_to_dia(_banded_coo(n, offs_b, seed=9), dtype=np.float32)
    dc_list, idx_map = _plan_maps(a.offsets, b.offsets)
    cx, nx = _dia_multiply_xla(a.bands, b.bands, offs_a=a.offsets,
                               idx_map=idx_map, dc_count=len(dc_list),
                               n_out=n)
    kw = dict(offs_a=a.offsets, offs_b=b.offsets, n_out=n, rows=8,
              cols=64, interpret=True)
    ck, nk = dia_multiply_kernel(a.bands, b.bands, **kw)
    np.testing.assert_allclose(np.asarray(ck), np.asarray(cx),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(nk), np.asarray(nx))
    cv, none = dia_multiply_kernel(a.bands, b.bands, values_only=True, **kw)
    assert none is None
    np.testing.assert_array_equal(np.asarray(cv), np.asarray(ck))


@pytest.mark.parametrize("offs_a,offs_b,dtype,platform,want", [
    (tuple(range(-32, 32)), tuple(range(-32, 32)), np.float32, "gpu", True),
    (tuple(range(-64, 64)), tuple(range(-64, 64)), np.float32, "gpu", True),
    (tuple(range(-64, 64)), tuple(range(-64, 64)), np.float32, "cpu",
     False),
    (tuple(range(-8, 8)), tuple(range(-8, 8)), np.float32, "gpu",
     False),                                                    # few pairs
    ((0, 1, 600, 601, -600, -601, 1200, 1201, -1200, -1201),) * 2
    + (np.float32, "gpu", False),                               # gapped
    (tuple(range(-64, 64, 2)), tuple(range(-64, 64)), np.float32, "gpu",
     False),
    (tuple(range(-64, 64)), tuple(range(-64, 64)), np.float64, "gpu",
     False),                                    # the kernel is f32 only
    (tuple(range(-64, 64)), tuple(range(-64, 64)), np.float16, "gpu",
     False),
])
def test_dia_kernel_choice(offs_a, offs_b, dtype, platform, want):
    from pem_spgemm.ops.dia import use_dia_kernel
    assert use_dia_kernel(offs_a, offs_b, dtype, platform) is want


def test_dia_plan_takes_xla_path_on_cpu():
    a = coo_to_dia(_banded_coo(400, tuple(range(-40, 40)), seed=3),
                   dtype=np.float32)
    assert not make_dia_plan(a, a).kernel


@pytest.mark.parametrize("dtype,want", [(np.float32, True),
                                        (np.float64, False)])
def test_dia_plan_on_gpu_keeps_f64_on_xla_path(monkeypatch, dtype, want):
    # a float64 range-64 product (f64 parity mode) must not be computed
    # by the float32 kernel; the plan reads only the bands' dtype, so host
    # bands stand in for x64 device arrays
    import dataclasses
    import types
    from pem_spgemm.ops import dia
    a = coo_to_dia(_banded_coo(400, tuple(range(-32, 32)), seed=3),
                   dtype=np.float32)
    a = dataclasses.replace(a, bands=np.asarray(a.bands, dtype))
    monkeypatch.setattr(dia.jax, "devices",
                        lambda: [types.SimpleNamespace(platform="gpu")])
    assert dia.make_dia_plan(a, a).kernel is want


def test_dia_kernel_refuses_non_f32():
    from pem_spgemm.ops.dia_kernel import dia_multiply_kernel
    offs = tuple(range(-4, 4))
    bands = np.ones((len(offs), 64), np.float16)
    with pytest.raises(AssertionError):
        dia_multiply_kernel(bands, bands, offs_a=offs, offs_b=offs,
                            n_out=64, interpret=True)


@pytest.mark.gpu
def test_dia_kernel_on_gpu_matches_xla(gpu):
    from pem_spgemm.ops.dia import _dia_multiply_xla, _plan_maps
    from pem_spgemm.ops.dia_kernel import dia_multiply_kernel
    offs = tuple(range(-64, 64))
    a = coo_to_dia(_banded_coo(20_000, offs, seed=4), dtype=np.float32)
    assert make_dia_plan(a, a).kernel
    dc_list, idx_map = _plan_maps(offs, offs)
    cx, nx = _dia_multiply_xla(a.bands, a.bands, offs_a=offs,
                               idx_map=idx_map, dc_count=len(dc_list),
                               n_out=a.shape[0])
    ck, nk = dia_multiply_kernel(a.bands, a.bands, offs_a=offs, offs_b=offs,
                                 n_out=a.shape[0])
    np.testing.assert_allclose(np.asarray(ck), np.asarray(cx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(nk), np.asarray(nx))
