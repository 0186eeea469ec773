"""Synthetic matrix generators: determinism and canonical form."""

import numpy as np
import pytest

from pem_spgemm.models import synthetic


def _assert_canonical(m):
    order = np.lexsort((m.cols, m.rows))
    assert (order == np.arange(m.nnz)).all()
    keys = m.rows.astype(np.int64) * m.shape[1] + m.cols
    assert len(np.unique(keys)) == m.nnz  # no duplicates


@pytest.mark.parametrize("spec", [
    "banded:n=1000",
    "power_law:n=5000,nnz=20000",
    "rmat:scale=10,edge_factor=4",
    "uniform_random:n_rows=500,n_cols=700,nnz=3000",
])
def test_generators(spec):
    m1 = synthetic.by_name(spec)
    m2 = synthetic.by_name(spec)
    _assert_canonical(m1)
    assert m1.nnz == m2.nnz
    np.testing.assert_array_equal(m1.rows, m2.rows)
    np.testing.assert_array_equal(m1.vals, m2.vals)
    assert (m1.rows >= 0).all() and (m1.rows < m1.shape[0]).all()
    assert (m1.cols >= 0).all() and (m1.cols < m1.shape[1]).all()


def test_power_law_is_skewed():
    m = synthetic.power_law(n=20000, nnz=100000, seed=1)
    deg = np.bincount(m.rows, minlength=m.shape[0])
    # scale-free: max row degree far above the mean
    assert deg.max() > 20 * deg.mean()


def test_bad_family():
    with pytest.raises(ValueError, match="unknown synthetic family"):
        synthetic.by_name("nope:n=3")


def test_wandering_device_structure():
    # irregular-macro generator: exact nnz, in-range, macro-aligned
    # offsets, and a diagonal census far beyond the DIA cap
    from pem_spgemm.ops.dia import detect_dia, diag_offsets
    m = synthetic.wandering_device(n=2048, width=16, block=128, seed=4)
    assert m.nnz == 2048 * 16
    rows = np.asarray(m.rows)
    cols = np.asarray(m.cols)
    assert (cols >= 0).all() and (cols < m.shape[1]).all()
    # every offset is (col - row) = 128*m_g + k, k in [-8, 8)
    walk = ((cols - rows) - (-8)) // 128  # varies across blocks
    assert len(np.unique(walk)) > 3       # the center actually wanders
    assert len(diag_offsets(m)) > 64
    assert detect_dia(m, max_bands=64) is None


def test_wandering_macro_engine_exact():
    from pem_spgemm.config import SpGEMMConfig
    from pem_spgemm.ops.spgemm import SpGEMM
    from pem_spgemm.ops.convert import coo_to_macro
    m = synthetic.wandering_device(n=1024, width=16, block=128, seed=7)
    a = coo_to_macro(m, dtype=np.float32)
    res = SpGEMM(SpGEMMConfig())(a, a)
    s = m.to_scipy()
    want = (s.tocsr() @ s.tocsr()).tocoo()
    want.sum_duplicates()
    assert res.c_nnz == want.nnz
    got = res.to_coo()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(got.rows, want.row[order])
    np.testing.assert_allclose(got.vals, want.data[order].astype(np.float32),
                               rtol=2e-4, atol=2e-4)
