"""Sharded Macro128 SpGEMM on the virtual CPU mesh vs scipy."""

import numpy as np
import pytest

import jax

from pem_spgemm.models.synthetic import banded
from pem_spgemm.ops.convert import coo_to_macro
from pem_spgemm.parallel.sharded import make_mesh
from pem_spgemm.parallel.sharded_macro import (
    plan_sharded_macro, sharded_macro_numeric, assemble_sharded_macro)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_macro_matches_scipy(n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    coo = banded(n=1500, bands=(0, 2, -2, 64, -64, 140, -140), seed=6)
    s = coo.to_scipy().tocsr()
    m = coo_to_macro(coo, dtype=np.float32)
    plan = plan_sharded_macro(m, m, n_dev)
    mesh = make_mesh(n_dev)
    c_dense, c_counts = sharded_macro_numeric(plan, mesh)
    rows, cols, vals = assemble_sharded_macro(plan, c_dense, c_counts)
    want = (s @ s).tocoo()
    want.sum_duplicates()
    assert len(rows) == want.nnz
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(rows, want.row[order])
    np.testing.assert_array_equal(cols, want.col[order])
    np.testing.assert_allclose(vals, want.data[order], rtol=1e-4, atol=1e-4)
