"""Column-sharded element engine on the virtual CPU mesh vs scipy."""

import numpy as np
import pytest
import jax.numpy as jnp

from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.models.synthetic import power_law
from pem_spgemm.ops.convert import coo_to_tiled
from pem_spgemm.parallel.sharded import make_mesh
from pem_spgemm.parallel.sharded_element import (
    plan_sharded_element, sharded_element_multiply,
    assemble_sharded_element)


def _run(coo, n_dev, b_coo=None):
    a = coo_to_tiled(coo, dtype=np.float32)
    b = a if b_coo is None else coo_to_tiled(b_coo, dtype=np.float32)
    sa = coo.to_scipy().tocsr()
    sb = sa if b_coo is None else b_coo.to_scipy().tocsr()
    want = (sa @ sb).tocoo()
    want.sum_duplicates()
    plan = plan_sharded_element(a, b, n_dev)
    assert plan.n_products > 0
    mesh = make_mesh(n_dev)
    per_class, res, c_nnz = sharded_element_multiply(plan, mesh)
    assert c_nnz == want.nnz, (n_dev, c_nnz, want.nnz)
    rows, cols, vals = assemble_sharded_element(plan, per_class, res)
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(rows, want.row[order])
    np.testing.assert_array_equal(cols, want.col[order])
    np.testing.assert_allclose(vals, want.data[order], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_element_power_law(n_dev):
    coo = power_law(n=3000, nnz=9000, seed=13, hub_correlation=0.15)
    _run(coo, n_dev)


def test_sharded_element_aat():
    from conftest import random_sparse
    m = random_sparse(400, 700, 0.004, seed=6)
    coo = COOMatrix.from_scipy(m)
    _run(coo, 4, b_coo=coo.transpose())
