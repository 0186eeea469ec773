"""The default engine choice (engine="auto") for each structural regime of
bench.py's suite, at CPU sizes, with scipy-exact C_nnz and values."""

import numpy as np
import pytest

from pem_spgemm.bench.harness import run_benchmark
from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.models import synthetic


def _host(coo):
    return COOMatrix(np.asarray(coo.rows), np.asarray(coo.cols),
                     np.asarray(coo.vals), coo.shape)


REGIMES = [
    ("banded", lambda: synthetic.banded(n=2000, bands=tuple(range(-8, 8)),
                                        seed=1), False, "dia"),
    ("pairbands", lambda: synthetic.banded(
        n=3000, bands=(0, 1, 60, 61, -60, -61, 120, 121, -120, -121),
        seed=9), False, "dia"),
    # > 512 distinct diagonals: the census refuses DIA, dense macro tiles
    ("wandering", lambda: _host(synthetic.wandering_device(n=128 * 80,
                                                           seed=4)),
     False, "macro"),
    ("powerlaw", lambda: synthetic.power_law(n=3000, nnz=9000, seed=42,
                                             hub_correlation=0.1),
     False, "element"),
    ("rmat", lambda: synthetic.rmat(scale=10, edge_factor=8, seed=7),
     False, "element"),
    ("uniform", lambda: synthetic.uniform_random(3000, 3000, 12000, seed=3),
     False, "element"),
    ("uniform-aat", lambda: synthetic.uniform_random(2000, 5000, 8000,
                                                     seed=5),
     True, "element"),
]


@pytest.mark.parametrize("name,make,aat,engine", REGIMES,
                         ids=[r[0] for r in REGIMES])
def test_auto_engine_choice_exact(name, make, aat, engine):
    coo = make()
    cfg = SpGEMMConfig(engine="auto", warmup=0, repeat=1)
    record, result = run_benchmark(coo, name, cfg, aat=aat, verbose=False)
    assert result.engine == engine
    s = coo.to_scipy().tocsr().astype(np.float32).astype(np.float64)
    t = s.T.tocsr() if aat else s
    pat = (s != 0).astype(np.float64)
    want = (pat @ (pat.T if aat else pat)).tocoo()
    assert result.c_nnz == record.c_nnz == want.nnz
    got = result.to_coo()
    order = np.lexsort((want.col, want.row))
    np.testing.assert_array_equal(got.rows, want.row[order])
    np.testing.assert_array_equal(got.cols, want.col[order])
    ref = np.asarray((s @ t)[got.rows, got.cols]).ravel()
    mag = np.asarray((abs(s) @ abs(t))[got.rows, got.cols]).ravel()
    assert np.all(np.abs(np.asarray(got.vals, np.float64) - ref)
                  <= 1e-5 * mag)
