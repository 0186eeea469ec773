"""chip_smoke.py on the CPU: its host references, its refusal of a CPU
platform, and the band and macro phases at tiny sizes (the element and
file-path phases are in test_chip_smoke_element.py, the four-card path in
test_chip_smoke_four.py)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.models import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scipy_nnz(coo):
    return cs.scipy_c_nnz(coo, coo)


@pytest.mark.parametrize("n,bands", [
    (300, tuple(range(-8, 8))),
    (700, (0, 1, 60, 61, -60, -61, 120, 121, -120, -121)),
    (50, (-49, -3, 0, 7, 49)),
])
def test_band_c_nnz_matches_scipy(n, bands):
    coo = synthetic.banded(n=n, bands=bands, seed=1)
    assert cs.band_c_nnz(n, bands, bands) == _scipy_nnz(coo)


def test_wandering_c_nnz_matches_scipy():
    coo = synthetic.wandering_device(n=128 * 20, seed=4)
    host = COOMatrix(np.asarray(coo.rows), np.asarray(coo.cols),
                     np.asarray(coo.vals), coo.shape)
    assert cs.wandering_c_nnz(host) == _scipy_nnz(host)


def test_sample_rows_covers_borders():
    rows = cs.sample_rows(1_000_000)
    assert len(rows) >= cs.SAMPLE_ROWS
    assert {0, 1, 999_998, 999_999} <= set(rows.tolist())
    np.testing.assert_array_equal(cs.sample_rows(10), np.arange(10))


def _exact_rows(coo, rows):
    s = coo.to_scipy().tocsr()
    c = (s @ s).tocoo()
    keep = np.isin(c.row, rows)
    return c.row[keep], c.col[keep], c.data[keep].astype(np.float32)


def test_check_rows_accepts_exact_and_flags_errors():
    coo = synthetic.power_law(n=400, nnz=2000, seed=3)
    rows = np.arange(0, 400, 3)
    r, c, v = _exact_rows(coo, rows)
    ok, ratio, _ = cs.check_rows(rows, r, c, v, coo, coo)
    assert ok and ratio <= 1.0
    bad = v.copy()
    bad[len(bad) // 2] *= 1.001                      # a 1e-3 value error
    ok, ratio, _ = cs.check_rows(rows, r, c, bad, coo, coo)
    assert ok and ratio > 1.0
    ok, _, _ = cs.check_rows(rows, r[1:], c[1:], v[1:], coo, coo)
    assert not ok                                     # a missing entry


def test_check_rows_rejects_tf32_rounding():
    # TF32 keeps 10 mantissa bits: rounding one operand that way must
    # break the stated bound, so a pass proves no dot ran in TF32
    coo = synthetic.banded(n=500, bands=tuple(range(-4, 4)), seed=2)
    rows = np.arange(500)
    m = coo.to_scipy().tocsr()
    t = m.copy()
    bits = t.data.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    t.data = bits.view(np.float32).astype(np.float64)
    c = (t @ m).tocoo()
    ok, ratio, _ = cs.check_rows(rows, c.row, c.col, c.data, coo, coo)
    assert ok and ratio > 10.0


def test_main_refuses_cpu(capsys):
    assert cs.main([]) == cs.NO_GPU_RC
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_script_alone_refuses_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize("name", ["dia:banded128-1M", "dia:pairbands-500k",
                                  "macro:wandering64-1M"])
def test_phase_tiny(name):
    phase = next(p for p in cs.PHASES if p.name == name)
    rec = cs.run_phase(phase, "tiny")
    assert rec["ok"], rec
    assert rec["dia_kernel"] is False            # the XLA path on the CPU
    assert rec["c_nnz"] == rec["c_nnz_host"]
    assert rec["rows_checked"] >= min(cs.SAMPLE_ROWS,
                                      rec["shape"][0])
    json.dumps(rec)


def test_phase_sizes_are_the_suites():
    import bench
    suite = {name: kw for name, _fam, kw, _e, _r in bench.SUITE}
    by_name = {p.name.split(":")[1]: p for p in cs.PHASES}
    for name in ("powerlaw-1M", "banded128-1M", "pairbands-500k",
                 "wandering64-1M"):
        assert by_name[name].full == suite[name]
