"""f64 reference-parity mode: all engines vs a float64 scipy oracle.

The reference computes in double (ValueType=double, spgemm.cu:728).  The
f64 path requires jax_enable_x64 — a process-global flag — so these tests
run the engines in a SUBPROCESS with JAX_ENABLE_X64=1 and assert the
recorded error bounds here.  The measured bounds feed BASELINE.md's
precision table.

Engine dtype support:
  fused / masks / macro : dtype=float64 end to end
  element (merge impl)  : dtype-agnostic sorts -> float64 exact path
  element (binned impl) : f32 value path only -> excluded here (dispatch
                          routes f64 to the merge impl, tested below)
"""

import json
import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import os, json
import sys
sys.path.insert(0, os.environ["REPO"])
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.ops.convert import coo_to_tiled, coo_to_macro
from pem_spgemm.ops.spgemm import SpGEMM

rs = np.random.default_rng(3)
n, nnz = 600, 6000
rows = rs.integers(0, n, nnz)
cols = rs.integers(0, n, nnz)
vals = rs.standard_normal(nnz)           # float64
m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
m.sum_duplicates()
coo = COOMatrix.from_scipy(m)
want = (m.tocsr() @ m.tocsr()).tocoo()
want.sum_duplicates()
order = np.lexsort((want.col, want.row))
wr, wc, wv = want.row[order], want.col[order], want.data[order]

out = {}
for engine in ("fused", "masks", "element", "macro"):
    cfg = SpGEMMConfig(engine=engine, dtype=jnp.float64,
                       numeric_chunk=1 << 10, macro_chunk=16)
    op = coo_to_macro(coo, dtype=jnp.float64) if engine == "macro" \
        else coo_to_tiled(coo, dtype=jnp.float64, with_tmasks=True)
    res = SpGEMM(cfg)(op, op)
    got = res.to_coo()
    assert res.c_nnz == want.nnz, (engine, res.c_nnz, want.nnz)
    gr, gc, gv = (np.asarray(got.rows), np.asarray(got.cols),
                  np.asarray(got.vals))
    assert gv.dtype == np.float64, (engine, gv.dtype)
    assert (gr == wr).all() and (gc == wc).all(), engine
    denom = np.maximum(np.abs(wv), 1e-300)
    out[engine] = float(np.max(np.abs(gv - wv) / denom))
    if engine == "element":
        assert res.binned is None, "f64 must route to the merge impl"

# DIA engine: banded operand, float64 band stacks end to end
from pem_spgemm.ops.dia import coo_to_dia
bd = sp.diags([rs.standard_normal(n - 1), rs.standard_normal(n),
               rs.standard_normal(n - 40)], [-1, 0, 40], format="coo")
coo_d = COOMatrix.from_scipy(bd)
da = coo_to_dia(coo_d, dtype=jnp.float64)
assert da.bands.dtype == jnp.float64
res = SpGEMM(SpGEMMConfig(engine="dia", dtype=jnp.float64))(da, da)
want_d = (bd.tocsr() @ bd.tocsr()).tocoo()
want_d.sum_duplicates()
assert res.c_nnz == want_d.nnz, ("dia", res.c_nnz, want_d.nnz)
got = res.to_coo()
order_d = np.lexsort((want_d.col, want_d.row))
assert np.asarray(got.vals).dtype == np.float64
denom = np.maximum(np.abs(want_d.data[order_d]), 1e-300)
out["dia"] = float(np.max(
    np.abs(np.asarray(got.vals) - want_d.data[order_d]) / denom))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def f64_errors():
    env = dict(os.environ)
    env["REPO"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # jax may be imported at interpreter startup, BEFORE the script body
    # runs — the flags must come in via the env
    env["JAX_ENABLE_X64"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_f64_all_engines_structure_and_values(f64_errors):
    # double accumulation vs a float64 oracle: a few ulps at most
    for engine, err in f64_errors.items():
        assert err < 1e-12, (engine, err)


def test_f64_error_bound_table(f64_errors):
    """Record the measured bounds (surfaced via -rA for BASELINE.md)."""
    for engine in ("fused", "masks", "element", "macro"):
        assert engine in f64_errors
    print("F64 max rel error vs scipy float64:",
          {k: f"{v:.2e}" for k, v in sorted(f64_errors.items())})
