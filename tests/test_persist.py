"""Converted-format persistence round trips (SURVEY §5 checkpoint)."""

import numpy as np
import pytest

from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.io.persist import (save_tiled, load_tiled,
                                   save_macro, load_macro)
from pem_spgemm.models.synthetic import banded, power_law
from pem_spgemm.ops.convert import coo_to_tiled, coo_to_macro
from pem_spgemm.ops.spgemm import SpGEMM


def test_tiled_roundtrip_and_multiply(tmp_path):
    coo = power_law(n=2000, nnz=7000, seed=8, hub_correlation=0.1)
    t = coo_to_tiled(coo, dtype=np.float32, with_tmasks=True)
    p = str(tmp_path / "a.tile16.npz")
    save_tiled(p, t)
    t2 = load_tiled(p)
    assert t2.shape == t.shape and t2.ntiles == t.ntiles
    np.testing.assert_array_equal(np.asarray(t2.masks), np.asarray(t.masks))
    # the loaded operand multiplies identically
    r1 = SpGEMM(SpGEMMConfig(engine="element"))(t, t)
    r2 = SpGEMM(SpGEMMConfig(engine="element"))(t2, t2)
    assert r1.c_nnz == r2.c_nnz
    c1, c2 = r1.to_coo(), r2.to_coo()
    np.testing.assert_array_equal(np.asarray(c1.rows), np.asarray(c2.rows))
    np.testing.assert_allclose(np.asarray(c1.vals), np.asarray(c2.vals),
                               rtol=1e-6)


def test_macro_roundtrip_and_multiply(tmp_path):
    coo = banded(n=1000, bands=(0, 2, -2, 64), seed=2)
    m = coo_to_macro(coo, dtype=np.float32)
    p = str(tmp_path / "a.macro.npz")
    save_macro(p, m)
    m2 = load_macro(p)
    assert m2.ntiles == m.ntiles and m2.nnz == m.nnz
    np.testing.assert_array_equal(np.asarray(m2.dense), np.asarray(m.dense))
    r1 = SpGEMM(SpGEMMConfig(engine="macro", macro_chunk=16))(m, m)
    r2 = SpGEMM(SpGEMMConfig(engine="macro", macro_chunk=16))(m2, m2)
    assert r1.c_nnz == r2.c_nnz


def test_magic_mismatch(tmp_path):
    coo = banded(n=500, bands=(0, 1), seed=1)
    t = coo_to_tiled(coo, dtype=np.float32)
    p = str(tmp_path / "x.npz")
    save_tiled(p, t)
    with pytest.raises(ValueError, match="not a"):
        load_macro(p)


def test_cli_save_converted(tmp_path):
    from pem_spgemm.bench import cli
    path = str(tmp_path / "conv.npz")
    cli.main(["banded:n=300", "0", "--repeat", "1", "--warmup", "0",
              "--no-csv", "--save-converted", path, "--engine", "element"])
    t = load_tiled(path)
    assert t.shape == (300, 300)
