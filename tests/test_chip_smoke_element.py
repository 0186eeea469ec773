"""chip_smoke.py's element-engine phases on the CPU at tiny sizes: the
binned engine, A.A^T of a rectangular operand, and the file path (.mtx
on disk -> native parser -> CLI -> four-file dump)."""

import json

import pytest

import chip_smoke as cs


@pytest.mark.parametrize("name", ["element:powerlaw-1M",
                                  "aat:uniform-1Mx500k",
                                  "file:powerlaw-1M.mtx"])
def test_phase_tiny(name):
    phase = next(p for p in cs.PHASES if p.name == name)
    rec = cs.run_phase(phase, "tiny")
    assert rec["ok"], rec
    assert rec["engine"] == "element"
    assert rec["c_nnz"] == rec["c_nnz_host"]
    json.dumps(rec)
