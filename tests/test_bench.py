"""Benchmark harness: protocol, CSV schema parity, CLI."""

import numpy as np

from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.bench.harness import run_benchmark
from pem_spgemm.models.synthetic import banded
from pem_spgemm.utils.csv_report import CSV_HEADER, matrix_name
from pem_spgemm.utils.flops import spgemm_flops


def test_run_benchmark_and_csv(tmp_path):
    coo = banded(n=2000, bands=(0, 1, -1, 40))
    csv = str(tmp_path / "out.csv")
    cfg = SpGEMMConfig(warmup=1, repeat=2, numeric_chunk=1 << 10)
    record, result = run_benchmark(coo, "banded2k.mtx", cfg, csv_path=csv,
                                   verbose=False)
    # exact structural counts vs scipy
    s = coo.to_scipy().tocsr()
    want = s @ s
    assert record.c_nnz == want.nnz
    assert record.flop == spgemm_flops(coo.cols, coo.rows, coo.shape[0])
    assert record.matrix == "banded2k"
    assert record.gflops > 0
    lines = open(csv).read().strip().split("\n")
    assert lines[0] == CSV_HEADER
    assert len(lines) == 2
    assert len(lines[1].split(",")) == 14
    # append keeps single header
    run_benchmark(coo, "banded2k.mtx", cfg, csv_path=csv, verbose=False)
    lines = open(csv).read().strip().split("\n")
    assert len(lines) == 3 and lines[0] == CSV_HEADER


def test_aat_benchmark(tmp_path):
    from pem_spgemm.models.synthetic import uniform_random
    coo = uniform_random(300, 80, 2000, seed=2)
    cfg = SpGEMMConfig(warmup=0, repeat=1, numeric_chunk=1 << 10)
    record, result = run_benchmark(coo, "rect", cfg, aat=True, verbose=False)
    want = coo.to_scipy().tocsr() @ coo.to_scipy().tocsr().T
    assert record.c_nnz == want.nnz
    got = result.to_coo().to_scipy().toarray()
    np.testing.assert_allclose(got, want.toarray(), rtol=1e-4, atol=1e-4)


def test_cli_synthetic(tmp_path, capsys):
    from pem_spgemm.bench import cli
    record = cli.main(["banded:n=500", "0", "--repeat", "1", "--warmup", "0",
                       "--csv", str(tmp_path / "r.csv")])
    assert record.c_nnz > 0
    out = capsys.readouterr().out
    assert "GFlops" in out


def test_cli_save_result(tmp_path):
    from pem_spgemm.bench import cli
    record = cli.main(["banded:n=200", "1", "--repeat", "1", "--warmup", "0",
                       "--no-csv", "--outdir", str(tmp_path)])
    nnz = int(open(tmp_path / "SPGEMM_RESULT_NNZ.txt").read())
    assert nnz == record.c_nnz
    vals = np.loadtxt(tmp_path / "SPGEMM_RESULT_VALS.txt")
    assert len(vals) == nnz


def test_matrix_name():
    assert matrix_name("/data/webbase-1M.mtx") == "webbase-1M"
    assert matrix_name("synth:banded") == "synth:banded"
