"""MatrixMarket reader: native C++ parser vs python fallback parity."""

import numpy as np
import pytest

from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.io.mtx import (read_matrix_market, write_matrix_market,
                               save_result_files)

HEADERS = {
    "real_general": (
        "%%MatrixMarket matrix coordinate real general\n"
        "% comment line\n"
        "4 4 3\n1 1 1.5\n2 3 -2.25e-3\n4 4 7\n"),
    "integer": (
        "%%MatrixMarket matrix coordinate integer general\n"
        "3 3 2\n1 2 4\n3 3 -7\n"),
    "pattern": (
        "%%MatrixMarket matrix coordinate pattern general\n"
        "3 3 2\n1 2\n3 1\n"),
    "complex": (
        "%%MatrixMarket matrix coordinate complex general\n"
        "2 2 2\n1 1 3.5 -1.0\n2 2 0.5 2.0\n"),
    "symmetric": (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 3\n1 1 2.0\n2 1 -1.0\n3 3 4.0\n"),
    "skew": (
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "3 3 2\n2 1 5.0\n3 2 -1.5\n"),
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_native_python_parity(tmp_path, name):
    path = str(tmp_path / f"{name}.mtx")
    with open(path, "w") as f:
        f.write(HEADERS[name])
    a = read_matrix_market(path, native=True)
    b = read_matrix_market(path, native=False)
    assert a.shape == b.shape
    ka = np.lexsort((a.cols, a.rows))
    kb = np.lexsort((b.cols, b.rows))
    assert (a.rows[ka] == b.rows[kb]).all()
    assert (a.cols[ka] == b.cols[kb]).all()
    np.testing.assert_array_equal(a.vals[ka], b.vals[kb])


def test_symmetry_expansion(tmp_path):
    path = str(tmp_path / "s.mtx")
    with open(path, "w") as f:
        f.write(HEADERS["symmetric"])
    m = read_matrix_market(path)
    dense = m.to_scipy().toarray()
    assert m.nnz == 4  # one off-diagonal mirrored
    np.testing.assert_array_equal(dense, dense.T)


def test_skew_expansion(tmp_path):
    path = str(tmp_path / "sk.mtx")
    with open(path, "w") as f:
        f.write(HEADERS["skew"])
    dense = read_matrix_market(path).to_scipy().toarray()
    np.testing.assert_array_equal(dense, -dense.T)


def test_complex_real_part(tmp_path):
    # Reference keeps only the real part (spgemm.cu:104).
    path = str(tmp_path / "c.mtx")
    with open(path, "w") as f:
        f.write(HEADERS["complex"])
    m = read_matrix_market(path)
    np.testing.assert_array_equal(np.sort(m.vals), [0.5, 3.5])


def test_truncated_raises(tmp_path):
    path = str(tmp_path / "t.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n"
                "3 3 5\n1 1 1.0\n2 2 2.0\n")
    with pytest.raises(ValueError, match="truncated"):
        read_matrix_market(path, native=True)
    with pytest.raises(ValueError, match="truncated"):
        read_matrix_market(path, native=False)


def test_not_mtx_raises(tmp_path):
    path = str(tmp_path / "x.mtx")
    with open(path, "w") as f:
        f.write("garbage\n")
    with pytest.raises(ValueError):
        read_matrix_market(path, native=False)


def test_write_read_round_trip(tmp_path):
    rs = np.random.default_rng(0)
    m = COOMatrix(rs.integers(0, 50, 30), rs.integers(0, 70, 30),
                  rs.standard_normal(30), (50, 70)).sum_duplicates()
    path = str(tmp_path / "w.mtx")
    write_matrix_market(path, m)
    got = read_matrix_market(path)
    assert got.shape == m.shape and got.nnz == m.nnz
    np.testing.assert_allclose(got.vals, m.vals)


def test_save_result_files(tmp_path):
    m = COOMatrix(np.array([0, 1]), np.array([1, 0]),
                  np.array([1.25, -2.5]), (2, 2))
    paths = save_result_files(str(tmp_path), m)
    assert open(paths["NNZ"]).read().strip() == "2"
    assert np.loadtxt(paths["VALS"]).tolist() == [1.25, -2.5]


def test_result_writer_native_matches_python(tmp_path):
    import numpy as np
    from pem_spgemm.formats.coo import COOMatrix
    from pem_spgemm.io.mtx import save_result_files
    rs = np.random.default_rng(3)
    m = COOMatrix(rs.integers(0, 500, 200).astype(np.int32),
                  rs.integers(0, 500, 200).astype(np.int32),
                  rs.standard_normal(200), (500, 500))
    p1 = save_result_files(str(tmp_path / "n"), m)
    p2 = save_result_files(str(tmp_path / "p"), m, native=False)
    for k in ("NNZ", "ROWS", "COLS"):
        assert open(p1[k]).read().split() == open(p2[k]).read().split()
    v1 = [float(x) for x in open(p1["VALS"]).read().split()]
    v2 = [float(x) for x in open(p2["VALS"]).read().split()]
    np.testing.assert_array_equal(v1, v2)
