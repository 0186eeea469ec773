"""MatrixMarket coordinate I/O.

Parity with the reference reader (read_matrix_market, spgemm.cu:43-110):
  * real / integer / pattern / complex fields (complex keeps the real part,
    spgemm.cu:99-107);
  * symmetric / skew-symmetric / hermitian inputs are generalized (both
    triangles emitted), matching fast_matrix_market's default behavior the
    reference relies on;
  * concurrent parsing: the reference reads A and B on a jthread
    (spgemm.cu:778-780); here the native reader itself is multithreaded.

Fast path: the C++ parser in csrc/mtx_reader.cpp via ctypes (built lazily
with g++). Fallback: a vectorized numpy parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from pem_spgemm.formats.coo import COOMatrix

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libmtx_reader.so")

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False

_FIELDS = {0: "real", 1: "integer", 2: "pattern", 3: "complex"}
_SYMS = {0: "general", 1: "symmetric", 2: "skew-symmetric", 3: "hermitian"}


def _build_native() -> bool:
    src = os.path.join(_CSRC, "mtx_reader.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
             "-o", _LIB_PATH, src],
            check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False


def _get_native() -> Optional[ctypes.CDLL]:
    """Lazily build + load the native parser; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build_native():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _lib_failed = True
            return None
        lib.mtx_read_header.restype = ctypes.c_int
        lib.mtx_read_header.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mtx_read_data.restype = ctypes.c_int64
        lib.mtx_read_data.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int]
        _lib = lib
        return _lib


def _read_native(path: str, nthreads: int):
    lib = _get_native()
    if lib is None:
        return None
    nr = ctypes.c_int64(); nc = ctypes.c_int64(); nnz = ctypes.c_int64()
    field = ctypes.c_int(); sym = ctypes.c_int()
    err = lib.mtx_read_header(path.encode(), ctypes.byref(nr),
                              ctypes.byref(nc), ctypes.byref(nnz),
                              ctypes.byref(field), ctypes.byref(sym))
    if err != 0:
        return None
    cap = max(1, nnz.value)
    rows = np.empty(cap, np.int32)
    cols = np.empty(cap, np.int32)
    vals = np.empty(cap, np.float64)
    n = lib.mtx_read_data(path.encode(), rows, cols, vals, cap, nthreads)
    if n < 0:
        return None
    if n < nnz.value:
        raise ValueError(
            f"{path}: truncated data section ({n} of {nnz.value} entries)")
    return (rows[:n], cols[:n], vals[:n], (nr.value, nc.value),
            _FIELDS.get(field.value, "real"), _SYMS.get(sym.value, "general"))


def _read_python(path: str):
    """Vectorized numpy fallback parser."""
    with open(path, "rb") as f:
        banner = f.readline().decode("ascii", "replace").lower()
        if not banner.startswith("%%matrixmarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        if "coordinate" not in banner:
            raise ValueError(f"{path}: only coordinate format supported")
        field = ("complex" if "complex" in banner else
                 "integer" if "integer" in banner else
                 "pattern" if "pattern" in banner else "real")
        sym = ("skew-symmetric" if "skew-symmetric" in banner else
               "hermitian" if "hermitian" in banner else
               "symmetric" if "symmetric" in banner else "general")
        line = f.readline()
        while line.startswith(b"%"):
            line = f.readline()
        nrows, ncols, nnz = (int(t) for t in line.split()[:3])
        body = f.read()
    ncol_tokens = {"pattern": 2, "complex": 4}.get(field, 3)
    data = np.array(body.split(), dtype=np.float64)
    if len(data) < nnz * ncol_tokens:
        raise ValueError(f"{path}: truncated data section")
    data = data[:nnz * ncol_tokens].reshape(nnz, ncol_tokens)
    rows = data[:, 0].astype(np.int32) - 1
    cols = data[:, 1].astype(np.int32) - 1
    if field == "pattern":
        vals = np.ones(nnz, np.float64)
    else:
        vals = data[:, 2]  # complex: real part only (reference spgemm.cu:104)
    return rows, cols, vals, (nrows, ncols), field, sym


def _generalize_symmetry(rows, cols, vals, sym: str):
    """Emit both triangles for symmetric-family matrices."""
    if sym == "general":
        return rows, cols, vals
    off = rows != cols
    mr, mc, mv = rows[off], cols[off], vals[off]
    if sym == "skew-symmetric":
        mv = -mv
    return (np.concatenate([rows, mc]), np.concatenate([cols, mr]),
            np.concatenate([vals, mv]))


def read_matrix_market(path: str, dtype=np.float64, nthreads: int = 0,
                       native: bool = True) -> COOMatrix:
    """Read a .mtx file into host COO triplets (0-based, symmetry expanded)."""
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    out = _read_native(path, nthreads) if native else None
    if out is None:
        out = _read_python(path)
    rows, cols, vals, shape, _field, sym = out
    rows, cols, vals = _generalize_symmetry(rows, cols, vals, sym)
    return COOMatrix(rows, cols, vals.astype(dtype, copy=False), shape)


def write_matrix_market(path: str, m: COOMatrix) -> None:
    """Write COO triplets as a general real coordinate .mtx file."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{m.shape[0]} {m.shape[1]} {m.nnz}\n")
        for r, c, v in zip(m.rows, m.cols, m.vals):
            f.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")


_writer_lib = None
_writer_failed = False


def _get_writer():
    """Lazily build + load the native result writer; None if unavailable."""
    global _writer_lib, _writer_failed
    if _writer_lib is not None or _writer_failed:
        return _writer_lib
    src = os.path.join(_CSRC, "result_writer.cpp")
    lib_path = os.path.join(_CSRC, "libresult_writer.so")
    if not os.path.exists(lib_path):
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
                 "-o", lib_path, src],
                check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            _writer_failed = True
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        _writer_failed = True
        return None
    lib.write_result_files.restype = ctypes.c_int64
    lib.write_result_files.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int]
    _writer_lib = lib
    return lib


def save_result_files(outdir: str, m: COOMatrix, prefix: str = "SPGEMM_RESULT",
                      native: bool = True):
    """Dump a result in the reference's four-file text layout.

    The reference writes /tmp/SPGEMM_RESULT_{NNZ,ROWS,COLS,VALS}.txt with
    values at max_digits10 precision (spgemm.cu:1527-1560) and highlights
    multi-GiB dumps (README.md:43-44); the native writer formats slices in
    parallel (csrc/result_writer.cpp), with numpy savetxt as fallback.
    """
    os.makedirs(outdir, exist_ok=True)
    paths = {k: os.path.join(outdir, f"{prefix}_{k}.txt")
             for k in ("NNZ", "ROWS", "COLS", "VALS")}
    lib = _get_writer() if native else None
    if lib is not None:
        rows = np.ascontiguousarray(m.rows, np.int32)
        cols = np.ascontiguousarray(m.cols, np.int32)
        vals = np.ascontiguousarray(m.vals, np.float64)
        n = lib.write_result_files(
            outdir.encode(), prefix.encode(), rows, cols, vals,
            np.int64(m.nnz), min(8, os.cpu_count() or 1))
        if n == m.nnz:
            return paths
    with open(paths["NNZ"], "w") as f:
        f.write(f"{m.nnz}\n")
    np.savetxt(paths["ROWS"], m.rows, fmt="%d")
    np.savetxt(paths["COLS"], m.cols, fmt="%d")
    np.savetxt(paths["VALS"], m.vals, fmt="%.17f")
    return paths
