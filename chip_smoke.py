"""On-chip smoke test: the SpGEMM main path on one GPU, checked.

    python chip_smoke.py                # every one-card phase
    python chip_smoke.py --four-cards   # the four sharded decompositions

Each phase builds a seeded operand at the size of bench.py's suite, runs it
through the user-facing entry points (bench/harness.run_benchmark, or the
CLI for the file path) and checks the result on the host:

  * C_nnz equals a host count exactly: scipy on 0/1 patterns, or a closed
    form for the band structures whose scipy product is too large;
  * the values of >= 1,000 sampled C rows (every row of a smaller C) lie
    within |c - c_ref| <= tol * (|A|.|B|)_ij of a float64 scipy product of
    the same float32 operand values, with tol = max(1e-5, k * 2^-24) for
    an entry summed from k products: k float32 roundings can cost up to
    k * 2^-24 relative to |A|.|B|, which exceeds 1e-5 only for k > 167.
    TF32 dots would miss the bound by ~50x, so passing also shows that
    precision="highest" kept every float32 dot out of TF32.

One JSON line per phase; the last line is the contract line
{"ok": true, "device": {...}}, printed only when every phase passed.
There is no CPU mode: without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

NO_GPU_RC = 3
SAMPLE_ROWS = 1000
REL_TOL = 1e-5
EPS32 = 2.0 ** -24

# bench.py's suite matrices (same generators, parameters and seeds)
WANDERING_N = 999_936          # 7812 * 128: macro-block aligned, closest to 1M
PAIRBANDS = (0, 1, 600, 601, -600, -601, 1200, 1201, -1200, -1201)


# --------------------------------------------------------------------------
# Host references

def pattern_csr(coo):
    """0/1 float64 CSR of a COO's structure (explicit entries count)."""
    import scipy.sparse as sp
    rows, cols = np.asarray(coo.rows), np.asarray(coo.cols)
    return sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                         shape=coo.shape)


def value_csr(coo):
    """float64 CSR of the float32-rounded values the device multiplies."""
    import scipy.sparse as sp
    vals = np.asarray(coo.vals).astype(np.float32).astype(np.float64)
    return sp.csr_matrix((vals, (np.asarray(coo.rows),
                                 np.asarray(coo.cols))), shape=coo.shape)


def scipy_c_nnz(a_coo, b_coo) -> int:
    """Structural nnz of A@B: a product of 0/1 patterns never cancels."""
    return int((pattern_csr(a_coo) @ pattern_csr(b_coo)).nnz)


def band_c_nnz(n: int, offs_a, offs_b) -> int:
    """Structural nnz of A@B for full n x n band matrices (every in-range
    entry of every listed diagonal present).  C[i, i+d1+d2] exists iff
    some pair (d1, d2) keeps i+d1 and i+d1+d2 inside [0, n): a union of
    row intervals per C diagonal."""
    by_dc = {}
    for d1 in offs_a:
        for d2 in offs_b:
            dc = d1 + d2
            lo = max(0, -d1, -dc)
            hi = min(n, n - d1, n - dc)
            if lo < hi:
                by_dc.setdefault(dc, []).append((lo, hi))
    total = 0
    for ivs in by_dc.values():
        ivs.sort()
        cur_lo, cur_hi = ivs[0]
        for lo, hi in ivs[1:]:
            if lo > cur_hi:
                total += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        total += cur_hi - cur_lo
    return total


def interval_rows(coo):
    """(lo, hi) inclusive column bounds per row, asserting every row is one
    contiguous run of columns."""
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    n = coo.shape[0]
    cnt = np.bincount(rows, minlength=n)
    assert (cnt > 0).all(), "every row must hold an interval"
    lo = np.full(n, np.iinfo(np.int64).max)
    hi = np.full(n, -1)
    np.minimum.at(lo, rows, cols)
    np.maximum.at(hi, rows, cols)
    assert (hi - lo + 1 == cnt).all(), "rows are not contiguous intervals"
    return lo, hi


def wandering_c_nnz(coo, block: int = 128) -> int:
    """Structural nnz of A@A for the wandering band: each row of A is one
    column interval, shifting by exactly one column per row inside a
    `block`-row block.  C row i is then the union over k in A's row i of
    B's row-k intervals: at most two runs (one per block that row i's
    interval touches), each the hull of its first and last row."""
    lo, hi = interval_rows(coo)
    n = coo.shape[0]
    same = (np.arange(n - 1) + 1) % block != 0
    assert (np.diff(lo)[same] == 1).all() and (np.diff(hi)[same] == 1).all()
    k0, k1 = lo, hi
    assert (k1 - k0 < block).all(), "a row may touch at most two blocks"
    split = np.minimum(k1, (k0 // block + 1) * block - 1)
    a_lo, a_hi = lo[k0], hi[split]                  # run over [k0, split]
    two = split < k1
    b_lo = np.where(two, lo[np.minimum(split + 1, n - 1)], 0)
    b_hi = np.where(two, hi[k1], -1)
    overlap = np.maximum(0, np.minimum(a_hi, b_hi)
                         - np.maximum(a_lo, b_lo) + 1)
    return int(((a_hi - a_lo + 1) + (b_hi - b_lo + 1) - overlap).sum())


def sample_rows(n_rows: int, k: int = SAMPLE_ROWS, seed: int = 0):
    """k distinct rows (all rows when n_rows <= k), always including both
    borders, where band products are truncated."""
    if n_rows <= k:
        return np.arange(n_rows)
    rs = np.random.default_rng(seed)
    edge = np.r_[0:4, n_rows - 4:n_rows]
    mid = rs.choice(n_rows, k, replace=False)
    return np.unique(np.concatenate([edge, mid]))


def check_rows(rows, got_r, got_c, got_v, a_coo, b_coo):
    """Compare device C entries of `rows` with float64 scipy.

    Returns (structure_ok, max of |c - c_ref| / bound, #entries whose bound
    was loosened to k * 2^-24)."""
    import scipy.sparse as sp
    a_val = value_csr(a_coo)
    b_val = a_val if b_coo is a_coo else value_csr(b_coo)
    a_pat, b_pat = (m.copy() for m in (a_val, b_val))
    for m in (a_pat, b_pat):
        m.data[:] = 1.0
    sel = sp.csr_matrix((np.ones(len(rows)), (np.arange(len(rows)), rows)),
                        shape=(len(rows), a_coo.shape[0]))
    ref = (sel @ a_val @ b_val).tocoo()
    mag = (sel @ abs(a_val) @ abs(b_val)).tocsr()
    cnt = (sel @ a_pat @ b_pat).tocoo()
    order = np.lexsort((cnt.col, cnt.row))
    want_r = np.asarray(rows)[cnt.row[order]]
    want_c = cnt.col[order]
    k = cnt.data[order]
    got_order = np.lexsort((got_c, got_r))
    got_r, got_c, got_v = (np.asarray(x)[got_order]
                           for x in (got_r, got_c, got_v))
    if len(got_r) != len(want_r) or not (
            np.array_equal(got_r, want_r) and np.array_equal(got_c, want_c)):
        return False, float("inf"), 0
    ref_d = ref.tocsr()
    local = cnt.row[order]
    c_ref = np.asarray(ref_d[local, want_c]).ravel()
    m = np.asarray(mag[local, want_c]).ravel()
    tol = np.maximum(REL_TOL, k * EPS32)
    bound = tol * m
    err = np.abs(got_v.astype(np.float64) - c_ref)
    ratio = np.where(bound > 0, err / np.where(bound > 0, bound, 1.0),
                     np.where(err > 0, np.inf, 0.0))
    return True, float(ratio.max(initial=0.0)), int((k * EPS32
                                                     > REL_TOL).sum())


# --------------------------------------------------------------------------
# Device C entries of selected rows, per engine

def result_rows(result, rows):
    """(r, c, v) host arrays of the C entries in `rows` of an SpGEMMResult,
    read from the engine's native form without assembling all of C."""
    import jax.numpy as jnp
    rows = np.asarray(rows, np.int64)
    n_rows, n_cols = result.shape
    if result.engine == "dia":
        idx = jnp.asarray(rows, jnp.int32)
        vals = np.asarray(result.vals[:, idx])
        present = np.asarray(result.c_counts[:, idx]) > 0
        dcs = np.asarray(result.dia_dc, np.int64)
        k, j = np.nonzero(present)
        r = rows[j]
        c = r + dcs[k]
        keep = (c >= 0) & (c < n_cols)
        return r[keep], c[keep], vals[k, j][keep]
    if result.binned is not None:
        st = result.binned
        rs, cs, vs = [], [], []
        for keys, vals, first, seg_rows in zip(
                st.bucket_keys, st.bucket_vals, st.bucket_first,
                st.bucket_rows):
            seg = np.asarray(seg_rows)
            hit = np.nonzero(np.isin(seg, rows))[0]
            if not len(hit):
                continue
            h = jnp.asarray(hit, jnp.int32)
            f = np.asarray(first[h])
            rs.append(np.broadcast_to(seg[hit][:, None], f.shape)[f])
            cs.append(np.asarray(keys[h])[f])
            vs.append(np.asarray(vals[h])[f])
        rr, rc, rv, rf = (np.asarray(x) for x in st.res)
        m = rf & np.isin(rr, rows)
        rs.append(rr[m])
        cs.append(rc[m])
        vs.append(rv[m])
        return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)
    if result.engine == "macro":
        tr = np.asarray(result.c_tile_row)
        tc = np.asarray(result.c_tile_col)
        hit = np.nonzero(np.isin(tr, np.unique(rows // 128))
                         & (tc < (n_cols + 127) // 128))[0]
        h = jnp.asarray(hit, jnp.int32)
        cnt = np.asarray(result.c_counts[h]).astype(np.float32)
        dense = np.asarray(result.vals[h])
        t, i, j = np.nonzero(cnt > 0)
        r = tr[hit][t].astype(np.int64) * 128 + i
        c = tc[hit][t].astype(np.int64) * 128 + j
        keep = np.isin(r, rows)
        return r[keep], c[keep], dense[t, i, j][keep]
    coo = result.to_coo()
    keep = np.isin(np.asarray(coo.rows), rows)
    return (np.asarray(coo.rows)[keep], np.asarray(coo.cols)[keep],
            np.asarray(coo.vals)[keep])


# --------------------------------------------------------------------------
# Phases

class CompileClock:
    """Sums the XLA backend compile seconds that JAX's monitoring reports
    while the `with` block runs, in total and per jitted function."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __enter__(self):
        import jax.monitoring
        self.seconds = 0.0
        self.by_fun = {}
        jax.monitoring.register_event_duration_secs_listener(self._on)
        return self

    def __exit__(self, *exc):
        import jax.monitoring
        jax.monitoring.unregister_event_duration_listener(self._on)

    def _on(self, event, duration, fun_name="?", **_kw):
        if event == self.EVENT:
            self.seconds += duration
            self.by_fun[fun_name] = self.by_fun.get(fun_name, 0.0) + duration

    def top(self, k: int = 5):
        return [[f, t] for f, t in sorted(self.by_fun.items(),
                                          key=lambda kv: -kv[1])[:k]]


@dataclasses.dataclass(frozen=True)
class Phase:
    """One checked run.  `full` and `tiny` are generator keyword sets: the
    suite size for the chip, a small one for CPU tests of the phase."""

    name: str
    family: str                 # models.synthetic generator
    full: dict
    tiny: dict
    engine: str = "auto"        # SpGEMMConfig.engine
    expect: str = ""            # engine the result must come from
    aat: bool = False
    count: str = "scipy"        # host C_nnz: "scipy" | "bands" | "wandering"
    via_cli: bool = False       # file path: .mtx on disk -> CLI -> dump
    dia_kernel: bool = False    # on a GPU, ops/dia_kernel must compute C


PHASES = (
    Phase("element:powerlaw-1M", "power_law",
          dict(n=1_000_000, nnz=3_000_000, seed=42, hub_correlation=0.1),
          dict(n=4096, nnz=12_000, seed=42, hub_correlation=0.1),
          engine="element", expect="element"),
    Phase("dia:banded128-1M", "banded_device",
          dict(n=1_000_000, seed=1, bands=tuple(range(-64, 64))),
          dict(n=3000, seed=1, bands=tuple(range(-64, 64))),
          expect="dia", count="bands", dia_kernel=True),
    Phase("dia:pairbands-500k", "banded_device",
          dict(n=500_000, seed=9, bands=PAIRBANDS),
          dict(n=4000, seed=9, bands=PAIRBANDS),
          expect="dia", count="bands"),
    Phase("macro:wandering64-1M", "wandering_device",
          dict(n=WANDERING_N, seed=4), dict(n=128 * 24, seed=4),
          engine="macro", expect="macro", count="wandering"),
    Phase("aat:uniform-1Mx500k", "uniform_random",
          dict(n_rows=1_000_000, n_cols=500_000, nnz=4_000_000, seed=5),
          dict(n_rows=3000, n_cols=1500, nnz=9000, seed=5),
          expect="element", aat=True),
    # the element phase's operand again, through a .mtx file: the CLI
    # then reuses that phase's compiled programs
    Phase("file:powerlaw-1M.mtx", "power_law",
          dict(n=1_000_000, nnz=3_000_000, seed=42, hub_correlation=0.1),
          dict(n=4096, nnz=12_000, seed=42, hub_correlation=0.1),
          expect="element", via_cli=True),
)


def host_c_nnz(phase: Phase, params: dict, coo, b_coo) -> int:
    if phase.count == "bands":
        n = coo.shape[0]
        offs = sorted(set(params["bands"]))
        full = sum(n - abs(d) for d in offs if abs(d) < n)
        assert coo.nnz == full, "band operand is not full"
        return band_c_nnz(n, offs, offs)
    if phase.count == "wandering":
        return wandering_c_nnz(coo)
    return scipy_c_nnz(coo, b_coo)


def _host(coo):
    """Host copy of a (possibly device-resident) COO."""
    from pem_spgemm.formats.coo import COOMatrix
    return COOMatrix(np.asarray(coo.rows), np.asarray(coo.cols),
                     np.asarray(coo.vals), coo.shape)


def _run_cli(coo, tmp):
    """Write `coo` as .mtx, run the CLI with --save 1 on it, and read the
    four-file dump back.  Returns (record, dumped C as host COO)."""
    from pem_spgemm.bench import cli
    from pem_spgemm.formats.coo import COOMatrix
    from pem_spgemm.io import mtx
    path = os.path.join(tmp, "a.mtx")
    mtx.write_matrix_market(path, coo)
    record = cli.main([path, "1", "--warmup", "1", "--repeat", "2",
                       "--fastest", "--no-csv", "--outdir", tmp])
    if mtx._get_native() is None or mtx._get_writer() is None:
        raise RuntimeError("the native .mtx parser or result writer did "
                           "not build")
    stem = os.path.join(tmp, "SPGEMM_RESULT_")
    with open(stem + "NNZ.txt") as f:
        nnz = int(f.read().split()[0])
    rows = np.fromfile(stem + "ROWS.txt", dtype=np.int64, sep=" ")
    cols = np.fromfile(stem + "COLS.txt", dtype=np.int64, sep=" ")
    vals = np.fromfile(stem + "VALS.txt", dtype=np.float64, sep=" ")
    assert nnz == len(rows) == len(cols) == len(vals), "dump sizes differ"
    return record, COOMatrix(rows, cols, vals, coo.shape)


def run_phase(phase: Phase, size: str = "full") -> dict:
    """Run one phase and check it; returns its JSON record."""
    import jax
    from pem_spgemm.bench.harness import run_benchmark
    from pem_spgemm.config import SpGEMMConfig
    from pem_spgemm.models import synthetic

    t0 = time.perf_counter()
    params = phase.full if size == "full" else phase.tiny
    coo = getattr(synthetic, phase.family)(**params)
    host = _host(coo)
    assert not (host.vals == 0).any(), "explicit zeros in the operand"
    b_host = host.transpose() if phase.aat else host
    t_gen = time.perf_counter() - t0

    t1 = time.perf_counter()
    with CompileClock() as clock:
        if phase.via_cli:
            with tempfile.TemporaryDirectory() as tmp:
                record, dumped = _run_cli(host, tmp)
            rows = sample_rows(host.shape[0])
            keep = np.isin(dumped.rows, rows)
            got = (dumped.rows[keep], dumped.cols[keep], dumped.vals[keep])
            engine = phase.expect
            c_nnz = record.c_nnz
            kernel = False
        else:
            cfg = SpGEMMConfig(engine=phase.engine, warmup=1, repeat=2,
                               fastest=True)
            record, result = run_benchmark(coo, phase.name, cfg,
                                           aat=phase.aat, verbose=False)
            engine = result.engine
            c_nnz = result.c_nnz
            kernel = result.dia_kernel
            rows = sample_rows(host.shape[0])
            got = result_rows(result, rows)
            del result
    t_run = time.perf_counter() - t1

    t2 = time.perf_counter()
    want_nnz = host_c_nnz(phase, params, host, b_host)
    struct_ok, err_ratio, loose = check_rows(rows, *got, host, b_host)
    t_check = time.perf_counter() - t2
    want_kernel = phase.dia_kernel and jax.devices()[0].platform == "gpu"
    ok = (struct_ok and err_ratio <= 1.0 and c_nnz == want_nnz
          and record.c_nnz == want_nnz
          and (not phase.expect or engine == phase.expect)
          and kernel == want_kernel)
    return {
        "phase": phase.name, "ok": bool(ok), "engine": engine,
        "dia_kernel": bool(kernel),
        "shape": list(host.shape), "nnz_a": host.nnz, "flop": record.flop,
        "c_nnz": int(c_nnz), "c_nnz_host": int(want_nnz),
        "rows_checked": int(len(rows)), "rows_structure_ok": struct_ok,
        "max_err_over_bound": err_ratio, "loose_bound_entries": loose,
        "interactive_ms": record.pem_spgemm_time,
        "steady_ms": record.steady_state_time,
        "pipelined_ms": record.pipelined_time,
        "compile_s": clock.seconds, "compile_top": clock.top(),
        "gen_s": t_gen, "run_s": t_run,
        "check_s": t_check,
    }


# --------------------------------------------------------------------------
# Four cards: the sharded decompositions against the one-card result

def _compare_full(name, got, one, a_coo, b_coo, want_nnz, extra):
    """Sharded C (host triplets) vs the one-card C and float64 scipy."""
    r, c, v = (np.asarray(x) for x in got)
    rows = sample_rows(a_coo.shape[0])
    keep = np.isin(r, rows)
    struct_ok, err_ratio, _ = check_rows(rows, r[keep], c[keep], v[keep],
                                         a_coo, b_coo)
    o = np.lexsort((one[1], one[0]))
    g = np.lexsort((c, r))
    same_struct = (len(r) == len(one[0])
                   and np.array_equal(r[g], np.asarray(one[0])[o])
                   and np.array_equal(c[g], np.asarray(one[1])[o]))
    diff = (float(np.abs(v[g].astype(np.float64)
                         - np.asarray(one[2])[o]).max(initial=0.0))
            if same_struct else float("inf"))
    ok = (struct_ok and err_ratio <= 1.0 and same_struct
          and len(r) == want_nnz)
    return dict(phase=name, ok=bool(ok), c_nnz=int(len(r)),
                c_nnz_host=int(want_nnz), c_nnz_one_card=int(len(one[0])),
                max_abs_diff_vs_one_card=diff,
                rows_checked=int(len(rows)), max_err_over_bound=err_ratio,
                **extra)


def _band_rows(c, cnt, dc_list, shape, rows):
    """(r, c, v) of the C entries in `rows` from host band stacks."""
    dcs = np.asarray(dc_list, np.int64)
    k, j = np.nonzero(np.asarray(cnt)[:, rows] > 0)
    r = np.asarray(rows, np.int64)[j]
    col = r + dcs[k]
    keep = (col >= 0) & (col < shape[1])
    return r[keep], col[keep], np.asarray(c)[:, rows][k, j][keep]


def _band_nnz(cnt, dc_list, shape) -> int:
    """Structural nnz of host band stacks (in-range positions only)."""
    n_rows, n_cols = shape
    total = 0
    for k, d in enumerate(dc_list):
        lo, hi = max(0, -d), min(n_rows, n_cols - d)
        if lo < hi:
            total += int(np.count_nonzero(np.asarray(cnt[k, lo:hi]) > 0))
    return total


def _timed(fn):
    import jax
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, first, time.perf_counter() - t0


# The tile16 ring and the element column shard share one operand, and
# so one one-card result: pairbands at full size (dense 16x16 tiles, the
# Tile16 regime; a hypersparse operand would give the one-card Tile16
# engine a dense C tile per C entry).
FOUR_CARD_SIZES = {
    "full": dict(tile=("banded", dict(n=262_144, seed=9, bands=PAIRBANDS)),
                 macro=dict(n=262_144, seed=5, bands=tuple(range(-32, 32))),
                 dia=dict(n=1_000_000, seed=1, bands=tuple(range(-32, 32)))),
    "tiny": dict(tile=("power_law", dict(n=2048, nnz=16_384, seed=3)),
                 macro=dict(n=1024, seed=5, bands=(0, 2, -2, 70, -70)),
                 dia=dict(n=2048, seed=1, bands=(-1, 0, 100))),
}


def run_four_cards(size: str = "full", n_devices: int = 4):
    """The four decompositions of __graft_entry__.dryrun_multichip, each
    compared with the one-card SpGEMM of the same operands."""
    import jax
    from pem_spgemm.config import SpGEMMConfig
    from pem_spgemm.models import synthetic
    from pem_spgemm.ops.convert import coo_to_macro, coo_to_tiled
    from pem_spgemm.ops.dia import coo_to_dia, make_dia_plan
    from pem_spgemm.ops.spgemm import SpGEMM
    from pem_spgemm.parallel.distributed import pod_mesh
    from pem_spgemm.parallel.sharded import (assemble_sharded,
                                             plan_sharded_spgemm,
                                             sharded_numeric)
    from pem_spgemm.parallel.sharded_dia import sharded_dia_multiply
    from pem_spgemm.parallel.sharded_element import (
        assemble_sharded_element, plan_sharded_element,
        sharded_element_multiply)
    from pem_spgemm.parallel.sharded_macro import (assemble_sharded_macro,
                                                   plan_sharded_macro,
                                                   sharded_macro_numeric)

    assert len(jax.devices()) >= n_devices, jax.devices()
    sizes = FOUR_CARD_SIZES[size]
    mesh = pod_mesh(n_devices)
    out = []

    family, params = sizes["tile"]
    coo = getattr(synthetic, family)(**params)
    want = scipy_c_nnz(coo, coo)
    a = coo_to_tiled(coo, dtype=np.float32)
    b = coo_to_tiled(coo, dtype=np.float32, with_tmasks=True)

    one = SpGEMM(SpGEMMConfig(engine="fused"))(a, b).to_coo()
    one = (one.rows, one.cols, one.vals)
    plan = plan_sharded_spgemm(a, b, n_devices)
    vals, first, steady = _timed(lambda: sharded_numeric(plan, mesh))
    out.append(_compare_full(
        "four:tile16-ring", assemble_sharded(plan, vals), one, coo, coo,
        want, dict(first_s=first, run_s=steady, pairs=int(plan.n_pairs))))

    eplan = plan_sharded_element(a, b, n_devices)
    (per_class, res, e_nnz), first, steady = _timed(
        lambda: sharded_element_multiply(eplan, mesh))
    out.append(_compare_full(
        "four:element-column-shard",
        assemble_sharded_element(eplan, per_class, res), one, coo, coo,
        want, dict(first_s=first, run_s=steady, c_nnz_device=int(e_nnz),
                   products=int(eplan.n_products))))

    coo_m = synthetic.banded(**sizes["macro"])
    mm = coo_to_macro(coo_m, dtype=np.float32)
    one = SpGEMM(SpGEMMConfig(engine="macro"))(mm, mm).to_coo()
    one = (one.rows, one.cols, one.vals)
    mplan = plan_sharded_macro(mm, mm, n_devices)
    (c_dense, c_counts), first, steady = _timed(
        lambda: sharded_macro_numeric(mplan, mesh))
    out.append(_compare_full(
        "four:macro-ring", assemble_sharded_macro(mplan, c_dense, c_counts),
        one, coo_m, coo_m,
        band_c_nnz(coo_m.shape[0], sizes["macro"]["bands"],
                   sizes["macro"]["bands"]),
        dict(first_s=first, run_s=steady, pairs=int(mplan.n_pairs))))

    coo_d = synthetic.banded(**sizes["dia"])
    da = coo_to_dia(coo_d, dtype=np.float32)
    dplan = make_dia_plan(da, da)
    c1, cnt1, _nnz, _ = dplan.run(da, da)
    c1, cnt1 = np.asarray(c1), np.asarray(cnt1)
    (dc, dcnt, dc_list), first, steady = _timed(
        lambda: sharded_dia_multiply(da, da, mesh))
    rows = sample_rows(coo_d.shape[0])
    struct_ok, err_ratio, _ = check_rows(
        rows, *_band_rows(dc, dcnt, dc_list, coo_d.shape, rows),
        coo_d, coo_d)
    want = band_c_nnz(coo_d.shape[0], sizes["dia"]["bands"],
                      sizes["dia"]["bands"])
    got_nnz = _band_nnz(dcnt, dc_list, coo_d.shape)
    same = (tuple(dc_list) == tuple(dplan.dc_list)
            and np.array_equal(dcnt > 0, cnt1 > 0))
    out.append(dict(
        phase="four:dia-halo", ok=bool(struct_ok and err_ratio <= 1.0
                                       and same and got_nnz == want),
        c_nnz=got_nnz, c_nnz_host=want,
        c_nnz_one_card=_band_nnz(cnt1, dplan.dc_list, coo_d.shape),
        max_abs_diff_vs_one_card=float(np.abs(dc - c1).max()),
        rows_checked=int(len(rows)), max_err_over_bound=err_ratio,
        first_s=first, run_s=steady, one_card_kernel=bool(dplan.kernel),
        band_pairs=len(da.offsets) ** 2))
    return out


# --------------------------------------------------------------------------

def gpu_power_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the cards in use."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four sharded decompositions, on 4 "
                        "GPUs, each against the one-card result")
    args = p.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); "
              "this script has no CPU mode", file=sys.stderr)
        return NO_GPU_RC
    from pem_spgemm.utils.runtime import enable_compile_cache
    cache = enable_compile_cache()
    print(f"device_kind: {devs[0].device_kind}  count: {len(devs)}",
          flush=True)
    print(gpu_power_line(), flush=True)
    print(f"compile cache: {cache}", flush=True)

    records = []
    if args.four_cards:
        if len(devs) < 4:
            print("chip_smoke: --four-cards needs 4 GPUs", file=sys.stderr)
            return 1
        try:
            records = run_four_cards("full")
        except Exception:
            traceback.print_exc()
            records = [{"phase": "four-cards", "ok": False}]
        for rec in records:
            print(json.dumps(rec), flush=True)
    else:
        for phase in PHASES:
            try:
                rec = run_phase(phase, "full")
            except Exception as e:
                traceback.print_exc()
                rec = {"phase": phase.name, "ok": False, "error": repr(e)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if not records or not all(r["ok"] for r in records):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
