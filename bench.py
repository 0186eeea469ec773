"""Round benchmark: SpGEMM GFlops across the structural-regime suite.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

The reference benchmarks A^2 on SuiteSparse matrices (README.md:18,58;
named: webbase-1M).  SuiteSparse is unreachable here (zero egress), so the
suite is generated (models/synthetic.py) to span the structural regimes,
with every engine tier represented:

  powerlaw-1M   — webbase-1M-scale scale-free web graph (hub-correlated so
                  products/nnz ~ 22, matching webbase's A^2 profile);
                  hypersparse -> binned element engine
  rmat-16       — Kronecker graph-analytics regime (123M products,
                  heavy hub rows) -> element engine
  uniform-1M    — near-1 nnz/tile worst case -> element engine
  pairbands-500k — paired diagonals 600 apart: dense 16x16 tiles but
                  sparse 128x128 macro tiles -> DIA engine
  banded16/64/128-1M — stencil regimes (mc2depi/atmosmodd/consph-like)
                  -> DIA engine
  wandering64-1M — banded64's local structure, aperiodic globally ->
                  generic macro engine (batched 128x128 matmuls)

METHODOLOGY (reference parity): `value` is the geometric mean of per-matrix
GFlops from the INTERACTIVE per-iteration wall time — the full pipeline
including host allocation and D2H size feedbacks, as the reference re-runs
cudaMallocAsync + three size feedbacks every repeat (spgemm.cu:1135-1357);
min over repeats (the reference's -DFASTEST).  The steady-state
fixed-capacity replay (pre-compiled plans; no reference analog) is reported
as steady_gflops_geomean, and the PIPELINED metric (queued dispatches, one
sync) is the analog of the reference's device-event timing.

vs_baseline normalizes against REFERENCE_EST: per-matrix estimates for
TileSpGEMM-class fp64 SpGEMM on the reference's RTX 3080 Mobile
(README.md:24-31; the repo publishes no numbers).  Derivation in
BASELINE.md.

PROCESSES: each matrix runs in its own child process, one at a time, and
the parent never imports JAX, so exactly one process holds the card and a
failed matrix cannot take the others down.  The suite runs on a GPU only:
a child that finds another platform exits with NO_GPU_RC and the driver
exits non-zero without printing a result.  A SIGTERM (the caller's
`timeout`) emits the partial summary on the way out.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time

NO_GPU_RC = 3

# (name, generator spec, engine, estimated reference GFlops on 3080M/fp64)
#
# ORDER = engine-coverage first: under a wall budget the first four rows
# exercise one matrix per engine tier (element, DIA-pairs, DIA-dense,
# macro run-class) before the remaining regimes widen the suite.
SUITE = [
    ("powerlaw-1M", "power_law",
     dict(n=1_000_000, nnz=3_000_000, seed=42, hub_correlation=0.1),
     "element", 1.2),
    # mid-fill regime (dense 16x16 tiles, sparse macro tiles): the
    # structural DIA census (ops/dia.py) finds 10 distinct diagonals and
    # the multiply collapses to shifted vector FMA streams
    ("pairbands-500k", "banded_device",
     dict(n=500_000, seed=9,
          bands=(0, 1, 600, 601, -600, -601, 1200, 1201, -1200, -1201)),
     "auto", 4.0),
    ("banded64-1M", "banded_device",
     dict(n=1_000_000, seed=1, bands=tuple(range(-32, 32))), "auto", 7.0),
    # irregular-macro regime: banded64's local structure but a wandering
    # band center — the diagonal census (>500 distinct diagonals) rejects
    # the DIA tier and the aperiodic pair stream defeats the stencil
    # planner, so the GENERIC macro path must carry it (the reference's
    # step 3 has no structural precondition, spgemm.cu:593-661).
    # n must be macro-block aligned (the walk works in 128-row blocks):
    # 999936 = 7812 * 128, the closest to 1M
    ("wandering64-1M", "wandering_device",
     dict(n=999_936, seed=4), "macro", 7.0),
    ("rmat-16", "rmat", dict(scale=16, edge_factor=8, seed=7),
     "element", 1.2),
    ("uniform-1M", "uniform_random",
     dict(n_rows=1_000_000, n_cols=1_000_000, nnz=4_000_000, seed=3),
     "element", 1.0),
    ("banded16-1M", "banded_device",
     dict(n=1_000_000, seed=1, bands=tuple(range(-8, 8))), "auto", 4.0),
    # wide-stencil / FEM-block-dense regime (consph/pdb1HYS-class rows)
    ("banded128-1M", "banded_device",
     dict(n=1_000_000, seed=1, bands=tuple(range(-64, 64))), "auto", 10.0),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def geo(xs):
    return math.exp(sum(math.log(max(x, 1e-6)) for x in xs) / len(xs))


class Collector:
    """Accumulates per-matrix results and can emit the summary JSON at any
    moment — normal completion, wall-budget stop, or SIGTERM — so a JSON
    line is ALWAYS produced."""

    def __init__(self, n_total):
        self.gfs, self.steadies, self.pipelineds, self.refs = [], [], [], []
        self.n_total = n_total
        self.emitted = False

    def add(self, gflops, steady, pipelined, ref_est):
        self.gfs.append(gflops)
        self.steadies.append(steady)
        self.pipelineds.append(pipelined)
        self.refs.append(ref_est)

    def emit(self):
        if self.emitted:
            return
        self.emitted = True
        if not self.gfs:
            out = {"metric": "spgemm_gflops_geomean_suite", "value": 0.0,
                   "unit": "GFlops", "vs_baseline": 0.0}
        else:
            geomean = geo(self.gfs)
            ref_geo = geo(self.refs)
            out = {
                "metric": "spgemm_gflops_geomean_suite",
                "value": round(geomean, 4),
                "unit": "GFlops",
                "vs_baseline": round(geomean / ref_geo, 4),
                "steady_gflops_geomean": round(geo(self.steadies), 4),
                "steady_vs_baseline": round(geo(self.steadies) / ref_geo, 4),
                "pipelined_gflops_geomean": round(geo(self.pipelineds), 4),
                "pipelined_vs_baseline":
                    round(geo(self.pipelineds) / ref_geo, 4),
                "n_matrices": len(self.gfs),
            }
            if len(self.gfs) < self.n_total:
                out["partial"] = True
        print(json.dumps(out), flush=True)


def run_one(idx: int):
    """Child mode: benchmark SUITE[idx] and print a RESULT line."""
    name, family, kw, engine, ref_est = SUITE[idx]
    from pem_spgemm.utils.runtime import (NoGPUError, enable_compile_cache,
                                          require_gpu)
    try:
        devs = require_gpu()
    except NoGPUError as e:
        log(f"[{name}] {e}")
        sys.exit(NO_GPU_RC)
    enable_compile_cache()
    log(f"[{name}] devices:", devs)

    from pem_spgemm.config import SpGEMMConfig
    from pem_spgemm.bench.harness import run_benchmark
    from pem_spgemm.models import synthetic

    t0 = time.time()
    coo = getattr(synthetic, family)(**kw)
    log(f"[{name}] shape={coo.shape} nnz={coo.nnz} "
        f"({time.time() - t0:.0f}s gen) engine={engine}")
    cfg = SpGEMMConfig(warmup=1, repeat=3, engine=engine, fastest=True)
    record, _result = run_benchmark(coo, name, cfg, verbose=False,
                                    csv_path="bench_results.csv")
    log(f"[{name}] C_nnz={record.c_nnz} flop={record.flop} "
        f"interactive={record.pem_spgemm_time:.1f}ms "
        f"GFlops={record.gflops:.2f} | steady="
        f"{record.steady_state_time:.1f}ms "
        f"({record.steady_gflops:.2f} GF) | pipelined="
        f"{record.pipelined_time:.1f}ms "
        f"({record.pipelined_gflops:.2f} GF) (ref est {ref_est})")
    print("RESULT " + json.dumps({
        "name": name,
        "gflops": record.gflops,
        "steady": record.steady_gflops,
        "pipelined": record.pipelined_gflops,
    }), flush=True)


def main():
    col = Collector(len(SUITE))
    t_start = time.time()
    budget = float(os.environ.get("PEM_BENCH_BUDGET_S", "1500"))
    matrix_cap = float(os.environ.get("PEM_BENCH_MATRIX_CAP_S", "900"))
    live = {"proc": None}

    def _on_term(signum, frame):
        log(f"[bench] signal {signum}: emitting partial summary")
        p = live["proc"]
        if p is not None and p.poll() is None:
            p.kill()
        col.emit()
        sys.stdout.flush()
        os._exit(0)

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    def attempt(idx, name, ref_est):
        """Run SUITE[idx] in a child; True on success (result collected),
        False on failure/timeout, None when out of budget."""
        remaining = budget - (time.time() - t_start)
        if remaining < 60:
            return None
        cap = min(matrix_cap, remaining + 30)
        # child stderr inherits (streams through); stdout carries RESULT
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--one", str(idx)],
            stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        live["proc"] = p
        try:
            out, _ = p.communicate(timeout=cap)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            log(f"[{name}] TIMED OUT after {cap:.0f}s (killed)")
            return False
        finally:
            live["proc"] = None
        if p.returncode == NO_GPU_RC:
            log("[bench] no GPU: refusing to report numbers")
            sys.exit(NO_GPU_RC)
        result = None
        for line in (out or "").splitlines():
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
        if p.returncode != 0 or result is None:
            log(f"[{name}] FAILED (rc={p.returncode})")
            return False
        col.add(result["gflops"], result["steady"], result["pipelined"],
                ref_est)
        log(f"[{name}] done [t+{time.time() - t_start:.0f}s]")
        return True

    for idx, (name, _f, _kw, _e, ref_est) in enumerate(SUITE):
        if attempt(idx, name, ref_est) is None:
            log(f"[bench] wall budget exhausted; stopping at {name}")
            break

    col.emit()


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        run_one(int(sys.argv[2]))
    else:
        main()
