"""DIA GPU kernel (ops/dia_kernel.py) against the XLA path, on the GPU.

    python scripts/dia_kernel_bench.py kernel    # compile + check + time
    python scripts/dia_kernel_bench.py e2e       # run_benchmark, both paths

`kernel` compiles the kernel at banded64-1M and banded128-1M widths,
checks it against ops/dia._dia_multiply_xla (values within 1e-5 relative
to |A|.|B|, counts equal) and times both (values-only and with counts;
min of 5 after a warm run).  `e2e` runs
bench/harness.run_benchmark on both matrices with the XLA path and with
the kernel, in the order XLA, kernel, kernel, XLA.  One JSON line per
measurement.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MATRICES = [("banded64-1M", tuple(range(-32, 32))),
            ("banded128-1M", tuple(range(-64, 64)))]


def _best(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def kernel_mode(n=1_000_000):
    import jax.numpy as jnp
    import numpy as np
    from pem_spgemm.models.synthetic import banded_device
    from pem_spgemm.ops.dia import _dia_multiply_xla, _plan_maps, coo_to_dia
    from pem_spgemm.ops.dia_kernel import dia_multiply_kernel
    for name, bands in MATRICES:
        coo = banded_device(n=n, bands=bands, seed=1)
        a = coo_to_dia(coo, dtype=jnp.float32)
        dc, idx_map = _plan_maps(a.offsets, a.offsets)
        kw = dict(offs_a=a.offsets, idx_map=idx_map, dc_count=len(dc),
                  n_out=a.shape[0])
        cx, nx = _dia_multiply_xla(a.bands, a.bands, **kw)
        mag, _ = _dia_multiply_xla(jnp.abs(a.bands), jnp.abs(a.bands), **kw)
        t_x = _best(lambda: _dia_multiply_xla(a.bands, a.bands, **kw))
        t_xv = _best(lambda: _dia_multiply_xla(a.bands, a.bands,
                                               values_only=True, **kw))
        print(json.dumps(dict(matrix=name, path="xla", counts_s=t_x,
                              values_s=t_xv)), flush=True)
        kk = dict(offs_a=a.offsets, offs_b=a.offsets, n_out=a.shape[0])
        rec = dict(matrix=name, path="kernel")
        t0 = time.perf_counter()
        ck, nk = dia_multiply_kernel(a.bands, a.bands, **kk)
        np_ck = np.asarray(ck)
        rec["first_s"] = time.perf_counter() - t0
        err = np.abs(np_ck - np.asarray(cx))
        rec["max_err_over_bound"] = float(
            (err / (1e-5 * np.asarray(mag) + 1e-30)).max())
        rec["counts_equal"] = bool(np.array_equal(
            np.asarray(nk), np.asarray(nx)))
        rec["counts_s"] = _best(
            lambda: dia_multiply_kernel(a.bands, a.bands, **kk))
        rec["values_s"] = _best(
            lambda: dia_multiply_kernel(a.bands, a.bands,
                                        values_only=True, **kk))
        print(json.dumps(rec), flush=True)


def e2e_mode(n=1_000_000):
    from pem_spgemm.bench.harness import run_benchmark
    from pem_spgemm.config import SpGEMMConfig
    from pem_spgemm.models.synthetic import banded_device
    from pem_spgemm.ops import dia
    real = dia.use_dia_kernel
    cfg = SpGEMMConfig(warmup=1, repeat=5, fastest=True)
    for name, bands in MATRICES:
        coo = banded_device(n=n, bands=bands, seed=1)
        for path in ("xla", "kernel", "kernel", "xla"):
            dia.use_dia_kernel = (real if path == "kernel"
                                  else (lambda *a: False))
            try:
                rec, res = run_benchmark(coo, name, cfg, verbose=False)
            except Exception as e:          # report and go on
                print(json.dumps(dict(matrix=name, path=path,
                                      error=repr(e)[:2000])), flush=True)
                continue
            print(json.dumps(dict(
                matrix=name, path=path,
                kernel_used=res.dia_kernel,
                c_nnz=rec.c_nnz, interactive_ms=rec.pem_spgemm_time,
                steady_ms=rec.steady_state_time,
                pipelined_ms=rec.pipelined_time,
                step3_ms=rec.step3_time)), flush=True)
            del res
    dia.use_dia_kernel = real


if __name__ == "__main__":
    from pem_spgemm.utils.runtime import enable_compile_cache, require_gpu
    devs = require_gpu()
    enable_compile_cache()
    print(devs[0].device_kind, flush=True)
    {"kernel": kernel_mode, "e2e": e2e_mode}[sys.argv[1]]()
