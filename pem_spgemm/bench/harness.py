"""Benchmark harness: WARMUP + REPEAT protocol with per-phase timing.

Mirrors the reference's measurement protocol (spgemm.cu:1097-1450):
  * conversion timed separately from the SpGEMM pipeline;
  * WARMUP iterations discarded, REPEAT iterations aggregated by mean
    (or min with fastest=True, the reference's -DFASTEST);
  * flop / GFlops / compression_ratio definitions identical (utils/flops.py);
  * kernel vs malloc split: kernel time is the in-phase (device + D2H sync)
    time, malloc time is the residual host orchestration of the two-pass
    allocation protocol — the analog of the reference's measured
    cudaMallocAsync time (spgemm.cu:1353-1354).
"""

from __future__ import annotations

import time
from typing import Optional

import jax

from pem_spgemm.config import SpGEMMConfig, DEFAULT_CONFIG
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.ops.convert import coo_to_tiled
from pem_spgemm.ops.spgemm import SpGEMM, SpGEMMResult
from pem_spgemm.utils.flops import spgemm_flops, gflops, compression_ratio
from pem_spgemm.utils.timing import PhaseTimers
from pem_spgemm.utils.csv_report import (BenchmarkRecord, append_csv,
                                         matrix_name, report_stdout)


# Share of the device's memory limit that queued output generations may
# hold in the pipelined loop; operands, plan constants and the interactive
# result take the rest.
INFLIGHT_SHARE = 0.25
MAX_INFLIGHT = 16


def device_bytes_limit(device=None):
    """The allocator's byte limit on `device` (default: the first device),
    or None where the backend reports no memory statistics (the CPU)."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats()
    return stats.get("bytes_limit") if stats else None


def inflight_generations(gen_bytes: int, bytes_limit) -> int:
    """How many pipelined dispatches may be queued before a sync: as many
    output generations as fit in INFLIGHT_SHARE of the device limit,
    between 1 and MAX_INFLIGHT.  Without a known limit, one at a time."""
    if not bytes_limit:
        return 1
    fit = int(bytes_limit * INFLIGHT_SHARE) // max(1, int(gen_bytes))
    return max(1, min(MAX_INFLIGHT, fit))


def run_benchmark(coo: COOMatrix, name: str,
                  config: SpGEMMConfig = DEFAULT_CONFIG,
                  aat: bool = False,
                  csv_path: Optional[str] = None,
                  verbose: bool = True):
    """Benchmark C = A@A (or A@A.T with aat=True) on one matrix.

    Returns (BenchmarkRecord, SpGEMMResult of the last iteration).
    """
    cfg = config

    # --- conversion (timed once, like the reference) ---
    # The reference times H2D copies separately from the conversion kernels
    # (cudaEvents on streams, spgemm.cu:832-838 vs :938-978); mirror that:
    # transfer the COO triplets first, report device-side kernel time in the
    # A/B_conversion columns, and fold the transfer into the total overhead.
    import jax.numpy as jnp
    from pem_spgemm.formats.coo import COOMatrix as _COO
    t_conv0 = time.perf_counter()
    b_coo = coo.transpose() if aat else coo

    def _to_device(c):
        dev = _COO(jax.device_put(jnp.asarray(c.rows, jnp.int32)),
                   jax.device_put(jnp.asarray(c.cols, jnp.int32)),
                   jax.device_put(jnp.asarray(c.vals, cfg.dtype)), c.shape)
        jax.block_until_ready(dev.vals)
        return dev

    coo_dev = _to_device(coo)
    b_coo_dev = coo_dev if not aat else _to_device(b_coo)

    # Structural dispatch at the conversion layer (the DIA census operates
    # on COO, before any tiling): explicit engine "dia", or "auto" when the
    # distinct-diagonal census qualifies — the analog of the reference's
    # pre-conversion NSPARSE dispatch (spgemm.cu:1142).
    from pem_spgemm.ops.dia import detect_dia, coo_to_dia
    dia_offs = dia_offs_b = None
    if cfg.engine in ("dia", "auto"):
        dia_offs = detect_dia(coo_dev, max_bands=cfg.dia_max_bands)
        if dia_offs is not None and aat:
            dia_offs_b = detect_dia(b_coo_dev, max_bands=cfg.dia_max_bands)
            if dia_offs_b is None:
                dia_offs = None
        if cfg.engine == "dia" and dia_offs is None:
            raise ValueError(
                "engine='dia' but the matrix does not qualify (diagonal "
                "census exceeds dia_max_bands, or explicit zeros present)")
    # Conversion runs twice; the kernel columns report the SECOND (steady)
    # run: the first pays XLA compilation, which the reference's
    # ahead-of-time-compiled CUDA kernels never pay, so including it would
    # measure the compiler, not the conversion.  The first run's cost is
    # still visible in total_conversion_overhead_time.
    t_a = t_b = None
    a = b = None
    for _rep in range(2):
        # release the previous rep's converted operands BEFORE building
        # the new ones — at 10^8 nnz two generations of dense tile tables
        # need not fit device memory together
        a = b = None
        if dia_offs is not None:
            t0 = time.perf_counter()
            a = coo_to_dia(coo_dev, dtype=cfg.dtype, offsets=dia_offs)
            jax.block_until_ready(a.bands)
            t_a = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = a if not aat else coo_to_dia(b_coo_dev, dtype=cfg.dtype,
                                             offsets=dia_offs_b)
            jax.block_until_ready(b.bands)
            t_b = time.perf_counter() - t0
        elif cfg.engine == "macro":
            # macro-dispatched workloads convert straight to Macro128 (the
            # Tile16 form would only duplicate the operand in HBM)
            from pem_spgemm.ops.convert import coo_to_macro
            t0 = time.perf_counter()
            a = coo_to_macro(coo_dev, dtype=cfg.dtype)
            jax.block_until_ready(a.dense)
            t_a = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = a if not aat else coo_to_macro(b_coo_dev, dtype=cfg.dtype)
            jax.block_until_ready(b.dense)
            t_b = time.perf_counter() - t0
        else:
            element_f32 = (cfg.engine == "element"
                           and jnp.dtype(cfg.dtype)
                           == jnp.dtype(jnp.float32))
            t0 = time.perf_counter()
            a = coo_to_tiled(coo_dev, dtype=cfg.dtype)
            if cfg.engine in ("fused", "masks"):
                # densification is conversion
                jax.block_until_ready(a.dense_flat())
            if element_f32:
                # row-sorted element CSR
                jax.block_until_ready(a.element_csr()[2])
            t_a = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = coo_to_tiled(b_coo_dev, dtype=cfg.dtype, with_tmasks=True)
            if cfg.engine in ("fused", "masks"):
                jax.block_until_ready(b.dense_flat())
            if element_f32:
                # the B chunk table is a converted-format product, like
                # the reference's B-side tiled arrays (built in its
                # conversion streams, spgemm.cu:880-983)
                from pem_spgemm.ops.binned import chunk_b
                jax.block_until_ready(chunk_b(b).table)
            t_b = time.perf_counter() - t0
    t_conv_total = time.perf_counter() - t_conv0
    # Free the device COO triplets: nothing after conversion reads them,
    # and at 10^8 nnz they hold ~1GB of device memory the multiply needs
    # (the reference likewise frees its COO inputs before the benchmark
    # loop, spgemm.cu:1081-1093).
    coo_dev = b_coo_dev = None

    # --- flop count (host; reference runs this on a jthread,
    #     spgemm.cu:1068-1079) ---
    flop = spgemm_flops(coo.cols, b_coo.rows, b_coo.shape[0])

    engine = SpGEMM(cfg)

    # --- WARMUP + REPEAT ---
    for _ in range(cfg.warmup):
        result = engine(a, b)
        jax.block_until_ready(result.vals)

    timers = PhaseTimers()
    wall_iters = []
    result: SpGEMMResult = None
    for i in range(cfg.repeat):
        # per-phase syncs are instrumentation the reference's device
        # events don't pay: record phase detail on the first timed
        # repeat only (see PhaseTimers.detail)
        timers.detail = i == 0
        t0 = time.perf_counter()
        result = engine(a, b, timers)
        jax.block_until_ready(result.vals)
        wall_iters.append(time.perf_counter() - t0)
    timers.detail = True

    # HEADLINE methodology matches the reference: pem_spgemm_time is the
    # per-iteration wall time of the full pipeline INCLUDING host-side
    # allocation and the D2H size feedbacks, exactly like the reference's
    # timed repeat iterations re-run cudaMallocAsync and all three size
    # feedbacks every repeat (spgemm.cu:1135-1357).  GFlops derives from
    # this time.
    interactive = min(wall_iters) if cfg.fastest else \
        sum(wall_iters) / len(wall_iters)
    # phase columns come from the detailed repeat (one iteration)
    s1 = timers.pick("step1", cfg.fastest, 1)
    s2 = timers.pick("step2", cfg.fastest, 1)
    s3 = timers.pick("step3", cfg.fastest, 1)
    kernel = s1 + s2 + s3
    malloc = max(0.0, interactive - kernel)

    # Steady-state extension (reported separately, not in the CSV): with
    # capacities known, the whole multiply compiles into ONE dispatch with
    # no host syncs (ops/fixed.py) — the production serving path.  The
    # fixed step returns an overflow flag; a tripped flag means truncation,
    # so the harness re-plans at doubled capacities and re-runs (tested in
    # tests/test_fixed.py).
    from pem_spgemm.ops.fixed import make_plan
    plan = make_plan(result, cfg, a, b)
    if result.engine == "dia":
        # dense C band stacks are the big allocation; keep only one
        # generation in flight during the timing loop
        result.vals = None
        result.c_counts = None
    if result.engine == "macro":
        # the interactive result holds multi-GB dense C tiles; release them
        # for the timing loop (two plan outputs are in flight at once) and
        # refresh from the final planned output below
        result.vals = None
        result.c_counts = None
    out = plan.run(a, b)
    jax.block_until_ready(plan.fence(out))   # compile + warm
    for _ in range(4):
        if not bool(out[-1]):                # overflow flag
            break
        plan = plan.grown()
        out = plan.run(a, b)
        jax.block_until_ready(plan.fence(out))
    else:
        raise RuntimeError("fixed-capacity plan still overflows after "
                           "4 growth steps")
    fast_iters = []
    for _ in range(cfg.repeat):
        t0 = time.perf_counter()
        prev, out = out, None
        del prev
        out = plan.run(a, b)
        # fence on a computation-dependent leaf: some plans' outputs are
        # plan-cached constants (DIA counts), which are ready at once
        jax.block_until_ready(plan.fence(out))
        fast_iters.append(time.perf_counter() - t0)
    steady = min(fast_iters) if cfg.fastest else \
        sum(fast_iters) / len(fast_iters)

    # Pipelined steady state: queue `repeat` dispatches back-to-back and
    # sync ONCE; the device executes them in order, so wall/repeats is the
    # per-multiply device time without the per-iteration host sync.  This
    # matches the reference's device-event timing (cudaEvent pairs around
    # each phase, spgemm.cu:730-755).  A tiny probe sum per iteration lets
    # XLA free each generation's large outputs.
    import jax.numpy as _jnp

    def _probe(o):
        leaf = plan.fence(o)
        return _jnp.sum(_jnp.ravel(leaf)[:256].astype(_jnp.float32))

    # untimed warmup: compiles the probe reduction (and any remaining
    # plan variant) outside the timed region
    warm_out = plan.run(a, b)
    jax.block_until_ready(_probe(warm_out))
    # async dispatch allocates every queued generation's outputs up
    # front; bound the in-flight generations so multi-GB dense-C plans
    # cannot exhaust device memory mid-batch.
    gen_bytes = sum(x.size * x.dtype.itemsize
                    for x in jax.tree_util.tree_leaves(warm_out)
                    if hasattr(x, "size"))
    inflight = inflight_generations(gen_bytes, device_bytes_limit())
    reps = max(cfg.repeat, 8) if inflight >= 8 else cfg.repeat
    warm_out = None
    last = None
    t0 = time.perf_counter()
    for i in range(reps):
        last = _probe(plan.run(a, b))
        if (i + 1) % inflight == 0:
            jax.block_until_ready(last)
    jax.block_until_ready(last)
    pipelined = (time.perf_counter() - t0) / reps
    last = None
    if result.engine == "macro":
        # Macro fixed plans return the full tuple (c_tile_row, c_tile_col,
        # c_dense, c_counts, cptr, c_nnz, overflow) — possibly at a
        # different capacity than the interactive run, so the coordinate
        # arrays are refreshed together with the values.
        result.c_tile_row = out[0]
        result.c_tile_col = out[1]
        result.vals = out[2]
        result.c_counts = out[3]
        result.cptr = out[4]
    if result.engine == "dia":
        result.vals = out[0]
        result.c_counts = out[1]

    record = BenchmarkRecord(
        matrix=matrix_name(name),
        flop=flop,
        c_nnz=result.c_nnz,
        compression_ratio=compression_ratio(flop, result.c_nnz),
        a_conversion_kernel_time=t_a * 1e3,
        b_conversion_kernel_time=t_b * 1e3,
        total_conversion_overhead_time=t_conv_total * 1e3,
        step1_time=s1 * 1e3,
        step2_time=s2 * 1e3,
        step3_time=s3 * 1e3,
        pem_spgemm_time=interactive * 1e3,
        pem_spgemm_kernel_time=kernel * 1e3,
        pem_spgemm_malloc_time=malloc * 1e3,
        gflops=gflops(flop, interactive),
        steady_state_time=steady * 1e3,
        steady_gflops=gflops(flop, steady),
        pipelined_time=pipelined * 1e3,
        pipelined_gflops=gflops(flop, pipelined),
    )
    if verbose:
        print(report_stdout(record))
    if csv_path:
        append_csv(csv_path, record)
    return record, result
