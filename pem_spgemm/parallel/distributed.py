"""Multi-host scaffolding + scaling-efficiency measurement.

The reference has no distributed component at all (SURVEY.md section 2.3);
this module provides the pod-slice wiring for the sharded engines
(parallel/sharded.py, sharded_macro.py, sharded_element.py):

  * initialize(): jax.distributed bring-up for multi-process runs (one
    process per host); a no-op for single-process runs, so the same code
    path serves the virtual CPU mesh used in tests and one host's cards.
  * pod_mesh(): a 1D mesh over the first n devices.  NVLink joins every
    card of a host to every other at the same rate, so the ring order is
    simply device order.
  * scaling_efficiency(): nnz(C)/s at n = 1..max devices with efficiency
    relative to n=1 (virtual-mesh numbers validate the schedule, not the
    interconnect).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import numpy as np

from pem_spgemm.parallel.sharded import AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> int:
    """Bring up jax.distributed for a multi-process (multi-host) run.

    Pass the coordinator address (host:port), process count and id: no
    cluster environment provides them.  Returns the process count.
    Single-process runs skip initialization entirely.
    """
    if num_processes is not None and num_processes > 1 \
            or coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    elif jax.process_count() > 1:
        pass                           # runtime already initialized us
    return jax.process_count()


def pod_mesh(n_devices: Optional[int] = None):
    """1D mesh over the first n_devices devices (default: all), in
    device order."""
    from jax.sharding import Mesh
    n = n_devices if n_devices is not None else len(jax.devices())
    return Mesh(np.array(jax.devices()[:n]), (AXIS,))


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    c_nnz: int
    seconds: float
    nnz_per_s: float
    efficiency: float                  # vs n=1, per-device


def scaling_efficiency(coo, engine: str = "tile16", max_devices: int = 0,
                       repeats: int = 3, verbose: bool = True):
    """nnz(C)/s at n = 1..max_devices for one sharded engine.

    Efficiency(n) = (nnz_per_s(n) / n) / nnz_per_s(1); virtual-mesh
    numbers validate the schedule, not the interconnect.
    """
    import jax.numpy as jnp
    from pem_spgemm.ops.convert import coo_to_tiled, coo_to_macro
    from pem_spgemm.parallel import sharded, sharded_macro
    from pem_spgemm.parallel import sharded_element

    n_max = max_devices or len(jax.devices())
    points = []
    base = None
    for n in range(1, n_max + 1):
        if n > 1 and n_max % n and n != n_max:
            continue                   # keep the sweep short: divisors
        mesh = pod_mesh(n)
        if engine == "macro":
            op = coo_to_macro(coo, dtype=jnp.float32)
            plan = sharded_macro.plan_sharded_macro(op, op, n)
            run = lambda: sharded_macro.sharded_macro_numeric(plan, mesh)
            c_nnz_of = lambda out: int(plan_nnz_macro(plan, out))
        elif engine == "element":
            op = coo_to_tiled(coo, dtype=jnp.float32)
            plan = sharded_element.plan_sharded_element(op, op, n)
            run = lambda: sharded_element.sharded_element_multiply(
                plan, mesh)
            c_nnz_of = lambda out: out[2]
        else:
            op = coo_to_tiled(coo, dtype=jnp.float32,
                              with_tmasks=True)
            plan = sharded.plan_sharded_spgemm(op, op, n)
            run = lambda: sharded.sharded_numeric(plan, mesh)
            c_nnz_of = lambda out: plan.c_nnz
        out = run()                    # compile + warm
        jax.block_until_ready(out)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = run()
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        sec = min(ts)
        c_nnz = c_nnz_of(out)
        rate = c_nnz / sec
        if base is None:
            base = rate
        eff = (rate / n) / base
        points.append(ScalingPoint(n, c_nnz, sec, rate, eff))
        if verbose:
            print(f"[{engine}] n={n}: {sec*1e3:.1f} ms, "
                  f"{rate/1e6:.2f} Mnnz/s, efficiency {eff:.2f}",
                  flush=True)
    return points


def plan_nnz_macro(plan, out):
    """Exact C nnz from a sharded-macro run's structural counts.

    Only the first plan.c_counts_dev[d] slab rows of each device are real
    C tiles; counting padded rows would silently inflate the metric if a
    padded row ever carried nonzero counts."""
    if not isinstance(out, tuple):
        return -1
    cnt = np.asarray(out[1])
    return sum(int((cnt[d, :int(plan.c_counts_dev[d])] > 0).sum())
               for d in range(plan.n_devices))
