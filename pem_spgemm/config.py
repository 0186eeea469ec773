"""Run-time configuration.

The reference exposes its knobs as compile-time macros only (WARMUP/REPEAT at
spgemm.cu:712-718, tileSize/ValueType constants at spgemm.cu:727-728, the
NSPARSE dispatch threshold at spgemm.cu:1142).  Here they are a first-class
config object, plus the knobs XLA's static shapes need and the reference has
no analog for (bucket growth for static-shape padding, matmul chunk size).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp


def round_up_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def round_up_bucket(n: int, granularity: int = 1) -> int:
    """Bucket a data-dependent size so XLA sees few distinct static shapes.

    Power-of-two buckets bound the number of compiled variants per phase at
    log2(max_size) while wasting at most 2x memory.  This is the static-shape
    replacement for the reference's exact `cudaMallocAsync` after each count
    pass (spgemm.cu:1246-1295): we still count exactly, but allocate the
    enclosing bucket so recompilation does not churn.
    """
    return max(granularity, round_up_pow2(max(1, int(n))))


@dataclasses.dataclass(frozen=True)
class SpGEMMConfig:
    """Configuration for the tiled SpGEMM pipeline."""

    # Tile edge. The bitmask format packs one tile row per integer, so this
    # is fixed at 16 in v1 (mirrors the reference's tileSize, spgemm.cu:727).
    tile: int = 16

    # Value dtype for the numeric phase. float64 requires jax_enable_x64
    # (the reference's ValueType, spgemm.cu:728).
    dtype: jnp.dtype = jnp.float32

    # Accumulation dtype for the batched 16x16 matmuls (preferred_element_type).
    acc_dtype: Optional[jnp.dtype] = None

    # Matmul precision for the numeric phase. A float32 dot may otherwise
    # run in TF32 (~3 decimal digits); "highest" keeps full f32 operand
    # precision, which the value-parity target requires. Use "default" to
    # trade precision for tensor-core throughput.
    precision: str = "highest"

    # Pairs processed per matmul chunk in the numeric phase. Bounds peak
    # memory for the (chunk, 16, 16) product tensor: 16384 pairs -> 16 MiB f32.
    numeric_chunk: int = 1 << 14

    # Structure engine:
    #   "fused" — exact structural pattern from a second 0/1 batched matmul
    #             inside the numeric loop (one pass over the pairs);
    #   "masks" — standalone bitmask phase (16 bit-plane segment reductions,
    #             mirrors the reference's step 2b shape; kept for parity
    #             testing and mask-only symbolic use);
    #   "element" — flop-proportional expand-sort-reduce at element level
    #             (the hypersparse regime, <~6 nnz per tile);
    #   "dia"   — diagonal-band engine (formats/dia.py): when all nonzeros
    #             lie on few distinct diagonals, SpGEMM reduces to shifted
    #             vector FMA streams with zero structure handling;
    #   "auto"  — dispatch on structure: DIA census first (harness level,
    #             operates on COO), then mean tile fill — the analog of
    #             the reference's structural dispatch to the NSPARSE
    #             fallback (spgemm.cu:1142).
    engine: str = "auto"

    # "auto"/"dia" engage the DIA engine only when the matrix's distinct-
    # diagonal census is at most this (band stacks are (D, n) dense).
    dia_max_bands: int = 512

    # "auto" picks the element engine when the mean nnz-per-occupied-tile
    # of both operands is below this; above it (but under the macro
    # threshold) the Tile16 fused engine runs.  The default routes
    # everything below the macro threshold to the element engine, and the
    # fused tier is an explicit opt-in (engine="fused"); the tiers have
    # not been re-ranked on the GPU yet (PERF.md).
    element_threshold: float = float("inf")

    # Element-engine implementation:
    #   "binned" — production path: row-binned padded segments + batched
    #              short-row sorts (ops/binned.py, f32 value path);
    #   "merge"  — dtype-agnostic merge-sort engine (ops/element.py); the
    #              f64 parity mode and non-f32 dtypes always use this.
    element_impl: str = "binned"

    # "auto" picks the macro (dense 128x128 matmul) engine when the mean nnz
    # per occupied 128x128 macro tile of both operands is at least this.
    # See formats/macro.py — the third engine tier, for stencil/banded/
    # block-dense structure.
    macro_threshold: float = 512.0

    # Macro-tile pairs per matmul chunk: 256 pairs -> 2 x 16 MiB f32
    # operands + 32 MiB products in flight.
    macro_chunk: int = 256

    # Benchmark protocol (reference defaults: WARMUP=1, REPEAT=10,
    # spgemm.cu:712-718 / Makefile:34).
    warmup: int = 1
    repeat: int = 10
    # Report the min across repeats instead of the mean (reference -DFASTEST,
    # spgemm.cu:1359).
    fastest: bool = False

    def acc(self) -> jnp.dtype:
        return self.acc_dtype if self.acc_dtype is not None else self.dtype

    def with_(self, **kw) -> "SpGEMMConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SpGEMMConfig()
