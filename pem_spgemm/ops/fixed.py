"""A fully-jittable fixed-capacity SpGEMM step.

The interactive pipeline (ops/spgemm.py) crosses to the host between phases
for the two-pass allocation protocol.  When capacities are known (from a
first interactive run on the same sparsity, or from upper bounds), the whole
symbolic+numeric pipeline composes into ONE jitted call — no host syncs.

The interactive pipeline pays up to three host<->device size feedbacks
per multiply; the fixed step has exactly one dispatch + one result fetch.
It is also the unit the multi-device layer shards and the reference-parity
"repeat" body for benchmarking (the reference re-runs its three steps with
no size feedback changes after the first iteration, spgemm.cu:1133-1357).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from pem_spgemm.ops import symbolic, cstruct, numeric


@partial(jax.jit, static_argnames=("p_cap", "c_cap", "c_nnz_cap", "chunk",
                                   "acc_dtype", "precision", "packed",
                                   "packed_coords"))
def spgemm_fixed(a_tile_row, a_tile_col, a_flat,
                 b_tile_rowptr, b_tile_col, b_flat,
                 ntiles_a, *, p_cap, c_cap, c_nnz_cap, chunk,
                 acc_dtype=jnp.float32, precision="highest", packed=False,
                 packed_coords=False):
    """One-shot fused-engine tiled SpGEMM at static capacities.

    Operands arrive as high-level tile structure + dense flat value tables
    (TiledMatrix.dense_flat(), built once at conversion like the
    reference's tiled arrays).  The step covers symbolic pair expansion,
    fused numeric+structural accumulation, mask/nnz derivation, intra-tile
    coordinates, and COMPRESSED tile-major value emission — the full span
    the reference times per iteration (steps 1-3 incl. CrowColIdx and the
    compressed Ctiles_vals writes, spgemm.cu:1133-1357); only global COO
    emission (sanitize_C) remains untimed assembly.

    Returns (c_tile_row, c_tile_col, cmask, cptr, c_rowcol, c_elem_tile,
    c_vals, c_nnz, overflow): C in compressed tiled form.  `overflow` is a
    device bool — True when any capacity was exceeded (p_cap < pairs,
    c_cap < C tiles, or c_nnz_cap < C nnz), in which case results are
    TRUNCATED and the caller must re-plan with larger capacities
    (bench/harness.py does).
    """
    offsets = symbolic.pair_counts(a_tile_col, b_tile_rowptr, ntiles_a)
    n_pairs = jnp.minimum(offsets[-1], p_cap)
    c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c = symbolic.expand_pairs(
        offsets, a_tile_row, a_tile_col, b_tile_rowptr, b_tile_col,
        n_pairs, p_cap, packed)
    c_dense, c_counts = numeric.accumulate_fused_flat(
        a_flat, b_flat, a_idx, b_idx, c_tile_id, c_cap, chunk,
        acc_dtype, precision)
    c_tile_row, c_tile_col = cstruct.c_tile_coords(
        c_tile_id, c_row, c_col, c_cap, packed_coords)
    cmask, cptr = numeric.counts_to_masks(c_counts.reshape(c_cap, 16, 16))
    c_rowcol, c_elem_tile = cstruct.c_rowcol(cmask, cptr, c_nnz_cap)
    c_vals = numeric.extract_values(c_dense, c_rowcol, c_elem_tile)
    overflow = ((offsets[-1] > p_cap) | (cnt_c > c_cap)
                | (cptr[-1] > c_nnz_cap))
    return (c_tile_row, c_tile_col, cmask, cptr, c_rowcol, c_elem_tile,
            c_vals, cptr[-1], overflow)


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Static capacities learned from one interactive run."""

    p_cap: int
    c_cap: int
    c_nnz_cap: int
    chunk: int
    packed: bool
    acc_dtype: object
    precision: str

    def fence(self, out):
        """Computation-dependent leaf to sync on (syncing a precomputed
        leaf measures dispatch, not execution)."""
        return out[6]                         # c_vals

    def run(self, a, b):
        """Execute the planned step: one dispatch, no host syncs."""
        return spgemm_fixed(
            a.tile_row, a.tile_col, a.dense_flat(),
            b.tile_rowptr, b.tile_col, b.dense_flat(),
            jnp.int32(a.ntiles), p_cap=self.p_cap, c_cap=self.c_cap,
            c_nnz_cap=self.c_nnz_cap, chunk=self.chunk,
            acc_dtype=self.acc_dtype, precision=self.precision,
            packed=self.packed,
            packed_coords=self.packed and a.n_tile_rows < (1 << 15))

    def grown(self):
        """Next-size plan after an overflow trip (double every capacity)."""
        return dataclasses.replace(self, p_cap=self.p_cap * 2,
                                   c_cap=self.c_cap * 2,
                                   c_nnz_cap=self.c_nnz_cap * 2)


@dataclasses.dataclass(frozen=True)
class MacroPlan:
    """Static capacities for the Macro128 engine's fixed step."""

    p_cap: int
    c_cap: int
    chunk: int
    acc_dtype: object
    precision: str

    def grown(self):
        """Next-size plan after an overflow trip (double every capacity)."""
        return dataclasses.replace(self, p_cap=self.p_cap * 2,
                                   c_cap=self.c_cap * 2)

    def fence(self, out):
        return out[4]                         # cptr

    def run(self, a, b):
        """One dispatch: (c_tile_row, c_tile_col, c_dense, c_counts, cptr,
        c_nnz, overflow)."""
        from pem_spgemm.formats.macro import MacroMatrix
        from pem_spgemm.ops.macro import macro_spgemm_fixed
        am = a if isinstance(a, MacroMatrix) else a.macro()
        bm = am if b is a else (
            b if isinstance(b, MacroMatrix) else b.macro())
        return macro_spgemm_fixed(
            am.tile_row, am.tile_col, am.dense,
            bm.tile_rowptr, bm.tile_col, bm.dense,
            jnp.int32(am.ntiles), p_cap=self.p_cap, c_cap=self.c_cap,
            chunk=self.chunk, acc_dtype=self.acc_dtype,
            precision=self.precision,
            packed_coords=am.n_macro_rows < (1 << 15))


@dataclasses.dataclass(frozen=True)
class BinnedElementPlan:
    """Fixed-step adapter for the binned element engine (ops/binned.py).

    The plan arrays are exact-structure (no capacities to overflow): the
    binning derives every bucket from the true chunk counts, so `overflow`
    is constantly False; a sparsity change requires re-planning, which the
    harness does per matrix.
    """

    plan: object            # ops.binned.BinnedPlan

    def grown(self):
        return self

    def fence(self, out):
        return out[0]                         # c_nnz depends on every bucket

    def run(self, a, b):
        """Dispatch the planned multiply; returns (c_nnz_device, overflow).
        The c_nnz scalar depends on every bucket, so syncing it fences the
        whole multiply."""
        import jax.numpy as _jnp
        from pem_spgemm.ops.binned import binned_multiply
        stream = binned_multiply(self.plan)
        return stream.c_nnz, _jnp.zeros((), _jnp.bool_)


@dataclasses.dataclass(frozen=True)
class ElementPlan:
    """Static capacities for the element-level engine's fixed step."""

    p_cap: int
    c_cap: int
    fill_rounds: object = None
    merge_rounds: object = None
    sum_rounds: object = None
    wide: bool = False      # >4-byte dtype: route around the f32 bit moves

    def grown(self):
        """Next-size plan after an overflow trip (double every capacity)."""
        return dataclasses.replace(self, p_cap=self.p_cap * 2,
                                   c_cap=self.c_cap * 2)

    def fence(self, out):
        return out[2]                         # vals

    def run(self, a, b):
        """One dispatch: C stream form (rows, cols, vals, first, c_nnz,
        overflow)."""
        from pem_spgemm.ops.element import element_fixed, \
            element_fixed_wide
        b_rowptr, _b_rows, b_cols, b_vals = b.element_csr()
        a_rows, a_cols = a.element_coords()
        if self.wide:
            # f64 parity mode: element_fixed's merge pipeline moves value
            # bits as f32 and would silently downcast —
            # the wide step keeps the native dtype end to end, matching
            # the interactive wide branch (ops/spgemm._element)
            return element_fixed_wide(
                a_rows, a_cols, a.vals, b_rowptr, b_cols, b_vals,
                p_cap=self.p_cap, c_cap=self.c_cap)
        return element_fixed(a_rows, a_cols, a.vals, b_rowptr, b_cols,
                             b_vals, p_cap=self.p_cap, c_cap=self.c_cap,
                             fill_rounds=self.fill_rounds,
                             merge_rounds=self.merge_rounds,
                             sum_rounds=self.sum_rounds)


def make_plan(result, config, a, b):
    """Build a fixed-capacity plan from an interactive SpGEMMResult.

    Capacities are chunk-granular, not power-of-two: the plan is compiled
    once per matrix, so fine granularity costs no recompile churn while a
    pow2 bucket would pad the pair stream (and every per-pair phase) by up
    to 2x.
    """
    from pem_spgemm.config import round_up_pow2
    from pem_spgemm.ops.scanops import can_pack
    chunk = config.numeric_chunk

    def gran(n, g):
        return max(g, -(-int(n) // g) * g)

    if result.engine == "dia":
        # the DIA plan is ALREADY fixed-step (C structure is static given
        # the offset sets); rebuild it from the operands' offsets
        from pem_spgemm.ops.dia import make_dia_plan
        return make_dia_plan(a, b)
    if result.engine == "element":
        import numpy as np
        if result.binned is not None:
            from pem_spgemm.ops.binned import build_plan_device
            return BinnedElementPlan(plan=build_plan_device(a, b))
        from pem_spgemm.ops.element import scan_round_bounds
        b_rowptr = np.asarray(b.element_csr()[0])
        a_rows_np, a_cols_np = (np.asarray(x) for x in a.element_coords())
        fr, mr, sr = scan_round_bounds(a_rows_np, a_cols_np,
                                       np.diff(b_rowptr))
        return ElementPlan(
            p_cap=gran(result.n_pairs, chunk),
            c_cap=round_up_pow2(max(1, result.c_nnz)),
            fill_rounds=fr, merge_rounds=mr, sum_rounds=sr,
            wide=jnp.dtype(config.dtype).itemsize > 4)
    if result.engine == "macro":
        return MacroPlan(
            p_cap=gran(result.n_pairs, config.macro_chunk),
            c_cap=gran(result.c_ntiles, 256),
            chunk=config.macro_chunk,
            acc_dtype=config.acc(), precision=config.precision)
    return SpGEMMPlan(
        p_cap=gran(result.n_pairs, chunk),
        c_cap=gran(result.c_ntiles, 1024),
        c_nnz_cap=round_up_pow2(max(1, result.c_nnz)),
        chunk=chunk,
        packed=can_pack(a.n_tile_rows, b.n_tile_cols),
        acc_dtype=config.acc(), precision=config.precision)
