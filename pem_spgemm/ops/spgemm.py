"""The tiled SpGEMM pipeline orchestrator.

Host-side driver that chains the jitted phases with the two-pass allocation
protocol (SURVEY.md section 3.3-3.5): each data-dependent size crosses to
the host exactly once and the next phase runs at a power-of-two bucketed
capacity.  This mirrors the reference's three D2H size-feedback syncs
(_C_nnz at spgemm.cu:1169, pairs_count at :1246, C_nnz at :1291) while
keeping XLA recompilation bounded.

Phase naming follows the reference for benchmark parity:
  step1 = symbolic pair expansion + C tile structure (ref steps 1 + 2a)
  step2 = C masks / exact nnz / intra-tile coords   (ref steps 2b + 2c)
  step3 = numeric accumulation + value extraction    (ref step 3)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pem_spgemm.config import SpGEMMConfig, DEFAULT_CONFIG, \
    round_up_bucket, round_up_pow2
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.formats.tiled import TiledMatrix
from pem_spgemm.ops import symbolic, cstruct, numeric, assemble
from pem_spgemm.ops.convert import transpose_masks
from pem_spgemm.utils.timing import PhaseTimers


@dataclasses.dataclass
class SpGEMMResult:
    """C = A@B. Tiled engines fill the tile-form fields; the element engine
    fills direct COO coordinates instead."""

    vals: jax.Array         # (cap,) value dtype (tile-major or coo order)
    shape: tuple
    c_nnz: int              # true C nnz (structural, exact)
    n_pairs: int            # intermediate products (tile- or element-level)
    engine: str
    # tiled form (engine in {"fused", "masks"})
    c_tile_row: Optional[jax.Array] = None   # (c_cap,) i32
    c_tile_col: Optional[jax.Array] = None   # (c_cap,) i32
    cmask: Optional[jax.Array] = None        # (c_cap, 16) i32
    cptr: Optional[jax.Array] = None         # (c_cap+1,) i32 nnz scan
    rowcol: Optional[jax.Array] = None       # (c_nnz_cap,) i32
    elem_tile: Optional[jax.Array] = None    # (c_nnz_cap,) i32
    c_ntiles: int = 0                        # true C tile count
    # direct COO / stream form (engine == "element"), (row, col)-sorted;
    # when `first` is set the arrays are the flagged group stream and
    # to_coo compacts them (untimed assembly)
    rows: Optional[jax.Array] = None         # (c_cap,) i32
    cols: Optional[jax.Array] = None         # (c_cap,) i32
    first: Optional[jax.Array] = None        # (c_cap,) i32 group-start flags
    # bucketed stream form (engine == "element", production f32 path):
    # ops/binned.BinnedStream — padded per-C-row segments with group
    # totals at first-flagged slots
    binned: Optional[object] = None
    # macro form (engine == "macro"): dense 128x128 C tiles + counts
    c_counts: Optional[jax.Array] = None     # (c_cap, 128, 128) f32
    # dia form (engine == "dia"): vals = (dc, n) C band stack, c_counts =
    # (dc, n) structural counts, dia_dc = the static C diagonal offsets,
    # dia_kernel = whether ops/dia_kernel (not the XLA path) computed them
    dia_dc: Optional[tuple] = None
    dia_kernel: bool = False

    def to_coo(self) -> COOMatrix:
        """Assemble + sort to canonical global COO (host)."""
        n = self.c_nnz
        if self.engine == "dia":
            from pem_spgemm.ops.dia import dia_to_coo
            rows, cols, vals = dia_to_coo(self.vals, self.c_counts,
                                          self.dia_dc, self.shape, n)
            return COOMatrix(rows, cols, vals, self.shape)
        if self.binned is not None:
            rows, cols, vals = self.binned.to_coo_arrays()
            return COOMatrix(rows, cols, vals, self.shape)
        if self.engine == "macro":
            from pem_spgemm.ops.macro import assemble_macro_coo
            rows, cols, vals = assemble_macro_coo(
                self.c_tile_row, self.c_tile_col, self.vals, self.c_counts,
                n)
            return COOMatrix(rows, cols, vals, self.shape)
        if self.rows is not None:
            if self.first is not None:
                from pem_spgemm.ops.element import compact_stream
                r, c, v = compact_stream(self.rows, self.cols, self.vals,
                                         self.first)
                return COOMatrix(np.asarray(r)[:n], np.asarray(c)[:n],
                                 np.asarray(v)[:n], self.shape)
            return COOMatrix(np.asarray(self.rows)[:n],
                             np.asarray(self.cols)[:n],
                             np.asarray(self.vals)[:n], self.shape)
        rows, cols, vals = assemble.assemble_coo(
            self.c_tile_row, self.c_tile_col, self.rowcol, self.elem_tile,
            self.vals, jnp.int32(n))
        return COOMatrix(np.asarray(rows)[:n], np.asarray(cols)[:n],
                         np.asarray(vals)[:n], self.shape)


def _empty_result(shape, engine: str) -> "SpGEMMResult":
    """A structurally empty C.  The reference emits an empty COO result and
    still reports/benchmarks (its count kernels produce _C_nnz == 0 and the
    pipeline completes; spgemm.cu:1133-1357) — so an empty product is a
    result, not an error."""
    z32 = jnp.zeros((0,), jnp.int32)
    return SpGEMMResult(
        vals=jnp.zeros((0,), jnp.float32), shape=shape, c_nnz=0, n_pairs=0,
        engine=engine, rows=z32, cols=z32)


class SpGEMM:
    """C = A@B (or A@A.T) on Tile16 operands."""

    def __init__(self, config: SpGEMMConfig = DEFAULT_CONFIG):
        self.config = config

    def pick_engine(self, a: TiledMatrix, b: TiledMatrix) -> str:
        """Three-tier structural dispatch (the analog of the reference's
        NSPARSE fallback dispatch, spgemm.cu:1142): macro (dense 128x128
        matmuls) / fused (Tile16) / element."""
        cfg = self.config
        if cfg.engine != "auto":
            return cfg.engine
        fill_m = 0.5 * (a.macro_stats()[1] + b.macro_stats()[1])
        if fill_m >= cfg.macro_threshold:
            return "macro"
        fill = 0.5 * (a.fill_ratio() + b.fill_ratio())
        return "element" if fill < cfg.element_threshold else "fused"

    def __call__(self, a: TiledMatrix, b: TiledMatrix,
                 timers: Optional[PhaseTimers] = None) -> SpGEMMResult:
        cfg = self.config
        timers = timers if timers is not None else PhaseTimers()
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
        from pem_spgemm.formats.macro import MacroMatrix
        from pem_spgemm.formats.dia import DiaMatrix
        if isinstance(a, DiaMatrix):
            return self._dia(a, b, timers)
        if isinstance(a, MacroMatrix):
            return self._macro(a, b, timers)
        engine = self.pick_engine(a, b)
        if engine == "element":
            return self._element(a, b, timers)
        if engine == "macro":
            return self._macro(a, b, timers)
        cfg = cfg.with_(engine=engine)
        b_tmasks = None
        if cfg.engine == "masks":
            b_tmasks = b.tmasks if b.tmasks is not None \
                else transpose_masks(b.masks)

        # --- step 1: pair expansion + C tile structure (symbolic) ---
        with timers.phase("step1") as box:
            offsets = symbolic.pair_counts(
                a.tile_col, b.tile_rowptr, jnp.int32(a.ntiles))
            n_pairs = int(offsets[-1])            # D2H size feedback #1
            if n_pairs == 0:
                return _empty_result((a.shape[0], b.shape[1]), "fused")
            p_cap = max(cfg.numeric_chunk, round_up_pow2(n_pairs))
            from pem_spgemm.ops.scanops import can_pack
            packed = can_pack(a.n_tile_rows, b.n_tile_cols)
            c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c_dev = \
                symbolic.expand_pairs(
                    offsets, a.tile_row, a.tile_col, b.tile_rowptr,
                    b.tile_col, jnp.int32(n_pairs), p_cap, packed)
            c_ntiles = int(cnt_c_dev)             # D2H size feedback #2
            box["sync"] = c_tile_id

        c_cap = round_up_bucket(c_ntiles)
        if cfg.engine == "fused":
            # --- step 3 (accumulation) runs first: one chunked pass yields
            # both the numeric tiles and the exact structural pattern ---
            with timers.phase("step3") as box:
                a_flat = a.dense_flat()      # cached conversion product
                b_flat = a_flat if b is a else b.dense_flat()
                c_dense, c_counts = numeric.accumulate_fused_flat(
                    a_flat, b_flat, a_idx, b_idx, c_tile_id,
                    c_cap, cfg.numeric_chunk, cfg.acc(), cfg.precision)
                box["sync"] = c_dense

            # --- step 2: structure derivation + two-pass value alloc ---
            with timers.phase("step2") as box:
                c_tile_row, c_tile_col = cstruct.c_tile_coords(
                    c_tile_id, c_row, c_col, c_cap,
                    packed and a.n_tile_rows < (1 << 15))
                cmask, cptr = numeric.counts_to_masks(
                    c_counts.reshape(c_cap, 16, 16))
                c_nnz = int(cptr[-1])             # D2H size feedback #3
                box["sync"] = cmask
        else:  # "masks": standalone bitmask structure phase
            with timers.phase("step2") as box:
                c_tile_row, c_tile_col, cmask, cptr, _pair_ptr = \
                    cstruct.c_masks(a.masks, b_tmasks, a_idx, b_idx,
                                    c_tile_id, c_row, c_col, c_cap)
                c_nnz = int(cptr[-1])             # D2H size feedback #3
                box["sync"] = cmask

            with timers.phase("step3") as box:
                a_dense = numeric.densify_tiles(
                    a.vals, a.rowcol, a.elem_tile, a.tile_cap)
                b_dense = a_dense if b is a else numeric.densify_tiles(
                    b.vals, b.rowcol, b.elem_tile, b.tile_cap)
                c_dense = numeric.accumulate_dense(
                    a_dense, b_dense, a_idx, b_idx, c_tile_id,
                    c_cap, cfg.numeric_chunk, cfg.acc(), cfg.precision)
                box["sync"] = c_dense

        # Per-nnz derivation stays TIMED: the reference times the
        # equivalent work inside its repeat loop — step 2c builds
        # Ctiles_rowColIdx between the allocate_c events (spgemm.cu:
        # 1301-1308) and step 3 writes compressed Ctiles_vals directly
        # (spgemm.cu:1316-1335); only sanitize_C's COO emission is
        # untimed.
        c_nnz_cap = round_up_bucket(c_nnz)
        with timers.phase("step2") as box:      # ref step 2c
            c_rowcol, c_elem_tile = cstruct.c_rowcol(cmask, cptr, c_nnz_cap)
            box["sync"] = c_rowcol
        with timers.phase("step3") as box:      # ref step 3's compressed emit
            c_vals = numeric.extract_values(
                c_dense, c_rowcol, c_elem_tile).astype(cfg.dtype)
            box["sync"] = c_vals

        return SpGEMMResult(
            vals=c_vals, shape=(a.shape[0], b.shape[1]), c_nnz=c_nnz,
            n_pairs=n_pairs, engine=cfg.engine,
            c_tile_row=c_tile_row, c_tile_col=c_tile_col, cmask=cmask,
            cptr=cptr, rowcol=c_rowcol, elem_tile=c_elem_tile,
            c_ntiles=c_ntiles)

    def _macro(self, a: TiledMatrix, b: TiledMatrix,
               timers: PhaseTimers) -> SpGEMMResult:
        """Macro128 engine (ops/macro.py): dense 128x128 matmuls."""
        from pem_spgemm.formats.macro import MacroMatrix
        from pem_spgemm.ops import macro as M
        from pem_spgemm.ops.scanops import can_pack
        cfg = self.config
        am = a if isinstance(a, MacroMatrix) else a.macro()
        bm = am if b is a else (
            b if isinstance(b, MacroMatrix) else b.macro())

        with timers.phase("step1") as box:
            offsets = symbolic.pair_counts(
                am.tile_col, bm.tile_rowptr, jnp.int32(am.ntiles))
            n_pairs = int(offsets[-1])        # D2H size feedback #1
            if n_pairs == 0:
                return _empty_result((a.shape[0], b.shape[1]), "macro")
            chunk = cfg.macro_chunk
            p_cap = max(chunk, -(-n_pairs // chunk) * chunk)
            assert can_pack(am.n_macro_rows, bm.n_macro_cols)
            c_row, c_col, a_idx, b_idx, c_tile_id, cnt_c_dev = \
                symbolic.expand_pairs(
                    offsets, am.tile_row, am.tile_col, bm.tile_rowptr,
                    bm.tile_col, jnp.int32(n_pairs), p_cap, True)
            c_ntiles = int(cnt_c_dev)         # D2H size feedback #2
            box["sync"] = c_tile_id

        c_cap = max(256, -(-c_ntiles // 256) * 256)
        with timers.phase("step3") as box:
            c_dense, c_counts = M.accumulate_macro(
                am.dense, bm.dense, a_idx, b_idx, c_tile_id,
                c_cap, chunk, cfg.acc(), cfg.precision)
            box["sync"] = c_dense

        with timers.phase("step2") as box:
            c_tile_row, c_tile_col = cstruct.c_tile_coords(
                c_tile_id, c_row, c_col, c_cap,
                am.n_macro_rows < (1 << 15))
            cptr = M.macro_structure(c_counts)
            c_nnz = int(cptr[-1])             # D2H size feedback #3
            box["sync"] = cptr

        return SpGEMMResult(
            vals=c_dense, shape=(a.shape[0], b.shape[1]), c_nnz=c_nnz,
            n_pairs=n_pairs, engine="macro",
            c_tile_row=c_tile_row, c_tile_col=c_tile_col, cptr=cptr,
            c_counts=c_counts, c_ntiles=c_ntiles)

    def _dia(self, a, b, timers: PhaseTimers) -> SpGEMMResult:
        """DIA engine (ops/dia.py): SpGEMM over diagonal-band operands.

        The reference's three steps collapse (spgemm.cu:261-661 -> band
        offset algebra): step1 = the static offset-pair plan (host, us);
        step3 = the shifted-FMA multiply of values AND 0/1 masks; step2 =
        the exact-nnz reduce + its one D2H size feedback."""
        from pem_spgemm.ops import dia as D

        with timers.phase("step1"):
            plan = D.make_dia_plan(a, b)
            if not plan.dc_list:
                return _empty_result((a.shape[0], b.shape[1]), "dia")

        with timers.phase("step3") as box:
            out = plan.run(a, b)
            box["sync"] = out[1]

        with timers.phase("step2"):
            c_nnz = int(out[2])               # the one D2H size feedback

        return SpGEMMResult(
            vals=out[0], shape=(a.shape[0], b.shape[1]), c_nnz=c_nnz,
            n_pairs=len(plan.offs_a) * len(plan.offs_b), engine="dia",
            c_counts=out[1], dia_dc=plan.dc_list, dia_kernel=plan.kernel)

    def _element(self, a: TiledMatrix, b: TiledMatrix,
                 timers: PhaseTimers) -> SpGEMMResult:
        """Element-level engine: flop-proportional.

        Production f32 path: the binned batched-sort engine (ops/binned.py,
        the NSPARSE-binning analog).  The f64 parity mode routes through
        the merge-sort engine (ops/element.py), whose movement is dtype-
        agnostic sorts."""
        from pem_spgemm.ops import element
        cfg = self.config
        if (cfg.element_impl == "binned"
                and jnp.dtype(cfg.dtype) == jnp.dtype(jnp.float32)):
            return self._element_binned(a, b, timers)

        with timers.phase("step1") as box:
            b_rowptr, _b_rows, b_cols, b_vals = b.element_csr()
            a_rows, a_cols = a.element_coords()
            b_row_nnz = b_rowptr[1:] - b_rowptr[:-1]
            offsets = element.product_offsets(a_cols, b_row_nnz)
            n_products = int(offsets[-1])         # D2H size feedback #1
            if n_products == 0:
                return _empty_result((a.shape[0], b.shape[1]), "element")
            box["sync"] = offsets

        wide = jnp.dtype(cfg.dtype).itemsize > 4
        with timers.phase("step3") as box:
            # chunk-granular capacity: one compile per matrix either way,
            # and a pow2 bucket would pad every stream pass by up to 2x
            p_cap = max(cfg.numeric_chunk,
                        -(-n_products // cfg.numeric_chunk)
                        * cfg.numeric_chunk)
            if wide:
                # f64 parity mode: the merge pipeline moves value BITS as
                # int32 (f32 only); the gather-based expansion keeps the
                # native dtype end to end (double accumulation, matching
                # the reference's ValueType=double, spgemm.cu:728)
                ci, cj, cv, out_id, c_nnz_dev = \
                    element.expand_sorted_products(
                        offsets, a_rows, a_cols, a.vals, b_rowptr,
                        b_cols, b_vals, jnp.int32(n_products), p_cap)
                box["sync"] = cv
            else:
                rows, cols, vals, first, c_nnz_dev = \
                    element.expand_reduce_products(
                        offsets, a_rows, a_cols, a.vals, b_rowptr, b_cols,
                        b_vals, jnp.int32(n_products), p_cap)
                box["sync"] = vals

        with timers.phase("step2") as box:
            c_nnz = int(c_nnz_dev)                # D2H size feedback #2
            if wide:
                from pem_spgemm.config import round_up_bucket
                rows, cols, vals = element.reduce_products(
                    ci, cj, cv, out_id, round_up_bucket(max(1, c_nnz)))
                first = None
                box["sync"] = vals

        return SpGEMMResult(
            vals=vals.astype(cfg.dtype), shape=(a.shape[0], b.shape[1]),
            c_nnz=c_nnz, n_pairs=n_products, engine="element",
            rows=rows, cols=cols, first=first)

    def _element_binned(self, a: TiledMatrix, b: TiledMatrix,
                        timers: PhaseTimers) -> SpGEMMResult:
        """Binned element engine (ops/binned.py).  Phase mapping:
        step1 = chunk binning plan (reference NSPARSE bin setup,
        spgemm.cu:1144-1151); step3 = expansion + batched segment sorts +
        group reduction (fused numeric+structural, like the fused Tile16
        engine); step2 = exact-nnz reduce + D2H."""
        from pem_spgemm.ops import binned

        with timers.phase("step1") as box:
            plan = binned.build_plan_device(a, b)
            if plan.n_products == 0:
                return _empty_result((a.shape[0], b.shape[1]), "element")
            box["sync"] = plan.res_src

        with timers.phase("step3") as box:
            stream = binned.binned_multiply(plan)
            box["sync"] = (stream.bucket_vals[-1] if stream.bucket_vals
                           else stream.res[2])

        with timers.phase("step2"):
            c_nnz = int(stream.c_nnz)             # the one D2H feedback
            stream.c_nnz = c_nnz

        return SpGEMMResult(
            vals=stream.res[2], shape=(a.shape[0], b.shape[1]),
            c_nnz=c_nnz, n_pairs=plan.n_products, engine="element",
            binned=stream)
