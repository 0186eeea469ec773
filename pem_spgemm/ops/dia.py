"""DIA engine: SpGEMM over diagonal-band operands (formats/dia.py).

The whole three-step pipeline of the reference (symbolic pair search,
structure generation, numeric accumulation — spgemm.cu:261-661) reduces,
for DIA operands, to one identity over band offsets:

    C[d1 + d2][i]  +=  A[d1][i] * B[d2][i + d1]

Every (A band, B band) pair contributes one shifted elementwise multiply;
the "symbolic phase" is a host loop over D1*D2 static offset pairs, and
the exact structural pattern is the same algebra run on the bands' 0/1
masks.  There are no gathers, sorts or scatters of elements anywhere:
the multiply is pure shifted vector FMA streams, with every shift a
compile-time constant.

Two execution paths, chosen by the plan:
  * XLA path (this module): a D1-step unrolled jit, each step one
    (D2, n) multiply + static row scatter-add.  Optimal when products
    are small-to-moderate (mid-fill regimes): traffic ~ products * 20B.
  * GPU kernel (ops/dia_kernel.py): each program keeps a block of C in
    registers and loops over the A bands; traffic ~ operands + C once.
    For wide-band stencils (dense offset ranges) where products >> C
    size; chosen by use_dia_kernel() from the platform, the offsets and
    the dtype (float32 only).

Structural dispatch (the analog of the reference's NSPARSE dispatch at
spgemm.cu:1142): detect_dia() censuses distinct diagonals on device; the
engine engages when the count is small enough that the band stacks fit
comfortably in HBM.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pem_spgemm.formats.dia import DiaMatrix

# Dispatch caps: D distinct diagonals, and total band-stack footprint
# (A + B + C values + C counts) in bytes.
MAX_BANDS = 512
MAX_BYTES = 6 << 30


# --------------------------------------------------------------------------
# Census + conversion

@partial(jax.jit, static_argnames=("n_rows", "n_cols"))
def _diag_census(rows, cols, n_rows, n_cols):
    """Packed presence bitmap over diagonal offsets (one small D2H).

    Offsets d = col - row live in [-(n_rows-1), n_cols-1]; the bitmap has
    bit (d + n_rows - 1) set iff any element lies on diagonal d.
    """
    span = n_rows + n_cols - 1
    idx = cols - rows + (n_rows - 1)
    hist = jnp.zeros(((span + 31) & ~31,), jnp.int32).at[idx].add(
        1, mode="drop")
    present = (hist > 0).astype(jnp.uint32).reshape(-1, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    return jnp.sum(present * weights, axis=1, dtype=jnp.uint32)


def diag_offsets(coo) -> np.ndarray:
    """Sorted distinct diagonal offsets of a COO matrix (device census)."""
    n_rows, n_cols = coo.shape
    packed = np.asarray(_diag_census(
        jnp.asarray(coo.rows, jnp.int32), jnp.asarray(coo.cols, jnp.int32),
        n_rows, n_cols))
    bits = np.unpackbits(packed.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64) - (n_rows - 1)


def detect_dia(coo, max_bands: int = MAX_BANDS,
               max_bytes: int = MAX_BYTES):
    """Return the sorted offsets array if the DIA engine should run,
    else None.  Cheap: one jitted histogram + a bitmap D2H.

    Refuses matrices carrying EXPLICIT ZERO entries: the band stacks
    encode structure as value != 0, so an explicit zero would be dropped
    from the structural pattern (the tiled engines keep it, matching the
    reference's presence-based bitmasks)."""
    offs = diag_offsets(coo)
    d = len(offs)
    if d == 0 or d > max_bands:
        return None
    n = coo.shape[0]
    sums = np.unique(offs[:, None] + offs[None, :])
    # A + B bands + C values + C counts, f32
    footprint = 4 * n * (2 * d + 2 * len(sums))
    if footprint > max_bytes:
        return None
    if bool(jnp.any(jnp.asarray(coo.vals) == 0)):
        return None
    return offs


@partial(jax.jit, static_argnames=("n_rows", "n_bands"))
def _fill_bands(rows, cols, vals, lut, n_rows, n_bands):
    k = lut[cols - rows]
    flat = jnp.zeros((n_bands * n_rows,), vals.dtype)
    flat = flat.at[k * n_rows + rows].set(vals, mode="drop")
    return flat.reshape(n_bands, n_rows)


def coo_to_dia(coo, dtype=jnp.float32, offsets=None,
               max_bands: int = MAX_BANDS):
    """COO -> DiaMatrix (device scatter).  Returns None if the diagonal
    census exceeds max_bands (caller falls back to another engine)."""
    if offsets is None:
        offsets = diag_offsets(coo)
        if len(offsets) > max_bands:
            return None
    offsets = np.asarray(offsets, np.int64)
    n_rows, n_cols = coo.shape
    lut_np = np.zeros(n_rows + n_cols, np.int32)      # index by d + n_rows
    lut_np[offsets + n_rows] = np.arange(len(offsets), dtype=np.int32)
    rows = jnp.asarray(coo.rows, jnp.int32)
    cols = jnp.asarray(coo.cols, jnp.int32)
    vals = jnp.asarray(coo.vals, dtype)
    bands = _fill_bands(rows, cols + jnp.int32(n_rows), vals,
                        jnp.asarray(lut_np), n_rows, len(offsets))
    return DiaMatrix(bands=bands, shape=coo.shape,
                     offsets=tuple(int(d) for d in offsets), nnz=coo.nnz)


# --------------------------------------------------------------------------
# Multiply (XLA path)

def _plan_maps(offs_a, offs_b):
    """Static (dc_list, idx_map): C offsets and, per A band, the C band
    index of each (d1, d2) product."""
    dc_list = sorted({da + db for da in offs_a for db in offs_b})
    pos = {dc: i for i, dc in enumerate(dc_list)}
    idx_map = tuple(tuple(pos[da + db] for db in offs_b) for da in offs_a)
    return tuple(dc_list), idx_map


# Above this many band-pair products the per-C-row static-sum graph gets
# too large to trace/compile; fall back to the row-scatter formulation.
_STACK_MAX_TERMS = 2048


@partial(jax.jit, static_argnames=("offs_a", "idx_map", "dc_count",
                                   "n_out", "values_only"))
def _dia_multiply_xla(a_bands, b_bands, *, offs_a, idx_map, dc_count,
                      n_out, values_only=False):
    """Unrolled band-pair accumulation.

    Two formulations, chosen by product count:
      * small (the mid-fill regimes): per-C-row STATIC sums — every term
        is a static slice multiply and every C row one fused elementwise
        sum; no scatters anywhere, XLA fuses each output row into one
        kernel.
      * large: D1 steps of one (D2, n) shifted multiply + static row
        scatter-add (bounded graph size; on a GPU the wide-stencil
        regimes take ops/dia_kernel instead).

    values_only=True skips the 0/1 mask algebra (the structural counts
    are static per plan; DiaPlan caches them after the first run).
    """
    n_i = a_bands.shape[1]
    n_k = b_bands.shape[1]
    d1_n, d2_n = a_bands.shape[0], b_bands.shape[0]
    pad_l = max(0, -min(offs_a))
    pad_r = max(0, n_i + max(offs_a) - n_k)
    bp = jnp.pad(b_bands, ((0, 0), (pad_l, pad_r)))
    bm = None if values_only else (bp != 0).astype(jnp.float32)
    am_all = None if values_only else (a_bands != 0).astype(jnp.float32)

    if d1_n * d2_n <= _STACK_MAX_TERMS:
        by_row = [[] for _ in range(dc_count)]
        for k1, d1 in enumerate(offs_a):
            for k2 in range(d2_n):
                by_row[idx_map[k1][k2]].append((k1, k2, pad_l + d1))
        c_rows, cnt_rows = [], []
        for terms in by_row:
            acc = jnp.zeros((n_out,), a_bands.dtype)
            macc = jnp.zeros((n_out,), jnp.float32)
            for k1, k2, s in terms:
                sl = jax.lax.slice(bp[k2], (s,), (s + n_out,))
                acc = acc + a_bands[k1, :n_out] * sl
                if not values_only:
                    slm = jax.lax.slice(bm[k2], (s,), (s + n_out,))
                    macc = macc + am_all[k1, :n_out] * slm
            c_rows.append(acc)
            cnt_rows.append(macc)
        return jnp.stack(c_rows), jnp.stack(cnt_rows)

    c = jnp.zeros((dc_count, n_out), a_bands.dtype)
    cnt = jnp.zeros((dc_count, n_out), jnp.float32)
    for k1, d1 in enumerate(offs_a):
        s = pad_l + d1
        sl = jax.lax.slice(bp, (0, s), (bp.shape[0], s + n_i))
        a_row = a_bands[k1][None, :]
        term = (a_row * sl)[:, :n_out]
        rows = jnp.asarray(idx_map[k1], jnp.int32)
        c = c.at[rows].add(term)
        if not values_only:
            slm = jax.lax.slice(bm, (0, s), (bm.shape[0], s + n_i))
            mterm = ((a_row != 0).astype(jnp.float32) * slm)[:, :n_out]
            cnt = cnt.at[rows].add(mterm)
    return c, cnt


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Fixed-step plan for the DIA engine.

    Everything is statically shaped (C band count and lengths derive from
    the offset sets alone), so there are no capacities to overflow and
    interactive == steady up to one D2H for c_nnz.

    The structural counts are a pure function of the operands' STRUCTURE:
    the first run computes values + counts, caches the count stack on the
    plan, and every later run executes the values-only kernel — half the
    FLOPs and half the C write traffic.  (The interactive pipeline builds
    a fresh plan per iteration, so its repeats keep full reference-parity
    structure recomputation; only the fixed-capacity replay reuses.)
    """

    offs_a: tuple
    offs_b: tuple
    dc_list: tuple
    idx_map: tuple
    n_out: int
    kernel: bool = False    # ops/dia_kernel instead of the XLA path

    def grown(self):
        return self

    def fence(self, out):
        return out[0]          # c_bands — counts may be plan-cached
                               # constants (never fence on a possibly
                               # precomputed leaf)

    def run(self, a: DiaMatrix, b: DiaMatrix):
        """(c_bands, c_counts, c_nnz_dev, overflow)."""
        cached = getattr(self, "_cnt_cache", None)
        if self.kernel:
            from pem_spgemm.ops.dia_kernel import dia_multiply_kernel
            c, cnt = dia_multiply_kernel(
                a.bands, b.bands, offs_a=self.offs_a, offs_b=self.offs_b,
                n_out=self.n_out, values_only=cached is not None)
        else:
            c, cnt = _dia_multiply_xla(
                a.bands, b.bands, offs_a=self.offs_a,
                idx_map=self.idx_map, dc_count=len(self.dc_list),
                n_out=self.n_out, values_only=cached is not None)
        if cached is not None:
            return c, cached[0], cached[1], jnp.zeros((), jnp.bool_)
        nnz = _count_nnz(cnt)
        object.__setattr__(self, "_cnt_cache", (cnt, nnz))
        return c, cnt, nnz, jnp.zeros((), jnp.bool_)


@jax.jit
def _count_nnz(cnt):
    return jnp.sum(cnt > 0, dtype=jnp.int64
                   if jax.config.jax_enable_x64 else jnp.int32)


def use_dia_kernel(offs_a, offs_b, dtype, platform: str) -> bool:
    """The GPU kernel (ops/dia_kernel.py) takes the regime where the XLA
    path scatter-adds into C once per A band (more than _STACK_MAX_TERMS
    band pairs), when both offset sets are dense ranges and the bands are
    float32 (the kernel computes in float32 only; other dtypes keep the
    XLA path's own precision); it beat the XLA path end to end on
    banded64-1M and banded128-1M (PERF.md)."""
    from pem_spgemm.ops.dia_kernel import is_range
    return (platform == "gpu" and np.dtype(dtype) == np.float32
            and is_range(offs_a) and is_range(offs_b)
            and len(offs_a) * len(offs_b) > _STACK_MAX_TERMS)


def make_dia_plan(a: DiaMatrix, b: DiaMatrix) -> DiaPlan:
    """Build the static plan (host; the step-1 analog — a pure offset-set
    computation, microseconds)."""
    dc_list, idx_map = _plan_maps(a.offsets, b.offsets)
    dtype = np.result_type(a.bands.dtype, b.bands.dtype)
    return DiaPlan(offs_a=a.offsets, offs_b=b.offsets, dc_list=dc_list,
                   idx_map=idx_map, n_out=a.shape[0],
                   kernel=use_dia_kernel(a.offsets, b.offsets, dtype,
                                         jax.devices()[0].platform))


# --------------------------------------------------------------------------
# Assembly (untimed, the sanitize_C analog)

def dia_to_coo(c_bands, c_counts, dc_list, shape, c_nnz=None):
    """C band stacks -> sorted global COO triplets (host numpy)."""
    cb = np.asarray(c_bands)
    cm = np.asarray(c_counts) > 0
    n_rows, n_cols = shape
    dcs = np.asarray(dc_list, np.int64)
    k_idx, i_idx = np.nonzero(cm)
    rows = i_idx.astype(np.int64)
    cols = rows + dcs[k_idx]
    keep = (cols >= 0) & (cols < n_cols) & (rows < n_rows)
    rows, cols, k_idx, i_idx = (x[keep] for x in
                                (rows, cols, k_idx, i_idx))
    vals = cb[k_idx, i_idx]
    order = np.lexsort((cols, rows))
    if c_nnz is not None:
        assert len(rows) == int(c_nnz), (len(rows), int(c_nnz))
    return rows[order], cols[order], vals[order]
