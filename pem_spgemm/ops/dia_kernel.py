"""GPU kernel for the DIA engine's wide-stencil regime (Pallas, Triton route).

For DIA operands whose A and B offsets are both dense integer ranges
(stencils: banded64, banded128), C band r = k1 + k2 collects

    C[r][i] = sum_k1  A[k1][i] * B[r - k1][i + a0 + k1]

The XLA path (ops/dia._dia_multiply_xla) runs one (D2, n) scatter-add into
C per A band, so C is read and written D1 times: ~200 GB of traffic on
banded128-1M.  This kernel gives each program one (R C rows x L columns)
block of C, held in registers for the whole reduction, and loops over the
A bands inside the program.  For A band k1 it loads the L-wide A row slice
and the R x L block of B rows [r0 - k1, r0 - k1 + R) shifted by k1
columns; consecutive k1 shift that block by one row and one column, so
most of it is already in L1/L2.  Device memory then sees each operand a
few times and C once.

B's band stack is padded with R zero rows above and below, and A and B
with zero columns, so that no load needs a mask: out-of-range rows and
columns contribute exact zeros, as in the XLA path.  The loop over k1
runs only over the A bands whose B rows meet the block.

The block sums in the same order as the XLA path (ascending k1), and the
structural counts are the same 0/1 algebra, so both paths agree to the
last bit up to FMA contraction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_ROWS = 32         # R: C band rows per program
BLOCK_COLS = 256        # L: columns per program
NUM_WARPS = 8
NUM_STAGES = 2


def is_range(offs) -> bool:
    """True when the offsets are one dense integer range."""
    return len(offs) > 0 and max(offs) - min(offs) + 1 == len(offs)


def _kernel(a_ref, b_ref, *out_refs, d1, d2, rows, cols, with_counts):
    j = pl.program_id(0)                 # column block
    g = pl.program_id(1)                 # C row block
    i0 = j * cols
    r0 = g * rows
    # A bands whose B rows r - k1 (r in the block) meet [0, d2)
    lo = jnp.maximum(0, r0 - d2 + 1)
    hi = jnp.minimum(d1, r0 + rows)

    def body(k1, carry):
        a = plgpu.load(a_ref.at[k1, pl.ds(i0, cols)])
        # padded B row of band r - k1 is r - k1 + rows; column i + k1
        b = plgpu.load(b_ref.at[pl.ds(r0 - k1 + rows, rows),
                                pl.ds(i0 + k1, cols)])
        acc = carry[0] + a[None, :] * b
        if not with_counts:
            return (acc,)
        am = (a != 0).astype(jnp.float32)
        bm = (b != 0).astype(jnp.float32)
        return acc, carry[1] + am[None, :] * bm

    zero = jnp.zeros((rows, cols), jnp.float32)
    init = (zero, zero) if with_counts else (zero,)
    out = jax.lax.fori_loop(lo, hi, body, init)
    for ref, val in zip(out_refs, out):
        plgpu.store(ref.at[pl.ds(r0, rows), pl.ds(i0, cols)], val)


@functools.partial(jax.jit, static_argnames=(
    "offs_a", "offs_b", "n_out", "values_only", "rows", "cols",
    "interpret"))
def dia_multiply_kernel(a_bands, b_bands, *, offs_a, offs_b, n_out,
                        values_only=False, rows=BLOCK_ROWS,
                        cols=BLOCK_COLS, interpret=False):
    """(c_bands, c_counts) over the dense C offset range
    [min(offs_a) + min(offs_b), max(offs_a) + max(offs_b)], the same
    contract as ops/dia._dia_multiply_xla; c_counts is None with
    values_only=True.  float32 bands only: the kernel accumulates in
    float32.  `rows` x `cols` is the C block per program (smaller blocks
    keep interpret-mode tests fast)."""
    assert is_range(offs_a) and is_range(offs_b), (offs_a, offs_b)
    assert a_bands.dtype == b_bands.dtype == jnp.float32, (
        a_bands.dtype, b_bands.dtype)
    d1, n_i = a_bands.shape
    d2, n_k = b_bands.shape
    dc = d1 + d2 - 1
    a0 = min(offs_a)
    n_pad = pl.cdiv(n_out, cols) * cols
    dc_pad = pl.cdiv(dc, rows) * rows
    # B column of (C column i, A band k1) is i + a0 + k1: lay B out so
    # that padded column i + k1 holds it (zeros outside [0, n_k))
    pad_l = max(0, -a0)
    start = a0 + pad_l
    width = n_pad + d1 - 1
    ap = jnp.pad(a_bands, ((0, 0), (0, max(0, n_pad - n_i))))[:, :n_pad]
    bp = jnp.pad(b_bands,
                 ((rows, rows),
                  (pad_l, max(0, start + width - pad_l - n_k))))
    bp = bp[:, start:start + width]
    n_outs = 1 if values_only else 2
    kernel = functools.partial(_kernel, d1=d1, d2=d2, rows=rows, cols=cols,
                               with_counts=not values_only)
    whole = lambda x: pl.BlockSpec(x.shape, lambda j, g: (0, 0))
    out = pl.pallas_call(
        kernel,
        grid=(n_pad // cols, dc_pad // rows),
        in_specs=[whole(ap), whole(bp)],
        out_specs=tuple(pl.BlockSpec((dc_pad, n_pad), lambda j, g: (0, 0))
                        for _ in range(n_outs)),
        out_shape=tuple(jax.ShapeDtypeStruct((dc_pad, n_pad), jnp.float32)
                        for _ in range(n_outs)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="dia_stencil",
    )(ap, bp)
    c = out[0][:dc, :n_out]
    if values_only:
        return c, None
    return c, out[1][:dc, :n_out]
