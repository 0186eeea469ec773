"""DIA — the diagonal-band format for stencil/banded structure.

The reference handles banded matrices through its general 16x16-tile
machinery (spgemm.cu:499-661): tile-pair search, bitmask intersection,
popc-indexed FMAs, whose per-pair indexing — not FLOPs — bounds
throughput.  But when a matrix's nonzeros live on a small
set of diagonals, SpGEMM collapses into pure vector algebra with NO
structure handling at all:

    C[d1 + d2][i]  +=  A[d1][i] * B[d2][i + d1]

— for every pair of bands (d1 of A, d2 of B), one shifted elementwise
multiply of length n.  No gathers, no sorts, no per-tile anything: the
exact operation streams at memory speed, and the structural pattern
falls out of running the band 0/1 masks through the same algebra.  This
is the answer to the reference's best-case regimes (its
banded/stencil benchmarks), a classic sparse format (DIA) as a fourth
engine tier: dia / macro / fused / element, dispatched structurally like
the reference's NSPARSE fallback (spgemm.cu:1142).

Bands are stored ROW-ALIGNED: bands[k][i] = M[i, i + offsets[k]], zero
outside the valid range i in [max(0, -d), n - max(0, d)).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DiaMatrix:
    """A sparse matrix as a dense stack of diagonal bands.

    ``offsets`` is static host metadata (a sorted tuple of int diagonal
    offsets, col - row); ``bands`` is the (D, n) device value stack.
    Only square-ish shapes where every nonzero lies on one of D diagonals
    are representable; the converter (ops/dia.coo_to_dia) rejects inputs
    whose diagonal census exceeds the cap.
    """

    bands: jax.Array     # (D, n) value dtype, row-aligned
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return int(self.bands.shape[1])

    @property
    def nbands(self) -> int:
        return len(self.offsets)

    def to_coo_numpy(self):
        """Round-trip to COO triplets (host; tests/debug)."""
        bands = np.asarray(self.bands)
        rows_l, cols_l, vals_l = [], [], []
        n_rows, n_cols = self.shape
        for k, d in enumerate(self.offsets):
            lo = max(0, -d)
            hi = min(n_rows, n_cols - d)
            i = np.arange(lo, hi)
            v = bands[k, lo:hi]
            nz = v != 0
            rows_l.append(i[nz])
            cols_l.append(i[nz] + d)
            vals_l.append(v[nz])
        rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
        cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
        vals = np.concatenate(vals_l) if vals_l else np.zeros(0)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]
