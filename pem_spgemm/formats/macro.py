"""Macro128 — the dense 128x128 macro-tile format for matmul-bound SpGEMM.

The reference's 16x16 tile is sized for one warp (uint16 row bitmasks,
spgemm.cu:727).  For matrices whose occupied 128x128 blocks are reasonably
filled (stencils, banded systems, block-dense graphs), the numeric phase
runs as batched dense 128x128 matmuls instead of per-16x16 pair
machinery: gathers move contiguous 64KB tiles, the matmul is a dense
batched GEMM, and the exact structural pattern falls out of a parallel
0/1 matmul.

This is one tier of the engine hierarchy (macro / tile16-fused / element),
the analog of the reference's structural dispatch to its NSPARSE fallback
(spgemm.cu:1142).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MacroMatrix:
    """A sparse matrix as dense 128x128 macro tiles (only occupied ones).

    Arrays are padded to ``tile_cap`` (= len(tile_row)); ``dense`` has one
    extra all-zero tile at index tile_cap for padding pairs.
    """

    tile_row: jax.Array      # (cap,) i32; padding = n_macro_rows sentinel
    tile_col: jax.Array      # (cap,) i32; padding = n_macro_cols sentinel
    tile_rowptr: jax.Array   # (n_macro_rows+1,) i32 CSR over macro tiles
    dense: jax.Array         # (cap+1, 128, 128) value dtype
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    ntiles: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def tile_cap(self) -> int:
        return int(self.tile_row.shape[0])

    @property
    def n_macro_rows(self) -> int:
        return cdiv(self.shape[0], 128)

    @property
    def n_macro_cols(self) -> int:
        return cdiv(self.shape[1], 128)

    def fill_ratio(self) -> float:
        """Mean nonzeros per occupied macro tile (dispatch statistic)."""
        return self.nnz / max(1, self.ntiles)
