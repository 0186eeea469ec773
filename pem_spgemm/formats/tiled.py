"""The Tile16 bitmask-tiled sparse format — the framework's central structure.

Re-design of the reference's tiled-CSR bundle (SURVEY.md section
2.1; built at spgemm.cu:840-1062).  Logical content is identical — per-tile
16-bit row bitmasks, tile-major CSR-ordered values, packed intra-tile
coordinates, a CSR over tiles — but the layout is flat int32/float arrays
(XLA-friendly; no uint8/uint16 packing games) and every data-dependent
dimension is padded to a bucketed capacity so jitted phases see static shapes.

Differences from the reference, by design:
  * no per-tile uint8 rowPtr array (reference tiles_rowPtr, spgemm.cu:205-209)
    — it is recomputed from mask popcounts in O(16) vector ops when needed;
  * no high-level CSC of B (reference spgemm.cu:1033-1062) — the symbolic
    phase here joins A's tile-columns against B's tile-row CSR directly, so
    the CSC + tileOffsets permutation machinery is unnecessary;
  * an explicit per-element tile index (elem_tile) kept from the conversion
    sort, which replaces pointer-chasing when densifying tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TiledMatrix:
    """A sparse matrix in Tile16 form. See module docstring.

    Array fields are JAX arrays; ``ntiles``/``nnz``/``shape`` are static
    Python metadata (pytree aux data). Arrays are padded:
    tile arrays to ``tile_cap`` (= len(tile_row)); element arrays are exact
    length nnz (input size is static per matrix).

    INVARIANT — treat instances as immutable after construction.  Derived
    conversion products (element_csr, macro, dense_flat, the binned chunk
    table) are cached on the instance via object.__setattr__; these caches
    are invisible to JAX transforms and are NOT invalidated if a field is
    rebuilt in place.  To change values or structure, build a new
    TiledMatrix (dataclasses.replace drops no caches either — reconvert
    from COO instead).
    """

    # --- per-tile arrays, padded to tile_cap ---
    tile_row: jax.Array   # (cap,) i32; padded entries = n_tile_rows sentinel
    tile_col: jax.Array   # (cap,) i32; padded entries = n_tile_cols sentinel
    ptr: jax.Array        # (cap+1,) i32 exclusive scan of per-tile nnz
    masks: jax.Array      # (cap, 16) i32; row bitmaps, bit j = col j occupied

    # --- per-element arrays, tile-major CSR order, length nnz ---
    vals: jax.Array       # (nnz,) value dtype
    rowcol: jax.Array     # (nnz,) i32 packed (row<<4)|col intra-tile coords
    elem_tile: jax.Array  # (nnz,) i32 owning tile index

    # --- high-level CSR over tiles ---
    tile_rowptr: jax.Array  # (n_tile_rows+1,) i32

    # --- optional: per-tile bit-transposed masks (built for B operands) ---
    tmasks: Optional[jax.Array]  # (cap, 16) i32; column bitmaps, bit i = row i

    # --- static metadata ---
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    ntiles: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def tile_cap(self) -> int:
        return int(self.tile_row.shape[0])

    @property
    def n_tile_rows(self) -> int:
        return cdiv(self.shape[0], 16)

    @property
    def n_tile_cols(self) -> int:
        return cdiv(self.shape[1], 16)

    def block_until_ready(self) -> "TiledMatrix":
        jax.block_until_ready(self.masks)
        return self

    # ---- host-side reconstruction (tests / debugging) ----

    def to_coo_numpy(self):
        """Round-trip back to global COO triplets (host numpy)."""
        et = np.asarray(self.elem_tile)
        rc = np.asarray(self.rowcol)
        tr = np.asarray(self.tile_row)[et]
        tc = np.asarray(self.tile_col)[et]
        rows = tr * 16 + (rc >> 4)
        cols = tc * 16 + (rc & 15)
        return rows.astype(np.int64), cols.astype(np.int64), np.asarray(self.vals)

    def element_coords(self):
        """Global (row, col) arrays of all elements (device, jitted)."""
        from pem_spgemm.ops.element import element_coords
        return element_coords(self.tile_row, self.tile_col, self.elem_tile,
                              self.rowcol)

    def element_csr(self):
        """Cached row-sorted element CSR (rowptr, rows, cols, vals).

        Built once per matrix, like the reference's element CSR during
        conversion (spgemm.cu:894-928); used by the element-level engine.
        """
        cached = getattr(self, "_ecsr_cache", None)
        if cached is None:
            from pem_spgemm.ops.element import build_element_csr
            cached = build_element_csr(self.tile_row, self.tile_col,
                                       self.elem_tile, self.rowcol,
                                       self.vals, self.shape[0])
            object.__setattr__(self, "_ecsr_cache", cached)
        return cached

    def fill_ratio(self) -> float:
        """Mean nonzeros per occupied tile (engine-dispatch statistic)."""
        return self.nnz / max(1, self.ntiles)

    def macro(self):
        """Cached Macro128 form of this matrix (formats/macro.py), built
        from the tiled elements on device — a conversion-time product like
        dense_flat()."""
        cached = getattr(self, "_macro_cache", None)
        if cached is None:
            from pem_spgemm.ops.convert import tiled_to_macro
            cached = tiled_to_macro(self)
            object.__setattr__(self, "_macro_cache", cached)
        return cached

    def macro_stats(self):
        """(occupied macro tiles, nnz per macro tile) without converting."""
        cached = getattr(self, "_macro_stats", None)
        if cached is None:
            import numpy as np
            tr = np.asarray(self.tile_row)[:self.ntiles] >> 3
            tc = np.asarray(self.tile_col)[:self.ntiles] >> 3
            nt = len(np.unique(tr.astype(np.int64) * (self.n_tile_cols + 1)
                               + tc))
            cached = (nt, self.nnz / max(1, nt))
            object.__setattr__(self, "_macro_stats", cached)
        return cached

    def dense_flat(self) -> jax.Array:
        """Cached dense value tiles, flat (tile_cap + 1, 2, 128) layout.

        Part of the converted format (built once per matrix, like the
        reference's conversion outputs): the numeric engines consume tiles
        as dense 1KB rows.  Row tile_cap is all-zero (padding-pair target).
        The flat last-dims (2, 128) keep the HBM layout dense — a
        (T, 16, 16) f32 array would be lane-padded to (T, 16, 128), an 8x
        memory and gather-traffic blowup.
        """
        cached = getattr(self, "_dense_cache", None)
        if cached is None:
            from pem_spgemm.ops.numeric import densify_tiles_flat
            cached = densify_tiles_flat(self.vals, self.rowcol,
                                        self.elem_tile, self.tile_cap)
            object.__setattr__(self, "_dense_cache", cached)
        return cached

    def intra_rowptr(self) -> jax.Array:
        """Per-tile intra-tile CSR row pointers, (cap, 17) i32.

        Recomputed from mask popcounts (replaces the reference's stored
        tiles_rowPtr, spgemm.cu:205-209).
        """
        pc = jax.lax.population_count(self.masks)
        return jnp.concatenate(
            [jnp.zeros((self.masks.shape[0], 1), jnp.int32),
             jnp.cumsum(pc, axis=1, dtype=jnp.int32)], axis=1)
