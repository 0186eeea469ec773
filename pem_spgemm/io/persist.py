"""Persist converted tiled formats to disk (SURVEY.md §5: checkpoint).

The reference re-runs its GPU conversion on every invocation; converted
formats here are first-class artifacts that can be saved once and
reloaded instantly — the checkpoint/resume analog for a benchmark/serving
pipeline whose expensive inputs are the converted operands.

Format: a single .npz per matrix (numpy archive) holding every array
field plus the static metadata.  Loaders return device-resident objects.

    save_tiled("a.tile16.npz", tiled)
    tiled = load_tiled("a.tile16.npz")
    save_macro("a.macro.npz", macro)
    macro = load_macro("a.macro.npz")
"""

from __future__ import annotations

import numpy as np

_MAGIC_TILED = "pem-spgemm/tile16/v1"
_MAGIC_MACRO = "pem-spgemm/macro128/v1"


def save_tiled(path: str, t) -> None:
    """Write a TiledMatrix to an .npz archive."""
    np.savez_compressed(
        path,
        magic=np.asarray(_MAGIC_TILED),
        shape=np.asarray(t.shape, np.int64),
        ntiles=np.asarray(t.ntiles, np.int64),
        tile_row=np.asarray(t.tile_row),
        tile_col=np.asarray(t.tile_col),
        ptr=np.asarray(t.ptr),
        masks=np.asarray(t.masks),
        vals=np.asarray(t.vals),
        rowcol=np.asarray(t.rowcol),
        elem_tile=np.asarray(t.elem_tile),
        tile_rowptr=np.asarray(t.tile_rowptr),
        tmasks=(np.asarray(t.tmasks) if t.tmasks is not None
                else np.zeros((0,), np.int32)),
    )


def load_tiled(path: str):
    """Load a TiledMatrix saved by save_tiled (arrays go to device)."""
    import jax.numpy as jnp
    from pem_spgemm.formats.tiled import TiledMatrix
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != _MAGIC_TILED:
        raise ValueError(f"{path}: not a {_MAGIC_TILED} archive")
    tm = z["tmasks"]
    return TiledMatrix(
        tile_row=jnp.asarray(z["tile_row"]),
        tile_col=jnp.asarray(z["tile_col"]),
        ptr=jnp.asarray(z["ptr"]),
        masks=jnp.asarray(z["masks"]),
        vals=jnp.asarray(z["vals"]),
        rowcol=jnp.asarray(z["rowcol"]),
        elem_tile=jnp.asarray(z["elem_tile"]),
        tile_rowptr=jnp.asarray(z["tile_rowptr"]),
        tmasks=jnp.asarray(tm) if tm.size else None,
        shape=tuple(int(x) for x in z["shape"]),
        ntiles=int(z["ntiles"]),
    )


def save_macro(path: str, m) -> None:
    """Write a MacroMatrix to an .npz archive."""
    np.savez_compressed(
        path,
        magic=np.asarray(_MAGIC_MACRO),
        shape=np.asarray(m.shape, np.int64),
        ntiles=np.asarray(m.ntiles, np.int64),
        nnz=np.asarray(m.nnz, np.int64),
        tile_row=np.asarray(m.tile_row),
        tile_col=np.asarray(m.tile_col),
        tile_rowptr=np.asarray(m.tile_rowptr),
        dense=np.asarray(m.dense),
    )


def load_macro(path: str):
    """Load a MacroMatrix saved by save_macro (arrays go to device)."""
    import jax.numpy as jnp
    from pem_spgemm.formats.macro import MacroMatrix
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != _MAGIC_MACRO:
        raise ValueError(f"{path}: not a {_MAGIC_MACRO} archive")
    return MacroMatrix(
        tile_row=jnp.asarray(z["tile_row"]),
        tile_col=jnp.asarray(z["tile_col"]),
        tile_rowptr=jnp.asarray(z["tile_rowptr"]),
        dense=jnp.asarray(z["dense"]),
        shape=tuple(int(x) for x in z["shape"]),
        ntiles=int(z["ntiles"]),
        nnz=int(z["nnz"]),
    )


_MAGIC_DIA = "pem-spgemm/dia/v1"


def save_dia(path: str, d) -> None:
    """Persist a DiaMatrix (band stack + static offsets)."""
    np.savez_compressed(
        path,
        magic=np.asarray(_MAGIC_DIA),
        bands=np.asarray(d.bands),
        offsets=np.asarray(d.offsets, np.int64),
        shape=np.asarray(d.shape, np.int64),
        nnz=np.asarray(d.nnz, np.int64),
    )


def load_dia(path: str):
    """Load a DiaMatrix persisted by save_dia (device-resident)."""
    import jax.numpy as jnp
    from pem_spgemm.formats.dia import DiaMatrix
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != _MAGIC_DIA:
        raise ValueError(f"{path}: not a {_MAGIC_DIA} archive")
    return DiaMatrix(
        bands=jnp.asarray(z["bands"]),
        shape=tuple(int(x) for x in z["shape"]),
        offsets=tuple(int(x) for x in z["offsets"]),
        nnz=int(z["nnz"]),
    )
