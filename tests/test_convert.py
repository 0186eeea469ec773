"""Conversion: COO -> Tile16 round-trip and structural invariants."""

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import random_sparse
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.ops.convert import coo_to_tiled, transpose_masks


def _tiled(m, **kw):
    return coo_to_tiled(COOMatrix.from_scipy(m), **kw)


@pytest.mark.parametrize("shape,density,seed", [
    ((64, 64), 0.05, 0), ((1000, 1000), 0.002, 1),
    ((333, 777), 0.01, 2), ((17, 4000), 0.01, 3), ((1, 1), 1.0, 4),
])
def test_round_trip(shape, density, seed):
    m = random_sparse(*shape, density, seed)
    t = _tiled(m)
    rows, cols, vals = t.to_coo_numpy()
    got = sp.coo_matrix((vals, (rows, cols)), shape=shape)
    ref = m.astype(np.float32)
    assert (abs(got - ref) > 1e-6).nnz == 0
    assert t.nnz == m.nnz


def test_tile_census_and_masks():
    m = random_sparse(256, 256, 0.02, seed=7)
    t = _tiled(m)
    dense = m.toarray() != 0
    # Recompute tile structure on the host.
    want_tiles = {}
    for r, c in zip(*np.nonzero(dense)):
        key = (r // 16, c // 16)
        want_tiles.setdefault(key, np.zeros(16, np.int64))
        want_tiles[key][r % 16] |= 1 << (c % 16)
    keys = sorted(want_tiles)
    assert t.ntiles == len(keys)
    tr = np.asarray(t.tile_row)[:t.ntiles]
    tc = np.asarray(t.tile_col)[:t.ntiles]
    assert [(int(a), int(b)) for a, b in zip(tr, tc)] == keys
    masks = np.asarray(t.masks)[:t.ntiles]
    for i, key in enumerate(keys):
        assert (masks[i] == want_tiles[key]).all(), key
    # per-tile nnz pointers
    ptr = np.asarray(t.ptr)
    per_tile = ptr[1:t.ntiles + 1] - ptr[:t.ntiles]
    for i, key in enumerate(keys):
        assert per_tile[i] == int(np.sum([bin(int(x)).count("1")
                                          for x in want_tiles[key]]))
    # padded tiles carry nothing
    assert (ptr[t.ntiles:] == m.nnz).all()
    assert (np.asarray(t.masks)[t.ntiles:] == 0).all()


def test_high_level_csr():
    m = random_sparse(500, 300, 0.01, seed=11)
    t = _tiled(m)
    tr = np.asarray(t.tile_row)[:t.ntiles]
    rowptr = np.asarray(t.tile_rowptr)
    counts = np.bincount(tr, minlength=t.n_tile_rows)
    assert (rowptr == np.concatenate([[0], np.cumsum(counts)])).all()


def test_transpose_masks():
    rs = np.random.default_rng(3)
    masks = rs.integers(0, 1 << 16, size=(40, 16)).astype(np.int32)
    got = np.asarray(transpose_masks(masks))
    want = np.zeros_like(masks)
    for t in range(masks.shape[0]):
        for c in range(16):
            v = 0
            for r in range(16):
                if (int(masks[t, r]) >> c) & 1:
                    v |= 1 << r
            want[t, c] = v
    assert (got == want).all()


def test_intra_rowptr():
    m = random_sparse(128, 128, 0.05, seed=5)
    t = _tiled(m)
    rp = np.asarray(t.intra_rowptr())[:t.ntiles]
    masks = np.asarray(t.masks)[:t.ntiles]
    pc = np.array([[bin(int(x)).count("1") for x in row] for row in masks])
    want = np.concatenate(
        [np.zeros((len(pc), 1), int), np.cumsum(pc, axis=1)], axis=1)
    assert (rp == want).all()


def test_elements_in_tile_major_csr_order():
    m = random_sparse(200, 200, 0.03, seed=9)
    t = _tiled(m)
    et = np.asarray(t.elem_tile)
    rc = np.asarray(t.rowcol)
    order = np.lexsort((rc, et))
    assert (order == np.arange(len(order))).all()


def test_duplicate_coordinates_rejected():
    import pytest as _pytest
    c = COOMatrix(np.array([0, 0, 1]), np.array([0, 0, 1]),
                  np.array([1.0, 2.0, 3.0]), (2, 2))
    with _pytest.raises(ValueError, match="duplicate"):
        coo_to_tiled(c)
    t = coo_to_tiled(c.sum_duplicates())
    assert t.nnz == 2
