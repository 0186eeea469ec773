"""pem_spgemm — a tiled sparse matrix-matrix product framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
CUDA code ``stckvrflw/pem-spgemm`` (an improved TileSpGEMM): native
MatrixMarket ingestion, device-side conversion to a 16x16 bitmask-tiled CSR
format, a symbolic phase (tile-pair matching + exact per-tile nnz), an
atomic-free numeric phase with two-pass exact allocation, COO result assembly
for ``C = A@A`` and ``C = A@A.T``, a benchmark harness with per-phase timing
and CSV parity, and multi-device scaling over ``jax.sharding`` meshes.

The design is XLA-first (see SURVEY.md section 7): ragged structure is kept as
dense arrays + offsets; every data-dependent size crosses to the host once via
a count pass and is padded to a bucket so XLA sees a small, cached set of
static shapes; per-tile compute is expressed as vector bit-math and batched
16x16 matmuls rather than warp intrinsics.
"""

from pem_spgemm.config import SpGEMMConfig
from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.formats.tiled import TiledMatrix
from pem_spgemm.ops.convert import coo_to_tiled
from pem_spgemm.ops.spgemm import SpGEMM, SpGEMMResult
from pem_spgemm.io.mtx import read_matrix_market

__version__ = "0.1.0"

__all__ = [
    "SpGEMMConfig",
    "COOMatrix",
    "TiledMatrix",
    "coo_to_tiled",
    "SpGEMM",
    "SpGEMMResult",
    "read_matrix_market",
]
