from pem_spgemm.ops.convert import coo_to_tiled
from pem_spgemm.ops.spgemm import SpGEMM, SpGEMMResult

__all__ = ["coo_to_tiled", "SpGEMM", "SpGEMMResult"]
