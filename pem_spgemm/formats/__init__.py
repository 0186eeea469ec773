from pem_spgemm.formats.coo import COOMatrix
from pem_spgemm.formats.tiled import TiledMatrix

__all__ = ["COOMatrix", "TiledMatrix"]
