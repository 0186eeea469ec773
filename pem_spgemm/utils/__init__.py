from pem_spgemm.utils.timing import PhaseTimers
from pem_spgemm.utils.flops import spgemm_flops, compression_ratio

__all__ = ["PhaseTimers", "spgemm_flops", "compression_ratio"]
