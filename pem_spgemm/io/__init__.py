from pem_spgemm.io.mtx import read_matrix_market, write_matrix_market

__all__ = ["read_matrix_market", "write_matrix_market"]
