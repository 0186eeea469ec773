from pem_spgemm.bench.harness import run_benchmark

__all__ = ["run_benchmark"]
