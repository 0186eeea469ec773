"""CLI driver: the analog of the reference's ./pemspgemm binary.

Reference usage (README.md:39-45):  pemspgemm <path.mtx> <0|1 save> [1=A*At]
Ours keeps those positionals and adds flags for the knobs the reference
bakes in at compile time:

  python -m pem_spgemm.bench.cli <matrix> <0|1 save> [1]
         [--repeat N] [--warmup N] [--fastest] [--dtype f32|f64]
         [--csv PATH] [--outdir DIR]

<matrix> is a .mtx path or a synthetic spec like 'power_law:n=1000000,nnz=3000000'
(see models/synthetic.by_name).  With save=1 the sorted COO result is dumped
in the reference's four-file layout (spgemm.cu:1527-1560), by default in the
temporary directory (TMPDIR, else /tmp — the reference's own location).
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser(prog="pem-spgemm", description=__doc__)
    p.add_argument("matrix", help=".mtx path or synthetic spec family:k=v,...")
    p.add_argument("save", type=int, choices=(0, 1),
                   help="1 = dump COO result files")
    p.add_argument("aat", nargs="?", type=int, default=0, choices=(0, 1),
                   help="1 = compute A@A.T instead of A@A")
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--fastest", action="store_true",
                   help="report min across repeats (reference -DFASTEST)")
    p.add_argument("--dtype", default="f32", choices=("f32", "f64", "bf16"))
    p.add_argument("--csv", default="pemspgemm_benchmark_result.csv")
    p.add_argument("--no-csv", action="store_true")
    p.add_argument("--outdir", default=tempfile.gettempdir(),
                   help="directory for result dumps with save=1")
    p.add_argument("--save-converted", metavar="PATH",
                   help="persist the converted A operand (.npz; Tile16 or "
                        "Macro128 by engine) for instant reload")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "element", "fused", "masks", "macro"))
    args = p.parse_args(argv)

    from pem_spgemm.config import SpGEMMConfig
    from pem_spgemm.bench.harness import run_benchmark
    from pem_spgemm.io.mtx import read_matrix_market, save_result_files
    from pem_spgemm.models.synthetic import by_name

    dtype = {"f32": jnp.float32, "f64": jnp.float64,
             "bf16": jnp.bfloat16}[args.dtype]
    if args.dtype == "f64":
        import jax
        jax.config.update("jax_enable_x64", True)

    if args.matrix.endswith(".mtx"):
        coo = read_matrix_market(args.matrix).sum_duplicates()
    else:
        coo = by_name(args.matrix)
    if args.aat == 0 and coo.shape[0] != coo.shape[1]:
        p.error("A@A needs a square matrix; rectangular inputs are only "
                "allowed in A@A.T mode (pass trailing 1)")

    cfg = SpGEMMConfig(dtype=dtype, warmup=args.warmup, repeat=args.repeat,
                       fastest=args.fastest, engine=args.engine)
    record, result = run_benchmark(
        coo, args.matrix, cfg, aat=bool(args.aat),
        csv_path=None if args.no_csv else args.csv)

    if args.save_converted:
        # checkpoint the converted format (SURVEY §5): reload with
        # io.persist.load_tiled / load_macro
        from pem_spgemm.io.persist import (save_tiled, save_macro,
                                           save_dia)
        from pem_spgemm.ops.convert import coo_to_tiled, coo_to_macro
        if result.engine == "dia":
            from pem_spgemm.ops.dia import coo_to_dia
            save_dia(args.save_converted, coo_to_dia(coo, dtype=dtype))
        elif result.engine == "macro":
            save_macro(args.save_converted, coo_to_macro(coo, dtype=dtype))
        else:
            save_tiled(args.save_converted,
                       coo_to_tiled(coo, dtype=dtype, with_tmasks=True))
        print(f"converted operand persisted to {args.save_converted}")

    if args.save:
        paths = save_result_files(args.outdir, result.to_coo())
        print(f"result dumped to {paths['NNZ'].rsplit('_', 1)[0]}_*.txt")
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
