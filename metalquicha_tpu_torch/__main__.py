"""Command-line entry point:
`python -m metalquicha_tpu_torch input.mqc [--f32] [--no-polish]
[--device cuda|cpu]`.

Runs the calculation on the torch port, writes `output_<base>.json` in the
CWD and prints the totals, as `python -m metalquicha_tpu` does.
`--version` prints the version string. The compiled kernel is kept in the
directory `MQC_COMPILE_CACHE` names (see `compile_cache.py`).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mqc-torch",
        description="fragmented GFN1/GFN2-xTB on PyTorch (CUDA or CPU)",
    )
    ap.add_argument("input", nargs="?", help="input .mqc file")
    ap.add_argument("--version", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="float32 SCC with the f64 polish of its results "
                         "(default: float64 throughout)")
    ap.add_argument("--no-polish", action="store_true",
                    help="disable the f64 polish of f32 results (raw "
                         "float32 precision)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; fails without one)")
    args = ap.parse_args(argv)

    from . import __version__

    if args.version:
        print(f"mqc-torch (metalquicha-tpu on PyTorch) version {__version__}")
        return 0
    if not args.input:
        ap.error("input file required")

    from .compile_cache import enable as _enable_cache

    _enable_cache()

    from .driver import run_file
    from .io.json_writer import output_filename_for

    overrides = {}
    if args.f32:
        overrides["force_dtype"] = "f32"
    if args.no_polish:
        overrides["host_polish"] = "off"
    t0 = time.time()
    outputs = run_file(args.input, device=args.device,
                       driver_overrides=overrides)
    elapsed = time.time() - t0

    for name, out in outputs.items():
        label = name or "total"
        print(f" {label}: total_energy = {out.result.total_energy:.12f} Ha")
        if out.result.gradient is not None:
            gn = float((out.result.gradient**2).sum() ** 0.5)
            print(f" {label}: gradient_norm = {gn:.9f}")
        if out.result.hessian is not None:
            hn = float((out.result.hessian**2).sum() ** 0.5)
            print(f" {label}: hessian_frobenius_norm = {hn:.9f}")
    print(f"\n output written to {output_filename_for(args.input)}")
    print(f" Total processing time: {elapsed:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
