"""Readings of the numbers the check compares, for setting their limits:
the program as the configuration states it, and its control, the
program's own float32 path (the nearest precision below the configured
float64), on many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--dtype float32] [--out FILE] [--run SECONDS]

Each seed runs the cell's own batches at its own sizes: the warm steps
(the first seed's capture the graphs), then `compare_steps` steps, as many
as a run compares, each against the plain reference, as a run's check
does. Prints one JSON line: per seed the widest fragment gap, the widest
MBE-total gap and the fragments failed. With `--run`, each seed is instead
one whole run of the cell (`harness/cell.run_cell`, a window of SECONDS)
in the chosen precision, and the line holds each run's `correct` and
`compared`: the control judged by the run's own check. Needs a CUDA card;
the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seeds, dtype=None, device="cuda") -> dict:
    """{seed: the gaps `Reference.gaps` reads and "failed"} of the program
    (dtype None: as configured; "f32": its float32 path)."""
    from benchmark.harness import cell as cell_run

    prog = cell_run.Program(cell, seeds[0], device, dtype=dtype)
    ref = cell_run.Reference(prog, cell.traffic["ref_block"])
    count = cell.traffic["compare_steps"]
    out = {}
    for n, seed in enumerate(seeds):
        prog.draw(seed)
        warm = range(cell_run.WARM_STEPS) if n == 0 else range(0)
        for row in warm:
            prog.step(row)
        steps = [(row, prog.step(row)) for row in range(
            cell_run.WARM_STEPS, cell_run.WARM_STEPS + count)]
        out[seed] = prog_gaps = ref.gaps(prog, steps)
        prog_gaps["failed"] = sum(rec["failed"] for _row, rec in steps)
        print(f"control: seed {seed} {out[seed]}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import env, spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    env.prepare()
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    dtype = {"float32": "f32", "float64": "f64", None: None}[args.dtype]
    result = {"workload": args.workload, "dtype": args.dtype or
              cell.config["dtype"], "device": torch.cuda.get_device_name()}
    if args.run is None:
        result["readings"] = readings(cell, seeds, dtype)
    else:
        from benchmark.harness import cell as cell_run

        result["runs"] = {}
        for seed in seeds:
            run = cell_run.run_cell(cell, seed, args.run, False, "cuda",
                                    dtype=dtype)
            result["runs"][seed] = {"correct": run["correct"],
                                    "compared": run["compared"]}
            print(f"control: seed {seed} {result['runs'][seed]}",
                  file=sys.stderr)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
