"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json; its configuration,
traffic, limits and per-layer metrics are files under `benchmark/` found by
name (`harness/spec.py`). The run needs a CUDA card and exits with 2,
printing no result, without one. It prints its progress and, last, each
number the check compared beside its limit on standard error, and one JSON
line last on standard output: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), `device`, with --trace 1 `breakdown`, and `compared`.

The program's nvcc builds are kept in `benchmark/.build_cache/` inside the
checkout, so only a checkout's first run builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark.harness import cell as cell_run
    from benchmark.harness import env, spec

    cell = spec.load_cell(args.workload)
    chips = next(w["chips"] for w in json.load(
        open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]
        if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2

    env.prepare()
    result = cell_run.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", t_start=T_START)
    loaded = cell_run._forbidden_loaded()
    if loaded:
        print(f"run: the process loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
