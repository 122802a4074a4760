#!/usr/bin/env python3
"""Device memory of the torch port's fragment chunks.

Two measurements, each printed as JSON lines:

--calibrate   the peak device memory one fragment of a padded shape
              takes in `XtbCalculator.energies` and `.gradients`
              (`torch.cuda.max_memory_allocated` above what was allocated
              before the call, with the batch already on the device and
              the SCC graph cache emptied, divided by the batch size: the
              call's own cache entries count (its loop's and, where the
              call runs as stages, the operand build's and the
              functional's, each a miss: an eager run, then its capture);
              the entries other chunks of
              a run keep are held by `executor.make_room`, not by the
              model), beside the executor's byte model
              (`parallel/executor.py` `fragment_bytes`) where the package
              has one, and their ratio. Shapes: GFN1 water dimers (nao 16)
              on the exact route in float64 and on the Jacobi route (in
              float32: the fast in-loop route runs in float32 only, as the
              JAX package's), w20 water tetramers (nao 32) on both routes,
              the 73-atom peptide of
              validation/inputs/no_frag.json padded as the executor pads it
              (nao 241), GFN1 with ALPB and with CPCM water (nao 16) and
              GFN2 (nao 16).
--workflows   run_calculation on the card for the driver inputs named:
              `hessian` (no_frag.json with its driver set to "Hessian":
              438 displaced gradients of one 73-atom fragment), `w20_grad`
              (w20_isomer.json at MBE(4) with driver "Gradient") and
              `w20_energy` (the same at driver "Energy"), each through the
              factory's executor (float64, the exact route): wall, peak
              device memory or the
              out-of-memory error, the executor's chunks and, where the
              package has one, its byte budget.

On the CPU (`--device cpu`, small batches) the peak is read from the
profiler's allocation events instead: the live bytes of every tensor.

Usage: python3 tools/memory_probe_torch.py --calibrate --workflows
           hessian,w20_grad,w20_energy [--device cuda] [--json-out F]
The script uses only the package's entry points, so it measures an older
checkout of the package too (put that checkout first on PYTHONPATH).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)

INPUTS = os.path.join(ROOT, "validation", "inputs")
W20_MQC = os.path.join(ROOT, "tests", "data", "port_w20_mbe4.mqc")
ANGSTROM_TO_BOHR = 1.0 / 0.52917721067
GIB = 2.0 ** 30

#: calibrated shapes: name -> (variant, solvation, fragments, route,
#: (energy batch, gradient batch) on a card, the same on the CPU)
SHAPES = {
    "gfn1_n16_exact": ("gfn1", None, "dimers", "exact", (512, 256), (16, 8)),
    "gfn1_n16_jacobi": ("gfn1", None, "dimers", "jacobi", (512, 256),
                        (16, 8)),
    "gfn1_n32_exact": ("gfn1", None, "tetramers", "exact", (512, 256),
                       (8, 4)),
    "gfn1_n32_jacobi": ("gfn1", None, "tetramers", "jacobi", (512, 256),
                        (8, 4)),
    "gfn1_n241": ("gfn1", None, "peptide", "exact", (8, 4), (1, 1)),
    "gfn1_alpb_n16": ("gfn1", "alpb", "dimers", "exact", (512, 256),
                      (16, 8)),
    "gfn1_cpcm_n16": ("gfn1", "cpcm", "dimers", "exact", (64, 32), (2, 1)),
    "gfn2_n16": ("gfn2", None, "dimers", "exact", (512, 256), (16, 8)),
}


def _clear_scc_graph_cache() -> None:
    """Empty the package's SCC graph cache, where it has one."""
    try:
        from metalquicha_tpu_torch.methods.xtb import scc_graph
    except ImportError:  # a checkout from before the graph route
        return
    if hasattr(scc_graph, "clear"):
        scc_graph.clear()


def peak_bytes(fn, device):
    """(fn(), peak bytes fn allocated above what was live before it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        # the graphs earlier calls cached: their entries' and pools'
        # blocks are freed, not counted as live
        _clear_scc_graph_cache()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = fn()
        torch.cuda.synchronize(device)
        return out, torch.cuda.max_memory_allocated(device) - base
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    steps = []
    for ev in prof.profiler.function_events:
        d = (ev.cpu_memory_usage if ev.name == "[memory]"
             else ev.self_cpu_memory_usage)
        if d:
            steps.append((ev.time_range.start, d))
    live = peak = 0
    for _t, d in sorted(steps):
        live += d
        peak = max(peak, live)
    return out, peak


def _w20_waters():
    """The 20 waters of port_w20_mbe4.mqc, (numbers, Bohr coordinates)."""
    with open(W20_MQC) as fh:
        lines = fh.read().split("%geometry")[1].splitlines()
    rows = [ln.split() for ln in lines[3:63]]
    z = {"O": 8, "H": 1}
    numbers = np.array([z[r[0]] for r in rows])
    coords = np.array([[float(x) for x in r[1:4]] for r in rows])
    return numbers.reshape(20, 3), coords.reshape(20, 3, 3) * ANGSTROM_TO_BOHR


def _peptide():
    with open(os.path.join(INPUTS, "no_frag.json")) as fh:
        mol = json.load(fh)["molecules"][0]
    z = {"H": 1, "C": 6, "N": 7, "O": 8}
    numbers = np.array([z[s] for s in mol["symbols"]])
    coords = np.array(mol["geometry"]).reshape(-1, 3) * ANGSTROM_TO_BOHR
    return numbers, coords


def fragments(kind: str, n: int, seed: int = 0) -> list:
    """n fragments of one kind: bench.py's water dimers, w20 tetramers
    (consecutive 4-subsets of the 20 waters), or the peptide, each moved
    by a seeded 0.01 Bohr jitter."""
    rng = np.random.default_rng(seed)
    if kind == "dimers":
        from metalquicha_tpu_torch.workloads import bench_dimers

        return bench_dimers(n)
    if kind == "tetramers":
        from itertools import combinations, islice

        numbers, coords = _w20_waters()
        out = []
        for idx in islice(combinations(range(20), 4), n):
            idx = list(idx)
            out.append((numbers[idx].ravel(), coords[idx].reshape(-1, 3),
                        0, 1))
        return out
    numbers, coords = _peptide()
    return [(numbers, coords + rng.normal(0.0, 0.01, coords.shape), 0, 1)
            for _ in range(n)]


def calculator(variant, solvation, route, device):
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params

    settings = settings_from_params(variant,
                                    use_pallas_eigh=(route == "jacobi"))
    solv = None
    if solvation == "alpb":
        from metalquicha_tpu_torch.methods.xtb.solvation.born import (
            BornSolvation,
        )

        solv = BornSolvation(78.4, alpb=True)
    elif solvation == "cpcm":
        from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import (
            CpcmSolvation,
        )

        solv = CpcmSolvation(78.4, nang=110)
    dtype = torch.float32 if route == "jacobi" else torch.float64
    return XtbCalculator(settings, variant, dtype, device, solv)


def _model(executor, frags, what):
    """The executor's byte model for one fragment of this bucket, or None
    where the package has none; and the padded (nat, nsh, nao)."""
    from metalquicha_tpu_torch.parallel import executor as ex_mod

    members = list(enumerate(frags))
    bucket = ex_mod._bucket_of(len(frags[0][0]))
    pad_to = executor._pad_shapes_for(bucket, members)
    if not hasattr(executor, "fragment_bytes"):
        return None, pad_to
    return executor.fragment_bytes(pad_to, members, what), pad_to


def calibrate(device, names=None) -> list:
    """One row per (shape, energy or gradient): the measured peak per
    fragment beside the byte model."""
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor

    rows = []
    for name, (variant, solv, kind, route, b_card, b_cpu) in SHAPES.items():
        if names and name not in names:
            continue
        calc = calculator(variant, solv, route, device)
        ex = FragmentExecutor(calc)
        for what, bsz in zip(("energy", "gradient"),
                             b_card if device.type == "cuda" else b_cpu):
            frags = fragments(kind, bsz)
            model, pad_to = _model(ex, frags, what)
            batch = calc.make_batch(frags, pad_to=pad_to)
            run = calc.gradients if what == "gradient" else calc.energies
            t0 = time.perf_counter()
            _out, peak = peak_bytes(lambda: run(batch), device)
            wall = time.perf_counter() - t0
            del batch, _out
            per = peak / bsz
            rows.append({
                "shape": name, "what": what, "pad_to": list(pad_to),
                "batch": bsz, "measured_bytes": int(per),
                "model_bytes": None if model is None else int(model),
                "ratio": None if model is None else round(model / per, 4),
                "wall_s": round(wall, 4),
            })
            print(json.dumps({"calibrate": rows[-1]}), flush=True)
    return rows


def _input(name: str, driver: str):
    from metalquicha_tpu_torch.io.config import parse_mqc_string
    from metalquicha_tpu_torch.io.prep import emit_mqc

    with open(os.path.join(INPUTS, name)) as fh:
        data = json.load(fh)
    data["driver"] = driver
    return parse_mqc_string(emit_mqc(data, base_dir=INPUTS))


WORKFLOWS = {
    # name -> (input, driver)
    "hessian": ("no_frag.json", "Hessian"),
    "w20_grad": ("w20_isomer.json", "Gradient"),
    "w20_energy": ("w20_isomer.json", "Energy"),
}


def workflow(name: str, device, capture=None) -> dict:
    """run_calculation on one driver input through the factory's executor;
    the peak device memory or the out-of-memory error, the chunks and the
    executor's byte budget.
    capture(jobs, result) is called with every executor run's input and
    output."""
    from metalquicha_tpu_torch.driver import make_executor, run_calculation
    from metalquicha_tpu_torch.ops import jacobi_eigh

    src, driver = WORKFLOWS[name]
    cfg = _input(src, driver)
    ex = make_executor(cfg, str(device))
    chunks = []
    run_chunk, run = ex._run_chunk, ex.run

    def counted(members, pad_to, *args):
        chunks.append((len(members), list(pad_to)))
        return run_chunk(members, pad_to, *args)

    def captured(jobs, what="energy"):
        out = run(jobs, what=what)
        if capture is not None:
            capture(jobs, out)
        return out

    ex._run_chunk = counted
    ex.run = captured
    n0 = jacobi_eigh.launches
    rec = {"workflow": name, "input": src, "driver": driver}
    t0 = time.perf_counter()
    try:
        out, peak = peak_bytes(
            lambda: run_calculation(cfg, write_json=False, executor=ex),
            device)
        rec["ok"] = True
        rec["peak_gib"] = round(peak / GIB, 3)
        rec["total_energy"] = float(out[""].result.total_energy)
        rec["output"] = out[""]
    except torch.cuda.OutOfMemoryError as exc:
        rec["ok"] = False
        rec["error"] = str(exc).splitlines()[0][:300]
        rec["peak_gib"] = round(
            torch.cuda.max_memory_allocated(device) / GIB, 3)
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    rec["chunks"] = len(chunks)
    rec["chunk_sizes"] = sorted({(n, tuple(p)) for n, p in chunks})
    rec["budget_gib"] = (None if getattr(ex, "last_budget", None) is None
                         else round(ex.last_budget / GIB, 3))
    rec["jacobi_launches"] = jacobi_eigh.launches - n0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="comma-separated names of SHAPES (default all)")
    ap.add_argument("--workflows", default="",
                    help="comma-separated names of WORKFLOWS")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    from metalquicha_tpu_torch.logging_ import global_logger
    from metalquicha_tpu_torch.methods.xtb.calculator import check_device

    global_logger.set_level("warning")
    device = check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": str(device)}
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
        free, total = torch.cuda.mem_get_info(device)
        result["mem_total_gib"] = round(total / GIB, 3)
        print(json.dumps(result), flush=True)
    if args.calibrate:
        names = [s for s in args.shapes.split(",") if s]
        result["calibration"] = calibrate(device, names)
    result["workflows"] = []
    for name in (w for w in args.workflows.split(",") if w):
        rec = workflow(name, device)
        rec.pop("output", None)
        result["workflows"].append(rec)
        print(json.dumps({"workflow": rec}, default=str), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(result, fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
