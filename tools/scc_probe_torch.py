#!/usr/bin/env python3
"""What one SCC iteration of the torch port costs on a card.

On the bench dimer batch (512 water dimers, nao 16, seed 0), on three
routes: GFN1 with the exact in-loop eigh in float64 ("gfn1_exact"), GFN1
on the Jacobi route in float32 ("gfn1_jacobi": the fast in-loop route
runs in float32 only, as the JAX package's) and GFN2's multipole SCC in
float64 ("gfn2"):

- `ms_per_iteration`: the time one iteration holds the device's stream
  (its idle gaps included), from CUDA events around whole 32-iteration
  solves (scf_tol 0, so every solve runs all 32) on prebuilt operands,
  the mean of 3 solves after a warm-up;
- `kernels_per_iteration`: the device kernels one iteration launches,
  from torch.profiler: a solve of 8 iterations minus one of 4, over 4
  (None where the profiler shows no device activity);
- `busy_ms_per_iteration`: the device time of those kernels (their sum,
  from the same two profiles), so that 1 - busy / ms is the device's
  idle share; `top_kernels`: the five kernels with the most device time
  per iteration, as [name, launches, device ms];
- `fermi_per_iteration`: the Fermi kernels' launches per iteration, from
  their wrapper's count (None where the package has no such kernel), and
  `density_per_iteration` those of them that fuse the density product
  (None where the package has no fused kernel);
- `host_ms_per_iteration`: where the host spends one iteration of a
  32-iteration solve: the ms inside each of the engine's SCC functions
  (`HOST_SPLIT`; a call made inside another counts for both, as GFN2's
  autograd pass `_aes_potentials` inside `_aes_fock`), "solve" for the
  whole solve up to its last kernel's end, and "other" for the time
  outside all of them (the Anderson step; before the fused density, the
  density product too);
- with --walls, `energies_s` and `gradients_s`: host seconds of one
  `XtbCalculator.energies` and `.gradients` call on the batch (32 SCC
  iterations), the mean of 3 calls after a warm-up, as `chip_smoke.py`'s
  slice phase times them;
- with --slice, instead of the routes: `slice`, `chip_smoke.py`'s slice
  phase timed call by call (GFN1 f64 with `use_pallas_eigh`, 512
  dimers, a gradients call to warm up, then three energies calls and
  three gradients calls): each call's host seconds and the graphs it
  captured (`scc_graph.stats`' captures and stage captures), and
  `energies_per_s` and `gradients_per_s` as the phase computes them (512
  over the mean of its three calls);
- `graph`: the same solves as replays of one captured CUDA graph per solve
  (the package's default on a card since the graph route; the keys above
  are then of the launch-by-launch loop, `graph=False`), from the same
  operands: `ms_per_iteration`, `kernels_per_iteration`,
  `busy_ms_per_iteration`, `top_kernels`, `host_ms_per_iteration` (the
  host's ms per iteration from the solve's call to its return, before
  the device finishes: what the host still spends on the loop) and
  `capture_ms` (host ms of the last solve's eager warm-up iteration, its
  recording and its instantiation) and `hit_ms` (host ms of a solve's
  setup on a hit of the graph cache: the lookup, the copies into the
  cached buffers and the state's reset; None before the cache); None
  where the package has no graph route;
- `parts`: for one `XtbCalculator.energies` and one `.gradients` call on
  the batch (32 SCC iterations, after a warm-up call, so the SCC and,
  where the package has them, the call's other stages replay cached
  graphs), the host ms and the stream ms (CUDA events on the call's
  stream, idle gaps included) of its three parts: `operands`, from the
  call's start to the loop's (`engine._anderson_solve`: `_scc_operands`,
  the orthogonalizer, the eigh status), `loop`, the loop itself, and
  `functional`, the rest of the call (the variational functional after
  the loop, for a gradient its backward pass, and the status read); and,
  where the call runs as stages (`scc_graph.Call`), `stages`: the host
  and stream ms of each stage's own call (`operands` and `functional`: a
  hit's copies, replay and clones) and of the call's `finish`.

Usage: python3 tools/scc_probe_torch.py [--walls | --slice] [--json-out F]
It prints one JSON line. It uses only the package's entry points, so it
measures an older checkout of the package too (put that checkout first on
PYTHONPATH).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)

ITERS = 32
#: route -> (variant, use_pallas_eigh, dtype)
ROUTES = {"gfn1_exact": ("gfn1", False, torch.float64),
          "gfn1_jacobi": ("gfn1", True, torch.float32),
          "gfn2": ("gfn2", False, torch.float64)}
#: the engine's functions an SCC iteration calls, timed on the host (the
#: fill and density: `_scc_density`, or `occupations` and, in "other", the
#: product where a package has no `_scc_density`)
HOST_SPLIT = ("_fock", "_aes_fock", "_aes_potentials", "_general_eigh",
              "jacobi_eigh", "_scc_density", "occupations",
              "_shell_populations", "_aes_moments_of_P")


def _fermi_counts():
    """The Fermi kernels' launch counts (all, fused), None for what the
    package lacks."""
    try:
        from metalquicha_tpu_torch.ops import fermi_fill
    except ImportError:
        return None, None
    return fermi_fill.launches, getattr(fermi_fill, "density_launches", None)


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernels(fn) -> dict:
    """name -> [launches, device ms] of the device kernels fn runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            out[ev.key] = [ev.count, us / 1e3]
    return out


def _per_iteration(n4: dict, n8: dict) -> dict:
    """The kernels of iterations 5-8 per iteration: name -> [launches,
    device ms]."""
    return {k: [(n8[k][0] - n4.get(k, [0, 0.0])[0]) / 4.0,
                (n8[k][1] - n4.get(k, [0, 0.0])[1]) / 4.0] for k in n8}


def _host_split(engine, solve) -> dict:
    """Host ms per iteration inside each of HOST_SPLIT during one solve,
    the whole solve and the time outside all of them ("other")."""
    spent, originals = {"outermost": 0.0}, {}
    depth = [0]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                dt = time.perf_counter() - t0
                spent[name] = spent.get(name, 0.0) + dt
                if depth[0] == 0:
                    spent["outermost"] += dt
        return wrapper

    for name in HOST_SPLIT:
        fn = getattr(engine, name, None)
        if fn is not None:
            originals[name] = fn
            setattr(engine, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(engine, name, fn)
    outermost = spent.pop("outermost")
    out = {k: 1e3 * v / ITERS for k, v in spent.items()}
    out["solve"] = 1e3 * total / ITERS
    out["other"] = 1e3 * (total - outermost) / ITERS
    return out


def _wall(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _device_costs(solve, settings) -> dict:
    """Stream ms, device kernels, busy ms and top kernels per iteration of
    solve(settings)."""
    rec = {"ms_per_iteration": _cuda_ms(lambda: solve(settings), 3) / ITERS}
    n4 = _kernels(lambda: solve(settings._replace(max_scf_iter=4)))
    n8 = _kernels(lambda: solve(settings._replace(max_scf_iter=8)))
    per = _per_iteration(n4, n8)
    count = sum(v[0] for v in per.values())
    seen = bool(n4) and count > 0
    rec["kernels_per_iteration"] = count if seen else None
    rec["busy_ms_per_iteration"] = (
        sum(v[1] for v in per.values()) if seen else None)
    rec["top_kernels"] = [
        [k[:80], v[0], v[1]] for k, v in
        sorted(per.items(), key=lambda kv: -kv[1][1])[:5]]
    return rec


def _graph_costs(solve, settings) -> dict:
    """The `graph` keys: the device costs of the replayed solve, the host's
    ms per iteration and the last capture's ms."""
    from metalquicha_tpu_torch.methods.xtb import scc_graph

    rec = _device_costs(solve, settings)
    solve(settings)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(settings)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    rec["host_ms_per_iteration"] = 1e3 * min(host) / ITERS
    rec["capture_ms"] = {k: scc_graph.stats[k] for k in (
        "warmup_ms", "record_ms", "instantiate_ms")}
    rec["hit_ms"] = scc_graph.stats.get("hit_setup_ms")
    return rec


def _parts(call) -> dict:
    """Host and stream ms of call()'s operand build, SCC loop and
    functional, and of its stages (the module docstring's `parts`)."""
    from metalquicha_tpu_torch.methods.xtb import engine, scc_graph

    marks = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[name] = (time.perf_counter(), ev)

    def around(fn, before, after):
        def wrapper(*args, **kwargs):
            mark(before)
            out = fn(*args, **kwargs)
            mark(after)
            return out
        return wrapper

    staged = hasattr(scc_graph, "Call")
    solve = engine._anderson_solve
    engine._anderson_solve = around(solve, "loop_start", "loop_end")
    if staged:
        stage, finish = scc_graph.Call.stage, scc_graph.Call.finish

        def timed_stage(self, key, inputs, fn):
            name = key[0]
            return around(stage, f"{name}_start", f"{name}_end")(
                self, key, inputs, fn)

        scc_graph.Call.stage = timed_stage
        scc_graph.Call.finish = around(finish, "finish_start", "finish_end")
    try:
        call()
        torch.cuda.synchronize()
        mark("start")
        call()
        mark("end")
        torch.cuda.synchronize()
    finally:
        engine._anderson_solve = solve
        if staged:
            scc_graph.Call.stage, scc_graph.Call.finish = stage, finish

    def span(a, b):
        (ta, ea), (tb, eb) = marks[a], marks[b]
        return [1e3 * (tb - ta), ea.elapsed_time(eb)]

    out = {"operands": span("start", "loop_start"),
           "loop": span("loop_start", "loop_end"),
           "functional": span("loop_end", "end"),
           "call": span("start", "end")}
    if staged:
        out["stages"] = {k: span(f"{k}_start", f"{k}_end")
                         for k in ("operands", "functional", "finish")}
    return out


def iteration_costs(device="cuda", routes=tuple(ROUTES), walls=False):
    """route -> its costs (the module docstring's keys)."""
    from metalquicha_tpu_torch.constants import KB_HARTREE
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import engine
    from metalquicha_tpu_torch.workloads import bench_dimers

    kt = 300.0 * KB_HARTREE
    # a package with the graph route runs it by default; its keys above
    # are then of the launch-by-launch loop
    has_graph = "graph" in inspect.signature(engine.scf_solve).parameters
    eager = {"graph": False} if has_graph else {}
    out = {}
    for route in routes:
        variant, jacobi, dtype = ROUTES[route]
        settings = engine.settings_from_params(
            variant, max_scf_iter=ITERS, scf_tol=0.0, use_pallas_eigh=jacobi)
        calc = tcalc.XtbCalculator(settings, variant=variant, dtype=dtype,
                                   device=device)
        frag = calc.make_batch(bench_dimers(512))
        with torch.no_grad():
            S, H0, gamma, mp = tcalc._scc_operands(frag.coords, frag,
                                                   settings)

            def solve(st=settings, **kw):
                kw = kw or eager
                if mp is None:
                    return engine.scf_solve(H0, S, gamma, frag, kt, st, **kw)
                return engine.scf_solve_multipole(
                    H0, S, frag.coords, gamma, frag, kt, st, None, mp, **kw)

            rec = _device_costs(solve, settings)
            f0, d0 = _fermi_counts()
            solve(settings._replace(max_scf_iter=4))
            f1, d1 = _fermi_counts()
            rec["fermi_per_iteration"] = (
                None if f0 is None else (f1 - f0) / 4.0)
            rec["density_per_iteration"] = (
                None if d0 is None else (d1 - d0) / 4.0)
            rec["host_ms_per_iteration"] = _host_split(engine, solve)
            rec["graph"] = (_graph_costs(
                lambda st: solve(st, graph=True), settings)
                if has_graph else None)
        if walls:
            rec["energies_s"] = _wall(lambda: calc.energies(frag), 3)
            rec["gradients_s"] = _wall(lambda: calc.gradients(frag), 3)
        # [host ms, stream ms] per part
        rec["parts"] = {"energies": _parts(lambda: calc.energies(frag)),
                        "gradients": _parts(lambda: calc.gradients(frag))}
        out[route] = rec
    return out


def slice_walls(device="cuda") -> dict:
    """`chip_smoke.py`'s slice phase, call by call (the docstring's
    `slice`)."""
    from metalquicha_tpu_torch.methods.xtb import scc_graph
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.workloads import bench_dimers

    settings = settings_from_params("gfn1", use_pallas_eigh=True)
    calc = XtbCalculator(settings, dtype=torch.float64, device=device)
    frag = calc.make_batch(bench_dimers(512))
    calc.gradients(frag)  # the phase's warm-up

    def calls(fn):
        out = []
        for _ in range(3):
            c0, s0 = (scc_graph.stats[k]
                      for k in ("captures", "stage_captures"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append({"s": time.perf_counter() - t0,
                        "captures": scc_graph.stats["captures"] - c0,
                        "stage_captures": (scc_graph.stats["stage_captures"]
                                           - s0)})
        return out

    energies = calls(lambda: calc.energies(frag))
    gradients = calls(lambda: calc.gradients(frag))
    return {"energies": energies, "gradients": gradients,
            "energies_per_s": 512 / (sum(c["s"] for c in energies) / 3),
            "gradients_per_s": 512 / (sum(c["s"] for c in gradients) / 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--walls", action="store_true",
                    help="also time the energies and gradients calls")
    ap.add_argument("--slice", action="store_true",
                    help="only chip_smoke.py's slice phase, call by call")
    ap.add_argument("--json-out", help="also write the line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scc_probe_torch: needs a CUDA card", file=sys.stderr)
        return 1
    import metalquicha_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    line = {"package": os.path.dirname(metalquicha_tpu_torch.__file__),
            "card": card}
    if args.slice:
        line["slice"] = slice_walls()
    else:
        line["routes"] = iteration_costs(walls=args.walls)
    text = json.dumps(line)
    print(text, flush=True)
    if args.json_out:
        with open(args.json_out, "a") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
