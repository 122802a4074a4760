"""One run of a cell: set-up, the measured window, the traced steps and the
check against the plain reference.

A step is one MBE energy of the cluster at one geometry: the cluster's
atoms moved by a seeded normal displacement (every step an independent
draw from `--seed`, so the SCC's work is alike from step to step), each
batch's coordinates gathered on the device and evaluated by
`XtbCalculator.energies` on the batch built once in set-up, and the MBE
total assembled on the host. Steps run back to back (a closed loop).

Set-up: the program's input layer and calculator, the MBE enumeration,
`make_batch` of every batch, the displacements of every step drawn on the
device, and two warm steps (the first captures each batch's stages and
SCC loop, the second replays them). The window then runs steps until
`seconds` have passed; with `trace`, `trace_steps` more steps follow
under `torch.profiler`, with the harness's spans around their parts.

The check, after the window, with the program's batches released: the
per-fragment energies and the MBE totals of `compare_steps` steps of the
window (the last and others drawn from the seed) against
`benchmark/reference/` at the same coordinates.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import statistics
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from ..reference import xtb as reference
from . import spec, system
from . import trace as tracing

#: modules that may not be loaded in the process that prints a result
#: (compared by top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "metalquicha_tpu")
#: steps before the window: the first captures, the second replays
WARM_STEPS = 2


class Chunk(NamedTuple):
    batch: system.Batch
    frag: object               # the program's FragmentData
    idx: torch.Tensor          # (B, nat) the cluster's atom of each slot
    real: torch.Tensor         # (B, nat, 1) bool: a real atom


class RunRecord(NamedTuple):
    """What a per-layer metric's reader reads (`benchmark/metrics/`)."""

    steps: int
    window_s: float
    #: deltas over the window: the SCC graph cache's `stats`,
    #: "eigh_launches" and "density_launches"
    counters: dict
    #: per batch: name, fragments, nat, nao, itemsize, open_shells
    chunks: list
    #: the traced steps' trace (tracing.Trace), or None
    trace: object
    traced_steps: int
    #: per batch name, the launches of the traced steps:
    #: {"eigh": n, "density": n}
    traced_launches: dict


def _counters() -> dict:
    from metalquicha_tpu_torch.methods.xtb import scc_graph
    from metalquicha_tpu_torch.ops import batched_eigh, fermi_fill

    out = {k: v for k, v in scc_graph.stats.items()
           if isinstance(v, int)}
    out["eigh_launches"] = batched_eigh.launches
    out["density_launches"] = fermi_fill.density_launches
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test, set up for one cell."""

    def __init__(self, cell: spec.Cell, seed: int, device, dtype=None,
                 wrap=None):
        from metalquicha_tpu_torch.io.adapter import config_to_driver
        from metalquicha_tpu_torch.methods.factory import create_calculator

        traffic = cell.traffic
        self.device = device
        cfg, self.cluster = system.read_input(cell.config, spec.ROOT)
        drv = config_to_driver(cfg)
        if dtype is not None:
            drv.force_dtype = dtype
        self.calc = create_calculator(drv, device=device)
        want = {"float64": torch.float64, "float32": torch.float32}
        if dtype is None and self.calc.dtype != want[cell.config["dtype"]]:
            raise RuntimeError(f"the calculator runs {self.calc.dtype}, the "
                               f"configuration states {cell.config['dtype']}")
        self.variant = self.calc.variant
        self.tol = self.calc.settings.scf_tol
        self.level = traffic["level"]
        self.batches = system.batches(self.cluster, traffic)
        if sorted({b.k for b in self.batches}) != list(
                range(1, self.level + 1)):
            raise ValueError("the traffic's batches miss a fragment size")
        n = len(self.cluster.monomers)
        self.weights = system.weights(self.batches, n, self.level)
        self.nfrag = len(self.weights)
        fdtype = self.calc.dtype
        self.base = torch.tensor(self.cluster.coords, dtype=fdtype,
                                 device=device)
        self.chunks = []
        for b in self.batches:
            frag = self.calc.make_batch(
                system.fragments(self.cluster, b, self.cluster.coords))
            idx = torch.tensor(np.maximum(b.atoms, 0), device=device)
            real = torch.tensor(b.atoms >= 0, device=device)[..., None]
            self.chunks.append(Chunk(b, frag, idx, real))
        self.sigma, self.max_steps = traffic["sigma_bohr"], traffic["max_steps"]
        self.draw(seed)
        if traffic["driver"] not in ("energy", "gradient"):
            raise ValueError(f"no driver {traffic['driver']!r}")
        self.grad = traffic["driver"] == "gradient"
        call = self.calc.gradients if self.grad else self.calc.energies
        self.call = wrap(call) if wrap else call

    def draw(self, seed: int) -> None:
        """Every step's displacement, drawn on the device from the seed in
        one call of one size."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.disp = self.sigma * torch.randn(
            (WARM_STEPS + self.max_steps, *self.base.shape), generator=gen,
            dtype=torch.float64, device=self.device).to(self.base.dtype)

    def coords(self, row: int) -> torch.Tensor:
        return self.base + self.disp[row]

    def step(self, row: int, span=None, launches=None) -> dict:
        """One MBE step at displacement `row`: the fragment energies in the
        batches' order ("e"), the MBE total ("total"), the fragments failed
        ("failed"); with gradients also each batch's fragment gradients
        ("g", a list) and the MBE gradient ("G", (natoms, 3))."""
        span = span or (lambda name: contextlib.nullcontext())
        with span("geometry"):
            x = self.coords(row)
        energies, resids, grads = [], [], []
        for ch in self.chunks:
            name = ch.batch.name
            with span("gather:" + name):
                c = torch.where(ch.real, x[ch.idx], ch.frag.coords)
            before = _counters() if launches is not None else None
            with span("call:" + name):
                try:
                    out = self.call(ch.frag._replace(coords=c))
                    e, r = out[0], out[-1]["scf_residual"]
                    g = out[1] if self.grad else None
                except RuntimeError as exc:
                    print(f"run: batch {name} raised: {exc}", file=sys.stderr)
                    e = torch.full((len(ch.batch.subsets),), float("nan"),
                                   dtype=self.base.dtype, device=self.device)
                    r = torch.full_like(e, float("inf"))
                    g = torch.full_like(c, float("nan"))
            if launches is not None:
                d = _delta(before, _counters())
                got = launches.setdefault(name, {"eigh": 0, "density": 0})
                got["eigh"] += d["eigh_launches"]
                got["density"] += d["density_launches"]
            energies.append(e)
            resids.append(r)
            grads.append(g)
        with span("assembly"):
            er = torch.stack([torch.cat(energies).double(),
                              torch.cat(resids).double()]).cpu().numpy()
            bad = ~np.isfinite(er[0]) | ~(er[1] <= self.tol)
            rec = {"e": er[0], "total": float(np.dot(self.weights, er[0]))}
            if self.grad:
                rec["g"] = [g.double().cpu().numpy() for g in grads]
                rec["G"] = self.assemble([g for g in rec["g"]])
                bad |= ~np.concatenate([np.isfinite(g).all(axis=(1, 2))
                                        for g in rec["g"]])
            rec["failed"] = int(bad.sum())
        return rec

    def assemble(self, grads: list) -> np.ndarray:
        """The MBE gradient (natoms, 3): each fragment's gradient times its
        weight, added into the cluster's atoms."""
        out = np.zeros_like(self.cluster.coords)
        at = 0
        for ch, g in zip(self.chunks, grads):
            count = len(ch.batch.subsets)
            w = self.weights[at:at + count]
            at += count
            atoms = ch.batch.atoms
            real = atoms >= 0
            np.add.at(out, atoms[real], (w[:, None, None] * g)[real])
        return out

    def chunk_shapes(self) -> list:
        out = []
        for ch in self.chunks:
            f = ch.frag
            out.append({"name": ch.batch.name,
                        "fragments": int(f.ao_mask.shape[0]),
                        "nat": int(f.atom_mask.shape[1]),
                        "nao": int(f.ao_mask.shape[1]),
                        "itemsize": f.coords.element_size(),
                        "open_shells": int((f.nuhf != 0).sum())})
        return out


def _quantile90(values) -> float:
    """The 90th percentile (Python's `statistics.quantiles`, n = 10, the
    "inclusive" method: never beyond the largest value)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


#: the window's first steps, among which the check draws those it
#: compares beside the last (their fragment gradients are kept)
EARLY = 10


def compare_rows(seed: int, steps: int, count: int) -> list:
    """The window steps the check compares: the last, and count - 1 drawn
    from the seed among the first EARLY."""
    rng = np.random.default_rng([seed, 7])
    early = min(EARLY, steps)
    drawn = rng.choice(early, size=min(count - 1, early), replace=False)
    return sorted({steps - 1, *(int(i) for i in drawn)})


def reference_at(prog: Program, row: int, tables: list, settings,
                 block: int) -> dict:
    """The reference at displacement `row`: fragment energies ("e"), with
    gradients each batch's ("g"), and the largest SCC residual."""
    x = prog.coords(row).double()
    es, gs, worst = [], [], 0.0
    for ch, t in zip(prog.chunks, tables):
        c = x[ch.idx]
        parts = []
        for lo in range(0, c.shape[0], block):
            hi = min(lo + block, c.shape[0])
            out = reference.energies_at(reference.rows(t, lo, hi), c[lo:hi],
                                        settings, grad=prog.grad)
            es.append(out[0].cpu())
            if prog.grad:
                parts.append(out[1].cpu())
            worst = max(worst, float(out[-1].max()))
        if prog.grad:
            gs.append(torch.cat(parts).numpy())
    return {"e": torch.cat(es).numpy(), "g": gs, "resid": worst}


class Reference:
    """The plain reference over a program's batches: its own tables, built
    from the fragments' numbers, charges and multiplicities."""

    def __init__(self, prog: Program, block: int):
        self.settings = reference.settings_for(prog.variant)
        self.block = block
        self.tables = [reference.build(
            system.fragments(prog.cluster, ch.batch, prog.cluster.coords),
            prog.variant, prog.device, torch.float64) for ch in prog.chunks]

    def gaps(self, prog: Program, steps) -> dict:
        """The widest gaps over `steps`, (row, the program's record) each:
        of a fragment's energy ("frag_gap_ha"), of the MBE total
        ("total_gap_ha"), with gradients of a fragment's gradient
        ("frag_grad_gap") and of the MBE gradient ("total_grad_gap");
        and the reference's largest SCC residual ("ref_residual")."""
        out = dict.fromkeys(("frag_gap_ha", "total_gap_ha", "ref_residual")
                            + (("frag_grad_gap", "total_grad_gap")
                               if prog.grad else ()), 0.0)

        def widen(key, value):
            # a gap that is not a number is as wide as can be
            value = float(value)
            out[key] = max(out[key], value if math.isfinite(value)
                           else math.inf)

        for row, rec in steps:
            ref = reference_at(prog, row, self.tables, self.settings,
                               self.block)
            widen("ref_residual", ref["resid"])
            widen("frag_gap_ha", np.max(np.abs(rec["e"] - ref["e"])))
            widen("total_gap_ha", abs(
                rec["total"] - float(np.dot(prog.weights, ref["e"]))))
            if prog.grad:
                for g, g_ref in zip(rec["g"], ref["g"]):
                    widen("frag_grad_gap", np.max(np.abs(g - g_ref)))
                widen("total_grad_gap", np.max(np.abs(
                    rec["G"] - prog.assemble(ref["g"]))))
        return out


def check(prog: Program, cell: spec.Cell, records: list, seed: int):
    """The numbers the check compares, {name: (value, limit)}, the
    reference's seconds and the window steps compared."""
    t0 = time.perf_counter()
    rows = compare_rows(seed, len(records), cell.traffic["compare_steps"])
    ref = Reference(prog, cell.traffic["ref_block"])
    gaps = ref.gaps(prog, [(WARM_STEPS + i, records[i]) for i in rows])
    compared = {k: (gaps[k], lim["limit"]) for k, lim in cell.limits.items()}
    # the reference's own stop: it must have converged to judge
    compared["ref_residual"] = (gaps["ref_residual"], ref.settings.scf_tol)
    return compared, time.perf_counter() - t0, rows


def _device_info(device, count: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": peak}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def _forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None, wrap=None, dtype=None) -> dict:
    """One run: the result line as a dict, `compared` last. t_start: when
    the process started (set-up counts from it); wrap: a function of the
    calculator's call that returns the call the steps make (tests break
    the timed path with it); dtype: the program's working precision where
    it is not the configuration's ("f32": the control, `control.py`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    traffic = cell.traffic

    prog = Program(cell, seed, device, dtype=dtype, wrap=wrap)
    for row in range(WARM_STEPS):
        prog.step(row)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    _log(f"run: set-up {setup_s:.3f} s, {prog.nfrag} fragments a step in "
         f"{len(prog.chunks)} batches")

    peak_setup = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    c0 = _counters()
    records, times = [], []
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    while True:
        ts = time.perf_counter()
        records.append(prog.step(WARM_STEPS + len(records)))
        te = time.perf_counter()
        times.append(te - ts)
        if len(records) > EARLY + 1:
            # a step the check cannot compare keeps no fragment gradients
            records[-2].pop("g", None)
        if te >= deadline or len(records) == traffic["max_steps"]:
            break
    window_s = te - t_w0
    counters = _delta(c0, _counters())
    peak_window = torch.cuda.max_memory_allocated(device) if on_card else 0
    _log(f"run: {len(records)} steps in {window_s:.3f} s")

    traced, traced_launches, extra = None, {}, []
    if trace:
        traced, traced_launches, extra = _traced_steps(
            prog, WARM_STEPS + len(records), traffic["trace_steps"])
    if len(records) + len(extra) > traffic["max_steps"]:
        raise RuntimeError("the window outran the drawn displacements")

    attempted = prog.nfrag * (len(records) + len(extra))
    failed = sum(r["failed"] for r in records + extra)
    record = RunRecord(len(records), window_s, counters,
                       prog.chunk_shapes(), traced, len(extra),
                       traced_launches)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "step_s": window_s / len(records),
            "p90_step_s": _quantile90(times),
            "peak_mem_gib": peak_window / 2**30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    # the check: the program's batches released first
    prog.chunks = [ch._replace(frag=None) for ch in prog.chunks]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared, check_s, rows = check(prog, cell, records, seed)
    compared["failed"] = (failed, 0)
    _log(f"run: the reference took {check_s:.3f} s for steps {rows}")

    correct = (failed == 0 and all(
        np.isfinite(v) and v <= lim for v, lim in compared.values()))
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device_info(device, 1, max(peak_setup, peak_window)),
    }
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": tracing.top_ops(traced),
                               "idle_gaps": tracing.idle_by_span(traced)}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result


def _traced_steps(prog: Program, first_row: int, count: int):
    """`count` steps under torch.profiler with the harness's spans: (the
    trace, the launches per batch, the steps' records)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    launches, records = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            for i in range(count):
                with record_function(tracing.STEP):
                    records.append(prog.step(first_row + i, record_function,
                                             launches))
            _sync(prog.device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        traced = tracing.read(path)
    return traced, launches, records
