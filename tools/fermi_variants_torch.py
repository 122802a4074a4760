#!/usr/bin/env python3
"""The Fermi kernels against variants of their own source, on a card:
each design choice of `csrc/fermi_fill.cu` timed beside its alternatives
(and an older checkout's kernels) in one process tree, the bits compared.

A variant is this tree's package with constants of `csrc/fermi_fill.cu`
set otherwise (`NAME=VALUE`, each a `constexpr int NAME = VALUE` of the
source: kRunWidth, kPacked32PerSM, kWideAheadPerSM, kWideWarps, ...),
copied into the gitignored `metalquicha_tpu_torch/_build/variants/<name>/`;
`--baseline DIR` adds the package of an older checkout (unpacked with `git
archive` into the gitignored `_archive/`) as the variant "baseline". Every
variant is built by its own process (all started together), then times
the cases in a process of its own, in turns: every variant once, then
again in the reverse order; the lesser of the two is kept. A case is the
fill (`fermi_occupations`) or the fused fill and density
(`fermi_density`) on `chip_smoke.fermi_inputs`' batch at 300 K (seeded by the case; its
shells "mixed" as drawn, or every fragment "closed" (nuhf 0) or "open"
(nuhf 1), nelec moved with nuhf),
graph-replayed (`kernel_times_torch.graph_ms`); its output's SHA-256 is
compared with the first variant's: a variant that moves a bit is reported
as such.

Usage: python3 tools/fermi_variants_torch.py [--variants
base;W0:kWideAheadPerSM=0;...] [--baseline DIR] [--cases
density:f64:512,16:closed;fill:f32:5985,32;...] [--reps N]
[--json-out F]
It prints a line per variant and case, and one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "metalquicha_tpu_torch")
SOURCE = os.path.join("csrc", "fermi_fill.cu")
#: (entry, dtype, B, nao, shells) timed: the fill at the dimer slice, the
#: w20 MBE(4) chunk and the FD Hessian's 241 AOs; the fused kernel at the
#: dimer slice, a w20 monomer bucket, the w20 MBE(4) chunks, a small batch
#: at 32, and at 48 and 64 on both sides of kWideAheadPerSM
CASES = tuple((*c, "mixed") for c in (
    ("fill", "f64", 512, 16), ("fill", "f64", 5985, 32),
    ("fill", "f64", 41, 241), ("fill", "f32", 512, 16),
    ("density", "f64", 512, 16), ("density", "f64", 20, 11),
    ("density", "f64", 2581, 32), ("density", "f64", 5985, 32),
    ("density", "f64", 256, 32), ("density", "f64", 128, 64),
    ("density", "f64", 600, 48), ("density", "f32", 512, 16),
    ("density", "f32", 5985, 32)))
DEFAULT = "base;P0:kPacked32PerSM=100000;W0:kWideAheadPerSM=0"


def parse(spec: str) -> list:
    """[(name, {constant: value})] of a spec `name[:C=V,...];...`."""
    out = []
    for part in filter(None, spec.split(";")):
        name, _, subs = part.partition(":")
        out.append((name, dict(kv.split("=") for kv in
                               filter(None, subs.split(",")))))
    return out


def make_variant(name: str, subs: dict) -> str:
    """A copy of the package with the constants set; its root."""
    root = os.path.join(PKG, "_build", "variants", name)
    dest = os.path.join(root, "metalquicha_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, dest, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    path = os.path.join(dest, SOURCE)
    with open(path) as fh:
        src = fh.read()
    for const, value in subs.items():
        src, count = re.subn(rf"(constexpr int {const} = )-?\d+",
                             rf"\g<1>{int(value)}", src)
        if count != 1:
            raise SystemExit(f"fermi_variants: {const} not found once in "
                             f"{SOURCE}")
    with open(path, "w") as fh:
        fh.write(src)
    return root


def parse_cases(spec: str) -> tuple:
    """CASES of a spec `entry:dtype:B,nao[:shells];...`."""
    out = []
    for part in filter(None, spec.split(";")):
        entry, dtype, shape, *rest = part.split(":")
        bsz, nao = map(int, shape.split(","))
        out.append((entry, dtype, bsz, nao, rest[0] if rest else "mixed"))
    return tuple(out)


def child(reps: int, cases) -> None:
    """Time the cases with the package first on the path; one JSON
    line."""
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_times_torch import graph_ms

    from metalquicha_tpu_torch.ops import fermi_fill as ff

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ff.build()
    kt = 300.0 * 3.1668115634556e-6
    out = []
    for entry, dtype, bsz, nao, shells in cases:
        rng = np.random.default_rng([bsz, nao, len(entry), len(dtype)])
        tdt = torch.float64 if dtype == "f64" else torch.float32
        eps, nelec, nuhf, mask = cs.fermi_inputs(rng, bsz, nao, tdt)
        if shells != "mixed":
            unpaired = 0.0 if shells == "closed" else 1.0
            nelec = nelec - nuhf + unpaired
            nuhf = torch.full_like(nuhf, unpaired)
        if entry == "fill":
            def fn():
                return ff.fermi_occupations(eps, nelec, nuhf, kt, mask)[0]
        else:
            c = torch.tensor(rng.standard_normal((bsz, nao, nao))
                             / np.sqrt(nao), dtype=tdt, device="cuda")
            def fn():
                return ff.fermi_density(eps, c, nelec, nuhf, kt, mask)
        got = fn()
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        out.append({"case": [entry, dtype, bsz, nao, shells],
                    "ms": graph_ms(fn, reps), "sha": digest})
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cases = parse_cases(args.cases) if args.cases else CASES
    if args.child:
        child(args.reps, cases)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("fermi_variants: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    variants = [(name, make_variant(name, subs))
                for name, subs in parse(args.variants)]
    if args.baseline:
        variants.append(("baseline", os.path.abspath(args.baseline)))
    build = ("from metalquicha_tpu_torch.ops import fermi_fill as ff; "
             "ff.build()")
    procs = [subprocess.Popen([sys.executable, "-c", build],
                              env={**os.environ, "PYTHONPATH": root})
             for _, root in variants]
    if any(p.wait() for p in procs):
        print("fermi_variants: a variant did not build", file=sys.stderr)
        return 1
    times = {name: [] for name, _ in variants}
    moved = {name: set() for name, _ in variants}
    shas = {}
    for name, root in variants + variants[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--reps", str(args.reps)] + (
                 ["--cases", args.cases] if args.cases else []),
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": root})
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        recs = json.loads(proc.stdout.strip().splitlines()[-1])
        times[name].append([r["ms"] for r in recs])
        for i, r in enumerate(recs):
            if shas.setdefault(i, r["sha"]) != r["sha"]:
                moved[name].add(i)
    result = {"card": card, "cases": [list(c) for c in cases],
              "variants": {}}
    for name, _ in variants:
        runs = times[name]
        best = [min(v) for v in zip(*runs)]
        result["variants"][name] = {"ms": best, "runs": runs,
                                    "bits_moved": sorted(moved[name])}
        for i, (case, ms) in enumerate(zip(cases, best)):
            flag = " BITS MOVED" if i in moved[name] else ""
            print(f"variant {name} {case}: ms={ms:.4f}{flag}", flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
