#!/usr/bin/env python3
"""The fragment product kernel's tiled class against variants of its own
source, on a card: each schedule choice measured beside its alternatives
in one process tree, with the bits compared.

A variant is this tree's package with constants of
`csrc/fragment_gemm.cu` set otherwise (`NAME=VALUE`, each a `constexpr
int NAME = VALUE` of the source: the plan's bands, k tiles, stages, the
threads a block, the row length staged by bulk copies).
Every variant is copied into the gitignored `metalquicha_tpu_torch/_build/
variants/<name>/`, built by its own process (all builds started
together), then each variant times the cases in a process of its own, in
turns: every variant once, then again in the reverse order. Each case is
the product `fragment_bmm` (or, past MAX_N in m, `_launch_bmm`, as the
op's backward launches it), graph-replayed (`kernel_times_torch.graph_ms`),
and its output's SHA-256 beside the first variant's: a variant that moves
a bit is reported as such (the kernel's bits may not move), with its
largest error relative to torch.matmul's largest entry.

Usage: python3 tools/tiled_variants_torch.py [--variants
base;S4:kTiledStages=4;...] [--cases f64:41,241,241,241,N,N;...] [--reps N]
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
SOURCE = os.path.join("csrc", "fragment_gemm.cu")
#: (dtype, B, m, k, n, trans_a, trans_b) timed: the wide squares (the
#: peptide's 241, SP2's 256), the small batches ((3, 128), (16, 96)),
#: CPCM's (nat, points) by (points, nat) at the w20 dimers as the engine
#: runs it (trans_a) and its backward's (points, nat) by (nat, nat)
CASES = (("f64", 41, 241, 241, 241, False, False),
         ("f64", 64, 256, 256, 256, False, False),
         ("f64", 3, 128, 128, 128, False, False),
         ("f64", 16, 96, 96, 96, False, False),
         ("f64", 190, 6, 660, 6, True, False),
         ("f64", 190, 660, 6, 6, False, False),
         ("f32", 41, 241, 241, 241, False, False),
         ("f32", 64, 256, 256, 256, False, False),
         ("f32", 3, 128, 128, 128, False, False),
         ("f32", 190, 6, 660, 6, True, False))
DEFAULT = ("base;W3:kWideStages=3;T2:kTiledStages=2;SK64:kSkinnyTileK=64;"
           "SB16:kSmallBand=16")


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
        src, count = re.subn(rf"(constexpr int [^;]*\b{const} = )\d+",
                             rf"\g<1>{int(value)}", src)
        if count != 1:
            raise SystemExit(f"tiled_variants: {const} not found once in "
                             f"{SOURCE}")
    with open(path, "w") as fh:
        fh.write(src)
    return root


def parse_cases(spec: str) -> tuple:
    """CASES of a spec `f64:B,m,k,n,T,N;...` (T: transposed)."""
    out = []
    for part in filter(None, spec.split(";")):
        dtype, _, rest = part.partition(":")
        *sizes, ta, tb = rest.split(",")
        out.append((dtype, *map(int, sizes), ta == "T", tb == "T"))
    return tuple(out)


def child(reps: int, cases) -> None:
    """Time the cases with the package first on the path; one JSON
    line."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from kernel_times_torch import graph_ms

    from metalquicha_tpu_torch.ops import fragment_gemm as fm

    fm.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for dtype, bsz, m, k, n, ta, tb in cases:
        rng = np.random.default_rng([bsz, m, k, n, ta, tb])
        tdt = torch.float64 if dtype == "f64" else torch.float32
        a = torch.tensor(rng.standard_normal(
            (bsz, *((k, m) if ta else (m, k)))), dtype=tdt, device="cuda")
        b = torch.tensor(rng.standard_normal(
            (bsz, *((n, k) if tb else (k, n)))), dtype=tdt, device="cuda")
        bmm = fm.fragment_bmm if fm.takes(m, n) else fm._launch_bmm
        got = bmm(a, b, ta, tb)
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        ref = torch.matmul(a.mT if ta else a, b.mT if tb else b)
        out.append({"case": [dtype, bsz, m, k, n, ta, tb],
                    "ms": graph_ms(lambda: bmm(a, b, ta, tb), reps),
                    "sha": digest, "err": float(
                        (got - ref).abs().max() / ref.abs().max())})
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cases = parse_cases(args.cases) if args.cases else CASES
    if args.child:
        child(args.reps, cases)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tiled_variants: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    variants = [(name, make_variant(name, subs))
                for name, subs in parse(args.variants)]
    build = ("from metalquicha_tpu_torch.ops import fragment_gemm as fm; "
             "fm.build()")
    procs = [subprocess.Popen([sys.executable, "-c", build],
                              env={**os.environ, "PYTHONPATH": root})
             for _, root in variants]
    if any(p.wait() for p in procs):
        print("tiled_variants: a variant did not build", file=sys.stderr)
        return 1
    times = {name: [] for name, _ in variants}
    moved = {name: set() for name, _ in variants}
    errs = {}
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
        errs[name] = [r["err"] for r in recs]
        for i, r in enumerate(recs):
            if shas.setdefault(i, r["sha"]) != r["sha"]:
                moved[name].add(i)
    result = {"card": card, "cases": [list(c) for c in cases],
              "variants": {}}
    for name, _ in variants:
        runs = times[name]
        best = [min(v) for v in zip(*runs)]
        result["variants"][name] = {"ms": best, "runs": runs,
                                    "bits_moved": sorted(moved[name]),
                                    "err": errs[name]}
        for i, (case, ms) in enumerate(zip(cases, best)):
            flag = (f" BITS MOVED (err {errs[name][i]:.2e})"
                    if i in moved[name] else "")
            print(f"variant {name} {case}: ms={ms:.4f}{flag}", flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
