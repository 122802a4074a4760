#!/usr/bin/env python3
"""Quantify the port's accuracy on the card in its three precisions: the
counterpart of tools/tpu_accuracy.py.

Runs the validation suite (tools/run_validation_torch.py) three ways and
writes H100_ACCURACY.json + H100_ACCURACY.md:

1. f64               — `--device cuda`: the parity path, the default.
2. f32 raw           — `--device cuda --f32 --polish off`: the device's
                       float32 SCC with the polish disabled, the error
                       envelope the f64 polish exists to close.
3. f32 + polish      — `--device cuda --f32`: float32 SCC with the f64
                       polish of the variational functional at the
                       converged charges (methods/xtb/polish.py), the
                       "production" column of the JAX report.

The headline table is leg 3 against leg 1; leg 2 is recorded alongside.
The rows keep the JAX report's keys, so the f64 leg's columns are named
`cpu_*` there as here. The header names the card and its power limit.

Each leg runs in a subprocess of its own, as the JAX report's do. An f64
or f32 + polish leg that cannot run a case (ERROR) stops the report;
cases that miss upstream's expected value (FAIL, as they do for the JAX
package) do not, and each leg's count of cases off the JAX package's
frozen results stands in the table.

Usage:
    python tools/h100_accuracy.py [--skip-slow] [--device cuda|cpu]
    python tools/h100_accuracy.py --cpu-json A.json --raw-json B.json \
        --prod-json C.json     # just compare existing runs
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
VAL = os.path.join(HERE, "run_validation_torch.py")


def _run(out: str, skip_slow: bool, *flags: str, strict: bool = True) -> None:
    cmd = [sys.executable, VAL, "--json-out", out, *flags]
    if skip_slow:
        cmd.append("--skip-slow")
    # the runner exits 1 for the cases that miss upstream's value in both
    # packages; the JSON it writes says whether a case errored
    proc = subprocess.run(cmd, check=False, cwd=REPO)
    if not os.path.exists(out):
        raise SystemExit(f"validation leg {flags} wrote no JSON "
                         f"(rc={proc.returncode})")
    with open(out) as fh:
        res = json.load(fh)
    if strict and res["errored"]:
        raise SystemExit(f"validation leg {flags}: {res['errored']} cases "
                         "errored")


def _values(case: dict) -> dict:
    """Flatten a case's checks to {observable_label: got_value}."""
    return {
        chk["label"]: float(chk["got"])
        for chk in case.get("checks", [])
        if isinstance(chk.get("got"), (int, float))
    }


def _worst_vs(base_case: dict, other_case: dict):
    vb, vo = _values(base_case), _values(other_case)
    worst, worst_obs = 0.0, None
    for obs, v in vb.items():
        if obs in vo:
            d = abs(vo[obs] - v)
            if d > worst:
                worst, worst_obs = d, obs
    return worst, worst_obs


def compare(cpu_json: str, raw_json: str, prod_json: str):
    """Rows of the report, worst first: per case, the largest difference of
    any observable of the f32 + polish leg (`prod_json`) and of the raw
    f32 leg from the f64 leg (`cpu_json`), and each leg's status."""
    with open(cpu_json) as fh:
        cpu = {c["name"]: c for c in json.load(fh)["cases"]}
    with open(raw_json) as fh:
        raw = {c["name"]: c for c in json.load(fh)["cases"]}
    with open(prod_json) as fh:
        prod = {c["name"]: c for c in json.load(fh)["cases"]}

    rows = []
    for name, cprod in prod.items():
        ccpu = cpu.get(name)
        if ccpu is None:
            continue
        d_prod, obs_prod = _worst_vs(ccpu, cprod)
        craw = raw.get(name)
        d_raw, _ = _worst_vs(ccpu, craw) if craw else (None, None)
        rows.append({
            "case": name,
            "production_vs_f64": d_prod,
            "worst_observable": obs_prod,
            "raw_f32_vs_f64": d_raw,
            "cpu_status": ccpu.get("status"),
            "production_status": cprod.get("status"),
            "cpu_vs_expected": ccpu.get("worst_delta"),
            "production_vs_expected": cprod.get("worst_delta"),
        })
    rows.sort(key=lambda r: -(r["production_vs_f64"] or 0.0))
    return rows


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-json", default=None,
                    help="an existing f64 leg's JSON (skips that leg)")
    ap.add_argument("--raw-json", default=None,
                    help="an existing raw f32 leg's JSON (skips that leg)")
    ap.add_argument("--prod-json", default=None,
                    help="an existing f32 + polish leg's JSON")
    ap.add_argument("--skip-slow", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; fails without one)")
    ap.add_argument("--out-prefix",
                    default=os.path.join(REPO, "H100_ACCURACY"))
    args = ap.parse_args(argv)

    from metalquicha_tpu_torch.methods.xtb.calculator import check_device

    if None in (args.cpu_json, args.raw_json, args.prod_json):
        check_device(args.device)
    dev = ["--device", args.device]
    with tempfile.TemporaryDirectory() as tmp:
        cpu_json = args.cpu_json or os.path.join(tmp, "val_f64.json")
        raw_json = args.raw_json or os.path.join(tmp, "val_f32_raw.json")
        prod_json = args.prod_json or os.path.join(tmp, "val_f32_polish.json")
        if args.cpu_json is None:
            _run(cpu_json, args.skip_slow, *dev)
        if args.raw_json is None:
            _run(raw_json, args.skip_slow, *dev, "--f32", "--polish", "off",
                 strict=False)
        if args.prod_json is None:
            _run(prod_json, args.skip_slow, *dev, "--f32")
        legs = {}
        for leg, path in (("f64", cpu_json), ("f32_raw", raw_json),
                          ("f32_polish", prod_json)):
            with open(path) as fh:
                res = json.load(fh)
            legs[leg] = {k: res.get(k) for k in (
                "device", "precision", "polish", "passed", "failed",
                "errored", "off_jax")}
            legs[leg]["seconds"] = round(
                sum(c.get("seconds", 0.0) for c in res["cases"]), 2)
        rows = compare(cpu_json, raw_json, prod_json)
        # a raw f32 case that raised has no observables: its distance of
        # 0.0 from compare means "not run", and the table says so
        with open(raw_json) as fh:
            raw_status = {c["name"]: c["status"]
                          for c in json.load(fh)["cases"]}
        for r in rows:
            r["raw_f32_status"] = raw_status.get(r["case"])

    device = card() if args.device == "cuda" else "cpu"
    with open(args.out_prefix + ".json", "w") as fh:
        json.dump({"card": device, "skip_slow": args.skip_slow,
                   "legs": legs, "cases": rows}, fh, indent=1)

    lines = [
        "# H100 accuracy of the port's three precisions",
        "",
        f"Card: {device} (`nvidia-smi --query-gpu=name,power.limit`). "
        "Written by `tools/h100_accuracy.py"
        + (" --skip-slow" if args.skip_slow else "") + "`.",
        "",
        "Per validation case, the largest deviation of any observable of",
        "the f32 + polish route (float32 SCC, then the f64 polish of the",
        "variational functional at the converged charges,",
        "`methods/xtb/polish.py`; `--f32`) from the float64 path, the",
        "port's default. The raw-f32 column is the same float32 run with",
        "the polish disabled (`--f32 --polish off`): the envelope the",
        "polish closes; ERROR there is a case whose float32 SCC stalled",
        "above the factory's scf_tol, which the driver refuses. The",
        "last two columns are each leg's worst distance from upstream's",
        "expected values; an observable of None means no difference at",
        "all.",
        "",
        "| leg | passed | failed | errored | off JAX | case seconds |",
        "|---|---|---|---|---|---|",
    ]
    for leg, s in legs.items():
        lines.append(f"| {leg} | {s['passed']} | {s['failed']} | "
                     f"{s['errored']} | {s['off_jax']} | {s['seconds']} |")
    lines += [
        "",
        "| case | f32 + polish vs f64 | observable | raw f32 vs f64 | "
        "f64 vs expected | f32 + polish vs expected |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        draw = r.get("raw_f32_vs_f64")
        if r["raw_f32_status"] == "ERROR":
            draw = "ERROR"
        elif draw is not None:
            draw = f"{draw:.3e}"
        c64 = r.get("cpu_vs_expected")
        cpr = r.get("production_vs_expected")
        lines.append(
            f"| {r['case']} | {r['production_vs_f64']:.3e} | "
            f"{r['worst_observable']} | "
            + (draw or "n/a") + " | "
            + (f"{c64:.2e}" if c64 is not None else "n/a") + " | "
            + (f"{cpr:.2e}" if cpr is not None else "n/a") + " |"
        )
    with open(args.out_prefix + ".md", "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {args.out_prefix}.json / .md ({len(rows)} cases)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
