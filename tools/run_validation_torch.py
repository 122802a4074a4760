#!/usr/bin/env python3
"""Physics validation runner for the torch port.

The port's counterpart of validation/run_validation.py: the same manifest
(validation/expected.json), the same inputs and the same checks, run
through `metalquicha_tpu_torch` only. Each JSON input is converted to .mqc
by the port's `io.prep`, run in-process, and compared with the upstream
expected values at --tol. Beside that, every case that the JAX package's
frozen float64 results hold (tests/data/port_golden_gfn1*.json, and
`w1_vib_therm`, the one GFN2 case, in port_golden_gfn2.json) is compared with them at the port's tolerances (`validation.GOLDEN_TOLERANCES`),
which is what says whether the port reproduces the JAX package: the deltas
to expected.json are the JAX package's own.

The exit code is 0 only when every case passes against expected.json and
none is off the JAX package's results. A case that raises reports ERROR
with the reason. The cases that the JAX package itself misses upstream's
value by more than --tol report FAIL here as there.

`--polish off` turns the f64 polish of an `--f32` run off (the driver's
`host_polish="off"`, as the command line's `--no-polish`): the raw
float32 results. `auto`, the default, polishes every float32 run.

Usage: python tools/run_validation_torch.py [--device cuda|cpu]
           [--filter NAME] [--skip-slow] [--tol T] [--f32]
           [--polish auto|off] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VALIDATION = os.path.join(REPO, "validation")
GOLDENS = (os.path.join(REPO, "tests", "data", "port_golden_gfn1.json"),
           os.path.join(REPO, "tests", "data", "port_golden_gfn1_full.json"))
GOLDEN_GFN2 = os.path.join(REPO, "tests", "data", "port_golden_gfn2.json")


def _jax_goldens() -> dict:
    cases = {}
    for path in GOLDENS:
        with open(path) as fh:
            cases.update(json.load(fh)["driver"])
    # the GFN2 file also holds GFN1 inputs switched to GFN2 under their
    # GFN1 names; only the manifest's own GFN2 case is taken from it
    with open(GOLDEN_GFN2) as fh:
        cases["w1_vib_therm"] = json.load(fh)["driver"]["w1_vib_therm"]
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--filter", default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; fails without one)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 working dtype (default float64)")
    ap.add_argument("--polish", default="auto", choices=("auto", "off"),
                    help="f64 polish of float32 results (auto = on for "
                         "every --f32 run; off = raw float32)")
    ap.add_argument("--json-out", default=None,
                    help="write per-case results/deltas to this JSON file")
    ap.add_argument("--skip-slow", action="store_true",
                    help="skip w20/gly10-scale tests")
    args = ap.parse_args(argv)

    from metalquicha_tpu_torch.driver import run_calculation
    from metalquicha_tpu_torch.io.config import parse_mqc_string
    from metalquicha_tpu_torch.io.prep import emit_mqc
    from metalquicha_tpu_torch.methods.xtb.calculator import check_device
    from metalquicha_tpu_torch.validation import (
        GOLDEN_TOLERANCES,
        checks,
        golden_failures,
        observables,
    )

    check_device(args.device)
    with open(os.path.join(VALIDATION, "expected.json")) as fh:
        manifest = json.load(fh)
    tol = args.tol if args.tol is not None else manifest["tolerance"]
    goldens = _jax_goldens()

    tests = manifest["tests"]
    if args.filter:
        tests = [t for t in tests if args.filter.lower() in t["name"].lower()]
    if args.skip_slow:
        tests = [t for t in tests if t["name"] not in ("w20_mbe", "gly10_mbe")]

    passed = failed = errored = off_jax = 0
    rows = []
    json_rows = []
    for test in tests:
        name = test["name"]
        json_path = os.path.join(VALIDATION, "inputs", test["input"])
        t0 = time.time()
        try:
            with open(json_path) as fh:
                data = json.load(fh)
            mqc_text = emit_mqc(data, base_dir=os.path.dirname(json_path))
            cfg = parse_mqc_string(mqc_text)
            overrides = {"host_polish": args.polish}
            if args.f32:
                overrides["force_dtype"] = "f32"
            outputs = run_calculation(cfg, input_path=test["input"],
                                      write_json=False,
                                      driver_overrides=overrides,
                                      device=args.device)
        except Exception as exc:  # noqa: BLE001
            errored += 1
            rows.append((name, "ERROR", str(exc)[:80], time.time() - t0))
            json_rows.append({"name": name, "status": "ERROR",
                              "error": str(exc)})
            continue
        seconds = time.time() - t0
        obs = observables(outputs)

        worst_delta = 0.0
        ok = True
        details = []
        compared = checks(obs, test)
        for label, got, exp in compared:
            delta = abs(got - exp)
            worst_delta = max(worst_delta, delta)
            this_tol = tol if label != "freq_max_dev_cm1" else 0.5
            if delta > this_tol:
                ok = False
            details.append(f"{label}: {got:+.9f} (exp {exp:+.9f}, d={delta:.2e})")

        # against the JAX package's frozen float64 results
        vs_jax = None
        jax_ok = None
        if name in goldens:
            vs_jax = [
                {"label": label, "got": float(got), "jax": float(exp),
                 "tolerance": GOLDEN_TOLERANCES[label.split("[")[0]]}
                for label, got, exp in checks(obs, goldens[name])
            ]
            jax_ok = not golden_failures(obs, goldens[name])
            off_jax += not jax_ok
            d_jax = max(abs(r["got"] - r["jax"]) for r in vs_jax)
            jax_note = (f"; vs JAX {'ok' if jax_ok else 'OFF'} "
                        f"d={d_jax:.2e}")
        else:
            jax_note = "; vs JAX: no frozen result"

        if ok:
            passed += 1
            rows.append((name, "PASS", f"worst d={worst_delta:.2e}" + jax_note,
                         seconds))
        else:
            failed += 1
            rows.append((name, "FAIL", "; ".join(details) + jax_note, seconds))
        json_rows.append(
            {
                "name": name,
                "status": "PASS" if ok else "FAIL",
                "worst_delta": worst_delta,
                "seconds": round(seconds, 2),
                "checks": [
                    {"label": label, "got": float(got), "expected": float(exp)}
                    for label, got, exp in compared
                ],
                "within_tolerance_of_jax": jax_ok,
                "vs_jax": vs_jax,
            }
        )

    print(f"\n{'='*100}")
    for name, status, info, dt in rows:
        mark = {"PASS": "+", "FAIL": "-", "ERROR": "!"}[status]
        print(f" [{mark}] {name:<24} {status:<6} [{dt:6.1f}s] {info}")
    print(f"{'='*100}")
    print(f" {passed} passed, {failed} failed, {errored} errored "
          f"(tolerance {tol:g}); {off_jax} off the JAX package's results")
    if args.json_out:
        import torch

        with open(args.json_out, "w") as fh:
            json.dump(
                {
                    "device": (torch.cuda.get_device_name(0)
                               if args.device == "cuda" else "cpu"),
                    "precision": "f32" if args.f32 else "f64",
                    "polish": args.polish,
                    "tolerance": tol,
                    "passed": passed,
                    "failed": failed,
                    "errored": errored,
                    "off_jax": off_jax,
                    "cases": json_rows,
                },
                fh,
                indent=1,
            )
        print(f" wrote {args.json_out}")
    return 0 if failed == 0 and errored == 0 and off_jax == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
