#!/usr/bin/env python3
"""Calibrate the GFN2 table against the w1_vib_therm reference observables,
in PyTorch on the card: the counterpart of tools/fit_gfn2_w1.py.

The single upstream GFN2 case constrains energy, gradient norm, Hessian
Frobenius norm, the three real frequencies, ZPE and the Gibbs thermal
correction of one water molecule. This fits the H/O rows of the GFN2 table
with scipy least_squares over a reduced parameter vector; observables are
evaluated through the full pipeline (autograd gradients of the geometry
and of its 18 displacements for the FD Hessian as one batch, vibrational
+ RRHO analysis in the port's `numerics/`).

Runs on the card unless given `--device cpu`, and raises without a card.
Writes `--out` (default tools/fitted_gfn2_torch.json); installs nothing.

Usage: python tools/fit_gfn2_w1_torch.py --iters 40
       python tools/fit_gfn2_w1_torch.py --iters 1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from metalquicha_tpu_torch.constants import ANGSTROM_TO_BOHR  # noqa: E402
from metalquicha_tpu_torch.io.xyz import read_xyz_file  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.calculator import (  # noqa: E402
    check_device,
    single_point_energy,
)
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.param_fit import (  # noqa: E402
    FragmentSpec,
    theta_from_overlay,
    theta_init,
)
from metalquicha_tpu_torch.numerics.finite_differences import (  # noqa: E402
    displaced_geometries,
    hessian_from_gradients,
)
from metalquicha_tpu_torch.numerics.thermochemistry import (  # noqa: E402
    compute_thermochemistry,
)
from metalquicha_tpu_torch.numerics.vibrational import (  # noqa: E402
    compute_vibrational_analysis,
)

EXPECTED = {
    "energy": -5.07054435383808,
    "grad_norm": 0.00018502438172,
    "hess_norm": 1.364748705645287,
    "freqs": [1538.8240294028515, 3642.8646747909797, 3651.4750140948781],
    "zpe": 0.020123434314,
    "gibbs": 0.001844309467,
}

# residual weights (bring observables to comparable scales)
W = {"energy": 1.0, "grad_norm": 20.0, "hess_norm": 0.3,
     "freq": 2.0e-4, "zpe": 20.0, "gibbs": 20.0}

FIT_KEYS = ("levels", "slater", "kcn", "shpoly", "gam", "lgam", "gam3",
            "alpha", "zeff", "e0", "aes")


def build_eval(device="cuda"):
    """observables(theta): the w1 observables at a GFN2 theta on `device`,
    or None where the evaluation fails."""
    geom = read_xyz_file(
        os.path.join(REPO, "validation", "inputs", "sample_inputs", "w1.xyz")
    )
    numbers = geom.numbers
    coords = geom.coords_angstrom * ANGSTROM_TO_BOHR
    settings = settings_from_params("gfn2")
    spec = FragmentSpec(numbers, coords, 0, 1, variant="gfn2", device=device)

    def grads_of(theta, c_b):
        """(energies (B,), gradients (B, nat, 3)) at geometries c_b."""
        c = torch.tensor(np.asarray(c_b), device=spec.device,
                         requires_grad=True)
        frag = spec.rebuild(theta, c)
        e, _ = single_point_energy(c, frag, settings)
        (g,) = torch.autograd.grad(e.sum(), c)
        return e.detach().cpu().numpy(), g.cpu().numpy()

    disp = 0.005
    displaced = displaced_geometries(coords, disp)

    def observables(theta):
        # a failed evaluation (an eigensolver or SCC blowup at a trial
        # point) is a large residual for the optimizer, not an abort
        try:
            # the geometry and its 18 displacements as one batch
            e, g = grads_of(theta, np.concatenate([coords[None], displaced]))
            grads = g[1:]
            if not np.isfinite(g).all() or not np.isfinite(e[0]):
                return None
            hess = hessian_from_gradients(grads, disp)
            vib = compute_vibrational_analysis(hess, numbers, coords)
            thermo = compute_thermochemistry(vib.frequencies, numbers, coords)
        except Exception as exc:  # noqa: BLE001
            print(f"    [warn] evaluation failed: {exc!r}")
            return None
        real = np.sort(vib.frequencies)[-3:]
        return {
            "energy": float(e[0]),
            "grad_norm": float(np.sqrt((g[0] ** 2).sum())),
            "hess_norm": float(np.sqrt((hess**2).sum())),
            "freqs": real.tolist(),
            "zpe": thermo.zpe_hartree,
            "gibbs": thermo.thermal_correction_gibbs,
        }

    return observables


def pack(theta):
    vec, meta = [], []
    for z in (1, 8):
        el = theta["elements"][z]
        for key in FIT_KEYS:
            v = np.atleast_1d(el[key].detach().cpu().numpy().astype(float))
            vec.extend(v.tolist())
            meta.append((z, key, len(v)))
    return np.array(vec), meta


def unpack(vec, meta, theta0):
    theta = {k: v for k, v in theta0.items() if k != "elements"}
    theta["elements"] = {z: dict(el) for z, el in theta0["elements"].items()}
    pos = 0
    for z, key, n in meta:
        vals = np.asarray(vec[pos: pos + n], dtype=np.float64)
        pos += n
        cur = theta["elements"][z][key]
        theta["elements"][z][key] = torch.tensor(
            vals if cur.ndim else vals[0], dtype=torch.float64,
            device=cur.device)
    return theta


def residuals(obs):
    if obs is None:  # failed evaluation (e.g. eigensolver blowup)
        return np.full(8, 10.0)
    r = [
        W["energy"] * (obs["energy"] - EXPECTED["energy"]),
        W["grad_norm"] * (obs["grad_norm"] - EXPECTED["grad_norm"]),
        W["hess_norm"] * (obs["hess_norm"] - EXPECTED["hess_norm"]),
        W["zpe"] * (obs["zpe"] - EXPECTED["zpe"]),
        W["gibbs"] * (obs["gibbs"] - EXPECTED["gibbs"]),
    ]
    for got, exp in zip(obs["freqs"], EXPECTED["freqs"]):
        r.append(W["freq"] * (got - exp))
    return np.array(r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out",
                    default=os.path.join(HERE, "fitted_gfn2_torch.json"))
    ap.add_argument("--seed-from", default=None,
                    help="start from a fitted GFN1 json (usually closer)")
    ap.add_argument("--prior", type=float, default=3e-3,
                    help="anchoring weight on relative parameter moves "
                         "from the seed (the w1 case has 8 observables "
                         "against dozens of parameters; unanchored, the "
                         "optimizer wanders to tables that nail w1 but "
                         "destabilize the SCC elsewhere). 0 disables.")
    ap.add_argument("--whess", type=float, default=W["hess_norm"],
                    help="hess_norm residual weight (boost when polishing "
                         "from an already-good seed)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; fails without one)")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    W["hess_norm"] = args.whess

    theta0 = theta_init("gfn2", device)
    if args.seed_from:
        theta0 = theta_from_overlay(args.seed_from, "gfn2", device)

    observe = build_eval(device)
    x0, meta = pack(theta0)
    t0 = time.time()

    obs = observe(theta0)
    print("start:", json.dumps(obs), f"[{time.time()-t0:.0f}s]")

    from scipy.optimize import least_squares

    # prior anchoring: relative move from the seed, so levels (~0.5 Ha),
    # slater (~1-2) and zeff (~1-8) are penalized comparably
    x_scale0 = np.maximum(np.abs(x0), 0.1)

    def f(x):
        r = residuals(observe(unpack(x, meta, theta0)))
        if args.prior > 0:
            r = np.concatenate([r, args.prior * (x - x0) / x_scale0])
        return r

    res = least_squares(
        f, x0, method="lm" if len(x0) <= 8 else "trf",
        max_nfev=args.iters * (len(x0) + 1), diff_step=1e-5, verbose=2,
        x_scale="jac",
    )
    theta = unpack(res.x, meta, theta0)
    obs = observe(theta)
    print("final:", json.dumps(obs))
    print("expected:", json.dumps(EXPECTED))

    out = {
        "elements": {
            str(z): {k: v.detach().cpu().numpy().tolist()
                     for k, v in el.items()}
            for z, el in theta["elements"].items()
        },
        "final_observables": obs,
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out} [{time.time()-t0:.0f}s]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
