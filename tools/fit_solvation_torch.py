#!/usr/bin/env python3
"""Calibrate implicit solvation against the three reference solvation
energies (hydronium in water: ALPB, GBSA, CPCM), in PyTorch on the card:
the counterpart of tools/fit_solvation.py.

The gas-phase GFN1 parameterization must be fitted first
(fit_gfn1_torch.py); solvation parameters then absorb the solvation free
energy:
    ALPB  -5.91221983940207
    GBSA  -5.935225830899037
    CPCM  -5.881430808516041
ALPB and GBSA share the generalized-Born machinery (vdW radii, descreening,
intrinsic-radius offset) and differ by the ALPB correction; CPCM fits its
dielectric scaling and self-interaction.

Runs on the card unless given `--device cpu`, and raises without a card.
Writes `--out` (default tools/fitted_solv_torch.json) and warm-starts from
that same file when it exists; installs nothing.

Usage: python tools/fit_solvation_torch.py --iters 60
       python tools/fit_solvation_torch.py --iters 1 --device cpu
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
from metalquicha_tpu_torch.methods.xtb.batch import build_batch  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.calculator import (  # noqa: E402
    check_device,
    fragment_data_from_batch,
    single_point_energy,
)
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.solvation import (  # noqa: E402
    dielectric_for,
)
from metalquicha_tpu_torch.methods.xtb.solvation import born as born_mod  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.solvation import cpcm as cpcm_mod  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.solvation.born import (  # noqa: E402
    BornSolvation,
)
from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import (  # noqa: E402
    CpcmSolvation,
)

EXPECTED = {
    "alpb": -5.91221983940207,
    "gbsa": -5.935225830899037,
    "cpcm": -5.881430808516041,
}


def build_eval(device="cuda"):
    """energies(x): the three solvation energies of h3o+ at the parameter
    vector x, on `device`. The per-atom radii, descreening and scalars go
    into the fragment's `solv_*` fields; CPCM takes 1000 angular points
    per atom (the w1_water_cpcm input)."""
    device = check_device(device)
    geom = read_xyz_file(
        os.path.join(REPO, "validation", "inputs", "sample_inputs", "h3op.xyz")
    )
    numbers = geom.numbers
    frag_tuple = (numbers, geom.coords_angstrom * ANGSTROM_TO_BOHR, 1, 1)
    settings = settings_from_params("gfn1")
    base = fragment_data_from_batch(build_batch([frag_tuple]), device)
    is_h = np.asarray(numbers) == 1

    eps_w = dielectric_for("water")
    models = {
        "alpb": BornSolvation(dielectric=eps_w, alpb=True),
        "gbsa": BornSolvation(dielectric=eps_w, alpb=False),
        "cpcm": CpcmSolvation(dielectric=eps_w, nang=1000),
    }

    def f64(x):
        return torch.tensor(np.asarray(x, dtype=np.float64),
                            device=device)[None]

    tensions = {name: f64(model.host_tables(numbers).get(
        "solv_tension", np.zeros(len(numbers))))
        for name, model in models.items()}

    def e_of(name, rvdw, sx, scalars):
        frag = base._replace(
            solv_rvdw=f64(rvdw), solv_sx=f64(sx), solv_scalars=f64(scalars),
            solv_tension=tensions[name],
        )
        with torch.no_grad():
            e, _ = single_point_energy(frag.coords, frag, settings,
                                       solvation=models[name])
        return float(e[0])

    def energies(x):
        rv_a = np.where(is_h, x[0], x[1]) * ANGSTROM_TO_BOHR
        sx_a = np.where(is_h, x[2], x[3])
        sc_a = [x[4] * ANGSTROM_TO_BOHR, x[5],
                born_mod.GSHIFT_DEFAULT, born_mod.PROBE_RADIUS]
        rv_g = np.where(is_h, x[6], x[7]) * ANGSTROM_TO_BOHR
        sx_g = np.where(is_h, x[8], x[9])
        sc_g = [x[10] * ANGSTROM_TO_BOHR, 0.0,
                born_mod.GSHIFT_DEFAULT, born_mod.PROBE_RADIUS]
        sc_c = [x[11], x[12], 0.0, 0.0]
        rv_c = np.where(is_h, x[13], x[14]) * ANGSTROM_TO_BOHR
        return {
            "alpb": e_of("alpb", rv_a, sx_a, sc_a),
            "gbsa": e_of("gbsa", rv_g, sx_g, sc_g),
            "cpcm": e_of("cpcm", rv_c, np.zeros_like(sx_a), sc_c),
        }

    return energies


# [0:5] ALPB vdw_H/vdw_O/descreen_H/descreen_O/rho_offset_A; [5] ALPB alpha;
# [6:11] GBSA same five; [11:13] CPCM cosmo_x, zeta; [13:15] CPCM vdw_H/O
X0 = np.array([1.20, 1.52, 0.85, 0.85, 0.09, 0.571412,
               1.20, 1.52, 0.85, 0.85, 0.09,
               0.5, 1.07, 1.20, 1.52])
LB = np.array([0.6, 0.9, 0.3, 0.3, 0.0, 0.0,
               0.6, 0.9, 0.3, 0.3, 0.0,
               0.0, 0.5, 0.6, 0.9])
UB = np.array([2.5, 2.8, 1.2, 1.2, 0.6, 2.0,
               2.5, 2.8, 1.2, 1.2, 0.6,
               2.0, 2.5, 2.5, 2.8])


def apply_params(x):
    """Persist fitted values into the port's solvation modules."""
    ps_a = born_mod.PARAM_SETS["alpb"]
    ps_g = born_mod.PARAM_SETS["gbsa"]
    ps_a["vdw"][1], ps_a["vdw"][8] = x[0], x[1]
    ps_a["descreen"][1], ps_a["descreen"][8] = x[2], x[3]
    ps_a["rho_offset_a"], ps_a["alpha"] = x[4], x[5]
    ps_g["vdw"][1], ps_g["vdw"][8] = x[6], x[7]
    ps_g["descreen"][1], ps_g["descreen"][8] = x[8], x[9]
    ps_g["rho_offset_a"] = x[10]
    cpcm_mod.COSMO_X = x[11]
    cpcm_mod.SELF_INTERACTION = x[12]


def residuals_fn(energies, nang=230):
    def f(x):
        e = energies(x)
        return np.array([e[k] - EXPECTED[k] for k in ("alpb", "gbsa", "cpcm")])

    return f


NAMES = ["alpb_vdw_H", "alpb_vdw_O", "alpb_descreen_H", "alpb_descreen_O",
         "alpb_rho_offset_A", "alpb_alpha",
         "gbsa_vdw_H", "gbsa_vdw_O", "gbsa_descreen_H", "gbsa_descreen_O",
         "gbsa_rho_offset_A", "cosmo_x", "cpcm_zeta",
         "cpcm_vdw_H", "cpcm_vdw_O"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--nang", type=int, default=230)
    ap.add_argument("--out",
                    default=os.path.join(HERE, "fitted_solv_torch.json"))
    ap.add_argument("--diff-step", type=float, default=0.02,
                    help="relative FD step for the Jacobian")
    ap.add_argument("--tol", type=float, default=1e-8,
                    help="ftol/xtol/gtol for least_squares (tighten to "
                         "polish past the default 1e-8 stopping point)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; fails without one)")
    args = ap.parse_args(argv)

    energies = build_eval(args.device)
    f = residuals_fn(energies, args.nang)
    # warm start from an earlier run's output when present
    x_start = X0.copy()
    try:
        with open(args.out) as fh:
            prev = json.load(fh)
        x0_map = dict(zip(NAMES, x_start))
        for k, v in prev.items():
            if k in x0_map:
                x0_map[k] = float(v)
        x_start[:] = [x0_map[k] for k in NAMES]
        print("warm-started from", args.out)
    except (FileNotFoundError, json.JSONDecodeError):
        pass
    t0 = time.time()
    r0 = f(x_start)
    print("start residuals:", r0, f"[{time.time()-t0:.0f}s]")

    from scipy.optimize import least_squares

    res = least_squares(
        f, x_start, bounds=(LB, UB), diff_step=args.diff_step,
        max_nfev=args.iters * 9, verbose=2, x_scale="jac",
        ftol=args.tol, xtol=args.tol, gtol=args.tol,
    )
    print("final residuals:", f(res.x))
    out = dict(zip(NAMES, res.x.tolist()))
    out["residuals"] = dict(zip(EXPECTED, f(res.x).tolist()))
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
