#!/usr/bin/env python3
"""Freeze the JAX package's float64 CPU results that the torch port is
held to.

Writes, from the repository root:
- tests/data/port_prism.mqc and tests/data/port_w20_mbe4.mqc, emitted from
  validation/inputs/prism.json and w20_isomer.json by
  `metalquicha_tpu.io.prep.emit_mqc` (geometry inlined) as
  validation/run_validation.py does;
- tests/data/port_golden_gfn1.json: the first 8 dimers of bench.py's batch
  (energies, gradients, converged shell charges, e_el/e_rep/e_disp), the
  w20 MBE(2) total and assembled-gradient norm of bench.py's executor
  pass, and the driver totals of prism_mbe and w20_mbe, with the commit;
- tests/data/port_golden_gfn1_full.json and tests/data/port_full_<case>.mqc:
  the other GFN1 cases of validation/expected.json through `run_calculation`
  (totals, and where the case has them gradient norm, Hessian Frobenius
  norm, frequencies, ZPE, Gibbs correction; the padded (nat, nsh, nao) and
  size of every executor chunk, which shows the cases whose AO count
  exceeds the Jacobi kernel's 64 and so reach SP2 on the fast route); a
  single water with ALPB, GBSA and CPCM (energy, gamma_at, Born radii,
  surface energy, gradient); and bench.py's w20 MBE(2) list with ALPB
  water (energies, gradients, total, |g|) and CPCM water (energies).

- tests/data/port_golden_gfn2.json, tests/data/port_gfn2_<case>.mqc: GFN2
  (multipole SCC, charge-scaled dispersion). The first 8 bench dimers
  (energies, gradients, packed converged state, dipoles); the converged
  states of the molecules of tests/data/gfn2_fixtures.json; the warm-start
  (`q_init`, from a perturbed converged state) and refine
  (`diff_scf_iters=3`) entries of `single_point_energy` on the first two
  dimers in GFN1 and GFN2; the w20 MBE(2) list in vacuum (gradients) and
  with ALPB water (energies); `w1_vib_therm` (Hessian, frequencies,
  thermochemistry), prism MBE(2) and w20 MBE(3) through the driver with
  the method switched to XTB-GFN2 (w20 MBE(4) raises ConvergenceError in
  the JAX package; its .mqc is written for the port's timing run).

- tests/data/port_golden_polish_fit.json: the mixed-precision route and
  the differentiable parameterization. `HostPolisher.polish` and `rescue`
  on three jittered waters (seed 7) in GFN1 and GFN2, with the float32
  leg's state they started from and the all-float64 results; the cases of
  tests/test_polish.py through the driver in float64 (two waters: energy,
  gradient, GFN2 gradient, Hessian at level 1 with its top frequencies),
  with the input they ran; `theta_init` and every field of
  `FragmentSpec.rebuild(theta_init)` on a six-atom fragment, dE/dtheta of
  a water and the mixed derivative d/dtheta |grad_R E|^2 of two jittered
  waters with three recorded refine steps, in GFN1 and GFN2.

- tests/data/port_golden_fit_tools.json: the training programs
  (tools/fit_gfn1.py, fit_gfn2_w1.py, fit_solvation.py) from the shipped
  overlay: the value and per-leaf theta-gradient of `TargetEval` for h3o
  and prism_mbe, `GradNormTarget` h3o_gnorm, `HessNormTarget` h3o_hnorm
  and `MbeHessNormTarget` prism_hnorm; the output JSON of `fit_gfn1.py
  --targets h3o,h3o_gnorm --iters 1`; `fit_gfn2_w1.build_eval()` at
  `theta_init("gfn2")`; `fit_solvation.build_eval()` at X0 and at one
  perturbed x; each with its JAX wall time in `seconds`.

- tests/data/port_golden_decane_gap.json: the decane GMBE(1) and
  unfragmented totals through the driver and their gap (the pair of
  tests/test_gmbe_tail_sentinel.py, at the JAX package's HEAD).

- tests/data/port_golden_memory.json, tests/data/port_memory_<case>.mqc:
  the driver workflows the executor's byte guard lets run on a card.
  validation/inputs/no_frag.json (73 atoms) with its driver set to
  "Hessian": the JAX gradients at the 12 displaced geometries of atoms 0
  and 40 (+x, -x, +y, -y, +z, -z at the driver's displacement, in
  batches of 4) and their central-difference Hessian rows; w20_isomer.json
  at MBE(4) with driver "Gradient": the JAX energies and gradients of 48
  tetramers evenly spaced over the driver's fragment list, by their index
  in it (the total is port_golden_gfn1.json's w20_mbe); the energies and
  gradients of the 40 jittered water trimers of
  tests/_torch_port_common.py `jittered_trimers` through the JAX
  executor with the default GFN1 calculator in float64.

- tests/data/port_golden_elements_spd.json: the behaviours of
  tests/test_elements_spd.py and tests/test_elements_ext.py beyond HCNO
  (inputs in tests/_torch_port_common.py): the NaCl + water MBE(2) driver
  total; the energies and SCC residuals of SiH4, Si, H, NaCl, Na, Cl, KBr
  and CH3I; the Fe(CO)2, Zn-water and Pt-ammonia energies, gradients
  and dispersion energies at 8 SCC iterations (their SCC converges in
  neither package).

Usage: python tools/gen_port_golden.py
           [--only gfn1|full|gfn2|polish_fit|fit_tools|decane_gap|
                   elements_spd|memory]
(about five minutes on a CPU for gfn1 and full; gfn2 see its `seconds`;
polish_fit about six minutes; fit_tools see its `seconds`)
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from metalquicha_tpu.driver import _make_executor, run_calculation  # noqa: E402
from metalquicha_tpu.io.adapter import config_to_driver  # noqa: E402
from metalquicha_tpu.io.config import read_mqc_file  # noqa: E402
from metalquicha_tpu.io.prep import emit_mqc  # noqa: E402
from metalquicha_tpu.logging_ import global_logger  # noqa: E402
from metalquicha_tpu.methods.xtb.calculator import XtbCalculator  # noqa: E402
from metalquicha_tpu.methods.xtb.engine import settings_from_params  # noqa: E402
from metalquicha_tpu.methods.xtb.solvation.born import BornSolvation  # noqa: E402
from metalquicha_tpu.methods.xtb.solvation.cpcm import CpcmSolvation  # noqa: E402
from metalquicha_tpu.parallel.executor import FragmentExecutor  # noqa: E402
from metalquicha_tpu_torch.workloads import (  # noqa: E402
    WATER_BOHR,
    bench_dimers,
    w20_mbe2_assemble,
    w20_mbe2_fragments,
)

DATA = os.path.join(ROOT, "tests", "data")
N_DIMERS = 8
MQC = {"prism_mbe": ("prism.json", "port_prism.mqc"),
       "w20_mbe": ("w20_isomer.json", "port_w20_mbe4.mqc")}


def _commit() -> str:
    proc = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                          capture_output=True, text=True, check=False)
    return proc.stdout.strip() or "unknown"


#: validation/expected.json name -> validation/inputs file, for the GFN1
#: cases beyond prism_mbe and w20_mbe
FULL_CASES = {
    "h3o_unfrag": "h3o.json",
    "unfrag_gly3": "no_frag.json",
    "gly10_mbe": "gly10.json",
    "multi_frag": "multi_frag.json",
    "multi_structure": "multi_structure.json",
    "charged_cluster_mbe": "charged_cluster.json",
    "prism_mbe_groups1": "prism_global_groups1.json",
    "gmbe1_gly3": "overlapping_gly3.json",
    "gmbe3_decane": "nlevel_3_ov_decane.json",
    "hess_h3o": "hess_h3o.json",
    "prism_hessian": "prism_hessian.json",
    "hess_gly3_ov": "hess_gly3_ov.json",
    "hess_gly3_serial": "hess_gly3_serial.json",
    "alpb_water": "w1_water.json",
    "gbsa_water": "w1_water_gbsa.json",
    "cpcm_water": "w1_water_cpcm.json",
}
FULL_PATH = os.path.join(DATA, "port_golden_gfn1_full.json")
WATER_DIELECTRIC = 78.4


def _emit(src: str, dst: str) -> str:
    """validation/inputs/<src> as tests/data/<dst> (.mqc, geometry inlined)."""
    json_path = os.path.join(ROOT, "validation", "inputs", src)
    with open(json_path) as fh:
        text = emit_mqc(json.load(fh), base_dir=os.path.dirname(json_path))
    mqc_path = os.path.join(DATA, dst)
    with open(mqc_path, "w") as fh:
        fh.write(text)
    return mqc_path


def _norm(x) -> float:
    return float(math.sqrt(float((np.asarray(x) ** 2).sum())))


def _driver_case(name: str, src: str) -> dict:
    """One validation case through the JAX driver, factory settings."""
    dst = f"port_full_{name}.mqc"
    cfg = read_mqc_file(_emit(src, dst))
    ex = _make_executor(config_to_driver(cfg))
    chunks = []
    run_chunk = ex._run_chunk

    def recording(members, pad_to, *args):
        chunks.append({"pad_to": [int(x) for x in pad_to],
                       "n": len(members)})
        return run_chunk(members, pad_to, *args)

    ex._run_chunk = recording
    t0 = time.time()
    outputs = run_calculation(cfg, write_json=False, executor=ex)
    entry = {"mqc": f"tests/data/{dst}", "seconds": round(time.time() - t0, 1),
             "chunks": chunks,
             "max_nao": max(c["pad_to"][2] for c in chunks)}
    if "" in outputs:
        out = outputs[""]
        entry["total_energy"] = float(out.result.total_energy)
        if out.result.gradient is not None:
            entry["gradient_norm"] = _norm(out.result.gradient)
        if out.result.hessian is not None:
            entry["hessian_frobenius_norm"] = _norm(out.result.hessian)
        if out.vibrational is not None:
            entry["frequencies"] = [float(f)
                                    for f in out.vibrational.frequencies]
        if out.thermo is not None:
            entry["zpe"] = float(out.thermo.zpe_hartree)
            entry["gibbs_correction"] = float(
                out.thermo.thermal_correction_gibbs)
    else:
        entry["energies"] = {mol: float(out.result.total_energy)
                             for mol, out in outputs.items()}
    return entry


def _solvation_models():
    return {
        "alpb": BornSolvation(WATER_DIELECTRIC, alpb=True),
        "gbsa": BornSolvation(WATER_DIELECTRIC, alpb=False),
        "cpcm": CpcmSolvation(WATER_DIELECTRIC),
    }


def _water_solvated() -> dict:
    """A single water (workloads.WATER_BOHR) with each model."""
    water = (np.array([8, 1, 1]), WATER_BOHR, 0, 1)
    out = {"dielectric": WATER_DIELECTRIC}
    for name, model in _solvation_models().items():
        calc = XtbCalculator(variant="gfn1", solvation=model)
        frag = calc.make_batch([water])
        one = jax.tree.map(lambda x: x[0], frag)
        entry = {
            "gamma_at": np.asarray(model.gamma_atoms(
                one.coords, one.solv_rvdw, one.solv_sx, one.atom_mask,
                scalars=one.solv_scalars)).tolist(),
        }
        if name == "cpcm":
            e, _aux = calc.energies(frag)
        else:
            # the JAX package's CPCM gradient is NaN, so none is frozen
            e, g, _aux = calc.gradients(frag)
            entry["gradient"] = np.asarray(g)[0].tolist()
            entry["born_radii"] = np.asarray(model.born_radii(
                one.coords, one.solv_rvdw, one.solv_sx, one.atom_mask,
                one.solv_scalars[0])).tolist()
            entry["surface_energy"] = float(
                model.surface_energy(one.coords, one))
        entry["energy"] = float(np.asarray(e)[0])
        out[name] = entry
    return out


def _w20_solvated() -> dict:
    """bench.py's w20 MBE(2) list with ALPB water (gradients) and CPCM
    water (energies, 110 angular points), bench's 32-iteration settings."""
    settings = settings_from_params("gfn1", max_scf_iter=32,
                                    use_pallas_eigh=True)
    models = _solvation_models()
    frags = w20_mbe2_fragments()
    out = {"dielectric": WATER_DIELECTRIC, "max_scf_iter": 32}

    calc = XtbCalculator(settings, dtype=jnp.float64, solvation=models["alpb"])
    e, g, aux = FragmentExecutor(calc).run(frags, what="gradient")
    total, gnorm = w20_mbe2_assemble(e, g)
    out["alpb"] = {
        "total": total, "gradient_norm": gnorm,
        "energies": np.asarray(e).tolist(),
        "gradients": [np.asarray(x).tolist() for x in g],
        "scf_residual_max": float(aux["scf_residual"].max()),
    }
    calc = XtbCalculator(settings, dtype=jnp.float64, solvation=models["cpcm"])
    e, aux = FragmentExecutor(calc).run(frags, what="energy")
    total, _ = w20_mbe2_assemble(e, [np.zeros((len(f[0]), 3)) for f in frags])
    out["cpcm"] = {
        "total": total, "nang": models["cpcm"].nang,
        "energies": np.asarray(e).tolist(),
        "scf_residual_max": float(aux["scf_residual"].max()),
    }
    return out


def gen_full() -> None:
    """Write port_golden_gfn1_full.json and its .mqc files."""
    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu",
              "driver": {}}
    for name, src in FULL_CASES.items():
        t0 = time.time()
        golden["driver"][name] = _driver_case(name, src)
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
    for name, fn in (("water_solvated", _water_solvated),
                     ("w20_mbe2_solvated", _w20_solvated)):
        t0 = time.time()
        golden[name] = fn()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
    with open(FULL_PATH, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")


GFN2_PATH = os.path.join(DATA, "port_golden_gfn2.json")
#: name -> (validation input, .mqc written, MBE level override or None)
GFN2_DRIVER = {
    "w1_vib_therm": ("w1_vib_therm.json", "port_gfn2_w1_vib_therm.mqc", None),
    "prism_mbe": ("prism.json", "port_gfn2_prism.mqc", None),
    # the JAX package's GFN2 SCC does not converge for one tetramer of
    # w20 MBE(4) (the driver raises ConvergenceError), so MBE(3) is frozen;
    # the MBE(4) input is written for the port's timing run only
    "w20_mbe3": ("w20_isomer.json", "port_gfn2_w20_mbe3.mqc", 3),
}
#: seed and size of the perturbation of the converged state that the
#: warm-start goldens start from
Q_INIT_SEED, Q_INIT_SCALE = 7, 1.0e-4


def _emit_gfn2(src: str, dst: str, level=None) -> str:
    """validation/inputs/<src> with the method switched to XTB-GFN2."""
    json_path = os.path.join(ROOT, "validation", "inputs", src)
    with open(json_path) as fh:
        data = json.load(fh)
    data["model"]["method"] = "XTB-GFN2"
    if level is not None:
        data["keywords"]["fragmentation"]["level"] = level
    text = emit_mqc(data, base_dir=os.path.dirname(json_path))
    mqc_path = os.path.join(DATA, dst)
    with open(mqc_path, "w") as fh:
        fh.write(text)
    return mqc_path


def _refine_entries(variant: str) -> dict:
    """`single_point_energy` with q_init and with diff_scf_iters=3 on the
    first two bench dimers (one batch), energies and gradients."""
    from metalquicha_tpu.methods.xtb.calculator import single_point_energy

    settings = settings_from_params(variant, max_scf_iter=64, scf_tol=1e-11)
    calc = XtbCalculator(settings, variant=variant, dtype=jnp.float64)
    frag = calc.make_batch(bench_dimers(2))
    _e, aux = calc.energies(frag)
    z_star = np.asarray(aux["shell_charges"])
    rng = np.random.default_rng(Q_INIT_SEED)
    q_init = z_star + Q_INIT_SCALE * rng.standard_normal(z_star.shape)

    def entry(diff_scf_iters=0):
        """Per-fragment (energy, gradient, residual, state); the optional
        third argument is the warm start."""
        def one(coords, fr, q0=None):
            (e, aux), g = jax.value_and_grad(
                single_point_energy, has_aux=True
            )(coords, fr, settings, None, diff_scf_iters=diff_scf_iters,
              q_init=q0)
            return e, g, aux["scf_residual"], aux["shell_charges"]
        return jax.jit(jax.vmap(one))

    out = {"max_scf_iter": 64, "scf_tol": 1e-11, "n": 2,
           "q_init_seed": Q_INIT_SEED, "q_init_scale": Q_INIT_SCALE,
           "q_init": q_init.tolist()}
    e, g, r, z = entry()(frag.coords, frag, jnp.asarray(q_init))
    out["warm"] = {"energies": np.asarray(e).tolist(),
                   "gradients": np.asarray(g).tolist(),
                   "scf_residual": np.asarray(r).tolist(),
                   "state": np.asarray(z).tolist()}
    e, g, r, z = entry(diff_scf_iters=3)(frag.coords, frag)
    out["refine3"] = {"energies": np.asarray(e).tolist(),
                      "gradients": np.asarray(g).tolist(),
                      "state": np.asarray(z).tolist()}
    return out


def _fixture_states() -> dict:
    """The converged packed states of tests/data/gfn2_fixtures.json's
    molecules (the settings of tests/test_gfn2_fixtures.py). CH4's SCC map
    has a second fixed point and its cold-start trajectory is chaotic, so a
    run on other hardware is held to the fixture from this state."""
    with open(os.path.join(DATA, "gfn2_fixtures.json")) as fh:
        fixtures = json.load(fh)
    calc = XtbCalculator(
        settings_from_params("gfn2", multipoles=True, max_scf_iter=256,
                             scf_tol=1e-11),
        variant="gfn2", dtype=jnp.float64)
    out = {}
    for name, case in fixtures.items():
        if name.startswith("_"):
            continue
        z = np.array(case["numbers"])
        c = np.array(case["coords_angstrom"]) / 0.52917721092
        e, aux = calc.energies(calc.make_batch([(z, c, 0, 1)]))
        assert abs(float(e[0]) - case["energy_ha"]) < 1e-9, name
        out[name] = np.asarray(aux["shell_charges"])[0].tolist()
    return out


def gen_gfn2(skip_w20: bool = False) -> None:
    """Write port_golden_gfn2.json and its .mqc files."""
    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu"}
    if os.path.exists(GFN2_PATH):
        with open(GFN2_PATH) as fh:
            golden.update({k: v for k, v in json.load(fh).items()
                           if k == "driver"})

    def save():
        with open(GFN2_PATH, "w") as fh:
            json.dump(golden, fh, indent=1)
            fh.write("\n")

    settings = settings_from_params("gfn2", max_scf_iter=32)
    calc = XtbCalculator(settings, variant="gfn2", dtype=jnp.float64)
    t0 = time.time()
    e, g, aux = calc.gradients(calc.make_batch(bench_dimers(N_DIMERS)))
    golden["bench_dimers"] = {
        "n": N_DIMERS,
        "max_scf_iter": 32,
        "energies": np.asarray(e).tolist(),
        "gradients": np.asarray(g).tolist(),
        "state": np.asarray(aux["shell_charges"]).tolist(),
        "charges": np.asarray(aux["charges"]).tolist(),
        "dipole": np.asarray(aux["dipole"]).tolist(),
        "e_el": np.asarray(aux["e_el"]).tolist(),
        "e_rep": np.asarray(aux["e_rep"]).tolist(),
        "scf_residual_max": float(np.asarray(aux["scf_residual"]).max()),
    }
    print(f"gfn2 bench dimers: {time.time() - t0:.1f} s", flush=True)
    golden["fixture_states"] = _fixture_states()

    for variant in ("gfn1", "gfn2"):
        t0 = time.time()
        golden[f"refine_{variant}"] = _refine_entries(variant)
        print(f"refine entries {variant}: {time.time() - t0:.1f} s",
              flush=True)
    save()

    t0 = time.time()
    frags = w20_mbe2_fragments()
    energies, grads, aux = FragmentExecutor(calc).run(frags, what="gradient")
    total, gnorm = w20_mbe2_assemble(energies, grads)
    golden["w20_mbe2"] = {
        "total": total, "gradient_norm": gnorm, "max_scf_iter": 32,
        "energies": np.asarray(energies).tolist(),
        "scf_residual_max": float(aux["scf_residual"].max()),
        "seconds": round(time.time() - t0, 1)}
    print(f"gfn2 w20 MBE(2): {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    alpb = XtbCalculator(settings, variant="gfn2", dtype=jnp.float64,
                         solvation=BornSolvation(WATER_DIELECTRIC, alpb=True))
    energies, aux = FragmentExecutor(alpb).run(frags, what="energy")
    total, _ = w20_mbe2_assemble(
        energies, [np.zeros((len(f[0]), 3)) for f in frags])
    golden["w20_mbe2_alpb"] = {
        "total": total, "dielectric": WATER_DIELECTRIC, "max_scf_iter": 32,
        "energies": np.asarray(energies).tolist(),
        "scf_residual_max": float(aux["scf_residual"].max()),
        "seconds": round(time.time() - t0, 1)}
    print(f"gfn2 w20 MBE(2) ALPB: {time.time() - t0:.1f} s", flush=True)
    save()

    golden.setdefault("driver", {})
    _emit_gfn2("w20_isomer.json", "port_gfn2_w20_mbe4.mqc")
    for name, (src, dst, level) in GFN2_DRIVER.items():
        if name == "w20_mbe3" and skip_w20:
            continue
        mqc_path = _emit_gfn2(src, dst, level)
        t0 = time.time()
        out = run_calculation(read_mqc_file(mqc_path), write_json=False)[""]
        entry = {"mqc": f"tests/data/{dst}",
                 "total_energy": float(out.result.total_energy)}
        if out.result.gradient is not None:
            entry["gradient_norm"] = _norm(out.result.gradient)
        if out.result.hessian is not None:
            entry["hessian_frobenius_norm"] = _norm(out.result.hessian)
        if out.vibrational is not None:
            entry["frequencies"] = [float(f)
                                    for f in out.vibrational.frequencies]
        if out.thermo is not None:
            entry["zpe"] = float(out.thermo.zpe_hartree)
            entry["gibbs_correction"] = float(
                out.thermo.thermal_correction_gibbs)
        entry["seconds"] = round(time.time() - t0, 1)
        golden["driver"][name] = entry
        print(f"gfn2 {name}: {time.time() - t0:.1f} s", flush=True)
        save()


POLISH_FIT_PATH = os.path.join(DATA, "port_golden_polish_fit.json")
#: the fragment of tests/test_native_and_fit.py's rebuild case
FIT_NUMBERS = [8, 1, 1, 6, 7, 1]
FIT_COORDS = [[0.0, 0.0, 0.2], [0.0, 1.4, -0.9], [0.0, -1.4, -0.9],
              [4.0, 0.0, 0.0], [6.5, 0.5, 0.0], [8.2, 0.0, 0.5]]
FIT_WATER = [[0.0, 0.0, 0.2], [0.0, 1.4, -0.9], [0.0, -1.4, -0.9]]
#: seed and size of the jitter of the two waters of the mixed derivative,
#: and the recorded refine steps
FIT_SEED, FIT_JITTER, FIT_REFINE = 3, 0.03, 3


def polish_waters(n: int = 3) -> list:
    """tests/test_polish.py's jittered waters (seed 7), 6 Bohr apart."""
    rng = np.random.default_rng(7)
    return [(np.array([8, 1, 1]),
             WATER_BOHR + rng.normal(0, 0.05, (1, 3))
             + np.array([[6.0 * i, 0, 0]]), 0, 1) for i in range(n)]


def _theta_lists(theta) -> dict:
    """A theta pytree as nested dicts of lists (element keys as strings)."""
    if isinstance(theta, dict):
        return {str(k): _theta_lists(v) for k, v in theta.items()}
    return np.asarray(theta).tolist()


def _polish_entries(variant: str) -> dict:
    from metalquicha_tpu.methods.xtb.polish import HostPolisher

    frags = polish_waters()
    calc32 = XtbCalculator(variant=variant, dtype=jnp.float32)
    fd32 = calc32.make_batch(frags)
    _e32, _g32, aux32 = calc32.gradients(fd32)
    pol = HostPolisher(calc32)
    e_p, g_p, aux_p = pol.polish(frags, None, aux32["shell_charges"],
                                 "gradient")
    e_r, g_r, aux_r = pol.rescue(frags, None, "gradient")
    calc64 = XtbCalculator(variant=variant, dtype=jnp.float64)
    e64, g64, _aux = calc64.gradients(calc64.make_batch(frags))
    return {
        "state_f32": np.asarray(aux32["shell_charges"]).tolist(),
        "polish": {"energies": np.asarray(e_p).tolist(),
                   "gradients": np.asarray(g_p).tolist(),
                   "dipole": np.asarray(aux_p["dipole"]).tolist(),
                   "scf_residual": np.asarray(aux_p["scf_residual"]).tolist()},
        "rescue": {"energies": np.asarray(e_r).tolist(),
                   "gradients": np.asarray(g_r).tolist(),
                   "scf_residual": np.asarray(aux_r["scf_residual"]).tolist()},
        "f64": {"energies": np.asarray(e64).tolist(),
                "gradients": np.asarray(g64).tolist()},
    }


def _two_waters_cases() -> dict:
    """tests/test_polish.py's driver cases in float64."""
    from metalquicha_tpu.io.config import parse_mqc_string

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_driver import TWO_WATERS_MQC

    out = {"mqc": TWO_WATERS_MQC}
    for name, driver, gfn2, level1 in (
        ("energy", "Energy", False, False),
        ("gradient", "Gradient", False, False),
        ("gradient_gfn2", "Gradient", True, False),
        ("hessian_level1", "Hessian", False, True),
    ):
        mqc = TWO_WATERS_MQC.format(driver=driver)
        if gfn2:
            mqc = mqc.replace("XTB-GFN1", "XTB-GFN2")
        if level1:
            mqc = mqc.replace("level = 2", "level = 1")
        res = run_calculation(parse_mqc_string(mqc), write_json=False,
                              driver_overrides={"force_dtype": "f64"})[""]
        entry = {"total_energy": float(res.result.total_energy)}
        if res.result.gradient is not None:
            entry["gradient"] = np.asarray(res.result.gradient).tolist()
        if res.result.hessian is not None:
            entry["hessian_frobenius_norm"] = _norm(res.result.hessian)
        if res.vibrational is not None:
            entry["frequencies"] = [float(f)
                                    for f in res.vibrational.frequencies]
        out[name] = entry
    return out


def _fit_entries(variant: str) -> dict:
    from metalquicha_tpu.methods.xtb.calculator import single_point_energy
    from metalquicha_tpu.methods.xtb.param_fit import FragmentSpec, theta_init

    theta = theta_init(variant)
    settings = settings_from_params(variant)
    spec = FragmentSpec(np.array(FIT_NUMBERS), np.array(FIT_COORDS), 0, 1,
                        variant=variant)
    frag = spec.rebuild(theta)
    out = {
        "theta_init": _theta_lists(theta),
        "rebuild": {k: np.asarray(v).tolist()
                    for k, v in frag._asdict().items()},
    }
    water = FragmentSpec(np.array([8, 1, 1]), np.array(FIT_WATER), 0, 1,
                         variant=variant)

    def e_of(th):
        fr = water.rebuild(th)
        return single_point_energy(fr.coords, fr, settings)[0]

    e, grad = jax.value_and_grad(e_of)(theta)
    out["water"] = {"energy": float(e), "grad": _theta_lists(grad)}

    rng = np.random.default_rng(FIT_SEED)
    coords_b = jnp.asarray(
        np.array(FIT_WATER)[None] + rng.normal(0, FIT_JITTER, (2, 3, 3)))

    def loss(th):
        fr = water.rebuild(th)

        def e_c(c):
            return single_point_energy(c, fr._replace(coords=c), settings,
                                       diff_scf_iters=FIT_REFINE)[0]

        g = jax.vmap(jax.grad(e_c))(coords_b)
        return (g**2).sum()

    val, grad = jax.jit(jax.value_and_grad(loss))(theta)
    out["force_loss"] = {"seed": FIT_SEED, "jitter": FIT_JITTER,
                         "diff_scf_iters": FIT_REFINE,
                         "coords": np.asarray(coords_b).tolist(),
                         "value": float(val), "grad": _theta_lists(grad)}
    return out


def gen_polish_fit() -> None:
    """Write port_golden_polish_fit.json."""
    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu",
              "polish": {}, "fit": {}}
    for variant in ("gfn1", "gfn2"):
        t0 = time.time()
        golden["polish"][variant] = _polish_entries(variant)
        print(f"polish {variant}: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    golden["two_waters"] = _two_waters_cases()
    print(f"two waters driver cases: {time.time() - t0:.1f} s", flush=True)
    for variant in ("gfn1", "gfn2"):
        t0 = time.time()
        golden["fit"][variant] = _fit_entries(variant)
        print(f"fit {variant}: {time.time() - t0:.1f} s", flush=True)
    with open(POLISH_FIT_PATH, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")


FIT_TOOLS_PATH = os.path.join(DATA, "port_golden_fit_tools.json")
#: the fit_gfn1.py targets whose value and theta-gradient are frozen, by
#: class; and the fit_gfn1.py run whose output JSON is frozen
FIT_TOOLS_TARGETS = (("TargetEval", "h3o"), ("TargetEval", "prism_mbe"),
                     ("GradNormTarget", "h3o_gnorm"),
                     ("HessNormTarget", "h3o_hnorm"),
                     ("MbeHessNormTarget", "prism_hnorm"))
FIT_TOOLS_RUN = ["--targets", "h3o,h3o_gnorm", "--iters", "1"]
#: seed and relative size of the perturbation of fit_solvation's X0
SOLV_SEED, SOLV_SCALE = 5, 0.02


def gen_fit_tools() -> None:
    """Write port_golden_fit_tools.json, saving after every entry."""
    import tempfile

    from jax.flatten_util import ravel_pytree

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import fit_gfn1
    import fit_gfn2_w1
    import fit_solvation
    from metalquicha_tpu.methods.xtb.param_fit import theta_init

    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu"}

    def save():
        with open(FIT_TOOLS_PATH, "w") as fh:
            json.dump(golden, fh, indent=1)
            fh.write("\n")

    theta = theta_init("gfn1")
    flat, unravel = ravel_pytree(theta)
    golden["theta_flat"] = np.asarray(flat).tolist()
    golden["prior_weight_vector"] = fit_gfn1.prior_weight_vector(
        theta).tolist()
    settings = settings_from_params("gfn1", max_scf_iter=256, scf_tol=1e-10)
    golden["targets"] = {}

    def target(cls, name):
        t0 = time.time()
        val, grad = getattr(fit_gfn1, cls)(name, settings).value_and_grad(
            theta)
        golden["targets"][name] = {
            "class": cls, "value": val, "grad_flat": np.asarray(grad).tolist(),
            "grad": _theta_lists(unravel(jnp.asarray(grad))),
            "seconds": round(time.time() - t0, 1)}
        print(f"fit_tools {name}: {time.time() - t0:.1f} s", flush=True)
        save()

    # the MBE Hessian norm, the slowest to compile, last
    for cls, name in FIT_TOOLS_TARGETS[:-1]:
        target(cls, name)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fit.json")
        subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "fit_gfn1.py"),
                        *FIT_TOOLS_RUN, "--out", out], cwd=ROOT, check=True)
        with open(out) as fh:
            golden["fit_gfn1_run"] = {"argv": FIT_TOOLS_RUN,
                                      "out": json.load(fh)}
    golden["fit_gfn1_run"]["seconds"] = round(time.time() - t0, 1)
    print(f"fit_tools fit_gfn1 run: {time.time() - t0:.1f} s", flush=True)
    save()

    t0 = time.time()
    golden["fit_gfn2_w1"] = {
        "observables": fit_gfn2_w1.build_eval()(theta_init("gfn2")),
        "seconds": round(time.time() - t0, 1)}
    print(f"fit_tools fit_gfn2_w1: {time.time() - t0:.1f} s", flush=True)
    save()

    t0 = time.time()
    energies = fit_solvation.build_eval()
    x0 = np.array(fit_solvation.X0)
    rng = np.random.default_rng(SOLV_SEED)
    x1 = np.clip(x0 * (1.0 + SOLV_SCALE * rng.standard_normal(x0.shape)),
                 fit_solvation.LB, fit_solvation.UB)
    golden["fit_solvation"] = {
        "x0": x0.tolist(), "energies_x0": energies(x0),
        "x1": x1.tolist(), "energies_x1": energies(x1),
        "seconds": round(time.time() - t0, 1)}
    print(f"fit_tools fit_solvation: {time.time() - t0:.1f} s", flush=True)
    save()
    target(*FIT_TOOLS_TARGETS[-1])


DECANE_GAP_PATH = os.path.join(DATA, "port_golden_decane_gap.json")


def decane_inputs() -> dict:
    """validation/inputs/overlapping_decane.json at GMBE(1) and as one
    unfragmented molecule (tests/test_gmbe_tail_sentinel.py's pair)."""
    with open(os.path.join(ROOT, "validation", "inputs",
                           "overlapping_decane.json")) as fh:
        data = json.load(fh)
    unfrag = json.loads(json.dumps(data))
    mol = unfrag["molecules"][0]
    for key in ("fragments", "connectivity", "fragment_charges",
                "fragment_multiplicities"):
        mol.pop(key, None)
    unfrag["keywords"].pop("fragmentation", None)
    return {"gmbe1": data, "unfrag": unfrag}


def gen_decane_gap() -> None:
    """Write port_golden_decane_gap.json: the JAX package's decane GMBE(1)
    and unfragmented totals through its driver, and their gap."""
    from metalquicha_tpu.io.config import parse_mqc_string

    inputs = os.path.join(ROOT, "validation", "inputs")
    t0 = time.time()
    totals = {}
    for name, data in decane_inputs().items():
        cfg = parse_mqc_string(emit_mqc(data, base_dir=inputs))
        out = run_calculation(cfg, write_json=False)[""]
        totals[name] = float(out.result.total_energy)
    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu",
              "e_gmbe1_ha": totals["gmbe1"], "e_unfrag_ha": totals["unfrag"],
              "gap_ha": totals["gmbe1"] - totals["unfrag"],
              "seconds": round(time.time() - t0, 1)}
    with open(DECANE_GAP_PATH, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")
    print(f"decane gap: {golden['gap_ha']:+.12f} Ha "
          f"({golden['seconds']} s)", flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("gfn1", "full", "gfn2", "polish_fit",
                                       "fit_tools", "decane_gap",
                                       "elements_spd", "memory"),
                    default=None,
                    help="regenerate one golden file instead of all seven")
    ap.add_argument("--skip-w20", action="store_true",
                    help="gfn2: keep the stored w20 MBE(3) driver total")
    args = ap.parse_args(argv)
    global_logger.set_level("warning")
    if args.only in (None, "gfn1"):
        gen_gfn1()
    if args.only in (None, "full"):
        gen_full()
    if args.only in (None, "gfn2"):
        gen_gfn2(skip_w20=args.skip_w20)
    if args.only in (None, "polish_fit"):
        gen_polish_fit()
    if args.only in (None, "fit_tools"):
        gen_fit_tools()
    if args.only in (None, "decane_gap"):
        gen_decane_gap()
    if args.only in (None, "elements_spd"):
        gen_elements_spd()
    if args.only in (None, "memory"):
        gen_memory()
    return 0


MEMORY_PATH = os.path.join(DATA, "port_golden_memory.json")
#: no_frag.json's atoms whose displaced gradients are frozen
HESSIAN_ATOMS = (0, 40)
#: w20 MBE(4) tetramers frozen, evenly spaced over the fragment list
N_TETRAMERS = 48


class _Captured(Exception):
    """Raised by `_capture_jobs`' executor with the fragments it got."""


def _capture_jobs(cfg):
    """(the fragment list the JAX driver sends to its executor for cfg,
    the driver's configuration), without evaluating it."""

    class Capture:
        n_devices = 1

        def run(self, fragments, what="energy"):
            raise _Captured(list(fragments))

    try:
        run_calculation(cfg, write_json=False, executor=Capture())
    except _Captured as exc:
        return exc.args[0], config_to_driver(cfg)
    raise RuntimeError("the driver sent no fragments")


def _emit_driver(src: str, dst: str, driver: str) -> str:
    """validation/inputs/<src> with its driver set, as tests/data/<dst>."""
    json_path = os.path.join(ROOT, "validation", "inputs", src)
    with open(json_path) as fh:
        data = json.load(fh)
    data["driver"] = driver
    text = emit_mqc(data, base_dir=os.path.dirname(json_path))
    with open(os.path.join(DATA, dst), "w") as fh:
        fh.write(text)
    return os.path.join(DATA, dst)


def _gradients(executor, jobs, batch):
    """JAX energies and gradients of jobs, `batch` at a time."""
    es, gs = [], []
    for start in range(0, len(jobs), batch):
        e, g, _aux = executor.run(jobs[start:start + batch], what="gradient")
        es.extend(float(x) for x in np.asarray(e))
        gs.extend(np.asarray(x).tolist() for x in g)
    return es, gs


def gen_memory() -> None:
    """Write port_golden_memory.json (see the module docstring)."""
    t0 = time.time()
    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu"}

    mqc = _emit_driver("no_frag.json", "port_memory_gly3_hessian.mqc",
                       "Hessian")
    (mol,), drv = _capture_jobs(read_mqc_file(mqc))
    # the driver's displacement sweep of the one (unfragmented) fragment
    from metalquicha_tpu.driver import _DisplacedFragment
    from metalquicha_tpu.numerics.finite_differences import (
        displaced_geometries,
    )

    h = drv.hessian.displacement
    jobs = [_DisplacedFragment(mol, c) for c in
            displaced_geometries(np.asarray(mol.coords), h)]
    picked = [2 * (3 * a + d) + s for a in HESSIAN_ATOMS for d in range(3)
              for s in (0, 1)]
    energies, grads = _gradients(_make_executor(drv), [jobs[i] for i in
                                                       picked], 4)
    g = np.asarray(grads).reshape(len(picked), -1)
    golden["hessian"] = {
        "mqc": "tests/data/port_memory_gly3_hessian.mqc",
        "n_jobs": len(jobs), "displacement": h,
        "atoms": list(HESSIAN_ATOMS), "jobs": picked,
        "energies": energies, "gradients": grads,
        # row 3a+d of the unsymmetrized FD Hessian: (g(+h) - g(-h)) / 2h
        "rows": ((g[0::2] - g[1::2]) / (2.0 * h)).tolist(),
    }
    print(f"memory: Hessian rows {time.time() - t0:.1f} s", flush=True)

    t1 = time.time()
    mqc = _emit_driver("w20_isomer.json", "port_memory_w20_mbe4_grad.mqc",
                       "Gradient")
    jobs, drv = _capture_jobs(read_mqc_file(mqc))
    tetramers = [i for i, f in enumerate(jobs) if len(f.numbers) == 12]
    picked = [tetramers[int(k)] for k in
              np.linspace(0, len(tetramers) - 1, N_TETRAMERS).round()]
    energies, grads = _gradients(_make_executor(drv),
                                 [jobs[i] for i in picked], N_TETRAMERS)
    golden["w20_mbe4_gradient"] = {
        "mqc": "tests/data/port_memory_w20_mbe4_grad.mqc",
        "n_jobs": len(jobs), "jobs": picked,
        "energies": energies, "gradients": grads,
    }
    print(f"memory: w20 tetramers {time.time() - t1:.1f} s", flush=True)

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_port_common import jittered_trimers

    e, g, _aux = FragmentExecutor(XtbCalculator(dtype=jnp.float64)).run(
        jittered_trimers(), what="gradient")
    golden["trimers"] = {"energies": np.asarray(e).tolist(),
                         "gradients": [np.asarray(x).tolist() for x in g]}
    golden["seconds"] = round(time.time() - t0, 1)
    with open(MEMORY_PATH, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")


ELEMENTS_SPD_PATH = os.path.join(DATA, "port_golden_elements_spd.json")
#: SCC iterations of the heavy-element single points (see gen_elements_spd)
HEAVY_SCF_ITERS = 8


def gen_elements_spd() -> None:
    """The spd and heavy-element single points and the NaCl + water driver
    input, with the JAX package's default GFN1 calculator."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_port_common import (
        HEAVY_CASES,
        NACL_WATER_MQC,
        SPD_CASES,
        heavy_coords,
        spd_fragment,
    )

    from metalquicha_tpu import geometry
    from metalquicha_tpu.io.config import parse_mqc_string

    t0 = time.time()
    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu"}
    out = run_calculation(parse_mqc_string(NACL_WATER_MQC), write_json=False)
    golden["nacl_water_total"] = float(out[""].result.total_energy)
    calc = XtbCalculator(variant="gfn1")
    golden["spd"] = {}
    for name in SPD_CASES:
        e, aux = calc.energies(calc.make_batch(
            [spd_fragment(geometry, name)]))
        golden["spd"][name] = {
            "energy": float(np.asarray(e)[0]),
            "scf_residual": float(np.asarray(aux["scf_residual"])[0]),
        }
    # the heavy-element SCC does not converge in either package (residuals
    # 2e-3 to 1 after the default 32 iterations): the two agree to 1e-12
    # in the charges through HEAVY_SCF_ITERS iterations, after which their
    # last-bit differences grow about tenfold per iteration
    golden["heavy_max_scf_iter"] = HEAVY_SCF_ITERS
    heavy = XtbCalculator(settings_from_params(
        "gfn1", max_scf_iter=HEAVY_SCF_ITERS))
    golden["heavy"] = {}
    for name, numbers in HEAVY_CASES.items():
        numbers = np.array(numbers, dtype=np.int64)
        frag = heavy.make_batch([(numbers, heavy_coords(len(numbers)), 0, 1)])
        e, g, aux = heavy.gradients(frag)
        golden["heavy"][name] = {
            "energy": float(np.asarray(e)[0]),
            "gradient": np.asarray(g)[0].tolist(),
            "scf_residual": float(np.asarray(aux["scf_residual"])[0]),
            "e_disp": float(np.asarray(aux["e_disp"])[0]),
        }
    golden["seconds"] = round(time.time() - t0, 1)
    with open(ELEMENTS_SPD_PATH, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")
    print(f"elements_spd: {golden['seconds']} s", flush=True)


def gen_gfn1() -> None:
    golden = {"commit": _commit(), "dtype": "float64", "platform": "cpu"}

    # bench.py's production calculator (32 SCC iterations, scf_tol = 0);
    # in float64 the JAX package's in-loop eigensolve is the exact eigh
    settings = settings_from_params("gfn1", max_scf_iter=32,
                                    use_pallas_eigh=True)
    calc = XtbCalculator(settings, dtype=jnp.float64)
    t0 = time.time()
    e, g, aux = calc.gradients(calc.make_batch(bench_dimers(N_DIMERS)))
    golden["bench_dimers"] = {
        "n": N_DIMERS,
        "max_scf_iter": 32,
        "energies": np.asarray(e).tolist(),
        "gradients": np.asarray(g).tolist(),
        "shell_charges": np.asarray(aux["shell_charges"]).tolist(),
        "e_el": np.asarray(aux["e_el"]).tolist(),
        "e_rep": np.asarray(aux["e_rep"]).tolist(),
        "e_disp": np.asarray(aux["e_disp"]).tolist(),
        "scf_residual_max": float(np.asarray(aux["scf_residual"]).max()),
    }
    print(f"bench dimers: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    energies, grads, aux = FragmentExecutor(calc).run(
        w20_mbe2_fragments(), what="gradient"
    )
    total, gnorm = w20_mbe2_assemble(energies, grads)
    golden["w20_mbe2"] = {"total": total, "gradient_norm": gnorm,
                          "scf_residual_max": float(aux["scf_residual"].max())}
    print(f"w20 MBE(2): {time.time() - t0:.1f} s", flush=True)

    golden["driver"] = {}
    for name, (src, dst) in MQC.items():
        mqc_path = _emit(src, dst)
        t0 = time.time()
        out = run_calculation(read_mqc_file(mqc_path), write_json=False)
        golden["driver"][name] = {
            "mqc": f"tests/data/{dst}",
            "total_energy": float(out[""].result.total_energy),
        }
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)

    with open(os.path.join(DATA, "port_golden_gfn1.json"), "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    raise SystemExit(main())
