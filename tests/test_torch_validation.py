"""The port's driver on the GFN1 validation cases, against the JAX
package's frozen float64 results (tests/data/port_golden_gfn1_full.json,
written by tools/gen_port_golden.py); the GFN2 cases that run on a CUDA
card (the fixtures of tests/data/gfn2_fixtures.json, the bench dimers'
gradients and `w1_vib_therm` of port_golden_gfn2.json).

Tolerances are `validation.GOLDEN_TOLERANCES`: totals 1e-7 Ha, gradient
norms 1e-6, Hessian Frobenius norms 1e-5, frequencies 0.5 cm^-1 (the FD
Hessian divides SCC noise at the factory's scf_tol by the displacement),
ZPE and Gibbs correction 1e-6 Ha. The small cases run here on the CPU;
every case runs on a CUDA card under the `gpu` marker. The solvated
single water and a part of the solvated w20 MBE(2) list are held to their
frozen energies (1e-10 Ha), kernels and radii (1e-12) and gradients (1e-9
Ha/Bohr; 1e-6 for dimers of identical, translated waters).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from metalquicha_tpu_torch.driver import run_calculation, run_file
from metalquicha_tpu_torch.io.adapter import config_to_driver
from metalquicha_tpu_torch.io.config import read_mqc_file
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.factory import create_calculator
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation
from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import CpcmSolvation
from metalquicha_tpu_torch.validation import golden_failures, observables
from metalquicha_tpu_torch.workloads import WATER_BOHR, w20_mbe2_fragments

torch.set_num_threads(1)
# nothing of the JAX package is imported here, so that the `gpu` cases run
# on a machine that has none
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL_PATH = os.path.join(REPO, "tests", "data", "port_golden_gfn1_full.json")
RUNNER = os.path.join(REPO, "tools", "run_validation_torch.py")
CPU_CASES = ("h3o_unfrag", "alpb_water", "gbsa_water", "cpcm_water",
             "hess_h3o", "multi_frag", "charged_cluster_mbe", "gmbe1_gly3")
ALL_CASES = CPU_CASES + (
    "unfrag_gly3", "gly10_mbe", "multi_structure", "prism_mbe_groups1",
    "gmbe3_decane", "prism_hessian", "hess_gly3_ov", "hess_gly3_serial")
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def golden():
    with open(FULL_PATH) as fh:
        return json.load(fh)


def max_abs_diff(a, b):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _run_case(gold, device):
    cfg = read_mqc_file(os.path.join(REPO, gold["mqc"]))
    level = global_logger.level
    global_logger.set_level("warning")  # no per-fragment XYZ dumps
    try:
        return observables(run_calculation(cfg, write_json=False,
                                           device=device))
    finally:
        global_logger.level = level


def test_golden_file_covers_every_case(golden):
    assert sorted(golden["driver"]) == sorted(ALL_CASES)
    # the cases whose padded AO count exceeds the Jacobi kernel's 64 reach
    # SP2 on the fast route
    above = sorted(k for k, v in golden["driver"].items() if v["max_nao"] > 64)
    assert above == ["gmbe3_decane", "hess_gly3_serial", "unfrag_gly3"]
    assert golden["driver"]["unfrag_gly3"]["max_nao"] == 241


@pytest.mark.parametrize("case", CPU_CASES)
def test_driver_case_matches_jax_on_cpu(golden, case):
    assert golden_failures(_run_case(golden["driver"][case], "cpu"),
                           golden["driver"][case]) == []


@pytest.mark.gpu
@pytest.mark.parametrize("case", ALL_CASES)
def test_driver_case_matches_jax_on_the_card(golden, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert golden_failures(_run_case(golden["driver"][case], "cuda"),
                           golden["driver"][case]) == []


def _models(eps):
    return {"alpb": BornSolvation(eps, alpb=True),
            "gbsa": BornSolvation(eps, alpb=False),
            "cpcm": CpcmSolvation(eps)}


@pytest.mark.parametrize("model", ["alpb", "gbsa", "cpcm"])
def test_solvated_water_matches_golden(golden, model):
    gold = golden["water_solvated"]
    solvation = _models(gold["dielectric"])[model]
    calc = XtbCalculator(device="cpu", solvation=solvation)
    frag = calc.make_batch([(np.array([8, 1, 1]), WATER_BOHR, 0, 1)])
    e, g, _ = calc.gradients(frag)
    assert abs(float(e[0]) - gold[model]["energy"]) <= 1e-10
    gamma = solvation.gamma_atoms(frag.coords, frag.solv_rvdw, frag.solv_sx,
                                  frag.atom_mask, scalars=frag.solv_scalars)
    assert max_abs_diff(gamma[0], gold[model]["gamma_at"]) <= 1e-12
    assert bool(torch.isfinite(g).all())
    if model == "cpcm":
        return
    assert max_abs_diff(g[0], gold[model]["gradient"]) <= 1e-9
    radii = solvation.born_radii(frag.coords, frag.solv_rvdw, frag.solv_sx,
                                 frag.atom_mask, frag.solv_scalars[:, 0])
    assert max_abs_diff(radii[0], gold[model]["born_radii"]) <= 1e-12
    surface = solvation.surface_energy(frag.coords, frag)
    assert abs(float(surface[0]) - gold[model]["surface_energy"]) <= 1e-12


@pytest.mark.parametrize("model", ["alpb", "cpcm"])
def test_solvated_w20_fragments_match_golden(golden, model):
    """Three monomers and three dimers of the solvated w20 MBE(2) list
    (the whole list runs on the card, chip_smoke.py)."""
    gold = golden["w20_mbe2_solvated"]
    idx = [0, 7, 19, 20, 21, 120]
    frags = w20_mbe2_fragments()
    calc = XtbCalculator(
        settings_from_params("gfn1", max_scf_iter=gold["max_scf_iter"]),
        device="cpu", solvation=_models(gold["dielectric"])[model])
    for group, g_tol in ((idx[:3], 1e-9), (idx[3:], 1e-6)):
        batch = calc.make_batch([frags[i] for i in group])
        if model == "alpb":
            e, g, _ = calc.gradients(batch)
            # 1e-6 for the dimers: exact translates of one water, whose
            # overlap spectra are degenerate, where the gradient depends on
            # the eigenvector gauge at the 1e-7 level in either package
            for slot, i in enumerate(group):
                assert max_abs_diff(g[slot], gold[model]["gradients"][i]) <= g_tol
        else:
            e, _ = calc.energies(batch)
        assert max_abs_diff(e, [gold[model]["energies"][i] for i in group]) <= 1e-10


def test_solvated_entry_points_ask_for_cuda(golden, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(REPO, golden["driver"]["alpb_water"]["mqc"])
    drv = config_to_driver(read_mqc_file(path))
    assert drv.method.xtb.has_solvation()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_calculator(drv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_file(path, write_json=False)
    assert create_calculator(drv, device="cpu").solvation.alpb


def _runner(*args):
    return subprocess.run(
        [sys.executable, RUNNER, "--device", "cpu", *args], cwd=REPO, env=ENV,
        capture_output=True, text=True, timeout=600,
    )


def test_validation_runner_reports_cases_and_jax_parity(tmp_path):
    out = tmp_path / "result.json"
    proc = _runner("--filter", "h3o", "--json-out", str(out))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    res = json.loads(out.read_text())
    assert [c["name"] for c in res["cases"]] == ["h3o_unfrag", "hess_h3o"]
    assert (res["passed"], res["failed"], res["errored"], res["off_jax"]) == (
        2, 0, 0, 0)
    labels = [r["label"] for r in res["cases"][1]["vs_jax"]]
    assert labels == ["energy", "grad_norm", "hess_norm", "zpe", "gibbs",
                      "freq_max_dev_cm1"]
    assert all(c["within_tolerance_of_jax"] for c in res["cases"])


def test_validation_runner_says_gfn2_is_not_ported(tmp_path):
    """The name dates from when the GFN2 case raised. GFN2 is ported: the
    runner reports `w1_vib_therm` as passed against upstream and within
    tolerance of the JAX package's frozen result, and exits 0."""
    out = tmp_path / "result.json"
    proc = _runner("--filter", "w1_vib_therm", "--json-out", str(out))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "ERROR" not in proc.stdout
    assert "1 passed, 0 failed, 0 errored" in proc.stdout
    case = json.loads(out.read_text())["cases"][0]
    assert case["name"] == "w1_vib_therm" and case["within_tolerance_of_jax"]
    assert [r["label"] for r in case["vs_jax"]] == [
        "energy", "grad_norm", "hess_norm", "zpe", "gibbs",
        "freq_max_dev_cm1"]


GFN2_PATH = os.path.join(REPO, "tests", "data", "port_golden_gfn2.json")
GFN2_FIXTURES = os.path.join(REPO, "tests", "data", "gfn2_fixtures.json")
ANGSTROM_TO_BOHR = 1.0 / 0.52917721092


def _fixture_on(device, name, warm):
    """(energy, charges, dipole, residual, fixture) of one molecule of
    tests/data/gfn2_fixtures.json, cold or warm-started from the frozen
    converged state of the JAX package."""
    from metalquicha_tpu_torch.methods.xtb.calculator import (
        single_point_energy,
    )

    with open(GFN2_FIXTURES) as fh:
        case = json.load(fh)[name]
    settings = settings_from_params("gfn2", max_scf_iter=256, scf_tol=1e-11)
    calc = XtbCalculator(settings, variant="gfn2", device=device)
    z = np.array(case["numbers"])
    c = np.array(case["coords_angstrom"]) * ANGSTROM_TO_BOHR
    frag = calc.make_batch([(z, c, 0, 1)])
    q_init = None
    if warm:
        with open(GFN2_PATH) as fh:
            state = json.load(fh)["fixture_states"][name]
        q_init = torch.tensor([state], dtype=torch.float64, device=device)
    with torch.no_grad():
        e, aux = single_point_energy(frag.coords, frag, settings, None,
                                     q_init=q_init)
    return (float(e[0]), aux["charges"][0][: len(z)], aux["dipole"][0],
            float(aux["scf_residual"][0]), case)


def _assert_fixture(e, q, mu, resid, case):
    assert resid < 1e-9
    assert abs(e - case["energy_ha"]) <= 1e-9
    assert max_abs_diff(q, case["charges"]) <= 1e-8
    assert max_abs_diff(mu, case["dipole_au"]) <= 1e-8


FIXTURE_NAMES = ["nh3", "ch4", "w2_donor", "w2_acceptor", "w2_dimer"]


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_gfn2_fixture_state_is_a_fixed_point(name):
    """Warm-started from the JAX package's converged state the port stays
    there and gives the fixture's observables (on the CPU)."""
    _assert_fixture(*_fixture_on("cpu", name, warm=True))


@pytest.mark.gpu
@pytest.mark.parametrize("name", FIXTURE_NAMES)
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_gfn2_fixture_observables_on_the_card(name, start):
    """tests/data/gfn2_fixtures.json at the tolerances of
    tests/test_gfn2_fixtures.py, on `cuda`. CH4 is held from the warm start
    only: its SCC map has a second fixed point and its cold-start
    trajectory is chaotic (residuals near 1 for some 60 iterations), so
    rounding decides where it lands (ROADMAP C11)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    e, q, mu, resid, case = _fixture_on("cuda", name, warm=start == "warm")
    if name == "ch4" and start == "cold":
        assert resid < 1e-9 and np.isfinite(e)
        return
    _assert_fixture(e, q, mu, resid, case)


@pytest.mark.gpu
def test_gfn2_gradients_match_golden_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from metalquicha_tpu_torch.workloads import bench_dimers

    with open(GFN2_PATH) as fh:
        gd = json.load(fh)["bench_dimers"]
    calc = XtbCalculator(
        settings_from_params("gfn2", max_scf_iter=gd["max_scf_iter"]),
        variant="gfn2", device="cuda")
    e, g, aux = calc.gradients(calc.make_batch(bench_dimers(gd["n"])))
    assert max_abs_diff(e, gd["energies"]) <= 1e-9
    assert max_abs_diff(g, gd["gradients"]) <= 1e-8
    assert max_abs_diff(aux["dipole"], gd["dipole"]) <= 1e-8


@pytest.mark.gpu
def test_gfn2_w1_vib_therm_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(GFN2_PATH) as fh:
        gold = json.load(fh)["driver"]["w1_vib_therm"]
    assert golden_failures(_run_case(gold, "cuda"), gold) == []


def test_validation_runner_asks_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, RUNNER, "--filter", "h3o_unfrag"],
                          cwd=REPO, env=ENV, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_prep_then_cli_from_json(golden, tmp_path):
    """`python -m metalquicha_tpu_torch.io.prep` then `python -m
    metalquicha_tpu_torch` on the result, for a Hessian case: the totals
    printed are the frozen ones."""
    gold = golden["driver"]["hess_h3o"]
    inputs = os.path.join(REPO, "validation", "inputs")
    shutil.copy(os.path.join(inputs, "hess_h3o.json"), tmp_path)
    shutil.copytree(os.path.join(inputs, "sample_inputs"),
                    tmp_path / "sample_inputs")
    prep = subprocess.run(
        [sys.executable, "-m", "metalquicha_tpu_torch.io.prep",
         "hess_h3o.json"], cwd=tmp_path, env=ENV, capture_output=True,
        text=True, timeout=600)
    assert prep.returncode == 0, prep.stderr[-2000:]
    assert (tmp_path / "hess_h3o.mqc").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "metalquicha_tpu_torch", "--device", "cpu",
         "hess_h3o.mqc"], cwd=tmp_path, env=ENV, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = {}
    for line in proc.stdout.splitlines():
        for key in ("total_energy", "gradient_norm", "hessian_frobenius_norm"):
            if f"{key} =" in line:
                got[key] = float(line.split("=")[1].split()[0])
    assert abs(got["total_energy"] - gold["total_energy"]) <= 1e-7
    assert abs(got["gradient_norm"] - gold["gradient_norm"]) <= 1e-6
    assert abs(got["hessian_frobenius_norm"]
               - gold["hessian_frobenius_norm"]) <= 1e-5
    assert (tmp_path / "output_hess_h3o.json").exists()


POLISH_FIT_PATH = os.path.join(REPO, "tests", "data",
                               "port_golden_polish_fit.json")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["gfn1", "gfn2"])
@pytest.mark.parametrize("fast", [False, True])
def test_polished_f32_matches_f64_on_the_card(variant, fast):
    """f32 SCC (exact or Jacobi in-loop route) + f64 polish on the card
    against the JAX package's frozen all-f64 results on three waters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from metalquicha_tpu_torch.methods.xtb.polish import HostPolisher
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor

    with open(POLISH_FIT_PATH) as fh:
        gold = json.load(fh)["polish"][variant]["f64"]
    rng = np.random.default_rng(7)
    frags = [(np.array([8, 1, 1]),
              WATER_BOHR + rng.normal(0, 0.05, (1, 3))
              + np.array([[6.0 * i, 0, 0]]), 0, 1) for i in range(3)]
    calc32 = XtbCalculator(
        settings_from_params(variant, use_pallas_eigh=fast), variant=variant,
        dtype=torch.float32, device="cuda")
    global_logger.set_level("warning")
    ex = FragmentExecutor(calc32, polisher=HostPolisher(calc32))
    e, g, aux = ex.run(frags, what="gradient")
    assert max_abs_diff(e, gold["energies"]) <= 1e-9
    assert max_abs_diff(np.stack(g), gold["gradients"]) <= 1e-8
    raw, _ = FragmentExecutor(calc32).run(frags, what="energy")
    assert max_abs_diff(raw, gold["energies"]) > 1e-6


@pytest.mark.gpu
def test_two_slot_mesh_matches_one_device_on_the_card():
    """The card listed twice: pad, cut and join, results as on one slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.parallel.mesh import fragment_mesh
    from metalquicha_tpu_torch.workloads import trimer_mbe2_fragments

    global_logger.set_level("warning")
    frags = trimer_mbe2_fragments(atom_jitter=0.02)
    calc = XtbCalculator(device="cuda")
    card = torch.device("cuda", 0)
    e1, g1, _ = FragmentExecutor(calc).run(frags, what="gradient")
    mesh = fragment_mesh([card, card], nodes_per_group=1)
    e2, g2, _ = FragmentExecutor(calc, mesh=mesh).run(frags, what="gradient")
    assert max_abs_diff(e2, e1) <= 1e-12
    assert max(max_abs_diff(a, b) for a, b in zip(g2, g1)) <= 1e-12
    assert fragment_mesh().size == torch.cuda.device_count()


@pytest.mark.gpu
def test_theta_gradient_matches_golden_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from metalquicha_tpu_torch.methods.xtb.calculator import (
        single_point_energy,
    )
    from metalquicha_tpu_torch.methods.xtb.param_fit import (
        FragmentSpec,
        theta_init,
    )

    with open(POLISH_FIT_PATH) as fh:
        gold = json.load(fh)["fit"]["gfn1"]["water"]
    theta = theta_init("gfn1", "cuda")
    levels = theta["elements"][8]["levels"].requires_grad_(True)
    spec = FragmentSpec(
        np.array([8, 1, 1]),
        np.array([[0.0, 0.0, 0.2], [0.0, 1.4, -0.9], [0.0, -1.4, -0.9]]),
        0, 1, device="cuda")
    frag = spec.rebuild(theta)
    e, _ = single_point_energy(frag.coords, frag, settings_from_params("gfn1"))
    (g,) = torch.autograd.grad(e.sum(), levels)
    assert abs(float(e.detach()) - gold["energy"]) <= 1e-10
    assert max_abs_diff(g, gold["grad"]["elements"]["8"]["levels"]) <= 1e-9
