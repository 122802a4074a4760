"""Torch port vs JAX package: the GFN1 single-point slice end to end.

- XtbCalculator energies and gradients on a small mixed batch against the
  live JAX package (float64): energies 1e-10 Ha, gradients 1e-9 Ha/Bohr,
  through the exact in-loop eigh and through the Jacobi route;
- the gradient against central differences (5e-8, as
  tests/test_xtb_engine.py holds the JAX package);
- the port against the frozen goldens (tests/data/port_golden_gfn1.json,
  written by tools/gen_port_golden.py): bench's first 8 dimers and the
  prism MBE(2) driver total, through run_calculation and the CLI;
- the factory's settings, dispatch and refusals, and the CUDA check.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    GLY3_FRAG,
    GOLDEN_PATH,
    H3O,
    HALOGEN,
    REPO,
    WATER,
    max_abs_diff,
    restore_jax_overlay,
)

from metalquicha_tpu_torch.driver import make_executor, run_calculation
from metalquicha_tpu_torch.io.adapter import MethodType, config_to_driver
from metalquicha_tpu_torch.io.config import read_mqc_file
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.factory import create_calculator
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator, check_device
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.workloads import bench_dimers

torch.set_num_threads(1)
ROUTES = [False, True]  # use_pallas_eigh: exact in-loop eigh / Jacobi
# randomly distorted dimers: no two monomers alike, so no exactly
# degenerate overlap spectra (ROADMAP C5)
MIXED = bench_dimers(2, seed=7) + [H3O, HALOGEN, GLY3_FRAG]


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def jax_mixed():
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator as JaxCalc

    restore_jax_overlay()
    calc = JaxCalc(dtype=jnp.float64)
    e, g, aux = calc.gradients(calc.make_batch(MIXED))
    return np.asarray(e), np.asarray(g), np.asarray(aux["shell_charges"])


@pytest.mark.parametrize("use_pallas_eigh", ROUTES)
def test_calculator_matches_live_jax(jax_mixed, use_pallas_eigh):
    calc = XtbCalculator(settings_from_params(
        "gfn1", use_pallas_eigh=use_pallas_eigh
    ), device="cpu")
    frag = calc.make_batch(MIXED)
    e_j, g_j, q_j = jax_mixed
    e, g, aux = calc.gradients(frag)
    e_only, _ = calc.energies(frag)
    assert float(aux["scf_residual"].max()) < 1e-10
    assert max_abs_diff(e, e_j) <= 1e-10
    assert max_abs_diff(e_only, e_j) <= 1e-10
    assert max_abs_diff(g, g_j) <= 1e-9
    assert max_abs_diff(aux["shell_charges"], q_j) <= 1e-9


def test_gradient_matches_central_differences():
    calc = XtbCalculator(device="cpu")
    numbers, coords, charge, mult = WATER
    _, g, _ = calc.gradients(calc.make_batch([WATER]))
    h = 1e-5
    disp = []
    for a in range(3):
        for d in range(3):
            for sgn in (1.0, -1.0):
                c = coords.copy()
                c[a, d] += sgn * h
                disp.append((numbers, c, charge, mult))
    e, _ = calc.energies(calc.make_batch(disp))
    fd = ((e[0::2] - e[1::2]) / (2 * h)).reshape(3, 3)
    assert max_abs_diff(g[0], fd) < 5e-8


@pytest.mark.parametrize("use_pallas_eigh", ROUTES)
def test_bench_dimers_match_golden(golden, use_pallas_eigh):
    gd = golden["bench_dimers"]
    calc = XtbCalculator(settings_from_params(
        "gfn1", max_scf_iter=gd["max_scf_iter"],
        use_pallas_eigh=use_pallas_eigh,
    ), device="cpu")
    e, g, aux = calc.gradients(calc.make_batch(bench_dimers(gd["n"])))
    assert max_abs_diff(e, gd["energies"]) <= 1e-10
    assert max_abs_diff(g, gd["gradients"]) <= 1e-9
    assert max_abs_diff(aux["shell_charges"], gd["shell_charges"]) <= 1e-9
    for key in ("e_el", "e_rep", "e_disp"):
        assert max_abs_diff(aux[key], gd[key]) <= 1e-10


@pytest.mark.parametrize("use_pallas_eigh", ROUTES)
def test_run_calculation_prism_matches_golden(golden, use_pallas_eigh):
    gold = golden["driver"]["prism_mbe"]
    cfg = read_mqc_file(os.path.join(REPO, gold["mqc"]))
    ex = make_executor(cfg, "cpu")
    ex.calc.settings = ex.calc.settings._replace(
        use_pallas_eigh=use_pallas_eigh
    )
    level = global_logger.level
    global_logger.set_level("warning")  # no per-fragment XYZ dumps
    try:
        out = run_calculation(cfg, write_json=False, executor=ex)
    finally:
        global_logger.level = level
    assert abs(out[""].result.total_energy - gold["total_energy"]) <= 1e-7


def test_cli_prism_on_cpu(golden, tmp_path):
    gold = golden["driver"]["prism_mbe"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "metalquicha_tpu_torch", "--device", "cpu",
         os.path.join(REPO, gold["mqc"])],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [s for s in proc.stdout.splitlines() if "total_energy" in s][-1]
    total = float(line.split("=")[1].split()[0])
    assert abs(total - gold["total_energy"]) <= 1e-7
    assert (tmp_path / "output_port_prism.json").exists()


def test_factory_settings_and_refusals():
    cfg = read_mqc_file(os.path.join(REPO, "tests", "data", "port_prism.mqc"))
    drv = config_to_driver(cfg)
    calc = create_calculator(drv, device="cpu")
    assert calc.dtype == torch.float64
    assert not calc.settings.use_pallas_eigh
    assert calc.settings.max_scf_iter == 256
    assert calc.settings.scf_tol == pytest.approx(1e-7)
    drv.force_dtype = "f32"
    assert create_calculator(drv, device="cpu").dtype == torch.float32

    drv.method.method_type = MethodType.GFN2
    gfn2 = create_calculator(drv, device="cpu")
    assert gfn2.variant == "gfn2" and gfn2.settings.multipoles
    assert gfn2.settings.max_scf_iter == 256
    assert calc.variant == "gfn1" and not calc.settings.multipoles
    for mt, variant in ((MethodType.HF, "hf"), (MethodType.DFT, "dft"),
                        (MethodType.MCSCF, "mcscf")):
        drv.method.method_type = mt
        assert create_calculator(drv).variant == variant  # no device taken
    drv.method.method_type = MethodType.MP2
    with pytest.raises(NotImplementedError, match="MP2"):
        create_calculator(drv, device="cpu")
    drv.method.method_type = MethodType.GFN1
    drv.method.xtb.solvent = "water"
    drv.method.xtb.solvation_model = "alpb"
    solvated = create_calculator(drv, device="cpu")
    assert solvated.solvation.kind == "born" and solvated.solvation.alpb
    assert solvated.solvation.dielectric == 78.4
    drv.method.xtb.solvation_model = "pcm"
    with pytest.raises(NotImplementedError, match="pcm"):
        create_calculator(drv, device="cpu")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_device("cuda")
    assert check_device("cpu") == torch.device("cpu")
