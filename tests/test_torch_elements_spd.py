"""Elements beyond HCNO through the port, held to the JAX package (float64,
CPU).

- The NaCl + water MBE(2) driver input of
  tests/test_elements_spd.py::test_nacl_water_driver_input: the driver
  total within 1e-9 Ha of the JAX driver's;
- the spd single points of test_spd_elements_converge_and_bind (SiH4, Si,
  H, NaCl, Na, Cl) and the fourth-row ones of test_fourth_row_elements_run
  (KBr, CH3I): energies within 1e-10 Ha, SCC residuals within 1e-10 and
  below that file's 1e-8, and the binding energies in its ranges;
- the Fe(CO)2, Zn-water and Pt-ammonia single points of
  tests/test_elements_ext.py::test_heavy_element_single_point_runs: with
  the default settings, finite energies and gradients (that test's
  assertions); held to the JAX package at 8 SCC iterations, energies within
  1e-10 Ha and gradients within 1e-9 Ha/Bohr, both relative to the
  quantity's size where it exceeds 1 (the dispersion energy of these
  geometries is -8.2e12 Ha for Fe(CO)2 and -1.4e5 Ha for Pt-ammonia in both
  packages), and the dispersion energy itself to 1e-12 relative. Their SCC
  converges in neither package (residuals of 2e-3 to 1 after the default
  32 iterations); the two agree to 1e-12 in the charges through the 8th
  iteration and their last-bit differences then grow about tenfold per
  iteration, so a comparison after 32 would compare rounding.

The JAX values are frozen in tests/data/port_golden_elements_spd.json
(`python tools/gen_port_golden.py --only elements_spd`); one live JAX
cross-check (KBr) keeps the file honest.
"""

import json
import os

import numpy as np
import pytest
import torch
from _torch_port_common import (
    HEAVY_CASES,
    NACL_WATER_MQC,
    REPO,
    SPD_CASES,
    heavy_coords,
    restore_jax_overlay,
    spd_fragment,
)

from metalquicha_tpu_torch import geometry
from metalquicha_tpu_torch.driver import run_calculation
from metalquicha_tpu_torch.io.config import parse_mqc_string
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params

torch.set_num_threads(1)

GOLDEN = os.path.join(REPO, "tests", "data", "port_golden_elements_spd.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.fixture(autouse=True)
def _quiet():
    global_logger.set_level("warning")


def _single_point(name):
    calc = XtbCalculator(variant="gfn1", device="cpu")
    e, aux = calc.energies(calc.make_batch([spd_fragment(geometry, name)]))
    return float(e[0]), float(aux["scf_residual"][0])


def _heavy(numbers, settings=None):
    calc = XtbCalculator(settings, device="cpu")
    numbers = np.array(numbers, dtype=np.int64)
    frag = calc.make_batch([(numbers, heavy_coords(len(numbers)), 0, 1)])
    return calc, frag


def test_nacl_water_driver_input(golden):
    out = run_calculation(parse_mqc_string(NACL_WATER_MQC), write_json=False,
                          device="cpu")
    e = out[""].result.total_energy
    assert np.isfinite(e) and e < -10.0
    assert abs(e - golden["nacl_water_total"]) <= 1e-9


@pytest.mark.parametrize("name", list(SPD_CASES))
def test_spd_single_point_matches_jax(golden, name):
    e, resid = _single_point(name)
    gold = golden["spd"][name]
    assert abs(e - gold["energy"]) <= 1e-10
    assert resid < 1e-8 and abs(resid - gold["scf_residual"]) <= 1e-10


def test_spd_elements_bind_as_the_reference_test_says(golden):
    """tests/test_elements_spd.py's ranges, on the port's energies."""
    e = {name: _single_point(name)[0] for name in
         ("sih4", "si", "h", "nacl", "na", "cl", "kbr", "ch3i")}
    assert -2.0 < e["sih4"] - e["si"] - 4 * e["h"] < -0.2
    assert -0.8 < e["nacl"] - e["na"] - e["cl"] < -0.05
    assert -6.0 < e["kbr"] < -2.0 and np.isfinite(e["ch3i"])


def test_kbr_matches_live_jax():
    import jax.numpy as jnp

    from metalquicha_tpu import geometry as jax_geometry
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator as JaxCalc

    restore_jax_overlay()
    calc = JaxCalc(variant="gfn1", dtype=jnp.float64)
    e_jax, _aux = calc.energies(calc.make_batch(
        [spd_fragment(jax_geometry, "kbr")]))
    assert abs(_single_point("kbr")[0] - float(np.asarray(e_jax)[0])) <= 1e-10


@pytest.mark.parametrize("name", list(HEAVY_CASES))
def test_heavy_element_single_point_runs(name):
    calc, frag = _heavy(HEAVY_CASES[name])
    e, _aux = calc.energies(frag)
    assert bool(torch.isfinite(e).all())
    e_val, g, _aux2 = calc.gradients(frag)
    assert bool(torch.isfinite(e_val).all() and torch.isfinite(g).all())


@pytest.mark.parametrize("name", list(HEAVY_CASES))
def test_heavy_element_matches_jax(golden, name):
    gold = golden["heavy"][name]
    settings = settings_from_params(
        "gfn1", max_scf_iter=golden["heavy_max_scf_iter"])
    calc, frag = _heavy(HEAVY_CASES[name], settings)
    e, g, aux = calc.gradients(frag)
    e, g = float(e[0]), g[0].numpy()
    g_gold = np.array(gold["gradient"])
    assert np.isfinite(e) and np.isfinite(g).all()
    assert abs(e - gold["energy"]) <= 1e-10 * max(1.0, abs(gold["energy"]))
    assert np.abs(g - g_gold).max() <= 1e-9 * max(1.0, np.abs(g_gold).max())
    e_disp = float(aux["e_disp"][0])
    assert abs(e_disp - gold["e_disp"]) <= 1e-12 * max(1.0, abs(gold["e_disp"]))
    assert abs(float(aux["scf_residual"][0]) - gold["scf_residual"]) <= 1e-8
