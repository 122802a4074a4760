"""Every tabulated element's frozen anchor through the port.

The hydride and oxide diatomics of tests/data/gfn1_element_fixtures.json
(written by tools/gen_element_fixtures.py from the JAX package) go through
the port's `XtbCalculator(device="cpu")` as one padded batch, with the
SCC settings of tests/test_element_fixtures.py (512 iterations, scf_tol
1e-11), and are held to the same bars: energies 1e-9 Ha, the two atoms'
charges and the dipole 1e-7. Beyond H, C, N, O this is the port's SCC
over s, p and d shells of every row of the table.
"""

import json
import os

import numpy as np
import pytest
import torch

from metalquicha_tpu_torch.constants import ANGSTROM_TO_BOHR
from metalquicha_tpu_torch.methods.xtb import params_gfn1
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "gfn1_element_fixtures.json")
with open(FIX) as _fh:
    FIXTURES = json.load(_fh)
NAMES = [n for n in FIXTURES if not n.startswith("_")]


@pytest.fixture(scope="module")
def evaluated():
    calc = XtbCalculator(
        settings_from_params("gfn1", max_scf_iter=512, scf_tol=1e-11),
        device="cpu",
    )
    frags = []
    for n in NAMES:
        spec = FIXTURES[n]
        r_b = spec["bond_angstrom"] * ANGSTROM_TO_BOHR
        coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, r_b]])
        frags.append(
            (np.array(spec["numbers"]), coords, 0, spec["multiplicity"]))
    e, aux = calc.energies(calc.make_batch(frags))
    return {n: (float(e[k]), aux["charges"][k].numpy(),
                aux["dipole"][k].numpy(), float(aux["scf_residual"][k]))
            for k, n in enumerate(NAMES)}


@pytest.mark.parametrize("name", NAMES)
def test_element_matches_frozen_anchor(evaluated, name):
    spec = FIXTURES[name]
    e, q, mu, resid = evaluated[name]
    assert resid <= 1e-9
    assert abs(e - spec["energy_ha"]) <= 1e-9
    assert np.abs(q[:2] - np.array(spec["charges"])).max() <= 1e-7
    assert np.abs(mu - np.array(spec["dipole_au"])).max() <= 1e-7


def test_fixtures_span_the_port_table():
    """Every element of the port's GFN1 table but H and O (the partners of
    every system) has its anchor."""
    have = {int(n[1:3]) for n in NAMES}
    assert [z for z in params_gfn1.ELEMENTS
            if z not in have and z not in (1, 8)] == []
    assert len(NAMES) == 170
