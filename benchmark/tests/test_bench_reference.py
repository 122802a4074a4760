"""The plain reference (`benchmark/reference/`) against the program on the
CPU: the waters of the isomer at MBE(2) in GFN1, at the isomer's own
geometry and displaced as the traffic displaces it."""

import numpy as np
import pytest
import torch

from benchmark.harness import spec, system
from benchmark.reference import xtb as reference

#: the two sides' sums run in other orders: rounding of a 20 Ha energy,
#: and the program's SCC stop at 1e-7 (its energy is stationary in the
#: charges, so the stop enters squared)
TOL = 1e-10
#: gradients (Ha/Bohr): the stop at 1e-7 enters linearly
GRAD_TOL = 1e-7


def _program():
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params

    settings = settings_from_params("gfn1", max_scf_iter=256, scf_tol=1e-7)
    return XtbCalculator(settings, variant="gfn1", device="cpu")


@pytest.mark.parametrize("sigma", [0.05, 0.0])
def test_reference_matches_the_program(sigma):
    cell = spec.load_cell("w20-gfn1.mbe4-energy")
    _cfg, cluster = system.read_input(cell.config, spec.ROOT)
    cluster = cluster._replace(monomers=cluster.monomers[:5])
    coords = cluster.coords + np.random.default_rng(5).normal(
        0.0, sigma, cluster.coords.shape)
    calc = _program()
    for batch in system.batches(cluster, {"batches": [[1, 5], [2, 10]]}):
        frags = system.fragments(cluster, batch, coords)
        e_prog, g_prog, aux = calc.gradients(calc.make_batch(frags))
        assert float(aux["scf_residual"].max()) < 1e-7
        tables = reference.build(frags, "gfn1", "cpu")
        settings = reference.settings_for("gfn1")
        e_ref, resid = reference.energies_at(tables, tables.coords, settings)
        assert float(resid.max()) <= 1e-10
        assert float((e_prog - e_ref).abs().max()) < TOL
        e_ref2, g_ref, _r = reference.energies_at(tables, tables.coords,
                                                  settings, grad=True)
        assert torch.equal(e_ref, e_ref2)
        assert float((g_prog - g_ref).abs().max()) < GRAD_TOL


def test_reference_is_its_own():
    """The reference reads its own copies of the tables: a build from
    numbers alone, with the coordinates given apart, gives the same
    energies as one from the coordinates."""
    cell = spec.load_cell("w20-gfn1.mbe4-energy")
    _cfg, cluster = system.read_input(cell.config, spec.ROOT)
    cluster = cluster._replace(monomers=cluster.monomers[:3])
    batch = system.batches(cluster, {"batches": [[1, 3]]})[0]
    frags = system.fragments(cluster, batch, cluster.coords)
    at_zero = reference.build(
        [(z, np.zeros_like(x), c, m) for z, x, c, m in frags], "gfn1", "cpu")
    direct = reference.build(frags, "gfn1", "cpu")
    s = reference.settings_for("gfn1")
    a, _ = reference.energies_at(at_zero, direct.coords, s)
    b, _ = reference.energies_at(direct, direct.coords, s)
    assert torch.equal(a, b)
