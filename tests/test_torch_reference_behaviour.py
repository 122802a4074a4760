"""Behaviour that a JAX test holds, through the port, on the CPU.

- A stalled SCC raises `ConvergenceError` through the driver
  (tests/test_convergence.py), and a converged one does not;
- `compute_energy_and_forces`, the re-entrant entry for dynamics drivers
  (tests/test_driver.py::test_external_calc_interface), against the JAX
  package's on the same input (1e-10 Ha, 1e-9 Ha/Bohr);
- the ATM term's padding and cap guards
  (tests/test_atm_dispersion.py::test_padding_and_cap_guards): padded atoms
  change nothing, a cap that coincides with a real atom leaves the energy
  and its gradient finite, and both equal the JAX package's;
- the decane GMBE(1) − unfragmented gap through the port's driver, held
  to the JAX package at HEAD (tests/data/port_golden_decane_gap.json,
  written by tools/gen_port_golden.py --only decane_gap); the older
  tests/data/gmbe_tail_sentinel.json predates the shipped ATM globals;
- GFN2's SCC on a seeded draw of chip_smoke.py's random water hexamers:
  the port leaves unconverged and gives a NaN to the same hexamers as the
  JAX package.
"""

import json
import os

import numpy as np
import pytest
import torch
from _torch_port_common import REPO, restore_jax_overlay

from metalquicha_tpu_torch.constants import ANGSTROM_TO_BOHR
from metalquicha_tpu_torch.driver import compute_energy_and_forces, run_calculation
from metalquicha_tpu_torch.errors import ConvergenceError
from metalquicha_tpu_torch.io.adapter import (
    config_to_driver,
    config_to_system_geometry,
)
from metalquicha_tpu_torch.io.config import parse_mqc_string
from metalquicha_tpu_torch.io.prep import emit_mqc
from metalquicha_tpu_torch.methods.xtb import params_gfn1
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.dispersion_d3 import (
    atm_energy,
    build_d3_tables,
    full_pair_table,
)
from metalquicha_tpu_torch.methods.xtb.engine import (
    coordination_numbers,
    settings_from_params,
)
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor

torch.set_num_threads(1)

TWO_WATERS_MQC = """
%schema
name = mqc-frag
version = 1.0
index_base = 0
units = angstrom
end

%model
method = XTB-GFN1
end

%driver
type = {driver}
end

%structure
charge = 0
multiplicity = 1
end

%geometry
6

O 0.0 0.0 0.117
H 0.0 0.757 -0.471
H 0.0 -0.757 -0.471
O 3.0 0.0 0.117
H 3.0 0.757 -0.471
H 3.0 -0.757 -0.471
end

%fragments
nfrag = 2

%fragment
charge = 0
multiplicity = 1
%indices
0 1 2
end
end

%fragment
charge = 0
multiplicity = 1
%indices
3 4 5
end
end

end  ! fragments

%fragmentation
method = MBE
allow_overlapping_fragments = false
level = 2
embedding = none
end
"""


def _dimer_cfg(driver="Energy"):
    return parse_mqc_string(TWO_WATERS_MQC.format(driver=driver))


def test_stalled_scc_raises():
    """One iteration without mixing cannot converge: the driver raises
    instead of returning the stalled numbers."""
    settings = settings_from_params("gfn1", max_scf_iter=1,
                                    mixer_damping=1.0)
    ex = FragmentExecutor(XtbCalculator(settings=settings, device="cpu"))
    with pytest.raises(ConvergenceError) as exc:
        run_calculation(_dimer_cfg(), write_json=False, executor=ex)
    assert "residual" in str(exc.value)


def test_converged_scc_passes():
    out = run_calculation(_dimer_cfg(), write_json=False, device="cpu")
    assert out[""].result.total_energy < 0.0


def test_compute_energy_and_forces_matches_jax():
    from metalquicha_tpu.driver import (
        compute_energy_and_forces as jax_compute,
    )
    from metalquicha_tpu.io.adapter import (
        config_to_driver as jax_config_to_driver,
        config_to_system_geometry as jax_system_geometry,
    )
    from metalquicha_tpu.io.config import parse_mqc_string as jax_parse

    cfg = _dimer_cfg()
    e, g, h = compute_energy_and_forces(
        config_to_system_geometry(cfg), config_to_driver(cfg),
        want_gradient=True, device="cpu")
    assert -12.0 < e < -9.0 and g.shape == (6, 3) and h is None
    e0, g0, h0 = compute_energy_and_forces(
        config_to_system_geometry(cfg), config_to_driver(cfg),
        want_gradient=False, device="cpu")
    assert e0 == pytest.approx(e, abs=1e-12) and g0 is None and h0 is None

    restore_jax_overlay()
    jcfg = jax_parse(TWO_WATERS_MQC.format(driver="Energy"))
    e_j, g_j, _ = jax_compute(jax_system_geometry(jcfg),
                              jax_config_to_driver(jcfg), want_gradient=True)
    assert abs(e - float(e_j)) <= 1e-10
    assert np.abs(np.asarray(g) - np.asarray(g_j)).max() <= 1e-9


def _water_trimer():
    base = np.array([[0.0, 0.0, 0.0], [1.8, 0.0, 0.6], [-0.6, 1.7, 0.0]])
    coords = np.concatenate(
        [base, base + [5.3, 0.0, 0.0], base + [2.6, 4.6, 0.0]])
    return coords, np.array([8, 1, 1] * 3)


A1, A2 = 0.63, 5.0


def _atm(coords, numbers, mask, grad=False):
    """The port's ATM energy (s9 = 1, rs9 = 0.65) of one fragment, and its
    gradient in the coordinates."""
    c = torch.tensor(coords[None], requires_grad=grad)
    m = torch.tensor(np.asarray(mask, dtype=float)[None])
    rcov = torch.tensor([params_gfn1.COVALENT_RADII_A[int(z)]
                         for z in numbers])[None] * ANGSTROM_TO_BOHR
    cn = coordination_numbers(c, rcov, m, torch.tensor([16.0]), "exp")
    tab = build_d3_tables(np.asarray(numbers))
    d3tab = {k: torch.tensor(np.asarray(tab[k]))[None]
             for k in ("ref_cn", "zidx", "sqrtc6", "r4r2")}
    d3tab["pair_table"] = torch.tensor(
        np.asarray(full_pair_table(True)))[None]
    one = torch.ones(1, dtype=torch.float64)
    e = atm_energy(c, cn, d3tab, m, one, 0.65 * one, A1 * one, A2 * one)
    if not grad:
        return float(e[0]), None
    (g,) = torch.autograd.grad(e.sum(), c)
    return float(e.detach()[0]), g[0].numpy()


def _jax_atm(coords, numbers, mask):
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb import params_gfn1 as jax_params
    from metalquicha_tpu.methods.xtb.dispersion_d3 import (
        atm_energy as jax_atm_energy,
        build_d3_tables as jax_tables,
        full_pair_table as jax_pair_table,
    )
    from metalquicha_tpu.methods.xtb.engine import (
        coordination_numbers as jax_cn,
    )

    rcov = np.array([jax_params.COVALENT_RADII_A[int(z)] for z in numbers])
    m = jnp.asarray(np.asarray(mask, dtype=float))
    cn = jax_cn(jnp.asarray(coords), jnp.asarray(rcov * ANGSTROM_TO_BOHR), m,
                16.0, "exp")
    tab = jax_tables(np.asarray(numbers))
    tabs = {k: jnp.asarray(tab[k]) for k in ("ref_cn", "zidx", "sqrtc6",
                                              "r4r2")}
    tabs["pair_table"] = jnp.asarray(np.asarray(jax_pair_table(True)))
    return float(jax_atm_energy(jnp.asarray(coords), cn, tabs, m, 1.0, 0.65,
                                A1, A2))


def test_atm_padding_and_cap_guards():
    restore_jax_overlay()
    coords, numbers = _water_trimer()
    e_ref, _ = _atm(coords, numbers, np.ones(9))
    assert e_ref > 0.0
    assert e_ref == pytest.approx(_jax_atm(coords, numbers, np.ones(9)),
                                  abs=1e-14)
    # padded atoms (z = 0, mask 0) far away change nothing
    cpad = np.concatenate([coords, coords[-1] + [[1000.0, 0, 0],
                                                 [2000.0, 0, 0]]])
    npad = np.concatenate([numbers, [0, 0]])
    mask = np.concatenate([np.ones(9), np.zeros(2)])
    assert _atm(cpad, npad, mask)[0] == pytest.approx(e_ref, abs=1e-14)
    # an H cap on top of a real atom (GMBE's gappy intersections): the
    # energy and its gradient stay finite, and equal the JAX package's
    ccap = np.concatenate([coords, coords[:1]])
    ncap = np.concatenate([numbers, [1]])
    e_cap, g_cap = _atm(ccap, ncap, np.ones(10), grad=True)
    assert np.isfinite(e_cap) and np.isfinite(g_cap).all()
    assert e_cap == pytest.approx(_jax_atm(ccap, ncap, np.ones(10)),
                                  abs=1e-14)


def _decane_inputs():
    """overlapping_decane.json at GMBE(1) and as one unfragmented molecule,
    as tools/gen_port_golden.py builds the pair."""
    with open(os.path.join(REPO, "validation", "inputs",
                           "overlapping_decane.json")) as fh:
        data = json.load(fh)
    unfrag = json.loads(json.dumps(data))
    mol = unfrag["molecules"][0]
    for key in ("fragments", "connectivity", "fragment_charges",
                "fragment_multiplicities"):
        mol.pop(key, None)
    unfrag["keywords"].pop("fragmentation", None)
    return {"gmbe1": data, "unfrag": unfrag}


def test_decane_gmbe1_gap_matches_jax():
    with open(os.path.join(REPO, "tests", "data",
                           "port_golden_decane_gap.json")) as fh:
        gold = json.load(fh)
    inputs = os.path.join(REPO, "validation", "inputs")
    totals = {}
    for name, data in _decane_inputs().items():
        cfg = parse_mqc_string(emit_mqc(data, base_dir=inputs))
        out = run_calculation(cfg, write_json=False, device="cpu")[""]
        totals[name] = float(out.result.total_energy)
    assert abs(totals["gmbe1"] - gold["e_gmbe1_ha"]) <= 1e-9
    assert abs(totals["unfrag"] - gold["e_unfrag_ha"]) <= 1e-9
    gap = totals["gmbe1"] - totals["unfrag"]
    assert abs(gap - gold["gap_ha"]) <= 1e-9
    # the sentinel's own sanity bound: a cap-dominated gap
    assert abs(gap) < 0.1


def test_random_hexamers_fail_where_the_reference_fails():
    """chip_smoke.py's seeded water hexamers (`water_clusters`: waters on a
    jittered grid 5.6 Bohr apart, each turned at random) of a new draw
    (seed 7), in GFN2 with 64 SCC iterations at scf_tol 1e-9: hexamer 0
    stops unconverged and hexamer 7 gives a NaN energy and residual in the
    JAX package on the CPU, and the port does the same; hexamer 4, which
    both converge, agrees to 1e-10 Ha."""
    import jax.numpy as jnp

    from chip_smoke import water_clusters
    from metalquicha_tpu.methods.xtb import calculator as jcalc
    from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp

    restore_jax_overlay()
    frags = [water_clusters(np.random.default_rng(7), 64, 6)[i]
             for i in (0, 4, 7)]
    kw = dict(max_scf_iter=64, scf_tol=1e-9)
    jc = jcalc.XtbCalculator(jsp("gfn2", **kw), variant="gfn2",
                             dtype=jnp.float64)
    e_j, aux_j = jc.energies(jc.make_batch(frags))
    e_j, r_j = np.asarray(e_j), np.asarray(aux_j["scf_residual"])
    calc = XtbCalculator(settings_from_params("gfn2", **kw), variant="gfn2",
                         dtype=torch.float64, device="cpu")
    e_t, aux_t = calc.energies(calc.make_batch(frags))
    e_t, r_t = e_t.numpy(), aux_t["scf_residual"].numpy()
    for e, r in ((e_j, r_j), (e_t, r_t)):
        assert r[0] > 1e-6 and r[1] <= 1e-9
        assert np.isnan(e[2]) and np.isnan(r[2])
    assert abs(e_t[1] - e_j[1]) <= 1e-10
