"""Torch port vs JAX package: GFN2 (multipole SCC, charge-scaled dispersion).

Live against the JAX package in float64 on the same arrays (the JAX side
under `vmap`, one fragment per lane, as its calculator runs it):
- `moment_matrices` on a batch with s, p and d shells and padding, 1e-12;
- `camm_moments`, `aes_energy`, `d4_zeta`, `d3_energy(c6_scale=)` on seeded
  densities and moments, 1e-12;
- the potentials of `_aes_fock` against `jax.grad` and the Fock matrix,
  1e-12;
- z* of `scf_solve_multipole`, 1e-9;
- `XtbCalculator(variant="gfn2")` energies 1e-10 Ha, gradients 1e-9
  Ha/Bohr, dipoles 1e-9 on one dimer shape; a GFN2 + ALPB water 1e-10.
Against frozen JAX results (tests/data/port_golden_gfn2.json, written by
tools/gen_port_golden.py --only gfn2): the first 8 bench dimers, the
warm-start (`q_init`) and refine (`diff_scf_iters=3`) entries in GFN1 and
GFN2 (1e-9), the w20 MBE(2) list (total 1e-8 Ha, |g| 1e-6, with ALPB 1e-8)
and the driver on `w1_vib_therm` and prism MBE(2) (w20 MBE(3) runs on the
card, chip_smoke.py).
The port alone: the gradient against central differences (5e-8), a padded
monomer in a dimer batch, coincident atoms, the JAX package's own GFN2 pins
(tests/data/gfn2_fixtures.json, size consistency, rotation), the factory,
the chunk cap and the placeholder methods through the driver.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    GLY3_FRAG,
    H3O,
    HALOGEN,
    REPO,
    WATER,
    max_abs_diff,
    port_from_jax,
    restore_jax_overlay,
    to_np,
)

from metalquicha_tpu.constants import ANGSTROM_TO_BOHR, KB_HARTREE
from metalquicha_tpu.methods.xtb import calculator as jcalc
from metalquicha_tpu.methods.xtb import dispersion_d3 as jd3
from metalquicha_tpu.methods.xtb import engine as je
from metalquicha_tpu.methods.xtb import gfn2 as jg2
from metalquicha_tpu.methods.xtb import multipole as jmp
from metalquicha_tpu.methods.xtb.batch import build_batch as jax_build_batch
from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp
from metalquicha_tpu_torch.driver import make_executor, run_calculation
from metalquicha_tpu_torch.io.adapter import MethodType, config_to_driver
from metalquicha_tpu_torch.io.config import read_mqc_file
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.factory import create_calculator
from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
from metalquicha_tpu_torch.methods.xtb import dispersion_d3 as td3
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb import gfn2 as tg2
from metalquicha_tpu_torch.methods.xtb import multipole as tmp_
from metalquicha_tpu_torch.methods.xtb.calculator import (
    XtbCalculator,
    single_point_energy,
)
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
from metalquicha_tpu_torch.validation import golden_failures, observables
from metalquicha_tpu_torch.workloads import (
    bench_dimers,
    w20_mbe2_assemble,
    w20_mbe2_fragments,
)

torch.set_num_threads(1)
KT = 300.0 * KB_HARTREE
GOLDEN_GFN2 = os.path.join(REPO, "tests", "data", "port_golden_gfn2.json")
FIXTURES = os.path.join(REPO, "tests", "data", "gfn2_fixtures.json")
TIGHT = dict(max_scf_iter=64, scf_tol=1e-11)
# water (s, p), the hydronium cation and CH3Br...NH3 (Br carries a d
# shell), padded to the largest: for the integrals and the energy terms
BATCH = [WATER, H3O, HALOGEN]
# for the SCC: the GFN2 table is calibrated for H, C, N, O only (the
# halogen complex does not converge in either package); the glycine
# fragment is a doublet
SCC_BATCH = [WATER, H3O, GLY3_FRAG]
# randomly distorted dimers: no two monomers alike, so no exactly
# degenerate overlap spectra (ROADMAP C5)
DIMERS = bench_dimers(2, seed=7)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_GFN2) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def batch():
    """(JAX FragmentData, the port's from the same arrays), GFN2."""
    restore_jax_overlay()
    jf = jcalc.fragment_data_from_batch(
        jax_build_batch(BATCH, variant="gfn2"), variant="gfn2")
    return jf, port_from_jax(jf)


def _quiet_run(cfg, **kw):
    level = global_logger.level
    global_logger.set_level("warning")  # no per-fragment XYZ dumps
    try:
        return run_calculation(cfg, write_json=False, **kw)
    finally:
        global_logger.level = level


# ---------------------------------------------------------------------------
# integrals and the GFN2 energy terms
# ---------------------------------------------------------------------------


def test_moment_matrices_match_jax(batch):
    jf, tf = batch
    S_j, D_j, Q_j = jax.vmap(jmp.moment_matrices)(
        jf.coords, jf.ao_atom, jf.ao_lxyz, jf.prim_alpha, jf.prim_coeff)
    S, D, Q = tmp_.moment_matrices(
        tf.coords, tf.ao_atom, tf.ao_lxyz, tf.prim_alpha, tf.prim_coeff)
    assert D.shape == (3, 3) + S.shape[1:] and Q.shape == (3, 6) + S.shape[1:]
    assert float(D.abs().max()) > 0.1 and float(Q.abs().max()) > 0.1
    assert max_abs_diff(S, S_j) <= 1e-12
    assert max_abs_diff(D, D_j) <= 1e-12
    assert max_abs_diff(Q, Q_j) <= 1e-12
    # the d shell of Br contributes, and padded AOs give zero rows
    assert int(tf.ao_lxyz[2].sum(-1).max()) == 2
    pad = tf.ao_mask[0] < 0.5
    assert bool(pad.any()) and float(D[0][:, pad].abs().max()) == 0.0


def _seeded_moments(tf, seed=3, scale=0.2):
    """Seeded shell charges, dipoles and quadrupoles (traceless) of the
    batch's shape, zero on padding."""
    rng = np.random.default_rng(seed)
    bsz, nat = tf.atom_mask.shape
    q = scale * rng.standard_normal(tf.sh_mask.shape) * tf.sh_mask.numpy()
    mu = scale * rng.standard_normal((bsz, nat, 3))
    th = scale * rng.standard_normal((bsz, nat, 6))
    th[..., :3] -= th[..., :3].mean(-1, keepdims=True)
    mask = tf.atom_mask.numpy()[..., None]
    return q, mu * mask, th * mask


def test_camm_moments_match_jax(batch):
    jf, tf = batch
    rng = np.random.default_rng(5)
    nao = tf.ao_mask.shape[1]
    P = rng.standard_normal((3, nao, nao))
    P = P + P.transpose(0, 2, 1)
    S, D, Q = tmp_.moment_matrices(
        tf.coords, tf.ao_atom, tf.ao_lxyz, tf.prim_alpha, tf.prim_coeff)
    nat = tf.atom_mask.shape[1]
    mu, th = tg2.camm_moments(torch.tensor(P), S, D, Q, tf.ao_atom, nat)
    mu_j, th_j = jax.vmap(
        lambda p, s, d, q, a: jg2.camm_moments(p, s, d, q, a, nat)
    )(jnp.asarray(P), *(jnp.asarray(to_np(x)) for x in (S, D, Q)), jf.ao_atom)
    assert max_abs_diff(mu, mu_j) <= 1e-12
    assert max_abs_diff(th, th_j) <= 1e-12
    assert float((th[..., :3].sum(-1)).abs().max()) <= 1e-12


def test_aes_energy_and_d4_zeta_match_jax(batch):
    jf, tf = batch
    q_sh, mu, th = _seeded_moments(tf)
    q_at = te._atom_charges(torch.tensor(q_sh), tf)
    aes = tf.at_aes
    e = tg2.aes_energy(tf.coords, q_at, torch.tensor(mu), torch.tensor(th),
                       aes[..., 0], aes[..., 1], aes[..., 2], tf.atom_mask)
    e_j = jax.vmap(jg2.aes_energy)(
        jf.coords, jnp.asarray(q_at.numpy()), jnp.asarray(mu),
        jnp.asarray(th), jf.at_aes[..., 0], jf.at_aes[..., 1],
        jf.at_aes[..., 2], jf.atom_mask)
    assert float(e.abs().min()) > 1e-4
    assert max_abs_diff(e, e_j) <= 1e-12
    zeta = tg2.d4_zeta(q_at, aes[..., 3], aes[..., 4], tf.atom_mask)
    zeta_j = jax.vmap(jg2.d4_zeta)(
        jnp.asarray(q_at.numpy()), jf.at_aes[..., 3], jf.at_aes[..., 4],
        jf.atom_mask)
    assert max_abs_diff(zeta, zeta_j) <= 1e-12
    assert float((zeta - 1.0).abs().max()) > 1e-3
    assert bool((zeta[tf.atom_mask < 0.5] == 1.0).all())


def _d3tab(f):
    return {"ref_cn": f.d3_ref_cn, "zidx": f.d3_zidx, "sqrtc6": f.d3_sqrtc6,
            "pair_table": f.d3_c6_pair, "r4r2": f.d3_r4r2}


def test_d3_energy_with_c6_scale_matches_jax(batch):
    jf, tf = batch
    rng = np.random.default_rng(9)
    nat = tf.atom_mask.shape[1]
    zeta = 1.0 + 0.3 * rng.random((3, nat))
    scale = zeta[:, :, None] * zeta[:, None, :]
    settings = tsp("gfn2")
    cn = te.coordination_numbers(tf.coords, tf.at_rcov, tf.atom_mask,
                                 tf.glb[:, 11], settings.cn_type_d3)
    glb = tf.glb
    args = (glb[:, 12], glb[:, 13], glb[:, 14], glb[:, 15])
    e = td3.d3_energy(tf.coords, cn, _d3tab(tf), tf.atom_mask, *args,
                      c6_scale=torch.tensor(scale))
    plain = td3.d3_energy(tf.coords, cn, _d3tab(tf), tf.atom_mask, *args)

    def one(f, cn_b, sc):
        return jd3.d3_energy(f.coords, cn_b, _d3tab(f), f.atom_mask,
                             f.glb[12], f.glb[13], f.glb[14], f.glb[15],
                             c6_scale=sc)

    e_j = jax.vmap(one)(jf, jnp.asarray(cn.numpy()), jnp.asarray(scale))
    assert max_abs_diff(e, e_j) <= 1e-12
    assert float((e - plain).abs().min()) > 1e-5


# ---------------------------------------------------------------------------
# potentials, Fock matrix, SCC
# ---------------------------------------------------------------------------


def _scc_operands(tf, settings):
    with torch.no_grad():
        S, H0, gamma, mp = tcalc._scc_operands(tf.coords, tf, settings)
    return S, H0, gamma, mp


def _jax_mp(jf_one, cn, D, Q):
    mp = jcalc._mp_tables(jf_one, cn)
    mp["D"], mp["Q"] = D, Q
    return mp


def test_aes_fock_and_potentials_match_jax_grad(batch):
    jf, tf = batch
    settings, jsettings = tsp("gfn2"), jsp("gfn2")
    S, H0, gamma, mp = _scc_operands(tf, settings)
    z = te._aes_pack(*(torch.tensor(x) for x in _seeded_moments(tf, seed=4)))
    with torch.no_grad():  # as inside the SCC loop
        F, (vq, vmu, vth) = te._aes_fock(H0, S, z, tf.coords, gamma, tf,
                                         settings, None, mp)
    assert not F.requires_grad and not vq.requires_grad

    def one(h0, s, zz, g, f, cn, d, q):
        return je._aes_fock(h0, s, zz, f.coords, g, f, jsettings, None,
                            _jax_mp(f, cn, d, q))

    F_j, (vq_j, vmu_j, vth_j) = jax.vmap(one)(
        *(jnp.asarray(to_np(x)) for x in (H0, S, z, gamma)), jf,
        *(jnp.asarray(to_np(mp[k])) for k in ("cn", "D", "Q")))
    assert float(vmu.abs().max()) > 1e-3 and float(vth.abs().max()) > 1e-3
    assert max_abs_diff(vq, vq_j) <= 1e-12
    assert max_abs_diff(vmu, vmu_j) <= 1e-12
    assert max_abs_diff(vth, vth_j) <= 1e-12
    assert max_abs_diff(F, F_j) <= 1e-12
    # the returned quadrupole potential is the projected one
    assert float(vth[..., :3].sum(-1).abs().max()) <= 1e-12


def test_scf_solve_multipole_matches_jax():
    restore_jax_overlay()
    jf = jcalc.fragment_data_from_batch(
        jax_build_batch(SCC_BATCH, variant="gfn2"), variant="gfn2")
    tf = port_from_jax(jf)
    tight = dict(max_scf_iter=128, scf_tol=1e-11)
    settings, jsettings = tsp("gfn2", **tight), jsp("gfn2", **tight)
    z, resid = tcalc._converge_charges(tf.coords, tf, KT, settings)
    z_j, resid_j = jax.jit(jax.vmap(
        lambda c, f: jcalc._converge_charges(c, f, KT, jsettings)
    ))(jf.coords, jf)
    assert z.shape == (3, tf.sh_mask.shape[1] + 9 * tf.atom_mask.shape[1])
    assert float(resid.max()) <= 1e-11 and float(resid_j.max()) <= 1e-11
    assert max_abs_diff(z, z_j) <= 1e-9
    # a warm start from a perturbed z* comes back to it, in fewer steps
    rng = np.random.default_rng(1)
    z0 = z + 1e-4 * torch.tensor(rng.standard_normal(tuple(z.shape)))
    z_w, resid_w = tcalc._converge_charges(tf.coords, tf, KT, settings, q0=z0)
    assert float(resid_w.max()) <= 1e-11
    assert max_abs_diff(z_w, z) <= 1e-9


# ---------------------------------------------------------------------------
# the calculator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dimers():
    restore_jax_overlay()
    calc = jcalc.XtbCalculator(jsp("gfn2", **TIGHT), variant="gfn2",
                               dtype=jnp.float64)
    e, g, aux = calc.gradients(calc.make_batch(DIMERS))
    return {k: np.asarray(v) for k, v in
            dict(e=e, g=g, z=aux["shell_charges"], dipole=aux["dipole"],
                 charges=aux["charges"]).items()}


def test_calculator_matches_live_jax(jax_dimers):
    calc = XtbCalculator(tsp("gfn2", **TIGHT), variant="gfn2", device="cpu")
    frag = calc.make_batch(DIMERS)
    e, g, aux = calc.gradients(frag)
    e_only, aux_only = calc.energies(frag)
    assert float(aux["scf_residual"].max()) <= 1e-11
    assert max_abs_diff(e, jax_dimers["e"]) <= 1e-10
    assert max_abs_diff(e_only, jax_dimers["e"]) <= 1e-10
    assert max_abs_diff(g, jax_dimers["g"]) <= 1e-9
    assert max_abs_diff(aux["shell_charges"], jax_dimers["z"]) <= 1e-9
    assert max_abs_diff(aux["dipole"], jax_dimers["dipole"]) <= 1e-9
    assert max_abs_diff(aux_only["dipole"], jax_dimers["dipole"]) <= 1e-9
    assert max_abs_diff(aux["charges"], jax_dimers["charges"]) <= 1e-9
    assert float(aux["e_disp"].abs().max()) == 0.0  # in-loop, inside e_el


def test_alpb_water_matches_live_jax():
    from metalquicha_tpu.methods.xtb.solvation.born import (
        BornSolvation as JaxBorn,
    )

    restore_jax_overlay()
    jc = jcalc.XtbCalculator(jsp("gfn2", **TIGHT), variant="gfn2",
                             dtype=jnp.float64,
                             solvation=JaxBorn(78.4, alpb=True))
    e_j, _ = jc.energies(jc.make_batch([WATER]))
    calc = XtbCalculator(tsp("gfn2", **TIGHT), variant="gfn2", device="cpu",
                         solvation=BornSolvation(78.4, alpb=True))
    e, g, _ = calc.gradients(calc.make_batch([WATER]))
    assert max_abs_diff(e, e_j) <= 1e-10
    assert bool(torch.isfinite(g).all())
    vac = XtbCalculator(tsp("gfn2", **TIGHT), variant="gfn2", device="cpu")
    e_vac, _ = vac.energies(vac.make_batch([WATER]))
    assert abs(float(e[0] - e_vac[0])) > 1e-3


def _central_differences(calc, frag_tuple, h=1e-5):
    numbers, coords, charge, mult = frag_tuple
    disp = []
    for a in range(len(numbers)):
        for d in range(3):
            for sgn in (1.0, -1.0):
                c = coords.copy()
                c[a, d] += sgn * h
                disp.append((numbers, c, charge, mult))
    e, _ = calc.energies(calc.make_batch(disp))
    return ((e[0::2] - e[1::2]) / (2 * h)).reshape(len(numbers), 3)


def test_gradient_matches_central_differences():
    calc = XtbCalculator(tsp("gfn2", max_scf_iter=64, scf_tol=1e-12),
                         variant="gfn2", device="cpu")
    _, g, _ = calc.gradients(calc.make_batch([WATER]))
    assert max_abs_diff(g[0], _central_differences(calc, WATER)) < 5e-8


def test_padded_monomer_in_a_dimer_batch():
    calc = XtbCalculator(tsp("gfn2", **TIGHT), variant="gfn2", device="cpu")
    e1, g1, _ = calc.gradients(calc.make_batch([WATER]))
    e2, g2, aux = calc.gradients(calc.make_batch([WATER, DIMERS[0]]))
    assert abs(float(e2[0] - e1[0])) <= 1e-11
    assert bool(torch.isfinite(g2).all())
    assert max_abs_diff(g2[0, :3], g1[0]) <= 1e-10
    assert float(g2[0, 3:].abs().max()) == 0.0


def test_coincident_atoms_give_a_finite_gradient():
    """Two hydrogen caps on one position (gappy GMBE intersections): the
    pair is skipped; the port's gradient is finite where the reference's
    `sqrt` at zero distance gives NaN (ROADMAP C10)."""
    numbers, coords, *_ = WATER
    capped = (np.concatenate([numbers, [1, 1]]),
              np.vstack([coords, [[3.0, 0.2, 0.1]] * 2]), 0, 1)
    calc = XtbCalculator(tsp("gfn2", **TIGHT), variant="gfn2", device="cpu")
    e, g, aux = calc.gradients(calc.make_batch([capped]))
    assert bool(torch.isfinite(e).all()) and bool(torch.isfinite(g).all())

    restore_jax_overlay()
    jf = jcalc.fragment_data_from_batch(
        jax_build_batch([capped], variant="gfn2"), variant="gfn2")
    tf = port_from_jax(jf)
    q_sh, mu, th = _seeded_moments(tf)
    q_at = te._atom_charges(torch.tensor(q_sh), tf)

    def aes(c):
        return jg2.aes_energy(
            c, jnp.asarray(q_at.numpy()[0]), jnp.asarray(mu[0]),
            jnp.asarray(th[0]), jf.at_aes[0, :, 0], jf.at_aes[0, :, 1],
            jf.at_aes[0, :, 2], jf.atom_mask[0])

    e_j, g_j = jax.value_and_grad(aes)(jf.coords[0])
    c = tf.coords.clone().requires_grad_(True)
    e_t = tg2.aes_energy(c, q_at, torch.tensor(mu), torch.tensor(th),
                         tf.at_aes[..., 0], tf.at_aes[..., 1],
                         tf.at_aes[..., 2], tf.atom_mask)
    (g_t,) = torch.autograd.grad(e_t.sum(), c)
    assert abs(float(e_t[0].detach()) - float(e_j)) <= 1e-12  # same value
    assert bool(torch.isfinite(g_t).all())
    assert not bool(np.isfinite(np.asarray(g_j)).all())  # the reference


@pytest.mark.parametrize("variant", ["gfn1", "gfn2"])
@pytest.mark.parametrize("entry", ["warm", "refine3"])
def test_warm_start_and_refine_entries_match_golden(golden, variant, entry):
    gold = golden[f"refine_{variant}"]
    settings = tsp(variant, max_scf_iter=gold["max_scf_iter"],
                   scf_tol=gold["scf_tol"])
    calc = XtbCalculator(settings, variant=variant, device="cpu")
    frag = calc.make_batch(bench_dimers(gold["n"]))
    kw = ({"q_init": torch.tensor(gold["q_init"])} if entry == "warm"
          else {"diff_scf_iters": 3})
    coords = frag.coords.clone().requires_grad_(True)
    e, aux = single_point_energy(coords, frag, settings, None, **kw)
    (g,) = torch.autograd.grad(e.sum(), coords)
    assert max_abs_diff(e, gold[entry]["energies"]) <= 1e-9
    assert max_abs_diff(g, gold[entry]["gradients"]) <= 1e-9
    assert max_abs_diff(aux["shell_charges"], gold[entry]["state"]) <= 1e-9
    if entry == "warm":
        # the residual reported is the last refine step's
        np.testing.assert_allclose(to_np(aux["scf_residual"]),
                                   gold[entry]["scf_residual"], atol=1e-12)
        with torch.no_grad():
            e_ng, _ = single_point_energy(frag.coords, frag, settings, None,
                                          **kw)
        assert max_abs_diff(e_ng, gold[entry]["energies"]) <= 1e-9
    else:
        # the refined state carries a derivative; the plain entry's does not
        assert aux["shell_charges"].requires_grad


# ---------------------------------------------------------------------------
# the JAX package's own GFN2 pins, through the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixtures():
    with open(FIXTURES) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def pin_calc():
    return XtbCalculator(
        tsp("gfn2", multipoles=True, max_scf_iter=256, scf_tol=1e-11),
        variant="gfn2", device="cpu")


def _observables(calc, case):
    z = np.array(case["numbers"])
    c = np.array(case["coords_angstrom"]) * ANGSTROM_TO_BOHR
    e, aux = calc.energies(calc.make_batch([(z, c, 0, 1)]))
    n = len(z)
    return (float(e[0]), to_np(aux["charges"])[0][:n],
            to_np(aux["dipole"])[0], float(aux["scf_residual"][0]))


@pytest.mark.parametrize(
    "name", ["nh3", "ch4", "w2_donor", "w2_acceptor", "w2_dimer"])
def test_gfn2_fixture_observables(pin_calc, fixtures, name):
    case = fixtures[name]
    e, q, mu, resid = _observables(pin_calc, case)
    assert resid < 1e-9
    assert e == pytest.approx(case["energy_ha"], abs=1e-9)
    np.testing.assert_allclose(q, case["charges"], atol=1e-8)
    np.testing.assert_allclose(mu, case["dipole_au"], atol=1e-8)


def test_gfn2_w2_interaction_energy(pin_calc, fixtures):
    parts = {name: _observables(pin_calc, fixtures[name])[0]
             for name in ("w2_donor", "w2_acceptor", "w2_dimer")}
    ie = parts["w2_dimer"] - parts["w2_donor"] - parts["w2_acceptor"]
    assert ie == pytest.approx(
        fixtures["_meta"]["w2_interaction_energy_ha"], abs=1e-9)
    assert -0.020 < ie < -0.003


WATER_A = np.array(
    [[0.0, 0.0, 0.0], [0.0, 0.0, 0.9572], [0.9239, 0.0, -0.2399]])


def test_gfn2_size_consistency():
    calc = XtbCalculator(tsp("gfn2", multipoles=True), variant="gfn2",
                         device="cpu")
    z = np.array([8, 1, 1])
    c1 = WATER_A * ANGSTROM_TO_BOHR
    e1, _ = calc.energies(calc.make_batch([(z, c1, 0, 1)]))
    c2 = c1 + np.array([1000.0, 0.0, 0.0])
    e2, aux = calc.energies(calc.make_batch(
        [(np.concatenate([z, z]), np.vstack([c1, c2]), 0, 1)]))
    assert float(aux["scf_residual"][0]) < 1e-8
    assert float(e2[0]) == pytest.approx(2.0 * float(e1[0]), abs=5e-9)


def test_gfn2_rotational_invariance_and_covariance():
    calc = XtbCalculator(tsp("gfn2", multipoles=True), variant="gfn2",
                         device="cpu")
    z = np.array([8, 1, 1])
    c = WATER_A * ANGSTROM_TO_BOHR
    a, b = 0.7, 1.1
    rz = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array(
        [[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    R = rx @ rz
    e, g, aux = calc.gradients(
        calc.make_batch([(z, c, 0, 1), (z, c @ R.T, 0, 1)]))
    assert float(e[1]) == pytest.approx(float(e[0]), abs=1e-9)
    np.testing.assert_allclose(to_np(g[1]), to_np(g[0]) @ R.T, atol=1e-8)
    d = to_np(aux["dipole"])
    np.testing.assert_allclose(d[1], R @ d[0], atol=1e-8)
    assert 0.3 < np.linalg.norm(d[0]) < 1.5


# ---------------------------------------------------------------------------
# the slice as a whole: frozen JAX results
# ---------------------------------------------------------------------------


def test_bench_dimers_match_golden(golden):
    gd = golden["bench_dimers"]
    calc = XtbCalculator(tsp("gfn2", max_scf_iter=gd["max_scf_iter"]),
                         variant="gfn2", device="cpu")
    e, g, aux = calc.gradients(calc.make_batch(bench_dimers(gd["n"])))
    assert max_abs_diff(e, gd["energies"]) <= 1e-9
    assert max_abs_diff(g, gd["gradients"]) <= 1e-8
    assert max_abs_diff(aux["shell_charges"], gd["state"]) <= 1e-8
    assert max_abs_diff(aux["dipole"], gd["dipole"]) <= 1e-8
    for key in ("e_el", "e_rep"):
        assert max_abs_diff(aux[key], gd[key]) <= 1e-9


def test_w20_mbe2_matches_golden(golden):
    gd = golden["w20_mbe2"]
    calc = XtbCalculator(tsp("gfn2", max_scf_iter=gd["max_scf_iter"]),
                         variant="gfn2", device="cpu")
    e, g, aux = FragmentExecutor(calc).run(w20_mbe2_fragments(),
                                           what="gradient")
    total, gnorm = w20_mbe2_assemble(e, g)
    assert abs(total - gd["total"]) <= 1e-8
    assert max_abs_diff(e, gd["energies"]) <= 1e-9
    # the dimers are exact translates of one water (ROADMAP C5)
    assert abs(gnorm - gd["gradient_norm"]) <= 1e-6


def test_w20_mbe2_alpb_fragments_match_golden(golden):
    """Three monomers and three dimers of the list with ALPB water (the
    whole list runs on the card, chip_smoke.py)."""
    gd = golden["w20_mbe2_alpb"]
    idx = [0, 7, 19, 20, 21, 120]
    frags = w20_mbe2_fragments()
    calc = XtbCalculator(
        tsp("gfn2", max_scf_iter=gd["max_scf_iter"]), variant="gfn2",
        device="cpu", solvation=BornSolvation(gd["dielectric"], alpb=True))
    e, _ = FragmentExecutor(calc).run([frags[i] for i in idx], what="energy")
    assert max_abs_diff(e, [gd["energies"][i] for i in idx]) <= 1e-9


def test_w1_vib_therm_matches_golden(golden):
    gold = golden["driver"]["w1_vib_therm"]
    obs = observables(_quiet_run(
        read_mqc_file(os.path.join(REPO, gold["mqc"])), device="cpu"))
    assert golden_failures(obs, gold) == []
    assert abs(obs["energy"] - gold["total_energy"]) <= 1e-9
    assert abs(obs["hessian_frobenius_norm"]
               - gold["hessian_frobenius_norm"]) <= 1e-5
    assert abs(obs["zpe"] - gold["zpe"]) <= 1e-8
    assert abs(obs["gibbs_correction"] - gold["gibbs_correction"]) <= 1e-8


def test_prism_gfn2_driver_matches_golden(golden):
    gold = golden["driver"]["prism_mbe"]
    cfg = read_mqc_file(os.path.join(REPO, gold["mqc"]))
    out = _quiet_run(cfg, device="cpu")
    assert abs(out[""].result.total_energy - gold["total_energy"]) <= 1e-8
    g1 = json.load(open(os.path.join(
        REPO, "tests", "data", "port_golden_gfn1.json")))
    assert abs(gold["total_energy"]
               - g1["driver"]["prism_mbe"]["total_energy"]) > 1e-3


# ---------------------------------------------------------------------------
# factory, executor, placeholder methods
# ---------------------------------------------------------------------------


def test_factory_builds_gfn2(golden):
    path = os.path.join(REPO, golden["driver"]["w1_vib_therm"]["mqc"])
    drv = config_to_driver(read_mqc_file(path))
    assert drv.method.method_type == MethodType.GFN2
    calc = create_calculator(drv, device="cpu")
    assert calc.variant == "gfn2" and calc.settings.multipoles
    assert calc.settings.max_scf_iter == 256
    assert calc.settings.scf_tol == pytest.approx(1e-7)
    assert calc.dtype == torch.float64
    drv.method.xtb.solvent = "water"
    drv.method.xtb.solvation_model = "alpb"
    solvated = create_calculator(drv, device="cpu")
    assert solvated.solvation.alpb and solvated.solvation.variant == "gfn2"


def test_gfn2_entry_points_ask_for_cuda(golden, monkeypatch):
    from metalquicha_tpu_torch.__main__ import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(REPO, golden["driver"]["w1_vib_therm"]["mqc"])
    for entry in (lambda: XtbCalculator(variant="gfn2"),
                  lambda: create_calculator(
                      config_to_driver(read_mqc_file(path))),
                  lambda: cli_main([path])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


def test_chunk_cap_counts_the_moment_tables():
    frags = [(i, t) for i, t in enumerate(w20_mbe2_fragments()[20:24])]
    g1 = FragmentExecutor(XtbCalculator(device="cpu"))
    g2 = FragmentExecutor(XtbCalculator(variant="gfn2", device="cpu"))
    pad_to = g1._pad_shapes_for(6, frags)
    assert pad_to == g2._pad_shapes_for(6, frags) == (6, 12, 16)
    # GFN1 chunking is what it was: 2e8 / nao^2
    assert g1._max_chunk(pad_to) == int(2.0e8 // 256)
    assert not g1._multipoles() and g2._multipoles()
    from metalquicha_tpu_torch.methods.xtb.batch import _sizes_for

    nprim = _sizes_for([np.array([8, 1, 1])], "gfn2")[3]
    assert nprim >= 3
    assert tmp_.work_elements(16, nprim) == 9 * 256 * nprim * nprim
    assert g2._max_chunk(pad_to, nprim) == int(
        2.0e8 // (256 + 9 * 256 * nprim * nprim))
    # `run` passes a GFN2 bucket's primitive axis on
    seen = []
    g2._max_chunk = lambda pad_to, nprim=0: seen.append(nprim) or 2
    g2.run([t for _, t in frags], what="energy")
    assert seen == [nprim]


@pytest.mark.parametrize("method", ["hf", "dft", "mcscf"])
def test_placeholder_methods_through_the_driver(method):
    """HF, DFT and MCSCF inputs give the JAX driver's dummy values."""
    from metalquicha_tpu.driver import run_calculation as jax_run
    from metalquicha_tpu.io.adapter import config_to_driver as jax_to_driver
    from metalquicha_tpu.io.config import read_mqc_file as jax_read
    from metalquicha_tpu.methods.factory import (
        create_calculator as jax_create,
    )
    from metalquicha_tpu.parallel.executor import (
        FragmentExecutor as JaxExecutor,
    )
    from metalquicha_tpu.parallel.mesh import fragment_mesh

    path = os.path.join(REPO, "tests", "data", "port_prism.mqc")
    cfg, jcfg = read_mqc_file(path), jax_read(path)
    for c in (cfg, jcfg):
        c.method = method
    ex = make_executor(cfg)  # the placeholders take no device
    assert ex.calc.variant == method
    out = _quiet_run(cfg)[""].result
    # one device: the JAX executor cannot shard a placeholder's batch
    jex = JaxExecutor(jax_create(jax_to_driver(jcfg)),
                      mesh=fragment_mesh(devices=jax.devices()[:1]))
    ref = jax_run(jcfg, write_json=False, executor=jex)[""].result
    assert out.total_energy == ref.total_energy
    assert out.total_energy != 0.0
