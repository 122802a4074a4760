"""The port's implicit solvation (ALPB, GBSA, CPCM) against the JAX package.

One water and one water dimer, padded to 8 atoms so that the masks are
exercised, go through both packages in float64 on the CPU; the port's
tensors are the JAX package's padded batch (`port_from_jax`), so each
comparison isolates the function under test. Tolerances:
- Born radii, electrostatic size, `gamma_atoms`, `surface_energy`: 1e-12
  (the same formulas in the same order; CPCM goes through an LU solve of a
  330 x 330 system in two libraries);
- solvated energies 1e-10 Ha, ALPB/GBSA gradients 1e-9 Ha/Bohr (as the
  unsolvated slice, tests/test_torch_slice.py);
- the CPCM gradient: finite, and within 5e-8 Ha/Bohr of central
  differences of the port's own energy. The JAX package's CPCM gradient is
  NaN (the derivative of the norm of a zero vector on the diagonal of its
  point-point distance matrix), which is asserted here so that the test
  says when the reference is repaired.
CPCM runs with 50 angular points here to keep the solves small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import WATER, max_abs_diff, port_from_jax

from metalquicha_tpu.methods.xtb.calculator import XtbCalculator as JaxCalc
from metalquicha_tpu.methods.xtb.solvation.born import BornSolvation as JaxBorn
from metalquicha_tpu.methods.xtb.solvation.cpcm import CpcmSolvation as JaxCpcm
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.methods.xtb.solvation import (
    dielectric_for,
    make_solvation_model,
)
from metalquicha_tpu_torch.methods.xtb.solvation.born import (
    GSHIFT_DEFAULT,
    BornSolvation,
)
from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import CpcmSolvation
from metalquicha_tpu_torch.parallel.executor import (
    MAX_CHUNK_ELEMENTS,
    FragmentExecutor,
)

torch.set_num_threads(1)
EPS = 78.4
DIMER = (
    np.concatenate([WATER[0], WATER[0]]),
    np.vstack([WATER[1], WATER[1] @ np.array([[0.0, 1.0, 0.0],
                                               [-1.0, 0.0, 0.0],
                                               [0.0, 0.0, 1.0]])
               + np.array([5.2, 0.3, 0.4])]),
    0,
    1,
)
FRAGMENTS = [WATER, DIMER]
PAD_TO = (8, 16, 21)
MODELS = {
    "alpb": (JaxBorn(EPS, alpb=True), BornSolvation(EPS, alpb=True)),
    "gbsa": (JaxBorn(EPS, alpb=False), BornSolvation(EPS, alpb=False)),
    "cpcm": (JaxCpcm(EPS, nang=50), CpcmSolvation(EPS, nang=50)),
}


@pytest.fixture(scope="module", params=list(MODELS))
def both(request):
    """(name, JAX model, JAX batch, JAX (e, g), port model, port batch)."""
    jm, tm = MODELS[request.param]
    calc = JaxCalc(variant="gfn1", solvation=jm, dtype=jnp.float64)
    jf = calc.make_batch(FRAGMENTS, pad_to=PAD_TO)
    e, g, _ = calc.gradients(jf)
    return request.param, jm, jf, (np.asarray(e), np.asarray(g)), tm, \
        port_from_jax(jf)


def test_make_batch_fills_the_solvation_tables(both):
    _, _, jf, _, tm, tf = both
    own = XtbCalculator(device="cpu", solvation=tm).make_batch(
        FRAGMENTS, pad_to=PAD_TO)
    for name in ("solv_rvdw", "solv_sx", "solv_tension", "solv_scalars"):
        assert torch.equal(getattr(own, name), getattr(tf, name)), name
    assert float(own.solv_rvdw[0, :3].min()) > 0.0
    assert float(own.solv_rvdw[0, 3:].abs().max()) == 0.0  # padded atoms


def test_gamma_atoms_matches_jax(both):
    _, jm, jf, _, tm, tf = both
    ref = jax.vmap(lambda f: jm.gamma_atoms(
        f.coords, f.solv_rvdw, f.solv_sx, f.atom_mask,
        scalars=f.solv_scalars))(jf)
    got = tm.gamma_atoms(tf.coords, tf.solv_rvdw, tf.solv_sx, tf.atom_mask,
                         scalars=tf.solv_scalars)
    assert got.shape == (2, 8, 8)
    assert max_abs_diff(got, ref) <= 1e-12
    assert float(got[0, 3:].abs().max()) == 0.0  # padded rows are masked
    # and with the module constants in place of the per-fragment scalars
    ref0 = jm.gamma_atoms(jf.coords[1], jf.solv_rvdw[1], jf.solv_sx[1],
                          jf.atom_mask[1])
    got0 = tm.gamma_atoms(tf.coords, tf.solv_rvdw, tf.solv_sx, tf.atom_mask)
    assert max_abs_diff(got0[1], ref0) <= 1e-12


def test_born_radii_size_and_surface_energy_match_jax(both):
    name, jm, jf, _, tm, tf = both
    if name == "cpcm":
        assert not hasattr(tm, "surface_energy")
        return
    radii = jax.vmap(lambda f: jm.born_radii(
        f.coords, f.solv_rvdw, f.solv_sx, f.atom_mask, f.solv_scalars[0]))(jf)
    got = tm.born_radii(tf.coords, tf.solv_rvdw, tf.solv_sx, tf.atom_mask,
                        tf.solv_scalars[:, 0])
    assert max_abs_diff(got, radii) <= 1e-12
    assert float((got[0, 3:] - 1.0).abs().max()) == 0.0  # padded atoms: 1
    size = jax.vmap(lambda f: jm.electrostatic_size(
        f.coords, f.solv_rvdw, f.atom_mask))(jf)
    assert max_abs_diff(
        tm.electrostatic_size(tf.coords, tf.solv_rvdw, tf.atom_mask), size
    ) <= 1e-12
    surf = jax.vmap(lambda f: jm.surface_energy(f.coords, f))(jf)
    assert max_abs_diff(tm.surface_energy(tf.coords, tf), surf) <= 1e-12


def test_solvated_energy_and_gradient_match_jax(both):
    name, _, _, (e_j, g_j), tm, tf = both
    calc = XtbCalculator(device="cpu", solvation=tm)
    e, g, aux = calc.gradients(tf)
    e_only, _ = calc.energies(tf)
    assert float(aux["scf_residual"].max()) < 1e-10
    assert max_abs_diff(e, e_j) <= 1e-10
    assert max_abs_diff(e_only, e_j) <= 1e-10
    assert bool(torch.isfinite(g).all())
    if name == "cpcm":
        # drop this assertion when the reference's gradient is repaired
        assert np.isnan(g_j).all()
    else:
        assert max_abs_diff(g, g_j) <= 1e-9
    # the Jacobi in-loop route reaches the same fixed point
    fast = XtbCalculator(settings_from_params("gfn1", use_pallas_eigh=True),
                         device="cpu", solvation=tm)
    e_f, _ = fast.energies(tf)
    assert max_abs_diff(e_f, e_j) <= 1e-10


def test_cpcm_gradient_matches_central_differences():
    calc = XtbCalculator(device="cpu", solvation=CpcmSolvation(EPS, nang=50))
    numbers, coords, charge, mult = WATER
    _, g, _ = calc.gradients(calc.make_batch([WATER]))
    assert bool(torch.isfinite(g).all())
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


def test_cds_and_shift_flags_change_energy():
    """The four identities of the JAX package's own test of the flags
    (tests/test_xtb_engine.py): defaults ON, the shift adds GSHIFT exactly,
    CDS is additive and not small for a water-sized cavity."""

    def energy(**kw):
        calc = XtbCalculator(device="cpu", solvation=BornSolvation(
            dielectric=80.2, alpb=True, **kw))
        e, _ = calc.energies(calc.make_batch([WATER]))
        return float(e[0])

    e00 = energy(use_cds=False, use_shift=False)
    e10 = energy(use_cds=True, use_shift=False)
    e01 = energy(use_cds=False, use_shift=True)
    e11 = energy(use_cds=True, use_shift=True)
    assert energy() == e11
    assert abs((e01 - e00) - GSHIFT_DEFAULT) <= 1e-12
    assert abs(e10 - e00) > 1e-4
    assert abs((e11 - e10) - (e01 - e00)) <= 1e-12


def test_make_solvation_model_and_dielectrics():
    from metalquicha_tpu_torch.io.adapter import XtbConfig

    assert dielectric_for("Water") == 78.4
    assert dielectric_for("water", 12.5) == 12.5
    with pytest.raises(ValueError, match="unknown solvent"):
        dielectric_for("brine")
    alpb = make_solvation_model(XtbConfig(solvent="dmso"), "gfn1")
    assert (alpb.kind, alpb.alpb, alpb.dielectric) == ("born", True, 46.7)
    gbsa = make_solvation_model(
        XtbConfig(solvent="water", solvation_model="GBSA", use_cds=False),
        "gfn1")
    assert (gbsa.alpb, gbsa.use_cds, gbsa.use_shift) == (False, False, True)
    cpcm = make_solvation_model(
        XtbConfig(solvent="water", solvation_model="cpcm", cpcm_nang=194,
                  cpcm_rscale=1.1), "gfn1")
    assert (cpcm.kind, cpcm.nang, cpcm.rscale) == ("cpcm", 194, 1.1)


def test_chunk_cap_counts_the_solvation_intermediates():
    """Unsolvated chunking is unchanged; a solvated calculator adds its
    largest per-fragment intermediate to nao^2."""
    pad_to = (24, 48, 61)
    plain = FragmentExecutor(XtbCalculator(device="cpu"))
    assert plain._max_chunk(pad_to) == int(MAX_CHUNK_ELEMENTS // 61**2)
    cpcm = FragmentExecutor(XtbCalculator(
        device="cpu", solvation=CpcmSolvation(EPS, nang=110)))
    assert cpcm._max_chunk(pad_to) == int(
        MAX_CHUNK_ELEMENTS // (61**2 + (24 * 110) ** 2))
    alpb = FragmentExecutor(XtbCalculator(
        device="cpu", solvation=BornSolvation(EPS)))
    assert alpb._max_chunk(pad_to) == int(
        MAX_CHUNK_ELEMENTS // (61**2 + 24 * 24 * 50))
    # a chunk is never empty, however large one fragment is
    assert cpcm._max_chunk((96, 192, 241)) == 1
    e_one, _ = alpb.run(FRAGMENTS)
    alpb._max_chunk = lambda pad_to: 1
    e_chunked, _ = alpb.run(FRAGMENTS)
    assert np.array_equal(e_one, e_chunked)
