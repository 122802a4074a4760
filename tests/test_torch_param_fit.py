"""The port's differentiable parameterization against the JAX package's.

`theta_init` and every field of `FragmentSpec.rebuild(theta_init)` equal
the JAX package's (1e-12) for GFN1 and GFN2, frozen by
tools/gen_port_golden.py in tests/data/port_golden_polish_fit.json;
dE/dtheta of a water against one live `jax.grad` (1e-9) and against the
frozen one in both variants; the mixed derivative d/dtheta |grad_R E|^2
through three recorded refine steps (it differentiates `eigh_safe`'s
backward pass once more) against the frozen JAX value (1e-8) and a central
difference; `theta_to_tables` round trip with every table it touches
restored, the D3 pair overrides included; `theta_from_overlay`; and
`settings_from_params` under MQC_FORM_VARIANT equal to the JAX package's,
warning included. Everything runs on the CPU.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from _torch_port_common import REPO, WATER, restore_jax_overlay

from metalquicha_tpu_torch.methods.xtb import (
    batch,
    dispersion_d3,
    params_gfn1,
    params_gfn2,
)
from metalquicha_tpu_torch.methods.xtb.basis import (
    orthogonalize_against,
    slater_to_gauss,
)
from metalquicha_tpu_torch.methods.xtb.calculator import (
    XtbCalculator,
    single_point_energy,
)
from metalquicha_tpu_torch.methods.xtb.engine import (
    eigh_safe,
    settings_from_params,
)
from metalquicha_tpu_torch.methods.xtb.param_fit import (
    FITTED_Z,
    FragmentSpec,
    _cgto_from_zeta,
    _element_shell_tables,
    _ortho,
    theta_from_overlay,
    theta_init,
    theta_leaves,
    theta_map,
    theta_to_tables,
)

torch.set_num_threads(1)

with open(os.path.join(REPO, "tests", "data",
                       "port_golden_polish_fit.json")) as _fh:
    GOLDEN = json.load(_fh)["fit"]

FIT_NUMBERS = np.array([8, 1, 1, 6, 7, 1])
FIT_COORDS = np.array([[0.0, 0.0, 0.2], [0.0, 1.4, -0.9], [0.0, -1.4, -0.9],
                       [4.0, 0.0, 0.0], [6.5, 0.5, 0.0], [8.2, 0.0, 0.5]])
FIT_WATER = np.array([[0.0, 0.0, 0.2], [0.0, 1.4, -0.9], [0.0, -1.4, -0.9]])
VARIANTS = ["gfn1", "gfn2"]


def _golden_theta(tree):
    """A frozen theta (string keys, lists) in the port's layout."""
    out = {k: np.asarray(v) for k, v in tree.items() if k != "elements"}
    out["elements"] = {int(z): {k: np.asarray(v) for k, v in el.items()}
                       for z, el in tree["elements"].items()}
    return out


def _max_diff(theta, gold):
    worst = 0.0
    for k, v in theta.items():
        if isinstance(v, dict):
            worst = max(worst, _max_diff(v, gold[k]))
        else:
            assert tuple(v.shape) == np.shape(gold[k]), k
            worst = max(worst, float(np.abs(v.detach().numpy()
                                            - gold[k]).max()))
    return worst


def _leafy(variant):
    return theta_map(lambda t: t.clone().requires_grad_(True),
                     theta_init(variant, "cpu"))


def _water_spec(variant):
    return FragmentSpec(np.array([8, 1, 1]), FIT_WATER, 0, 1,
                        variant=variant, device="cpu")


def _energy(spec, theta, settings, coords=None, diff_scf_iters=0):
    frag = spec.rebuild(theta, coords)
    return single_point_energy(frag.coords, frag, settings,
                               diff_scf_iters=diff_scf_iters)[0]


def _grad_tree(value, theta):
    """d value / d theta in theta's layout; zeros for a leaf the value
    does not depend on (an element the fragment lacks), as `jax.grad`."""
    leaves = theta_leaves(theta)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    lookup = {id(t): torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads)}
    return theta_map(lambda t: lookup[id(t)], theta)


@pytest.mark.parametrize("variant", VARIANTS)
def test_theta_init_matches_jax(variant):
    theta = theta_init(variant, "cpu")
    gold = _golden_theta(GOLDEN[variant]["theta_init"])
    assert set(theta) == set(gold) == {"elements", "d3_pairs", "kpair",
                                       "globals"}
    assert set(theta["elements"]) == set(FITTED_Z)
    assert all(t.dtype == torch.float64 and t.device.type == "cpu"
               for t in theta_leaves(theta))
    assert _max_diff(theta, gold) <= 1e-12
    assert len(theta_leaves(theta)) == 4 * 15 + 3


def test_theta_init_asks_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        theta_init("gfn1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FragmentSpec(np.array([8, 1, 1]), FIT_WATER, 0, 1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_rebuild_matches_jax_and_the_host_batch(variant):
    """Every field of rebuild(theta_init): the JAX package's (frozen) and
    the port's own host batch's, and the energy of either."""
    spec = FragmentSpec(FIT_NUMBERS, FIT_COORDS, 0, 1, variant=variant,
                        device="cpu")
    frag = spec.rebuild(theta_init(variant, "cpu"))
    gold = GOLDEN[variant]["rebuild"]
    assert set(gold) == set(frag._fields)
    for name in frag._fields:
        got = getattr(frag, name)
        ref = np.asarray(gold[name])
        assert got.shape == (1, *ref.shape), name
        assert float(np.abs(got[0].numpy() - ref).max()) <= 1e-12, name
        base = getattr(spec.base, name)
        assert got.shape == base.shape and got.dtype == base.dtype, name
        assert float((got - base).abs().max()) <= 1e-12, name
    s = settings_from_params(variant)
    with torch.no_grad():
        e1, _ = single_point_energy(spec.base.coords, spec.base, s)
        e2, _ = single_point_energy(frag.coords, frag, s)
    # the fragment is a structure test, not a molecule: its GFN2 SCC does
    # not settle in 32 iterations and amplifies the last bit of the tables
    tol = 1e-12 if variant == "gfn1" else 1e-10
    assert abs(float(e1) - float(e2)) <= tol * max(1.0, abs(float(e1)))


def test_basis_rebuild_matches_the_host_basis():
    """`_cgto_from_zeta` and `_ortho` against basis.py's NumPy versions
    (H's 1s and its orthogonalized 2s), and the table rows they fill."""
    rec = params_gfn1.get_element(1)
    zeta = torch.tensor(rec.slater, dtype=torch.float64)
    a1, c1 = _cgto_from_zeta(rec.ngauss[0], 1, 0, zeta[0])
    a2, c2 = _cgto_from_zeta(rec.ngauss[1], 2, 0, zeta[1])
    ra1, rc1 = slater_to_gauss(rec.ngauss[0], 1, 0, rec.slater[0])
    ra2, rc2 = slater_to_gauss(rec.ngauss[1], 2, 0, rec.slater[1])
    assert np.abs(a1.numpy() - ra1).max() <= 1e-12
    assert np.abs(c1.numpy() - rc1).max() <= 1e-12
    ao, co = _ortho(a1, c1, a2, c2, 0)
    rao, rco = orthogonalize_against(ra1, rc1, ra2, rc2, 0)
    assert np.abs(ao.numpy() - rao).max() <= 1e-12
    assert np.abs(co.numpy() - rco).max() <= 1e-12
    tabs = _element_shell_tables(theta_init("gfn1", "cpu"), "gfn1",
                                 nprim=len(rao), needed_z={1})
    assert tabs["prim_alpha"].shape == (8, len(rao))
    assert np.abs(tabs["prim_alpha"][1].numpy() - rao).max() <= 1e-12
    assert float(tabs["level"][2]) == 100.0  # carbon is not needed


def test_energy_gradient_in_theta_matches_live_jax():
    """dE/dtheta of a water, every leaf, against `jax.grad` (GFN1)."""
    import jax

    from metalquicha_tpu.methods.xtb.calculator import (
        single_point_energy as jax_spe,
    )
    from metalquicha_tpu.methods.xtb.engine import (
        settings_from_params as jax_settings,
    )
    from metalquicha_tpu.methods.xtb.param_fit import (
        FragmentSpec as JaxSpec,
        theta_init as jax_theta_init,
    )

    restore_jax_overlay()
    jspec = JaxSpec(np.array([8, 1, 1]), FIT_WATER, 0, 1)
    js = jax_settings("gfn1")

    def e_of(th):
        fr = jspec.rebuild(th)
        return jax_spe(fr.coords, fr, js)[0]

    e_j, g_j = jax.value_and_grad(e_of)(jax_theta_init("gfn1"))

    theta = _leafy("gfn1")
    e = _energy(_water_spec("gfn1"), theta, settings_from_params("gfn1"))
    assert abs(float(e.detach()) - float(e_j)) <= 1e-10
    grad = _grad_tree(e.sum(), theta)
    gold = {k: np.asarray(v) for k, v in g_j.items() if k != "elements"}
    gold["elements"] = {z: {k: np.asarray(v) for k, v in el.items()}
                        for z, el in g_j["elements"].items()}
    assert _max_diff(grad, gold) <= 1e-9


@pytest.mark.parametrize("variant", VARIANTS)
def test_energy_gradient_in_theta_matches_golden(variant):
    gold = GOLDEN[variant]["water"]
    theta = _leafy(variant)
    spec = _water_spec(variant)
    settings = settings_from_params(variant)
    e = _energy(spec, theta, settings)
    assert abs(float(e.detach()) - gold["energy"]) <= 1e-10
    grad = _grad_tree(e.sum(), theta)
    assert _max_diff(grad, _golden_theta(gold["grad"])) <= 1e-9
    if variant == "gfn1":
        # d(E)/d(levels) for water ~ occupation numbers (band-dominated),
        # and a central difference on one level
        g_o = grad["elements"][8]["levels"].numpy()
        assert ((g_o > 0.5 * params_gfn1.EV2AU)
                & (g_o < 8.0 * params_gfn1.EV2AU)).all()
        h = 1e-4

        def shifted(d):
            th = theta_init("gfn1", "cpu")
            th["elements"][8]["levels"][0] += d
            with torch.no_grad():
                return float(_energy(spec, th, settings))

        fd = (shifted(h) - shifted(-h)) / (2 * h)
        assert fd == pytest.approx(float(g_o[0]), rel=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_force_loss_gradient_in_theta_matches_golden(variant):
    """d/dtheta of sum |grad_R E|^2 over two jittered waters with three
    recorded refine steps: a second derivative through `eigh_safe`."""
    gold = GOLDEN[variant]["force_loss"]
    coords = torch.tensor(gold["coords"], dtype=torch.float64)
    spec = _water_spec(variant)
    settings = settings_from_params(variant)

    def loss(theta, create_graph):
        c = coords.clone().requires_grad_(True)
        e = _energy(spec, theta, settings, c, gold["diff_scf_iters"])
        (g,) = torch.autograd.grad(e.sum(), c, create_graph=create_graph)
        return (g**2).sum()

    theta = _leafy(variant)
    val = loss(theta, True)
    assert abs(float(val.detach()) - gold["value"]) <= 1e-9
    grad = _grad_tree(val, theta)
    assert _max_diff(grad, _golden_theta(gold["grad"])) <= 1e-8
    if variant == "gfn1":
        h = 1e-4

        def shifted(d):
            th = theta_init("gfn1", "cpu")
            th["elements"][8]["slater"][1] += d
            return float(loss(th, False))

        fd = (shifted(h) - shifted(-h)) / (2 * h)
        # the three recorded damped steps carry the state's response to
        # theta only in part, the central difference all of it
        assert fd == pytest.approx(
            float(grad["elements"][8]["slater"][1]), rel=1e-3)


def test_eigh_safe_is_twice_differentiable():
    """A gradient taken through `eigh_safe` with create_graph=True can be
    differentiated again: against torch.linalg.eigh's own double backward
    on a matrix with well separated eigenvalues."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 6, 6))
    a0 = torch.tensor(x + x.transpose(0, 2, 1)
                      + np.diag(np.arange(6.0) * 3.0))
    occ = torch.tensor([1.0, 1.0, 0.7, 0.0, 0.0, 0.0], dtype=torch.float64)
    probe = torch.tensor(rng.normal(size=(6, 6)))

    def mixed(eigh):
        a = a0.clone().requires_grad_(True)
        w, v = eigh(a)
        # eigenvalues and a density-like function of the eigenvectors
        f = (occ * w).sum() + ((v * occ) @ v.mT * probe).sum()
        (g,) = torch.autograd.grad(f, a, create_graph=True)
        (h,) = torch.autograd.grad((g**2).sum(), a)
        return g.detach(), h

    g_s, h_s = mixed(eigh_safe)
    g_t, h_t = mixed(lambda a: torch.linalg.eigh(a))
    assert float((g_s - g_t).abs().max()) <= 1e-11
    assert float((h_s - h_t).abs().max()) <= 1e-9
    assert float(h_s.abs().max()) > 1e-3


def test_rebuild_broadcasts_over_a_coordinate_batch():
    """rebuild(theta, coords): leading axis B, every other field a view,
    energies equal to one geometry at a time; padded atoms keep their
    parking positions."""
    rng = np.random.default_rng(11)
    coords = torch.tensor(FIT_WATER[None] + rng.normal(0, 0.03, (3, 3, 3)))
    spec = FragmentSpec(np.array([8, 1, 1]), FIT_WATER, 0, 1, device="cpu",
                        pad_to=(4, 8, 11))
    theta = theta_init("gfn1", "cpu")
    frag = spec.rebuild(theta, coords)
    assert frag.coords.shape == (3, 4, 3)
    assert torch.equal(frag.coords[:, :3], coords)
    assert torch.equal(frag.coords[1, 3], spec.base.coords[0, 3])
    assert all(x.shape[0] == 3 for x in frag)
    assert frag.d3_c6_pair.stride(0) == 0 and frag.sh_level.stride(0) == 0
    settings = settings_from_params("gfn1")
    with torch.no_grad():
        e_b, _ = single_point_energy(frag.coords, frag, settings)
        for b in range(3):
            one = spec.rebuild(theta, coords[b : b + 1])
            e_1, _ = single_point_energy(one.coords, one, settings)
            assert abs(float(e_b[b]) - float(e_1[0])) <= 1e-11


class _Tables:
    """Snapshot of every table `theta_to_tables` writes (the parameter
    modules' records, radii and globals; the shared D3 r4r2 and pair
    overrides), restored on exit with the caches cleared."""

    def __enter__(self):
        self.state = [
            (m, copy.deepcopy(m.ELEMENTS), m.ATOMIC_RADII_A.copy(),
             m.COVALENT_RADII_A.copy(), copy.deepcopy(m.GLOBALS))
            for m in (params_gfn1, params_gfn2)
        ]
        self.r4r2 = dict(dispersion_d3.R4R2)
        self.pairs = {k: v.copy()
                      for k, v in dispersion_d3._PAIR_OVERRIDES.items()}
        return self

    def __exit__(self, *exc):
        for m, elements, rad, rcov, glob in self.state:
            m.ELEMENTS.clear()
            m.ELEMENTS.update(elements)
            m.ATOMIC_RADII_A[:] = rad
            m.COVALENT_RADII_A[:] = rcov
            m.GLOBALS.__dict__.update(glob.__dict__)
        dispersion_d3.R4R2.clear()
        dispersion_d3.R4R2.update(self.r4r2)
        dispersion_d3._PAIR_OVERRIDES.clear()
        dispersion_d3._PAIR_OVERRIDES.update(self.pairs)
        dispersion_d3.invalidate_caches()
        batch.element_basis.cache_clear()


def _host_energy(variant, frag=WATER):
    calc = XtbCalculator(variant=variant, device="cpu")
    return float(calc.energies(calc.make_batch([frag]))[0][0])


@pytest.mark.parametrize("variant", VARIANTS)
def test_theta_to_tables_round_trip(variant):
    """A perturbed theta written into the port's tables gives the host
    batch the rebuilt fragment's energy; afterwards every table is back
    (the D3 pair overrides too) and the JAX package's tables never moved."""
    from metalquicha_tpu.methods.xtb import params_gfn1 as jax_params

    numbers, coords, *_ = WATER
    jax_level = jax_params.get_element(8).levels
    e_before = _host_energy(variant)
    e_dimer_before = _host_energy("gfn1", (FIT_NUMBERS, FIT_COORDS, 0, 1))
    theta = theta_init(variant, "cpu")
    theta["elements"][8]["levels"] = theta["elements"][8]["levels"] + 0.05
    theta["elements"][1]["rad"] = theta["elements"][1]["rad"] * 1.02
    theta["elements"][8]["en"] = theta["elements"][8]["en"] + 0.01
    theta["elements"][8]["r4r2"] = theta["elements"][8]["r4r2"] * 1.03
    theta["d3_pairs"] = theta["d3_pairs"] * 1.01
    theta["globals"] = theta["globals"].clone()
    theta["globals"][0] += 0.01
    settings = settings_from_params(variant)
    with torch.no_grad():
        e_theta = float(_energy(
            FragmentSpec(numbers, coords, 0, 1, variant=variant,
                         device="cpu"), theta, settings))
    assert abs(e_theta - e_before) > 1e-4
    with _Tables():
        theta_to_tables(theta, variant)
        # the form flags come from the same GLOBALS that were written
        calc = XtbCalculator(settings, variant=variant, device="cpu")
        e_prod = float(calc.energies(calc.make_batch([WATER]))[0][0])
        if variant == "gfn1":
            assert e_prod == pytest.approx(e_theta, abs=1e-11)
            assert (1, 8) in dispersion_d3._PAIR_OVERRIDES
        else:
            # a GFN2 theta leaves the shared (GFN1) dispersion state alone:
            # its r4r2 and pair grids are not written
            theta["elements"][8]["r4r2"] = theta_init(
                variant, "cpu")["elements"][8]["r4r2"]
            theta["d3_pairs"] = theta_init(variant, "cpu")["d3_pairs"]
            with torch.no_grad():
                e_theta = float(_energy(
                    FragmentSpec(numbers, coords, 0, 1, variant=variant,
                                 device="cpu"), theta, settings))
            assert e_prod == pytest.approx(e_theta, abs=1e-11)
        back = theta_init(variant, "cpu")
        assert float(back["elements"][8]["levels"][0]) == pytest.approx(
            float(theta["elements"][8]["levels"][0]), abs=1e-14)
        assert float(back["globals"][0]) == pytest.approx(
            float(theta["globals"][0]), abs=1e-14)
    assert _host_energy(variant) == e_before
    assert _host_energy("gfn1", (FIT_NUMBERS, FIT_COORDS, 0, 1)) == (
        e_dimer_before)
    assert jax_params.get_element(8).levels == jax_level


def test_theta_from_overlay_preserves_globals(tmp_path):
    """Warm-starting a fit from another fit's JSON keeps its globals, its
    elements, pair grids and kpair entries."""
    theta = theta_init("gfn1", "cpu")
    gvec = theta["globals"].numpy().copy() + 0.017
    out = {
        "elements": {
            str(z): {k: v.numpy().tolist() for k, v in el.items()}
            for z, el in theta["elements"].items()
        },
        "globals": {n: float(gvec[k])
                    for k, n in enumerate(batch.GLB_FIELDS)},
        "d3_pairs": (theta["d3_pairs"] * 1.5).numpy().tolist(),
        "kpair": {"1-8": 1.07},
    }
    out["elements"]["8"]["levels"] = [-20.0, -15.0]
    out["elements"]["8"]["d3_c6"] = [1.0]       # legacy field: skipped
    out["elements"]["9"] = {"levels": [0.0]}    # not a fitted element
    path = tmp_path / "fit_out.json"
    path.write_text(json.dumps(out))
    back = theta_from_overlay(str(path), "gfn1", "cpu")
    assert np.abs(back["globals"].numpy() - gvec).max() <= 1e-14
    assert back["elements"][8]["levels"].tolist() == [-20.0, -15.0]
    assert "d3_c6" not in back["elements"][8] and 9 not in back["elements"]
    assert torch.equal(back["d3_pairs"], theta["d3_pairs"] * 1.5)
    kp = back["kpair"].numpy()
    assert kp[0, 3] == kp[3, 0] == 1.07
    assert kp[1, 2] == float(theta["kpair"][1, 2])


@pytest.mark.parametrize("variant", VARIANTS)
def test_form_variant_override_matches_jax(variant, monkeypatch):
    """MQC_FORM_VARIANT overrides the functional form in both packages,
    after the caller's overrides, with the same warning."""
    from metalquicha_tpu.methods.xtb.engine import (
        settings_from_params as jax_settings,
    )

    restore_jax_overlay()
    form = {"kpol_mode": "avg_noen", "eta_average": "arithmetic",
            "cn_type": "gfn", "max_scf_iter": 7}
    monkeypatch.setenv("MQC_FORM_VARIANT", json.dumps(form))
    with pytest.warns(UserWarning) as rec_j:
        ref = jax_settings(variant, max_scf_iter=99, scf_tol=1e-5)
    with pytest.warns(UserWarning) as rec_t:
        got = settings_from_params(variant, max_scf_iter=99, scf_tol=1e-5)
    assert str(rec_t[0].message) == str(rec_j[0].message)
    assert "MQC_FORM_VARIANT active" in str(rec_t[0].message)
    assert got._asdict() == ref._asdict()
    assert got.kpol_mode == "avg_noen" and got.max_scf_iter == 7
    monkeypatch.delenv("MQC_FORM_VARIANT")
    assert settings_from_params(variant)._asdict() == (
        jax_settings(variant)._asdict())
