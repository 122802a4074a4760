"""The port's training programs against the JAX package's.

tools/fit_gfn1_torch.py, fit_gfn2_w1_torch.py, fit_solvation_torch.py and
h100_accuracy.py against their JAX originals (tools/fit_gfn1.py,
fit_gfn2_w1.py, fit_solvation.py, tpu_accuracy.py), from the shipped
overlay, on the CPU in float64:

- `fragments_and_weights` of every GFN1 target equals the JAX script's
  (host code: counts, weights, numbers, coordinates), live;
- the flat theta and `prior_weight_vector` equal `ravel_pytree` of the JAX
  theta and the JAX vector element by element, and `unravel` inverts the
  flattening;
- the value and the theta-gradient of `TargetEval` (h3o, prism MBE(2)),
  `GradNormTarget` (h3o) and `HessNormTarget` (h3o) equal the JAX
  script's, frozen by tools/gen_port_golden.py in
  tests/data/port_golden_fit_tools.json: values 1e-10 (the FD Hessian norm
  1e-9: it moves by 2e-10 between scf_tol 1e-10 and 1e-12 in the port
  alone), per-leaf gradients relative 1e-7 (energies) and 1e-6 (norms);
  the MBE Hessian norm of the prism (75 s here) runs under the `gpu`
  marker with the others, and its assembly is held to a loop here;
- one LM iteration over h3o and its gradient norm writes the JAX run's
  JSON (theta relative 1e-7), which reads back through
  `theta_from_overlay`;
- the w1 observables and the three solvation energies at two parameter
  vectors equal the JAX scripts' (energies 1e-10 Ha, |g| 1e-9, |H| 1e-7,
  frequencies 1e-3 cm^-1, ZPE and Gibbs 1e-9);
- `h100_accuracy.compare` equals `tpu_accuracy.compare`, the validation
  runner's `--polish off` reports raw float32, and every script asks for
  CUDA by default.

Nothing of the JAX package is imported at module level, so that the `gpu`
cases run on a machine that has none.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import fit_gfn1_torch as fit1  # noqa: E402
import fit_gfn2_w1_torch as fitw1  # noqa: E402
import fit_solvation_torch as fits  # noqa: E402
import h100_accuracy  # noqa: E402
import run_validation_torch  # noqa: E402

from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.param_fit import (  # noqa: E402
    theta_from_overlay,
    theta_init,
    theta_leaves,
)

torch.set_num_threads(1)

with open(os.path.join(REPO, "tests", "data",
                       "port_golden_fit_tools.json")) as _fh:
    GOLDEN = json.load(_fh)

#: targets whose frozen value and gradient run here; all of the frozen
#: ones run on the card
CPU_TARGETS = ("h3o", "prism_mbe", "h3o_gnorm", "h3o_hnorm")
ENERGY_CLASSES = ("TargetEval",)


def _settings():
    return settings_from_params("gfn1", max_scf_iter=256, scf_tol=1e-10)


def _jax_fit_gfn1():
    """tools/fit_gfn1.py, imported without enabling the JAX compilation
    cache for the whole worker."""
    from metalquicha_tpu import compile_cache

    enable = compile_cache.enable
    compile_cache.enable = lambda *a, **k: None
    try:
        import fit_gfn1
    finally:
        compile_cache.enable = enable
    return fit_gfn1


@pytest.mark.parametrize("name", list(fit1.GFN1_TARGETS)
                         + list(fit1.GAP_TARGETS))
def test_fragments_and_weights_match_jax(name):
    ref_frags, ref_w = _jax_fit_gfn1().fragments_and_weights(name)
    frags, w = fit1.fragments_and_weights(name)
    assert len(frags) == len(ref_frags)
    assert np.array_equal(w, ref_w)
    for f, r in zip(frags, ref_frags):
        assert np.array_equal(f.numbers, r.numbers)
        assert np.array_equal(f.coords, r.coords)
        assert (f.charge, f.multiplicity, f.n_real, f.n_caps) == (
            r.charge, r.multiplicity, r.n_real, r.n_caps)
        assert np.array_equal(fit1._global_rows(f), np.concatenate(
            [r.local_to_global, r.cap_replaces_atom]) if r.n_caps
            else r.local_to_global)


def test_flat_theta_and_prior_match_ravel_pytree():
    theta = theta_init("gfn1", "cpu")
    flat, unravel = fit1.ravel_theta(theta)
    assert np.array_equal(flat, GOLDEN["theta_flat"])
    assert np.array_equal(fit1.prior_weight_vector(theta),
                          GOLDEN["prior_weight_vector"])
    # unravel inverts the flattening, leaf by leaf, on theta's device
    x = np.random.default_rng(3).normal(size=flat.shape)
    back = unravel(x)
    assert np.array_equal(fit1.ravel_theta(back)[0], x)
    for a, b in zip(theta_leaves(back), theta_leaves(theta)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64
    # the order does not rest on str(Z) sorting like int(Z)
    assert list(unravel(flat)["elements"]) == [1, 6, 7, 8]


def _check_target(name, device):
    gold = GOLDEN["targets"][name]
    tgt = fit1.make_target(name, _settings(), "gfn1", device)
    assert type(tgt).__name__ == gold["class"]
    val, grad = tgt.value_and_grad(theta_init("gfn1", device))
    val_tol = 1e-9 if "hnorm" in name else 1e-10
    assert abs(val - gold["value"]) <= val_tol
    # the value alone (the final residuals of a fit) is the same number; on
    # the card a Hessian's scatter-adds round in either order, and the FD
    # divides that by 2h (4e-12 and 6e-12 seen on an H100)
    same = 1e-10 if "hnorm" in name else 1e-12
    assert abs(tgt.value(theta_init("gfn1", device)) - val) <= same
    rel = 1e-7 if gold["class"] in ENERGY_CLASSES else 1e-6
    # leaf by leaf, relative to the largest entry of the leaf; where the
    # JAX gradient is NaN (prism_hnorm's slater exponents of H and O) the
    # port's is finite
    assert np.isfinite(grad).all()
    ref = np.array(gold["grad_flat"], dtype=float)
    known = np.isfinite(ref)
    _flat, unravel = fit1.ravel_theta(theta_init("gfn1", "cpu"))
    got, ref = unravel(np.where(known, grad, 0.0)), unravel(
        np.where(known, ref, 0.0))
    for a, b in zip(theta_leaves(got), theta_leaves(ref)):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= rel * scale


@pytest.mark.parametrize("name", CPU_TARGETS)
def test_target_value_and_gradient_match_jax(name):
    _check_target(name, "cpu")


def test_mbe_hessian_assembly_accumulates_repeated_rows():
    """A cap's rows are those of the atom it replaces, so a fragment's rows
    repeat: every addition lands, as in `H.at[rows, rows].add`."""
    rng = np.random.default_rng(7)
    rows3 = torch.tensor([[0, 1, 2, 0, 1, 2], [3, 4, 5, 0, 1, 2]])
    hf = torch.tensor(rng.normal(size=(2, 6, 6)))
    w = torch.tensor([1.5, -0.5])
    got = fit1.add_fragment_hessians(torch.zeros(6, 6, dtype=torch.float64),
                                     rows3, w, hf)
    ref = np.zeros((6, 6))
    for f in range(2):
        for i in range(6):
            for j in range(6):
                ref[rows3[f, i], rows3[f, j]] += float(w[f] * hf[f, i, j])
    assert np.abs(got.numpy() - ref).max() <= 1e-15


def test_mbe_hess_norm_of_one_fragment_is_the_hess_norm(monkeypatch):
    """The assembled norm over h3o's one fragment (weight 1) is the
    unfragmented norm, in value and theta-gradient."""
    monkeypatch.setitem(fit1.MBE_HESSNORM_TARGETS, "h3o_mbe_hnorm",
                        fit1.HESSNORM_TARGETS["h3o_hnorm"])
    theta = theta_init("gfn1", "cpu")
    v1, g1 = fit1.MbeHessNormTarget("h3o_mbe_hnorm", _settings(),
                                    device="cpu").value_and_grad(theta)
    v2, g2 = fit1.HessNormTarget("h3o_hnorm", _settings(),
                                 device="cpu").value_and_grad(theta)
    assert abs(v1 - v2) <= 1e-12
    assert np.abs(g1 - g2).max() <= 1e-12 * np.abs(g2).max()


def test_energy_jacobian_matches_central_difference():
    """An energy target is exact through the variational functional: its
    gradient along a random direction is the central difference."""
    tgt = fit1.TargetEval("h3o", _settings(), device="cpu")
    theta = theta_init("gfn1", "cpu")
    flat, unravel = fit1.ravel_theta(theta)
    d = np.random.default_rng(0).normal(size=flat.shape) * 1e-4 * (
        np.abs(flat) + 1e-2)
    _val, grad = tgt.value_and_grad(theta)
    fd = (tgt.value(unravel(flat + d)) - tgt.value(unravel(flat - d))) / 2
    assert abs(fd - grad @ d) <= 1e-5 * abs(grad @ d)


def test_one_lm_iteration_writes_the_jax_json(tmp_path):
    run = GOLDEN["fit_gfn1_run"]
    out = tmp_path / "fit.json"
    assert fit1.main(run["argv"] + ["--device", "cpu", "--out",
                                    str(out)]) == 0
    got = json.loads(out.read_text())
    ref = run["out"]
    assert set(got) == set(ref)
    assert set(got["residuals"]) == set(ref["residuals"])
    for name, r in ref["residuals"].items():
        assert abs(got["residuals"][name] - r) <= 1e-10

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, np.asarray(tree, dtype=float)

    ref_leaves = dict(leaves({k: v for k, v in ref.items()
                              if k != "residuals"}))
    got_leaves = dict(leaves({k: v for k, v in got.items()
                              if k != "residuals"}))
    assert set(got_leaves) == set(ref_leaves)
    for path, b in ref_leaves.items():
        a = got_leaves[path]
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-7 * max(np.abs(b).max(), 1e-12), (
            path)
    # the written JSON is a theta again, and carries the fitted values
    back = theta_from_overlay(str(out), "gfn1", "cpu")
    assert np.array_equal(back["elements"][8]["levels"].numpy(),
                          got["elements"]["8"]["levels"])
    assert np.array_equal(back["d3_pairs"].numpy(), got["d3_pairs"])


def test_w1_observables_match_jax():
    obs = fitw1.build_eval("cpu")(theta_init("gfn2", "cpu"))
    ref = GOLDEN["fit_gfn2_w1"]["observables"]
    assert set(obs) == set(ref)
    for key, tol in (("energy", 1e-10), ("grad_norm", 1e-9),
                     ("hess_norm", 1e-7), ("freqs", 1e-3), ("zpe", 1e-9),
                     ("gibbs", 1e-9)):
        assert np.abs(np.subtract(obs[key], ref[key])).max() <= tol, key


def test_w1_pack_unpack_round_trip():
    theta = theta_init("gfn2", "cpu")
    x, meta = fitw1.pack(theta)
    back = fitw1.unpack(x + 0.5, meta, theta)
    y, _ = fitw1.pack(back)
    assert np.array_equal(y, x + 0.5)
    assert back["elements"][8]["gam"].ndim == 0
    assert torch.equal(back["elements"][6]["levels"],
                       theta["elements"][6]["levels"])
    at = meta.index((8, "gam", 1))
    assert float(theta["elements"][8]["gam"]) == x[sum(
        n for *_key, n in meta[:at])]


@pytest.fixture(scope="module")
def solvation_energies():
    return fits.build_eval("cpu")


@pytest.mark.parametrize("point", ["x0", "x1"])
def test_solvation_energies_match_jax(solvation_energies, point):
    gold = GOLDEN["fit_solvation"]
    if point == "x0":
        assert np.array_equal(fits.X0, gold["x0"])
    got = solvation_energies(np.array(gold[point]))
    for model, ref in gold["energies_" + point].items():
        assert abs(got[model] - ref) <= 1e-10, model


def _synthetic_leg(rng, names, scale):
    cases = []
    for i, name in enumerate(names):
        checks = [{"label": lab, "got": float(rng.normal() * scale + k),
                   "expected": float(k)}
                  for k, lab in enumerate(("energy", "gradient_norm"))]
        if i == 2:
            checks.append({"label": "zpe", "got": "n/a", "expected": 0.0})
        cases.append({"name": name, "status": ("PASS", "FAIL")[i % 2],
                      "worst_delta": float(abs(rng.normal()) * scale),
                      "checks": checks})
    cases.append({"name": "errored", "status": "ERROR", "error": "boom"})
    return {"cases": cases}


def test_compare_matches_tpu_accuracy(tmp_path):
    import tpu_accuracy

    rng = np.random.default_rng(2)
    names = ["a", "b", "c", "d", "e"]
    paths = []
    for leg, (subset, scale) in enumerate(((names, 0.0), (names[:4], 1e-3),
                                           (names[1:] + ["f"], 1e-9))):
        path = tmp_path / f"leg{leg}.json"
        path.write_text(json.dumps(_synthetic_leg(rng, subset, scale)))
        paths.append(str(path))
    got = h100_accuracy.compare(*paths)
    assert got == tpu_accuracy.compare(*paths)
    assert [r["case"] for r in got][-1] == "errored" and len(got) == 5


def test_report_from_existing_legs(tmp_path):
    """Given three legs' JSON, the report runs no leg and writes both
    files; a raw case that raised reads ERROR, not a distance of 0."""
    rng = np.random.default_rng(4)
    names = ["a", "b"]
    paths = []
    for leg in range(3):
        data = _synthetic_leg(rng, names, 1e-6 * leg)
        data.update(device="cpu", precision="f64", polish="auto",
                    passed=1, failed=1, errored=1, off_jax=0)
        path = tmp_path / f"leg{leg}.json"
        path.write_text(json.dumps(data))
        paths.append(str(path))
    prefix = str(tmp_path / "REPORT")
    assert h100_accuracy.main(["--cpu-json", paths[0], "--raw-json",
                               paths[1], "--prod-json", paths[2],
                               "--device", "cpu",
                               "--out-prefix", prefix]) == 0
    report = json.loads(open(prefix + ".json").read())
    assert report["card"] == "cpu" and set(report["legs"]) == {
        "f64", "f32_raw", "f32_polish"}
    status = {r["case"]: r["raw_f32_status"] for r in report["cases"]}
    assert status == {"a": "PASS", "b": "FAIL", "errored": "ERROR"}
    table = open(prefix + ".md").read()
    assert "| errored | 0.000e+00 | None | ERROR |" in table


def test_polish_off_reports_raw_f32(tmp_path):
    """`--polish off` gives the float32 run's own numbers; `auto` polishes
    them to within 1e-8 of float64."""
    with open(os.path.join(REPO, "tests", "data",
                           "port_golden_gfn1_full.json")) as fh:
        f64 = json.load(fh)["driver"]["h3o_unfrag"]["total_energy"]
    got = {}
    for polish in ("off", "auto"):
        out = tmp_path / f"{polish}.json"
        run_validation_torch.main(["--filter", "h3o_unfrag", "--f32",
                                   "--device", "cpu", "--polish", polish,
                                   "--json-out", str(out)])
        res = json.loads(out.read_text())
        assert (res["precision"], res["polish"], res["errored"]) == (
            "f32", polish, 0)
        (case,) = res["cases"]
        got[polish] = case["checks"][0]["got"]
    assert abs(got["auto"] - f64) <= 1e-8
    assert abs(got["off"] - f64) > 1e-7


SCRIPTS = {
    "fit_gfn1_torch": lambda out: fit1.main(["--targets", "h3o", "--iters",
                                             "0", "--out", out]),
    "fit_gfn2_w1_torch": lambda out: fitw1.main(["--iters", "0", "--out",
                                                 out]),
    "fit_solvation_torch": lambda out: fits.main(["--iters", "1", "--out",
                                                  out]),
    "h100_accuracy": lambda out: h100_accuracy.main(["--out-prefix", out]),
    "run_validation_torch": lambda out: run_validation_torch.main(
        ["--filter", "h3o_unfrag", "--json-out", out]),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_script_asks_for_cuda(script, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SCRIPTS[script](out)
    assert not os.listdir(tmp_path)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GOLDEN["targets"]))
def test_target_value_and_gradient_match_jax_on_card(cuda, name):
    _check_target(name, cuda)
