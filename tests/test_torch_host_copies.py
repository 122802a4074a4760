"""The port's own host layer against the JAX package's, on the same inputs.

The port carries its own copies of the JAX package's framework-free
modules (input parsing, the JSON preprocessor, fragmentation, numerics,
results, JSON output, the angular grids, the fitted overlays). Each case below runs the same function of both packages
on the same inputs, made with NumPy from a seed, and the outputs must be
exactly equal: the copies are the same code.
"""

import dataclasses
import enum
import importlib
import json
import os

import numpy as np
import pytest
from _torch_port_common import REPO

MQC_FILES = ("port_prism.mqc", "port_w20_mbe4.mqc")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(x):
    """A structure of builtins and arrays that compares equal across the
    two packages (their dataclasses and enums are distinct classes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    return x


def _read_config(pkg, name):
    config = _mod(pkg, "io.config")
    adapter = _mod(pkg, "io.adapter")
    cfg = config.read_mqc_file(os.path.join(REPO, "tests", "data", name))
    return {"config": cfg, "driver": adapter.config_to_driver(cfg),
            "systems": adapter.config_to_system_geometries(cfg)}


def _prism(pkg):
    return _read_config(pkg, MQC_FILES[0])["systems"][0][1]


def _mbe_weights(pkg):
    comb = _mod(pkg, "frag.combinatorics")
    mbe = _mod(pkg, "frag.mbe")
    polymers = comb.enumerate_polymers(7, 4)
    return {"polymers": polymers, "weights": mbe.mbe_weights(polymers),
            "levels": comb.polymer_levels(polymers)}


def _gmbe_pie(pkg):
    """GMBE(2) of the prism hexamer: the dimers overlap in their monomers."""
    comb = _mod(pkg, "frag.combinatorics")
    gmbe = _mod(pkg, "frag.gmbe")
    geometry = _mod(pkg, "geometry")
    sys_geom = _prism(pkg)
    dimers = comb.enumerate_polymers(sys_geom.n_monomers, 2)
    dimers = dimers[(dimers >= 0).sum(axis=1) == 2]
    atom_sets, coeffs = gmbe.enumerate_pie_terms(
        gmbe.primary_atom_sets(sys_geom, dimers)
    )
    frags = [geometry.build_fragment_from_atom_list(sys_geom, s)
             for s in atom_sets]
    rng = np.random.default_rng(3)
    energies = rng.normal(size=len(frags))
    gradients = [rng.normal(size=(f.n_total, 3)) for f in frags]
    dipoles = rng.normal(size=(len(frags), 3))
    result = gmbe.compute_gmbe_pie(sys_geom, frags, coeffs, energies,
                                   gradients=gradients, dipoles=dipoles)
    return {"atom_sets": atom_sets, "coeffs": coeffs, "result": result}


def _water_hessian():
    """A symmetric, positive definite Hessian of a water (seeded)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(9, 9))
    numbers = np.array([8, 1, 1])
    coords = np.array([[0.0, 0.0, 0.221], [0.0, 1.43, -0.89],
                       [0.0, -1.43, -0.89]])
    dipder = rng.normal(size=(3, 9))
    return 0.1 * (x @ x.T) / 9.0, numbers, coords, dipder


def _vibrational(pkg):
    vib = _mod(pkg, "numerics.vibrational")
    thermo = _mod(pkg, "numerics.thermochemistry")
    hess, numbers, coords, dipder = _water_hessian()
    v = vib.compute_vibrational_analysis(hess, numbers, coords,
                                         dipole_derivatives=dipder)
    t = thermo.compute_thermochemistry(v.frequencies, numbers, coords,
                                       temperature=350.0, pressure_atm=2.0)
    return {"vibrational": v, "thermo": t}


def _json_output(pkg, tmp_path):
    writer = _mod(pkg, "io.json_writer")
    results = _mod(pkg, "results")
    out = _gmbe_pie(pkg)
    vib = _vibrational(pkg)
    path = tmp_path / f"{pkg}.json"
    writer.write_json_output(
        str(path), "prism", out["result"], pie_atom_sets=out["atom_sets"],
        vibrational=vib["vibrational"], thermo=vib["thermo"],
    )
    mbe = _mbe_weights(pkg)
    rng = np.random.default_rng(5)
    energies = rng.normal(size=len(mbe["polymers"]))
    sum_by_level = np.array([energies[mbe["levels"] == k].sum()
                             for k in range(1, 5)])
    res = results.MbeResult(
        total_energy=float(mbe["weights"] @ energies),
        fragment_energies=energies,
        delta_energies=_mod(pkg, "frag.mbe").mbe_deltas(mbe["polymers"],
                                                        energies),
        sum_by_level=sum_by_level,
    )
    multi = tmp_path / f"{pkg}_multi.json"
    writer.merge_multi_molecule_json(str(multi), "w7", {
        "a": writer.build_output_object(res, polymers=mbe["polymers"],
                                        max_level=4),
    })
    return {"single": path.read_bytes(), "multi": multi.read_bytes(),
            "name": writer.output_filename_for("dir/in.mqc", "x")}


def _validation_inputs():
    with open(os.path.join(REPO, "validation", "expected.json")) as fh:
        return sorted({t["input"] for t in json.load(fh)["tests"]})


def _emit_mqc(pkg, name):
    """The .mqc text of a validation input, and what the package's own
    parser makes of it."""
    prep = _mod(pkg, "io.prep")
    config = _mod(pkg, "io.config")
    path = os.path.join(REPO, "validation", "inputs", name)
    with open(path) as fh:
        text = prep.emit_mqc(json.load(fh), base_dir=os.path.dirname(path))
    return {"text": text, "config": config.parse_mqc_string(text),
            "solvents": sorted(prep.KNOWN_SOLVENTS)}


def _angular_grids(pkg):
    grids = _mod(pkg, "methods.xtb.solvation.grids")
    return {n: grids.angular_grid(n) for n in (50, 110, 194, 1000)}


def _solvation_tables(pkg):
    """Parameter sets after the overlay, per-atom tables and scalars."""
    solv = _mod(pkg, "methods.xtb.solvation")
    born = _mod(pkg, "methods.xtb.solvation.born")
    cpcm = _mod(pkg, "methods.xtb.solvation.cpcm")
    numbers = np.array([8, 1, 1, 6, 7, 16, 0])
    models = {"alpb": born.BornSolvation(78.4, alpb=True),
              "gbsa": born.BornSolvation(78.4, alpb=False, use_cds=False,
                                         solvent="dmso"),
              "cpcm": cpcm.CpcmSolvation(78.4, rscale=1.1)}
    return {
        "dielectrics": solv.SOLVENT_DIELECTRICS,
        "param_sets": born.PARAM_SETS,
        "constants": [born.RHO_OFFSET, born.ALPB_ALPHA, born.PROBE_RADIUS,
                      born.SASA_SWITCH, born.SURFACE_TENSION, born.GSHIFT,
                      cpcm.COSMO_X, cpcm.SELF_INTERACTION, cpcm.SWITCH_WIDTH],
        "tables": {k: m.host_tables(numbers) for k, m in models.items()},
        "scalars": {k: m.default_scalars() for k, m in models.items()},
    }


def _placeholder_methods(pkg):
    """HF, DFT and MCSCF placeholders on two fragments of unlike size."""
    stubs = _mod(pkg, "methods.stubs")
    base = _mod(pkg, "methods.base")
    frags = [(np.array([8, 1, 1]), np.zeros((3, 3)), 0, 1),
             (np.array([6, 1, 1, 1, 1]), np.ones((5, 3)), 0, 1)]
    out = {}
    for cls in (stubs.HFMethod, stubs.DFTMethod, stubs.MCSCFMethod):
        calc = cls()
        assert isinstance(calc, base.QCMethod)
        batch = calc.make_batch(frags)
        out[calc.variant] = {"energies": calc.energies(batch),
                             "gradients": calc.gradients(batch)}
    return out


_BASIS_TEXT = """\
****
H     0
S   3   1.00
      3.42525091             0.15432897
      0.62391373             0.53532814
      0.16885540             0.44463454
****
O     0
S   3   1.00
    130.7093200              0.15432897
     23.8088610              0.53532814
      6.4436083              0.44463454
SP   3   1.00
      5.0331513             -0.09996723             0.15591627
      1.1695961              0.39951283             0.60768372
      0.3803890              0.70011547             0.39195739
****
"""


def _basis_sets(pkg):
    bs = _mod(pkg, "methods.basis_sets")
    mb = bs.build_molecular_basis(["O", "H", "H"], _BASIS_TEXT)
    return {"parsed": bs.parse_basis_text(_BASIS_TEXT), "molecular": mb,
            "name": bs.normalize_basis_name(" 6-31G* ")}


def _cli_parser(pkg):
    cli = _mod(pkg, "io.cli_parser")
    errors = _mod(pkg, "errors")
    out = {"parsed": cli.parse_command_line(["w1.xyz", "cc-pVDZ"])}
    for argv in ([], ["only.xyz"], ["a.xyz", "b", "c"]):
        try:
            cli.parse_command_line(argv)
            out[str(argv)] = "no error"
        except errors.ParseError as exc:
            out[str(argv)] = str(exc)
    return out


CASES = {
    **{f"read_mqc_file[{name}]": (lambda pkg, tmp, n=name: _read_config(pkg, n))
       for name in MQC_FILES},
    **{f"emit_mqc[{name}]": (lambda pkg, tmp, n=name: _emit_mqc(pkg, n))
       for name in _validation_inputs()},
    "angular_grid": lambda pkg, tmp: _angular_grids(pkg),
    "solvation_tables": lambda pkg, tmp: _solvation_tables(pkg),
    "enumerate_polymers_and_mbe_weights": lambda pkg, tmp: _mbe_weights(pkg),
    "enumerate_pie_terms_and_compute_gmbe_pie": lambda pkg, tmp: _gmbe_pie(pkg),
    "vibrational_and_thermochemistry": lambda pkg, tmp: _vibrational(pkg),
    "json_writer": _json_output,
    "placeholder_methods": lambda pkg, tmp: _placeholder_methods(pkg),
    "basis_sets": lambda pkg, tmp: _basis_sets(pkg),
    "cli_parser": lambda pkg, tmp: _cli_parser(pkg),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_copy_matches_jax_package(case, tmp_path):
    ref = _plain(CASES[case]("metalquicha_tpu", tmp_path))
    port = _plain(CASES[case]("metalquicha_tpu_torch", tmp_path))
    assert port == ref


def _same_bytes(rel):
    with open(os.path.join(REPO, "metalquicha_tpu", rel), "rb") as fh:
        ref = fh.read()
    with open(os.path.join(REPO, "metalquicha_tpu_torch", rel), "rb") as fh:
        return fh.read() == ref


def test_fitted_overlay_is_the_jax_package_file():
    assert _same_bytes(os.path.join("methods", "xtb", "data",
                                    "gfn1_fitted.json"))


def test_gfn2_fitted_overlay_is_the_jax_package_file():
    assert _same_bytes(os.path.join("methods", "xtb", "data",
                                    "gfn2_fitted.json"))


@pytest.mark.parametrize("rel", ["data/solv_fitted.json",
                                 "solvation/data/lebedev.json"])
def test_solvation_data_file_is_the_jax_package_file(rel):
    assert _same_bytes(os.path.join("methods", "xtb", *rel.split("/")))
