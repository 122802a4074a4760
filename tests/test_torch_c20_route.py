"""The SCC's in-loop route follows the reference's (ROADMAP C20).

The JAX package takes its fast in-loop route (the Jacobi kernel up to
64 AOs, SP2 purification above) only in float32
(`metalquicha_tpu/methods/xtb/engine.py` `scf_solve`: `fast_inloop =
settings.use_pallas_eigh and S.dtype == jnp.float32`); a float64 SCC runs
the exact route (`_ortho_factors`, `_general_eigh`, the Fermi fill) what
ever `use_pallas_eigh` says. The port follows it: with the flag on, in
float64 on the CPU, its energies match the JAX package's at 1e-10 Ha on
small-gap fragments below and above 64 AOs and on a GMBE bucket with
coincident caps (the inputs where the fast route's T = 0 density and its
1e-5 linear-dependence cut differ from the exact route), and its SCC calls
neither the Jacobi kernel nor SP2; in float32 it still takes Jacobi up to
64 AOs and SP2 above.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    GLY3_FRAG,
    REPO,
    restore_jax_overlay,
    spd_fragment,
)

from metalquicha_tpu_torch import geometry
from metalquicha_tpu_torch.driver import (
    _build_plan,
    _driver_config,
    read_mqc_file,
)
from metalquicha_tpu_torch.elements import symbol_to_number
from metalquicha_tpu_torch.io.adapter import config_to_system_geometries
from metalquicha_tpu_torch.methods.xtb import engine
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor

torch.set_num_threads(1)
TOL = 1e-10
GMBE_DECANE = os.path.join(REPO, "tests", "data", "port_full_gmbe3_decane.mqc")


def _tuple(frag):
    return (np.asarray(frag.numbers), np.asarray(frag.coords),
            int(frag.charge), int(frag.multiplicity))


def _decane():
    """validation/inputs/sample_inputs/decane.xyz as one closed-shell
    fragment (84 AOs)."""
    path = os.path.join(REPO, "validation", "inputs", "sample_inputs",
                        "decane.xyz")
    with open(path) as fh:
        rows = [ln.split() for ln in fh.read().splitlines()[2:] if ln.strip()]
    numbers = np.array([symbol_to_number(r[0]) for r in rows])
    coords = np.array([[float(x) for x in r[1:4]] for r in rows])
    return numbers, coords / 0.52917721067, 0, 1


def _gmbe_caps_bucket():
    """The bucket of tests/data/port_full_gmbe3_decane.mqc's GMBE(3)
    intersections that pads to 81 AOs (four fragments of 25 to 29 atoms
    with coincident hydrogen caps), and its padded shape."""
    cfg = read_mqc_file(GMBE_DECANE)
    (_name, system), = config_to_system_geometries(cfg)
    plan = _build_plan(system, _driver_config(cfg, None))
    ex = FragmentExecutor(XtbCalculator(device="cpu"))
    for atoms, members in ex._buckets(plan.fragments).items():
        pad_to = ex._pad_shapes_for(atoms, members)
        if pad_to[-1] > engine.PALLAS_EIGH_MAX_N:
            return [f for _, f in members], pad_to
    raise AssertionError("no GMBE bucket above 64 AOs")


#: name -> (fragments, pad_to): below 64 AOs the silicon triplet (nuhf 2,
#: its p levels degenerate) and the gly3 residue radical (a doublet); above
#: 64 decane (84 AOs) and the GMBE bucket with coincident caps
CASES = {
    "si_triplet": (lambda: ([_tuple(spd_fragment(geometry, "si"))], None)),
    "gly3_radical": (lambda: ([GLY3_FRAG], None)),
    "decane_84ao": (lambda: ([_decane()], None)),
    "gmbe3_decane_caps": _gmbe_caps_bucket,
}


def _jax_energies(fragments, pad_to):
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator as JaxCalc
    from metalquicha_tpu.methods.xtb.engine import (
        settings_from_params as jax_settings,
    )

    restore_jax_overlay()
    calc = JaxCalc(jax_settings("gfn1", max_scf_iter=256, scf_tol=1e-9,
                                use_pallas_eigh=True),
                   variant="gfn1", dtype=jnp.float64)
    e, aux = calc.energies(calc.make_batch(fragments, pad_to=pad_to))
    return np.asarray(e), np.asarray(aux["scf_residual"])


class _Counted:
    """Counts the engine's calls of the fast route's solvers."""

    def __init__(self, monkeypatch):
        self.jacobi = self.sp2 = 0
        jacobi, sp2 = engine.jacobi_eigh, engine.sp2_density

        def counted_jacobi(*args, **kw):
            self.jacobi += 1
            return jacobi(*args, **kw)

        def counted_sp2(*args, **kw):
            self.sp2 += 1
            return sp2(*args, **kw)

        monkeypatch.setattr(engine, "jacobi_eigh", counted_jacobi)
        monkeypatch.setattr(engine, "sp2_density", counted_sp2)


@pytest.mark.parametrize("name", list(CASES))
def test_f64_flag_takes_the_reference_route(monkeypatch, name):
    fragments, pad_to = CASES[name]()
    e_j, r_j = _jax_energies(fragments, pad_to)
    settings = settings_from_params("gfn1", max_scf_iter=256, scf_tol=1e-9,
                                    use_pallas_eigh=True)
    calc = XtbCalculator(settings, device="cpu")
    frag = calc.make_batch(fragments, pad_to=pad_to)
    counted = _Counted(monkeypatch)
    e, aux = calc.energies(frag)
    miss = np.abs(e.numpy() - e_j).max()
    assert miss <= TOL, (f"{name}: {miss:.3e} Ha off the JAX package (SCC "
                         f"residual {float(aux['scf_residual'].max()):.2e})")
    assert float(aux["scf_residual"].max()) < 1e-8 and r_j.max() < 1e-8
    assert counted.jacobi == 0 and counted.sp2 == 0
    exact = XtbCalculator(settings._replace(use_pallas_eigh=False),
                          device="cpu")
    assert torch.equal(exact.energies(frag)[0], e)


@pytest.mark.parametrize("name,route", [("si_triplet", "jacobi"),
                                        ("gly3_radical", "jacobi"),
                                        ("decane_84ao", "sp2")])
def test_f32_flag_keeps_the_fast_route(monkeypatch, name, route):
    """Two SCC iterations are enough to see the route."""
    fragments, pad_to = CASES[name]()
    calc = XtbCalculator(settings_from_params("gfn1", max_scf_iter=2,
                                              use_pallas_eigh=True),
                         dtype=torch.float32, device="cpu")
    frag = calc.make_batch(fragments, pad_to=pad_to)
    counted = _Counted(monkeypatch)
    e, _aux = calc.energies(frag)
    assert bool(torch.isfinite(e).all())
    calls = {"jacobi": counted.jacobi, "sp2": counted.sp2}
    assert calls[route] == 2 and sum(calls.values()) == 2
