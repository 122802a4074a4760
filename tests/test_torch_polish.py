"""The port's mixed-precision route against the JAX package's.

`HostPolisher.polish` and `rescue` of the port (methods/xtb/polish.py) on
the three jittered waters of tests/test_polish.py: one live call of the
JAX package's polisher from the same float32 state (energies 1e-10 Ha,
gradients 1e-9 Ha/Bohr), the rest against the JAX package's results frozen
by tools/gen_port_golden.py in tests/data/port_golden_polish_fit.json.
Then the port of every case of tests/test_polish.py but the TPU batch
quantum's, at that file's tolerances (totals and gradients 1e-8, Hessian
norm 1e-7, frequencies 0.01 cm^-1), each float64 leg also held to the JAX
package's float64 result (1e-9). Everything runs on the CPU
(`device="cpu"`), where both legs of the route are on the CPU.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from _torch_port_common import REPO, restore_jax_overlay

from metalquicha_tpu_torch.__main__ import main as cli_main
from metalquicha_tpu_torch.driver import make_executor, run_calculation
from metalquicha_tpu_torch.io.config import parse_mqc_string
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.methods.xtb.polish import (
    POLISH_ITERS,
    POLISH_SCF_TOL,
    HostPolisher,
    host_polish_available,
)
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
from metalquicha_tpu_torch.workloads import WATER_BOHR

torch.set_num_threads(1)

E_TOL = 1e-10   # Ha, against the JAX package
G_TOL = 1e-9    # Ha/Bohr

with open(os.path.join(REPO, "tests", "data",
                       "port_golden_polish_fit.json")) as _fh:
    GOLDEN = json.load(_fh)
TWO_WATERS_MQC = GOLDEN["two_waters"]["mqc"]


@pytest.fixture(autouse=True)
def _quiet():
    global_logger.set_level("warning")


def _waters(n=3):
    rng = np.random.default_rng(7)
    return [(np.array([8, 1, 1]),
             WATER_BOHR + rng.normal(0, 0.05, (1, 3))
             + np.array([[6.0 * i, 0, 0]]), 0, 1) for i in range(n)]


def _polisher(variant):
    return HostPolisher(
        XtbCalculator(variant=variant, dtype=torch.float32, device="cpu"))


def test_polish_matches_live_jax():
    """The same float32 state through both polishers, GFN1."""
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.calculator import (
        XtbCalculator as JaxCalculator,
    )
    from metalquicha_tpu.methods.xtb.polish import (
        HostPolisher as JaxPolisher,
    )

    restore_jax_overlay()
    q0 = np.asarray(GOLDEN["polish"]["gfn1"]["state_f32"], dtype=np.float32)
    frags = _waters()
    e_j, g_j, aux_j = JaxPolisher(JaxCalculator(dtype=jnp.float32)).polish(
        frags, None, q0, "gradient")
    e_t, g_t, aux_t = _polisher("gfn1").polish(frags, None, q0, "gradient")
    assert e_t.dtype == torch.float64 and g_t.dtype == torch.float64
    assert np.abs(e_t.numpy() - np.asarray(e_j)).max() <= E_TOL
    assert np.abs(g_t.numpy() - np.asarray(g_j)).max() <= G_TOL
    assert np.abs(aux_t["dipole"].numpy()
                  - np.asarray(aux_j["dipole"])).max() <= G_TOL
    assert float(aux_t["scf_residual"].max()) < 1e-9


@pytest.mark.parametrize("variant", ["gfn1", "gfn2"])
@pytest.mark.parametrize("what", ["energy", "gradient"])
def test_polish_matches_golden(variant, what):
    gold = GOLDEN["polish"][variant]
    q0 = torch.tensor(gold["state_f32"], dtype=torch.float32)
    e, g, aux = _polisher(variant).polish(_waters(), None, q0, what)
    assert np.abs(e.numpy() - gold["polish"]["energies"]).max() <= E_TOL
    assert np.abs(aux["dipole"].numpy()
                  - gold["polish"]["dipole"]).max() <= G_TOL
    assert float(aux["scf_residual"].max()) < 1e-9
    if what == "gradient":
        assert np.abs(g.numpy() - gold["polish"]["gradients"]).max() <= G_TOL
        # and the polish lands on the all-float64 result
        assert np.abs(e.numpy() - gold["f64"]["energies"]).max() <= 1e-9
        assert np.abs(g.numpy() - gold["f64"]["gradients"]).max() <= 1e-8
    else:
        assert g is None


@pytest.mark.parametrize("variant", ["gfn1", "gfn2"])
def test_rescue_matches_golden(variant):
    gold = GOLDEN["polish"][variant]
    e, g, aux = _polisher(variant).rescue(_waters(), None, "gradient")
    assert isinstance(e, np.ndarray) and e.dtype == np.float64
    assert np.abs(e - gold["rescue"]["energies"]).max() <= E_TOL
    assert np.abs(g - gold["rescue"]["gradients"]).max() <= G_TOL
    assert np.abs(e - gold["f64"]["energies"]).max() <= E_TOL
    e_only, g_only, _ = _polisher(variant).rescue(_waters(), None, "energy")
    assert g_only is None and np.abs(e_only - e).max() <= 1e-12


def test_calc64_copies_the_device_calculator():
    from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation

    solv = BornSolvation(78.4, alpb=True)
    settings = settings_from_params("gfn2", use_pallas_eigh=True,
                                    scf_tol=1e-6, max_scf_iter=77)
    calc = XtbCalculator(settings, variant="gfn2", dtype=torch.float32,
                         device="cpu", solvation=solv)
    pol = HostPolisher(calc)
    c64 = pol.calc64
    assert pol.k == POLISH_ITERS == 2 and pol.supports()
    assert host_polish_available()
    assert c64.dtype == torch.float64 and c64.device == calc.device
    assert c64.variant == "gfn2" and c64.solvation is solv
    assert c64.settings == settings._replace(use_pallas_eigh=False,
                                             scf_tol=POLISH_SCF_TOL)
    # scf_tol == 0 (fixed-iteration semantics) is left alone
    fixed = XtbCalculator(settings._replace(scf_tol=0.0), variant="gfn2",
                          dtype=torch.float32, device="cpu")
    assert HostPolisher(fixed).calc64.settings.scf_tol == 0.0


def _run(mqc, **overrides):
    return run_calculation(parse_mqc_string(mqc), write_json=False,
                           device="cpu", driver_overrides=overrides)[""]


@pytest.mark.parametrize("what", ["Energy", "Gradient"])
def test_polished_f32_matches_f64(what):
    mqc = TWO_WATERS_MQC.format(driver=what)
    ref = _run(mqc, force_dtype="f64")
    raw = _run(mqc, force_dtype="f32", host_polish="off")
    pol = _run(mqc, force_dtype="f32")

    gold = GOLDEN["two_waters"][what.lower()]
    e_ref = ref.result.total_energy
    assert abs(e_ref - gold["total_energy"]) < 1e-9
    # raw f32 sits at ~1e-4; the polish must close it to <=1e-8
    assert abs(pol.result.total_energy - e_ref) < 1e-8
    assert abs(raw.result.total_energy - e_ref) > abs(
        pol.result.total_energy - e_ref
    )
    if what == "Gradient":
        g_ref = np.asarray(ref.result.gradient)
        assert np.abs(g_ref - gold["gradient"]).max() < 1e-8
        assert np.abs(np.asarray(pol.result.gradient) - g_ref).max() < 1e-8
        assert np.abs(np.asarray(raw.result.gradient) - g_ref).max() > np.abs(
            np.asarray(pol.result.gradient) - g_ref).max()


def test_polished_f32_matches_f64_gfn2():
    """GFN2: the polish refines the packed AES state (shell charges +
    atomic dipoles/quadrupoles) via engine.scf_refine_multipole."""
    mqc = TWO_WATERS_MQC.format(driver="Gradient").replace(
        "XTB-GFN1", "XTB-GFN2")
    ref = _run(mqc, force_dtype="f64")
    raw = _run(mqc, force_dtype="f32", host_polish="off")
    pol = _run(mqc, force_dtype="f32")
    gold = GOLDEN["two_waters"]["gradient_gfn2"]
    assert abs(ref.result.total_energy - gold["total_energy"]) < 1e-9
    assert abs(pol.result.total_energy - ref.result.total_energy) < 1e-8
    assert abs(raw.result.total_energy - ref.result.total_energy) > abs(
        pol.result.total_energy - ref.result.total_energy)
    g_ref = np.asarray(ref.result.gradient)
    assert np.abs(g_ref - gold["gradient"]).max() < 1e-8
    assert np.abs(np.asarray(pol.result.gradient) - g_ref).max() < 1e-8


def test_polished_hessian_matches_f64():
    mqc = TWO_WATERS_MQC.format(driver="Hessian").replace("level = 2",
                                                          "level = 1")
    ref = _run(mqc, force_dtype="f64")
    pol = _run(mqc, force_dtype="f32")
    gold = GOLDEN["two_waters"]["hessian_level1"]
    n_ref = float(np.sqrt((np.asarray(ref.result.hessian) ** 2).sum()))
    n_pol = float(np.sqrt((np.asarray(pol.result.hessian) ** 2).sum()))
    assert abs(n_ref - gold["hessian_frobenius_norm"]) < 1e-7
    # FD Hessians difference polished GRADIENTS, whose error is first
    # order in the post-polish charge residual: the warm-started f64
    # solve (POLISH_SCF_TOL) is what keeps these tight
    assert abs(n_pol - n_ref) < 1e-7
    assert ref.vibrational is not None and pol.vibrational is not None
    f_ref = np.sort(np.asarray(ref.vibrational.frequencies))[-3:]
    f_pol = np.sort(np.asarray(pol.vibrational.frequencies))[-3:]
    assert np.abs(f_ref - np.sort(gold["frequencies"])[-3:]).max() < 0.01
    assert np.abs(f_pol - f_ref).max() < 0.01  # cm^-1


def test_rescue_resolves_unconverged_f32_fragments():
    """rescue_tol: fragments whose f32 SCC misses the gate are re-solved
    in full f64 (executor._run_chunk -> HostPolisher.rescue).

    An impossibly tight gate forces EVERY fragment down the rescue path,
    so the executor's output must equal the all-f64 calculator's exactly
    (rescue IS the f64 path)."""
    frags = _waters(3)
    calc32 = XtbCalculator(dtype=torch.float32, device="cpu")
    ex = FragmentExecutor(calc32, polisher=HostPolisher(calc32),
                          rescue_tol=1e-30)
    e, g, aux = ex.run(frags, what="gradient")

    ex64 = FragmentExecutor(XtbCalculator(dtype=torch.float64, device="cpu"))
    e64, g64, _ = ex64.run(frags, what="gradient")
    assert np.abs(e - e64).max() < 1e-12
    for a, b in zip(g, g64):
        assert np.abs(a - b).max() < 1e-12
    # the rescue reports the f64 residuals it actually converged to
    assert float(np.abs(aux["scf_residual"]).max()) < 1e-8
    gold = GOLDEN["polish"]["gfn1"]["f64"]
    assert np.abs(e - gold["energies"]).max() <= E_TOL


@pytest.fixture
def log_text(monkeypatch):
    """The driver's log at level info, as a function returning its text."""
    stream = io.StringIO()
    monkeypatch.setattr(global_logger, "stream", stream)
    global_logger.set_level("info")
    return stream.getvalue


def test_rescue_logs_its_line(log_text):
    frags = _waters(2)
    calc32 = XtbCalculator(dtype=torch.float32, device="cpu")
    ex = FragmentExecutor(calc32, polisher=HostPolisher(calc32),
                          rescue_tol=1e-30)
    ex.run(frags, what="energy")
    assert ("f64 host rescue: 2 fragment(s) with f32 SCC residual > 1.0e-30"
            in log_text())


def test_make_executor_wires_the_polisher(log_text):
    """`_make_executor`: an f32 calculator gets the polisher and the
    driver's convergence gate as rescue threshold, unless host_polish is
    off; an f64 one gets neither."""
    cfg = parse_mqc_string(TWO_WATERS_MQC.format(driver="Energy"))
    ex = make_executor(cfg, "cpu", {"force_dtype": "f32"})
    assert "mixed precision: f32 device SCC + f64 host polish" in log_text()
    assert isinstance(ex.polisher, HostPolisher)
    assert ex.calc.dtype == torch.float32
    assert ex.polisher.calc64.settings.scf_tol == POLISH_SCF_TOL
    assert ex.rescue_tol == max(10.0 * cfg.scf_tolerance, 1e-8)
    off = make_executor(cfg, "cpu", {"force_dtype": "f32",
                                     "host_polish": "off"})
    assert off.polisher is None and off.rescue_tol is None
    f64 = make_executor(cfg, "cpu")
    assert f64.calc.dtype == torch.float64
    assert f64.polisher is None and f64.rescue_tol is None


def test_cli_flags(tmp_path, monkeypatch, capsys):
    """--version needs no input; --f32 polishes, --no-polish does not."""
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--version"]) == 0
    assert "version 0." in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_main([])
    capsys.readouterr()
    path = tmp_path / "two.mqc"
    path.write_text(TWO_WATERS_MQC.format(driver="Energy"))

    def total(*flags):
        assert cli_main([str(path), "--device", "cpu", *flags]) == 0
        line = [s for s in capsys.readouterr().out.splitlines()
                if "total_energy" in s][-1]
        return float(line.split("=")[1].split()[0])

    e64 = total()
    e_pol = total("--f32")
    e_raw = total("--f32", "--no-polish")
    assert abs(e64 - GOLDEN["two_waters"]["energy"]["total_energy"]) < 1e-9
    assert abs(e_pol - e64) < 1e-8 < abs(e_raw - e64)
