"""`bench_torch.py`, the port's counterpart of `bench.py`, on the CPU at a
small size.

Its functions run at 4 dimers, 1 timed call, a gradient batch of 2, the
water-trimer MBE(2) set in place of w20, eigh at (4, 8), SP2 at (2, 16)
and the Jacobi route at (4, 8) (its plain version on the CPU); the line's
keys equal `bench.py`'s (frozen below from bench.py:322-347, and read
from bench.py's source); `main` reads `bench.py`'s knobs, prints the
device on stderr and one JSON line on stdout; and the energies of
`bench.py`'s first 4 dimers at 16 SCC iterations in float64 equal the JAX
package's `XtbCalculator.energies` (live, 1e-10 Ha).
"""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import REPO, restore_jax_overlay

import bench_torch
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
from metalquicha_tpu_torch.workloads import (
    bench_dimers,
    dimers_from,
    trimer_mbe2_assemble,
    trimer_mbe2_fragments,
)

torch.set_num_threads(1)

#: bench.py:322-347, the keys of its JSON line in order
BENCH_PY_KEYS = [
    "metric", "value", "unit", "vs_baseline", "platform", "batch_size",
    "scf_residual", "gfn1_fragment_gradients_per_sec", "grad_scf_residual",
    "mbe2_w20_grad_wall_s", "mbe2_w20_total_ha", "eigh_tflops_b512_n16",
    "eigh_tflops_b64_n256", "sp2_density_speedup_b64_n256",
    "sp2_tflops_b64_n256", "jacobi_tflops_b512_n16",
    "jacobi_speedup_b512_n16", "jacobi_tflops_b128_n64",
    "jacobi_speedup_b128_n64",
]

N_DIMERS = 4


def _trimer(jitter):
    return [(z, c + jitter, q, m) for z, c, q, m in trimer_mbe2_fragments()]


def _trimer_total(energies, gradients):
    return trimer_mbe2_assemble(energies, gradients)[0]


SMALL = dict(
    device="cpu", batch_size=N_DIMERS, n_iters=1, grad_batch=2,
    mbe=(_trimer, _trimer_total), mbe_passes=1,
    eigh_shapes=((4, 8), (4, 8)), sp2_shape=(2, 16),
    jacobi_shapes=((4, 8), (4, 8)),
)


@pytest.fixture(autouse=True)
def _quiet():
    global_logger.set_level("warning")


@pytest.fixture(scope="module")
def small_run():
    global_logger.set_level("warning")
    return bench_torch.measure(**SMALL)


def test_keys_equal_bench_py():
    assert list(bench_torch.KEYS) == BENCH_PY_KEYS
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    dicts = [node for node in ast.walk(tree) if isinstance(node, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric"
                     for k in node.keys)]
    assert len(dicts) == 1
    assert [k.value for k in dicts[0].keys] == BENCH_PY_KEYS


def test_small_run_gives_bench_py_line(small_run):
    line, energies = small_run
    assert list(line) == BENCH_PY_KEYS
    assert line["platform"] == "cpu" and line["batch_size"] == N_DIMERS
    assert line["metric"] == "gfn1_fragment_energies_per_sec"
    assert line["unit"] == "fragments/s"
    assert line["scf_residual"] < 1e-5 and line["grad_scf_residual"] < 1e-5
    for key in ("value", "gfn1_fragment_gradients_per_sec",
                "mbe2_w20_grad_wall_s", "eigh_tflops_b512_n16",
                "sp2_density_speedup_b64_n256", "jacobi_speedup_b512_n16"):
        assert np.isfinite(line[key]) and line[key] >= 0, key
    base = bench_torch.BASELINE_FRAGS_PER_SEC
    # both rounded as printed: value to 1e-2, vs_baseline to 1e-3
    assert abs(line["vs_baseline"] - line["value"] / base) <= (
        5e-4 + 5e-3 / base)
    assert energies.shape == (N_DIMERS,) and np.isfinite(energies).all()


def test_small_run_mbe_total_equals_the_executor(small_run):
    """The MBE pass's total is the executor's on the last pass's inputs
    (printed rounded to 1e-6, as bench.py prints it)."""
    line, _ = small_run
    calc = bench_torch._calculator(32, True, torch.float64, "cpu")
    e, g, _aux = FragmentExecutor(calc).run(_trimer(np.full(3, 1e-5)),
                                            "gradient")
    assert line["mbe2_w20_total_ha"] == round(_trimer_total(e, g), 6)


def test_dimers_follow_bench_py_draws():
    """The energy batch is bench_dimers; the gradient batch continues the
    same generator after the eigensolver inputs, as in bench.py."""
    rng = np.random.default_rng(0)
    first = dimers_from(rng, 3)
    for (z, c, q, m), (zr, cr, qr, mr) in zip(first, bench_dimers(3)):
        assert (z == zr).all() and np.array_equal(c, cr) and (q, m) == (qr, mr)
    later = dimers_from(rng, 1)[0][1]
    assert np.array_equal(later, bench_dimers(4)[3][1])


def test_eigensolver_rates_are_finite():
    rng = np.random.default_rng(0)
    dev = torch.device("cpu")
    assert bench_torch.eigh_tflops(rng, 4, 8, torch.float64, dev) > 0
    sp2 = bench_torch.density_secs(rng, 2, 16, "sp2", torch.float64, dev, 2)
    eig = bench_torch.density_secs(rng, 2, 16, "eigh", torch.float64, dev, 2)
    assert sp2 > 0 and eig > 0
    tflops, speedup = bench_torch.jacobi_pair(rng, 4, 8, torch.float64, dev, 1)
    assert tflops > 0 and speedup > 0


def test_main_reads_the_knobs_and_prints_one_line(monkeypatch, capsys):
    calls = []
    measure = bench_torch.measure

    def small(**kwargs):
        calls.append(kwargs)
        return measure(**{**SMALL, **kwargs})

    monkeypatch.setattr(bench_torch, "measure", small)
    for key, value in (("BENCH_BATCH", "2"), ("BENCH_ITERS", "1"),
                       ("BENCH_SCF_ITERS", "16"), ("BENCH_GRAD_BATCH", "2"),
                       ("BENCH_F64", "1"), ("BENCH_PALLAS", "0")):
        monkeypatch.setenv(key, value)
    assert bench_torch.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == BENCH_PY_KEYS and line["batch_size"] == 2
    assert line["jacobi_tflops_b512_n16"] == 0.0  # BENCH_PALLAS=0
    assert "cpu" in err
    (kw,) = calls
    assert kw["dtype"] == torch.float64 and kw["use_pallas"] is False
    assert (kw["batch_size"], kw["n_iters"], kw["scf_iters"],
            kw["grad_batch"]) == (2, 1, 16, 2)


def test_defaults_are_bench_py_sizes(monkeypatch):
    seen = {}
    monkeypatch.setattr(bench_torch, "measure",
                        lambda **kw: (seen.update(kw), ({}, None))[1])
    for key in ("BENCH_BATCH", "BENCH_ITERS", "BENCH_SCF_ITERS",
                "BENCH_GRAD_BATCH", "BENCH_F64", "BENCH_PALLAS"):
        monkeypatch.delenv(key, raising=False)
    bench_torch.main(["--device", "cpu"])
    assert (seen["batch_size"], seen["n_iters"], seen["scf_iters"],
            seen["grad_batch"]) == (512, 8, 16, 256)
    assert seen["dtype"] == torch.float64 and seen["use_pallas"] is True


def test_energies_match_live_jax(small_run):
    """bench.py's first 4 dimers at 16 SCC iterations in float64 (moved
    by 1e-6 Bohr, the timed call's shift) against the JAX package."""
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator as JaxCalc
    from metalquicha_tpu.methods.xtb.engine import settings_from_params

    restore_jax_overlay()
    _line, energies = small_run
    frags = [(z, c + 1e-6, q, m) for z, c, q, m in bench_dimers(N_DIMERS)]
    calc = JaxCalc(settings_from_params("gfn1", max_scf_iter=16),
                   dtype=jnp.float64)
    e_jax, _aux = calc.energies(calc.make_batch(frags))
    assert np.abs(energies - np.asarray(e_jax)).max() <= 1e-10
    port = XtbCalculator(bench_torch._calculator(
        16, False, torch.float64, "cpu").settings, device="cpu")
    e_exact, _ = port.energies(port.make_batch(frags))
    assert np.abs(e_exact.numpy() - np.asarray(e_jax)).max() <= 1e-10
