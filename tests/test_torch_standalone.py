"""The port stands alone and runs on the card unless asked for the CPU.

- With `jax` and `metalquicha_tpu` both unimportable, every module of the
  port imports, and the prism MBE(2) driver runs on the CPU within 1e-9 Ha
  of its golden (tests/data/port_golden_gfn1.json, from the JAX package);
- the same for the mixed-precision route, a two-slot mesh (whose worker
  processes load neither), the differentiable parameterization and the
  build cache;
- every entry point asks for CUDA by default: with no card it raises
  instead of falling back to the CPU;
- the default path (one device, float64, no polisher) still reproduces the
  goldens of tests/data/port_golden_gfn1.json, and `compile_cache.enable`
  directs the kernel's build directory.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_port_common import GOLDEN_PATH, REPO

import bench_torch

from metalquicha_tpu_torch import compile_cache

from metalquicha_tpu_torch.__main__ import main as cli_main
from metalquicha_tpu_torch.driver import make_executor, run_calculation, run_file
from metalquicha_tpu_torch.io.adapter import config_to_driver
from metalquicha_tpu_torch.io.config import read_mqc_file
from metalquicha_tpu_torch.methods.factory import create_calculator
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.methods.xtb.param_fit import FragmentSpec, theta_init
from metalquicha_tpu_torch.ops import kernel_build
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
from metalquicha_tpu_torch.parallel.mesh import fragment_mesh
from metalquicha_tpu_torch.workloads import (
    bench_dimers,
    w20_mbe2_assemble,
    w20_mbe2_fragments,
)

PRISM = os.path.join(REPO, "tests", "data", "port_prism.mqc")
GFN2_W1 = os.path.join(REPO, "tests", "data", "port_gfn2_w1_vib_therm.mqc")
GFN2_PRISM = os.path.join(REPO, "tests", "data", "port_gfn2_prism.mqc")
GOLDEN_GFN2 = os.path.join(REPO, "tests", "data", "port_golden_gfn2.json")

_STANDALONE = """
import importlib, json, os, pkgutil, sys
sys.modules["jax"] = None
sys.modules["metalquicha_tpu"] = None
import torch
torch.set_num_threads(1)
import metalquicha_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from metalquicha_tpu_torch.driver import run_calculation
from metalquicha_tpu_torch.io.config import read_mqc_file
from metalquicha_tpu_torch.logging_ import global_logger
global_logger.set_level("warning")
out = run_calculation(read_mqc_file(sys.argv[1]), write_json=False,
                      device="cpu")
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "metalquicha_tpu"))
print(json.dumps({"modules": len(names), "loaded": loaded,
                  "total": out[""].result.total_energy}))
"""


def test_port_runs_prism_without_jax_package():
    with open(GOLDEN_PATH) as fh:
        gold = json.load(fh)["driver"]["prism_mbe"]["total_energy"]
    proc = subprocess.run(
        [sys.executable, "-c", _STANDALONE, PRISM], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 30
    assert res["loaded"] == []
    assert abs(res["total"] - gold) <= 1e-9


def test_port_runs_gfn2_prism_without_jax_package():
    with open(GOLDEN_GFN2) as fh:
        gold = json.load(fh)["driver"]["prism_mbe"]["total_energy"]
    proc = subprocess.run(
        [sys.executable, "-c", _STANDALONE, GFN2_PRISM], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 37 and res["loaded"] == []
    assert abs(res["total"] - gold) <= 1e-9


_NEW_MODULES = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["metalquicha_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from metalquicha_tpu_torch import compile_cache
from metalquicha_tpu_torch.driver import make_executor, run_calculation
from metalquicha_tpu_torch.io.config import read_mqc_file
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.xtb.calculator import single_point_energy
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.methods.xtb.param_fit import FragmentSpec, theta_init
from metalquicha_tpu_torch.methods.xtb.polish import HostPolisher
from metalquicha_tpu_torch.ops import kernel_build
from metalquicha_tpu_torch.parallel.mesh import fragment_mesh
global_logger.set_level("warning")
compile_cache.enable(sys.argv[2])
cfg = read_mqc_file(sys.argv[1])
ex = make_executor(cfg, "cpu", {"force_dtype": "f32"})
ex.mesh = fragment_mesh(["cpu", "cpu"], nodes_per_group=1)
ex.n_devices = 2
polished = run_calculation(cfg, write_json=False, executor=ex)
raw = run_calculation(cfg, write_json=False, device="cpu",
                      driver_overrides={"force_dtype": "f32",
                                        "host_polish": "off"})
spec = FragmentSpec(np.array([8, 1, 1]),
                    np.array([[0, 0, 0.2], [0, 1.4, -0.9], [0, -1.4, -0.9]]),
                    0, 1, device="cpu")
theta = theta_init("gfn1", "cpu")
theta["globals"].requires_grad_(True)
frag = spec.rebuild(theta)
e, _ = single_point_energy(frag.coords, frag, settings_from_params("gfn1"))
(g,) = torch.autograd.grad(e.sum(), theta["globals"])
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "metalquicha_tpu"))
workers = [sorted(set(w.modules) & {"jax", "metalquicha_tpu"})
           for w in ex.workers]
ex.close()
print(json.dumps({"loaded": loaded, "polisher": type(ex.polisher).__name__,
                  "workers": workers,
                  "polished": polished[""].result.total_energy,
                  "raw": raw[""].result.total_energy,
                  "grad_finite": bool(torch.isfinite(g).all()),
                  "build_dir": str(kernel_build.BUILD_DIR)}))
"""


def test_new_modules_run_without_jax_package(tmp_path):
    """The f32 + polish route on a two-slot mesh (two worker processes,
    which load nothing of jax or the JAX package either), the parameter
    rebuild and the build cache, with jax and the JAX package
    unimportable."""
    with open(GOLDEN_PATH) as fh:
        gold = json.load(fh)["driver"]["prism_mbe"]["total_energy"]
    cache = str(tmp_path / "cache")
    proc = subprocess.run(
        [sys.executable, "-c", _NEW_MODULES, PRISM, cache], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["polisher"] == "HostPolisher"
    assert res["workers"] == [[], []]
    assert abs(res["polished"] - gold) <= 1e-8
    assert abs(res["raw"] - gold) > abs(res["polished"] - gold)
    assert res["grad_finite"] and res["build_dir"] == cache


_TRAINING = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["metalquicha_tpu"] = None
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.getcwd(), "tools"))
sys.path.insert(0, os.getcwd())
import fit_gfn1_torch, fit_gfn2_w1_torch, fit_solvation_torch, h100_accuracy
import bench_torch
fit_gfn1_torch.main(["--targets", "h3o", "--iters", "0", "--device", "cpu",
                     "--out", sys.argv[1]])
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "metalquicha_tpu"))
with open(sys.argv[1]) as fh:
    print(json.dumps({"loaded": loaded,
                      "residual": json.load(fh)["residuals"]["h3o"]}))
"""


def test_training_programs_run_without_jax_package(tmp_path):
    """The fit and accuracy scripts and bench_torch.py import with jax and
    the JAX package unimportable, and the GFN1 fit evaluates its h3o target (against the
    JAX script's frozen value, tests/data/port_golden_fit_tools.json)."""
    with open(os.path.join(REPO, "tests", "data",
                           "port_golden_fit_tools.json")) as fh:
        gold = json.load(fh)["targets"]["h3o"]["value"]
    proc = subprocess.run(
        [sys.executable, "-c", _TRAINING, str(tmp_path / "fit.json")],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert abs(res["residual"] - (gold + 5.773131213617977)) <= 1e-10


def _cfg():
    return read_mqc_file(PRISM)


ENTRY_POINTS = {
    "XtbCalculator": lambda: XtbCalculator(),
    "FragmentExecutor": lambda: FragmentExecutor(),
    "create_calculator": lambda: create_calculator(config_to_driver(_cfg())),
    "make_executor": lambda: make_executor(_cfg()),
    "run_calculation": lambda: run_calculation(_cfg(), write_json=False),
    "run_file": lambda: run_file(PRISM, write_json=False),
    "cli": lambda: cli_main([PRISM]),
    "cli[f32]": lambda: cli_main([PRISM, "--f32", "--no-polish"]),
    "run_calculation[f32]": lambda: run_calculation(
        _cfg(), write_json=False, driver_overrides={"force_dtype": "f32"}),
    "fragment_mesh": lambda: fragment_mesh(),
    "theta_init": lambda: theta_init("gfn2"),
    "FragmentSpec": lambda: FragmentSpec([8, 1, 1], np.eye(3), 0, 1),
    "XtbCalculator[gfn2]": lambda: XtbCalculator(variant="gfn2"),
    "run_file[gfn2]": lambda: run_file(GFN2_W1, write_json=False),
    "cli[gfn2]": lambda: cli_main([GFN2_W1]),
    "bench_torch": lambda: bench_torch.main([]),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_asks_for_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry]()


def test_cpu_when_asked():
    assert XtbCalculator(device="cpu").device == torch.device("cpu")
    ex = make_executor(_cfg(), device="cpu")
    assert ex.calc.device == torch.device("cpu")


def test_default_path_is_one_device_f64_without_polisher():
    """What earlier goldens were taken with: the factory's executor has a
    one-device mesh, a float64 calculator and no polisher, and bench's
    first dimers and w20 MBE(2) list land on the same digits as before."""
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)
    ex = make_executor(_cfg(), device="cpu")
    assert ex.calc.dtype == torch.float64 and ex.polisher is None
    assert ex.rescue_tol is None and ex.n_devices == 1
    assert ex.mesh.flat == [torch.device("cpu")]
    out = run_calculation(_cfg(), write_json=False, executor=ex)
    assert abs(out[""].result.total_energy
               - golden["driver"]["prism_mbe"]["total_energy"]) <= 1e-9

    settings = settings_from_params("gfn1", max_scf_iter=32,
                                    use_pallas_eigh=True)
    ex = FragmentExecutor(XtbCalculator(settings, device="cpu"))
    gd = golden["bench_dimers"]
    e, g, _ = ex.run(bench_dimers(gd["n"]), what="gradient")
    assert np.abs(e - gd["energies"]).max() <= 1e-9
    assert np.abs(np.stack(g) - gd["gradients"]).max() <= 1e-8
    # the whole list on the exact in-loop route (the plain Jacobi version
    # takes half a minute for it on the CPU)
    ex.calc.settings = settings._replace(use_pallas_eigh=False)
    e, g, _ = ex.run(w20_mbe2_fragments(), what="gradient")
    total, _gnorm = w20_mbe2_assemble(e, g)
    assert abs(total - golden["w20_mbe2"]["total"]) <= 1e-8


def test_compile_cache_directs_the_build_directory(tmp_path, monkeypatch):
    """`enable`: an explicit path, MQC_COMPILE_CACHE, the package's
    `_build/` by default, and "0" for a fresh temporary directory."""
    default = kernel_build.BUILD_DIR
    monkeypatch.setattr(kernel_build, "BUILD_DIR", default)
    monkeypatch.delenv("MQC_COMPILE_CACHE", raising=False)
    assert str(default) == compile_cache._DEFAULT
    assert os.path.basename(compile_cache._DEFAULT) == "_build"
    compile_cache.enable(str(tmp_path / "a"))
    assert str(kernel_build.BUILD_DIR) == str(tmp_path / "a")
    monkeypatch.setenv("MQC_COMPILE_CACHE", str(tmp_path / "b"))
    compile_cache.enable()
    assert str(kernel_build.BUILD_DIR) == str(tmp_path / "b")
    assert not (tmp_path / "b").exists()  # made by the build, not before
    monkeypatch.setenv("MQC_COMPILE_CACHE", "0")
    compile_cache.enable()
    fresh = kernel_build.BUILD_DIR
    assert fresh.is_dir() and not any(fresh.iterdir())
    assert str(fresh) not in (compile_cache._DEFAULT, str(tmp_path / "b"))
    compile_cache.enable()
    assert kernel_build.BUILD_DIR != fresh  # one per call, none shared
    monkeypatch.delenv("MQC_COMPILE_CACHE")
    compile_cache.enable()
    assert str(kernel_build.BUILD_DIR) == compile_cache._DEFAULT
