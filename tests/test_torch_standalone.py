"""The port stands alone and runs on the card unless asked for the CPU.

- With `jax` and `metalquicha_tpu` both unimportable, every module of the
  port imports, and the prism MBE(2) driver runs on the CPU within 1e-9 Ha
  of its golden (tests/data/port_golden_gfn1.json, from the JAX package);
- every entry point asks for CUDA by default: with no card it raises
  instead of falling back to the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from _torch_port_common import GOLDEN_PATH, REPO

from metalquicha_tpu_torch.__main__ import main as cli_main
from metalquicha_tpu_torch.driver import make_executor, run_calculation, run_file
from metalquicha_tpu_torch.io.adapter import config_to_driver
from metalquicha_tpu_torch.io.config import read_mqc_file
from metalquicha_tpu_torch.methods.factory import create_calculator
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor

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
    "XtbCalculator[gfn2]": lambda: XtbCalculator(variant="gfn2"),
    "run_file[gfn2]": lambda: run_file(GFN2_W1, write_json=False),
    "cli[gfn2]": lambda: cli_main([GFN2_W1]),
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
