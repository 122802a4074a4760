"""No module that a run loads is JAX or the JAX package, compared by
top-level name (`metalquicha_tpu_torch` is not `metalquicha_tpu`); the
reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "metalquicha_tpu"}


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, env=env, cwd=spec.ROOT, timeout=600,
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import torch
torch.set_num_threads(2)
import benchmark.run, benchmark.control
from benchmark.harness import cell, spec
from benchmark.tests._small import small_cell
import pathlib
for m in ("graph_miss_share", "scc_iters_per_step", "roofline.eigh",
          "roofline.fermi_density", "device_idle_share"):
    spec.metric_reader(m)
result = cell.run_cell(small_cell(pathlib.Path({str(tmp_path)!r}), waters=3),
                       2**31 + 7, 0.1, True, "cpu")
assert result["correct"], result
"""
    loaded = _loaded(code)
    assert "metalquicha_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import benchmark.reference.xtb")
    assert not loaded & (FORBIDDEN | {"metalquicha_tpu_torch"})
    ref_dir = os.path.join(spec.BENCH_DIR, "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            with open(os.path.join(ref_dir, name), encoding="utf-8") as fh:
                src = fh.read()
            assert "import metalquicha" not in src
            assert "from metalquicha" not in src
