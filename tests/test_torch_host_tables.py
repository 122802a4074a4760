"""The torch port's own host layer against the JAX package's.

The port carries its own copies of `params_gfn1`, `batch` and the NumPy
half of `dispersion_d3`. Every derived array must be exactly equal: all
XtbBatch fields, the D3 tables, the FragmentData the calculator builds,
and the engine settings. The package must import and run one CPU energy
with jax and the JAX package made unimportable, and no module of it, nor
chip_smoke.py, may import either.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_port_common import (
    GLY3_FRAG,
    HALOGEN,
    REPO,
    WATER,
    restore_jax_overlay,
)

from metalquicha_tpu.methods.xtb import batch as jbatch
from metalquicha_tpu.methods.xtb import dispersion_d3 as jd3
from metalquicha_tpu.methods.xtb.calculator import (
    fragment_data_from_batch as jax_fragment_data_from_batch,
)
from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp
from metalquicha_tpu_torch.methods.xtb import batch as tbatch
from metalquicha_tpu_torch.methods.xtb import dispersion_d3 as td3
from metalquicha_tpu_torch.methods.xtb.calculator import (
    fragment_data_from_batch as port_fragment_data_from_batch,
)
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp

torch.set_num_threads(1)
PKG = os.path.join(REPO, "metalquicha_tpu_torch")


def _overlay_elements():
    from metalquicha_tpu.methods.xtb import params_gfn1

    with open(params_gfn1._OVERLAY_PATH) as fh:
        return sorted(int(z) for z in json.load(fh).get("elements", {}))


def _fragments():
    """One single-atom fragment per element of the fitted overlay, and the
    molecules of the parity tests (with a halogen-bond donor/acceptor
    pair, Br ... N)."""
    atoms = [(np.array([z]), np.zeros((1, 3)), 0, 1 + (z % 2))
             for z in _overlay_elements()]
    return atoms + [WATER, GLY3_FRAG, HALOGEN]


@pytest.fixture(scope="module", autouse=True)
def _jax_tables():
    restore_jax_overlay()


def test_overlay_covers_elements():
    assert len(_overlay_elements()) >= 4


@pytest.mark.parametrize("pad_to", [None, (12, 24, 31)])
def test_batch_fields_equal(pad_to):
    frags = _fragments()
    jb = jbatch.build_batch(frags, pad_to=pad_to)
    tb = tbatch.build_batch(frags, pad_to=pad_to)
    for name in jb.__dataclass_fields__:
        a, b = getattr(jb, name), getattr(tb, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def test_d3_tables_equal():
    assert np.array_equal(td3.full_pair_table(), jd3.full_pair_table())
    for numbers, *_ in _fragments():
        jt = jd3.build_d3_tables(numbers)
        tt = td3.build_d3_tables(numbers)
        for key in jt:
            assert np.array_equal(jt[key], tt[key]), key


def test_fragment_data_equal():
    frags = _fragments()
    jf = jax_fragment_data_from_batch(jbatch.build_batch(frags))
    tf = port_fragment_data_from_batch(tbatch.build_batch(frags), "cpu")
    assert tf._fields == jf._fields
    for name in jf._fields:
        a, b = np.asarray(getattr(jf, name)), getattr(tf, name).numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_settings_equal():
    js, ts = jsp("gfn1"), tsp("gfn1")
    assert ts._fields == js._fields
    assert ts._asdict() == js._asdict()


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "run_validation_torch.py")
    for root, _dirs, files in os.walk(PKG):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax():
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif (isinstance(node, ast.ImportFrom) and node.module
                  and node.level == 0):
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "metalquicha_tpu"), (
                    path, name)


def test_imports_and_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['metalquicha_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import metalquicha_tpu_torch.__main__, metalquicha_tpu_torch.driver\n"
        "from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator\n"
        "from metalquicha_tpu_torch.workloads import WATER_BOHR\n"
        "import numpy as np\n"
        "calc = XtbCalculator(device='cpu')\n"
        "e, aux = calc.energies(calc.make_batch(\n"
        "    [(np.array([8, 1, 1]), WATER_BOHR, 0, 1)]))\n"
        "print(repr(float(e[0])))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator

    calc = XtbCalculator(device="cpu")
    e, _ = calc.energies(calc.make_batch([WATER]))
    assert float(proc.stdout.strip().splitlines()[-1]) == float(e[0])
