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
    yield os.path.join(REPO, "bench_torch.py")
    for tool in ("run_validation_torch", "fit_gfn1_torch",
                 "fit_gfn2_w1_torch", "fit_solvation_torch", "h100_accuracy",
                 "c17_probe_torch", "gemm_bits_torch", "kernel_times_torch",
                 "fermi_bits_torch", "fermi_variants_torch"):
        yield os.path.join(REPO, "tools", tool + ".py")
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


# ---------------------------------------------------------------------------
# GFN2: its own element table, the pristine dispersion state, its batches
# ---------------------------------------------------------------------------


def _gfn2_modules():
    from metalquicha_tpu.methods.xtb import params_gfn2 as jp2
    from metalquicha_tpu_torch.methods.xtb import params_gfn2 as tp2

    return jp2, tp2


def test_gfn2_params_equal():
    """Elements, globals, radii and pair scalings after the overlay."""
    import dataclasses

    jp2, tp2 = _gfn2_modules()
    assert sorted(tp2.ELEMENTS) == sorted(jp2.ELEMENTS)
    for z, rec in jp2.ELEMENTS.items():
        assert dataclasses.asdict(tp2.ELEMENTS[z]) == dataclasses.asdict(rec), z
    assert vars(tp2.GLOBALS) == vars(jp2.GLOBALS)
    assert tp2.GLOBALS.multipoles
    assert np.array_equal(tp2.ATOMIC_RADII_A, jp2.ATOMIC_RADII_A)
    assert np.array_equal(tp2.COVALENT_RADII_A, jp2.COVALENT_RADII_A)
    assert tp2.KPAIR == jp2.KPAIR


def test_pristine_snapshots_equal():
    import dataclasses

    from metalquicha_tpu.methods.xtb import params_gfn1 as jp1
    from metalquicha_tpu_torch.methods.xtb import params_gfn1 as tp1

    assert sorted(tp1.PRISTINE_ELEMENTS) == sorted(jp1.PRISTINE_ELEMENTS)
    for z, rec in jp1.PRISTINE_ELEMENTS.items():
        assert (dataclasses.asdict(tp1.PRISTINE_ELEMENTS[z])
                == dataclasses.asdict(rec)), z
    assert np.array_equal(tp1.PRISTINE_ATOMIC_RADII_A,
                          jp1.PRISTINE_ATOMIC_RADII_A)
    assert np.array_equal(tp1.PRISTINE_COVALENT_RADII_A,
                          jp1.PRISTINE_COVALENT_RADII_A)
    assert td3.PRISTINE_REF_C6_DIAG == jd3.PRISTINE_REF_C6_DIAG
    assert td3.PRISTINE_R4R2 == jd3.PRISTINE_R4R2
    # the snapshot was taken before the overlay: it differs from the
    # fitted state for at least one element of the overlay
    assert any(td3.PRISTINE_REF_C6_DIAG[z] != td3.REF_C6_DIAG[z]
               or td3.PRISTINE_R4R2[z] != td3.R4R2[z]
               for z in _overlay_elements())


def test_gfn2_d3_tables_equal():
    """fitted=False: the pure geometric-mean table of the pristine
    diagonal, cached apart from the fitted one."""
    assert np.array_equal(td3.full_pair_table(fitted=False),
                          jd3.full_pair_table(fitted=False))
    assert not np.array_equal(td3.full_pair_table(fitted=False),
                              td3.full_pair_table(fitted=True))
    for numbers, *_ in _fragments():
        jt = jd3.build_d3_tables(numbers, fitted=False)
        tt = td3.build_d3_tables(numbers, fitted=False)
        for key in jt:
            assert np.array_equal(jt[key], tt[key]), key


def test_gfn1_tables_unchanged_by_loading_gfn2():
    _gfn2_modules()
    test_d3_tables_equal()
    from metalquicha_tpu.methods.xtb import params_gfn1 as jp1
    from metalquicha_tpu_torch.methods.xtb import params_gfn1 as tp1
    import dataclasses

    for z, rec in jp1.ELEMENTS.items():
        assert dataclasses.asdict(tp1.ELEMENTS[z]) == dataclasses.asdict(rec), z


@pytest.mark.parametrize("pad_to", [None, (12, 24, 31)])
def test_gfn2_batch_fields_equal(pad_to):
    frags = _fragments()
    jb = jbatch.build_batch(frags, variant="gfn2", pad_to=pad_to)
    tb = tbatch.build_batch(frags, variant="gfn2", pad_to=pad_to)
    for name in jb.__dataclass_fields__:
        a, b = getattr(jb, name), getattr(tb, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert np.abs(tb.at_aes).sum() > 0
    assert not np.array_equal(
        tb.glb, tbatch.build_batch(frags, pad_to=pad_to).glb)


def test_gfn2_fragment_data_equal():
    frags = _fragments()
    jf = jax_fragment_data_from_batch(
        jbatch.build_batch(frags, variant="gfn2"), variant="gfn2")
    tf = port_fragment_data_from_batch(
        tbatch.build_batch(frags, variant="gfn2"), "cpu", variant="gfn2")
    for name in jf._fields:
        a, b = np.asarray(getattr(jf, name)), getattr(tf, name).numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_gfn2_settings_equal():
    js, ts = jsp("gfn2"), tsp("gfn2")
    assert ts._asdict() == js._asdict()
    assert ts.multipoles and not tsp("gfn1").multipoles


def test_gfn2_overlay_clears_both_caches():
    """`load_overlay` finds the port's own dispersion_d3 and batch modules
    through `__package__` and clears their caches."""
    _jp2, tp2 = _gfn2_modules()
    assert tp2.__package__ == "metalquicha_tpu_torch.methods.xtb"
    tbatch.element_basis(8, "gfn2")
    td3.full_pair_table(fitted=False)
    td3.build_d3_tables(np.array([8, 1]), fitted=False)
    assert tbatch.element_basis.cache_info().currsize > 0
    assert td3.full_pair_table.cache_info().currsize > 0
    assert td3._element_ref_arrays.cache_info().currsize > 0
    tp2.load_overlay(tp2._OVERLAY_PATH)  # idempotent
    assert tbatch.element_basis.cache_info().currsize == 0
    assert td3.full_pair_table.cache_info().currsize == 0
    assert td3._element_ref_arrays.cache_info().currsize == 0
    test_gfn2_params_equal()


def test_gfn2_overlay_missing_file_raises():
    _jp2, tp2 = _gfn2_modules()
    with pytest.raises(FileNotFoundError):
        tp2.load_overlay(os.path.join(REPO, "no_such_overlay.json"))
    proc = subprocess.run(
        [sys.executable, "-c",
         "from metalquicha_tpu_torch.methods.xtb import params_gfn2 as p\n"
         "print(p.ELEMENTS[8].mrad, p.KPAIR)"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, MQC_NO_OVERLAY="1"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["3.0", "{}"]
