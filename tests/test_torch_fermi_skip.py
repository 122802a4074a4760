"""The Fermi kernels' bisection as the kernels take it, on the CPU.

`ops/fermi_fill.py` `_bisect_skipping` is the plain version of the
kernels' control flow: a step whose levels' exponents are all clamped to
+-60 is followed by the run of steps that leave its nearest levels on
their sides of the clamp's margins (`clamp_margins`), each given that
step's decision without a row sum. It must equal `_bisect(trace=True)`
bit for bit in the state at the stop and in the steps taken, in float64
and float32: on the fingerprint's families of inputs, and on rows that
hypothesis draws (levels spread, in clusters a few kT wide, repeated, at
the margin off the first mid; masks, NaN levels and electron counts, kT
from 10 K to 20000 K). Also here: the margins against their definition,
the launches counted by class of nao, and the arguments the wrapper hands
the fused kernel.
"""

import collections
import os
import sys
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from metalquicha_tpu_torch.constants import KB_HARTREE
from metalquicha_tpu_torch.ops import fermi_fill as ff
from metalquicha_tpu_torch.ops import replay_counts

torch.set_num_threads(1)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import fermi_bits_torch as bits  # noqa: E402

DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _same(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _check_rows(e, n_el, kt, mask):
    """_bisect_skipping against _bisect(trace=True) on rows e (masked AOs
    at 1e3): the state at the stop and the steps; returns the steps that
    evaluated a row sum."""
    _, _, lo_stop, hi_stop, steps = ff._bisect(e, n_el, kt, mask, trace=True)
    lo, hi, taken, full = ff._bisect_skipping(e, n_el, kt, mask)
    assert _same(lo, lo_stop) and _same(hi, hi_stop)
    assert torch.equal(taken, steps)
    assert bool((full <= taken).all()) and bool((full >= 1).all())
    return full


SMALL = [c for c in bits.cases() if c[1] == "fill" and c[5][0] <= 600]


@pytest.mark.parametrize("key, entry, family, dtype, kelvin, shape", SMALL,
                         ids=[c[0] for c in SMALL])
def test_skipping_equals_the_plain_bisection_on_the_fingerprint_inputs(
        key, entry, family, dtype, kelvin, shape):
    eps, nelec, nuhf, mask = (torch.from_numpy(a) for a in bits.inputs(
        entry, family, dtype, kelvin, shape))
    e2, n_ch, mask2 = ff._channels(eps, nelec, nuhf, mask)
    e2 = torch.where(mask2 > 0.5, e2, 1.0e3)
    full = _check_rows(e2, n_ch, kelvin * KB_HARTREE, mask2)
    _, _, steps, _ = ff._bisect_skipping(e2, n_ch, kelvin * KB_HARTREE, mask2)
    # the first steps of a gapped row are a run of clamped ones
    if family == "margin" and kelvin == 300:
        assert int((steps - full).sum()) > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kelvin", [10.0, 300.0, 5000.0, 20000.0])
def test_margins_are_the_least_clamped_differences(kelvin, dtype):
    kt = kelvin * KB_HARTREE
    hi, lo = ff.clamp_margins(kt, DTYPES[dtype])
    zero = torch.zeros_like(hi)
    assert float(hi / kt) >= 60.0 and float(-lo / kt) <= -60.0
    assert float(torch.nextafter(hi, zero) / kt) < 60.0
    assert float(-torch.nextafter(lo, zero) / kt) > -60.0
    np_dtype = np.float64 if dtype == "f64" else np.float32
    assert float(hi) == float(bits.clamp_margin(kt, np_dtype, 1))
    nan = ff.clamp_margins(-1.0, DTYPES[dtype])
    assert all(bool(torch.isnan(m)) for m in nan)


@st.composite
def rows(draw):
    """(e with masked AOs at 1e3, n_el, kt, mask, dtype) of a few rows."""
    dtype = draw(st.sampled_from(sorted(DTYPES)))
    n_rows = draw(st.integers(1, 5))
    nao = draw(st.integers(1, 20))
    kelvin = draw(st.sampled_from([10.0, 300.0, 5000.0, 20000.0])
                  | st.floats(10.0, 20000.0))
    kt = kelvin * KB_HARTREE
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    kind = draw(st.sampled_from(["spread", "cluster", "repeat", "margin"]))
    if kind == "spread":
        e = rng.uniform(-2.0, 2.0, (n_rows, nao))
    elif kind == "cluster":
        e = rng.uniform(-0.5, 0.5, (n_rows, 1)) + kt * rng.uniform(
            -80.0, 80.0, (n_rows, nao))
    elif kind == "repeat":
        e = rng.choice(rng.uniform(-1.0, 1.0, 3), (n_rows, nao))
    else:
        np_dtype = np.float64 if dtype == "f64" else np.float32
        m = bits.clamp_margin(kt, np_dtype, 1)
        top = rng.uniform(0.5, 3.0)
        e = rng.uniform(-top, top, (n_rows, nao))
        e[:, 0], e[:, -1] = -top, top
        for r in range(n_rows):
            d = int(rng.integers(-3, 4))
            j = int(rng.integers(0, nao))
            e[r, j] = float(bits._steps(np_dtype(m), d, np_dtype)) * (
                1 if rng.random() < 0.5 else -1)
    mask = (rng.random((n_rows, nao)) < 0.85).astype(float)
    if draw(st.booleans()):
        e[0, int(rng.integers(0, nao))] = np.nan
    n_el = rng.integers(0, 2 * nao + 1, n_rows) / 2.0
    if draw(st.booleans()):
        n_el[-1] = np.nan
    t = DTYPES[dtype]
    e = torch.tensor(e, dtype=t)
    mask = torch.tensor(mask, dtype=t)
    e = torch.where(mask > 0.5, e, 1.0e3)
    return e, torch.tensor(n_el, dtype=t), kt, mask


@settings(max_examples=120, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(rows())
def test_skipping_equals_the_plain_bisection_on_drawn_rows(case):
    e, n_el, kt, mask = case
    _check_rows(e, n_el, kt, mask)


@pytest.mark.parametrize("run_width", [0, ff.RUN_WIDTH])
def test_skipping_from_any_width_equals_the_plain_bisection(run_width):
    """Runs may start from any step (width 0) or only from wide brackets
    (the kernel's window): the steps are the same either way, only fewer
    of them are skipped; the window is the kernel's constant."""
    src = ff._LIB.source.read_text()
    assert f"constexpr int kRunWidth = {ff.RUN_WIDTH};" in src
    eps, nelec, nuhf, mask = (torch.from_numpy(a) for a in bits.inputs(
        "fill", "margin", "f64", 300, (190, 16)))
    e2, n_ch, mask2 = ff._channels(eps, nelec, nuhf, mask)
    e2 = torch.where(mask2 > 0.5, e2, 1.0e3)
    kt = 300 * KB_HARTREE
    steps = ff._bisect(e2, n_ch, kt, mask2, trace=True)[-1]
    _, _, taken, full = ff._bisect_skipping(e2, n_ch, kt, mask2, run_width)
    assert torch.equal(taken, steps)
    _, _, _, full_any = ff._bisect_skipping(e2, n_ch, kt, mask2, 0)
    assert bool((full_any <= full).all())
    assert int((taken - full).sum()) > 0


def test_a_nan_row_evaluates_every_step():
    e = torch.tensor([[0.1, float("nan"), 0.3], [0.1, 0.2, 0.3]],
                     dtype=torch.float64)
    mask = torch.ones_like(e)
    _, _, steps, full = ff._bisect_skipping(e, torch.tensor([1.0, 1.0],
                                            dtype=torch.float64),
                                            300 * KB_HARTREE, mask)
    assert int(steps[0]) == int(full[0]) == ff.STEPS
    assert int(steps[1]) < ff.STEPS


def test_density_launches_counted_by_class():
    """Each fused launch counts in its class of nao (16, 32, 64), outside a
    capture and in each replay of one; a worker's counts are added."""
    assert [ff.density_class(n) for n in (1, 16, 17, 32, 33, 64)] == [
        16, 16, 32, 32, 64, 64]
    before = collections.Counter(ff.density_by_class)
    fused = ff.density_launches
    ff._count(11, density=True, nao_class=32)
    with replay_counts.capturing() as tally:
        ff._count(11, density=True, nao_class=64)
    tally.replayed(11)
    tally.replayed(11)
    ff.add_launches(3, 3, {16: 3})
    assert ff.density_by_class - before == collections.Counter(
        {32: 1, 64: 2, 16: 3})
    assert ff.density_launches == fused + 6


def test_wrapper_hands_the_kernel_its_spec(monkeypatch):
    """The fused launch passes the batch, nao, the device and the stream
    after C and P (the kernel chooses its path from them alone) and
    counts the launch in its class."""
    seen = []
    lib = types.SimpleNamespace(
        mqc_fermi_density_f64=lambda *args: seen.append(args) or 0)
    monkeypatch.setattr(ff._LIB, "lib", lib)
    monkeypatch.setattr(ff, "_stream", lambda index: 5)
    eps = torch.zeros(2, 20, dtype=torch.float64)
    c = torch.zeros(2, 20, 20, dtype=torch.float64)
    rows_ = torch.zeros(2, dtype=torch.float64)
    before = ff.density_by_class[32]
    ff._launch_density(eps, c, rows_, rows_, 0.001, torch.ones_like(eps))
    assert len(seen) == 1 and seen[0][7:] == (2, 20, None, 5)
    assert len(ff._DENSITY) == len(seen[0])
    assert ff.density_by_class[32] == before + 1
