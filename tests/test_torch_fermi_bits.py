"""The Fermi kernels' bits pinned by a fingerprint
(`tests/data/fermi_bits.json`, `tools/fermi_bits_torch.py`).

The fixture holds SHA-256 fingerprints of the fill's f, entropy and steps
and of the fused fill and density's P, as the kernels before the fused
kernel's redesign and the runs of clamped steps (commit bb294ac) computed
them on a card, at the main path's shapes and odd sizes at the fused
kernel's class edges, f64 and f32, 300 K and 5000 K, on three families of
seeded inputs: mixed batches with NaN rows, gapless rows and levels
placed ulps from the clamp's margin off a mid. On the CPU each case's
inputs are made again from the tool's recipe and their hashes compared,
and the families are checked to be what they say. The `gpu` case
(`python3 -m pytest --noconftest tests/test_torch_fermi_bits.py -m gpu`)
runs this tree's kernels on a card against the same fingerprints.
"""

import os
import sys

import numpy as np
import pytest
import torch

from metalquicha_tpu_torch.ops import fermi_fill as ff

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (os.path.join(_ROOT, "tools"), _ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import fermi_bits_torch as bits  # noqa: E402

FIXTURE = bits.load_fixture()
CASES = bits.cases()
OUTPUTS = {"fill": {"inputs", "f", "entropy", "steps"},
           "density": {"inputs", "P"}}


def test_fixture_covers_every_case():
    import chip_smoke

    assert FIXTURE["seed"] == bits.SEED and FIXTURE["recipe"] == bits.RECIPE
    assert set(FIXTURE["cases"]) == {c[0] for c in CASES}
    assert len(CASES) == (len(bits.FILL) + len(bits.DENSITY)) * len(
        bits.FAMILIES) * len(bits.DTYPES) * len(bits.KELVIN)
    for key, entry, *_ in CASES:
        assert set(FIXTURE["cases"][key]) == OUTPUTS[entry], key
    # chip_smoke.py's shapes, every class of the fused kernel and odd sizes
    assert bits.FILL == chip_smoke.FERMI_SHAPES
    assert set(chip_smoke.DENSITY_SHAPES) <= set(bits.DENSITY)
    assert {ff.density_class(n) for _, n in bits.DENSITY} == {16, 32, 64}
    assert {n % 2 for _, n in bits.DENSITY if n > 32} == {0, 1}
    from metalquicha_tpu_torch.constants import KB_HARTREE

    assert bits.KB_HARTREE == KB_HARTREE


@pytest.mark.parametrize("key, entry, family, dtype, kelvin, shape", CASES,
                         ids=[c[0] for c in CASES])
def test_recipe_remakes_the_hashed_inputs(key, entry, family, dtype, kelvin,
                                          shape):
    arrays = bits.inputs(entry, family, dtype, kelvin, shape)
    np_dtype = np.float64 if dtype == "f64" else np.float32
    assert all(a.dtype == np_dtype for a in arrays)
    assert [a.shape for a in arrays[:4]] == [shape, shape[:1], shape[:1],
                                             shape]
    assert [bits.digest(a) for a in arrays] == FIXTURE["cases"][key]["inputs"]


def _channel_rows(arrays, dtype):
    eps, nelec, nuhf, mask = (torch.from_numpy(a) for a in arrays[:4])
    e2, n_ch, mask2 = ff._channels(eps, nelec, nuhf, mask)
    return torch.where(mask2 > 0.5, e2, 1.0e3), n_ch, mask2


@pytest.mark.parametrize("dtype", bits.DTYPES)
def test_margin_rows_sit_on_the_margin(dtype):
    """At 300 K the margin family's rows put a level d ulps from the clamp's
    margin off the first mid (exactly 0: kind 0) and off the fourth mid of
    a run of clamped steps (kinds 1 and 2): the plain trace skips a step
    fewer where the run's nearest level is one ulp inside the margin than
    where it sits on it (on average over the rows: later runs add their
    own)."""
    arrays = bits.inputs("fill", "margin", dtype, 300, (512, 16))
    kt = 300 * bits.KB_HARTREE
    e, n_ch, mask = _channel_rows(arrays, dtype)
    lo, hi, steps, full = ff._bisect_skipping(e, n_ch, kt, mask)
    skipped = (steps - full)[:512].numpy()
    r = np.arange(512)
    kind, d = r % 3, (r // 3) % 7 - 3
    m_hi, m_lo = (float(m) for m in ff.clamp_margins(kt, e.dtype))
    np_dtype = np.float64 if dtype == "f64" else np.float32
    assert m_hi == float(bits.clamp_margin(kt, np_dtype, 1))
    assert m_lo == float(bits.clamp_margin(kt, np_dtype, -1))
    for k in (1, 2):
        for on, inside in ((0, -1), (1, -2), (2, -3)):
            assert (skipped[(kind == k) & (d == on)].mean()
                    >= skipped[(kind == k) & (d == inside)].mean() + 0.5)
    # kind 0: the first step's levels at the margin (mid_1 exactly 0)
    ulps = 3 * np.spacing(np_dtype(m_hi))
    for r in np.flatnonzero(kind == 0):
        real = arrays[0][r][arrays[3][r] > 0.5]
        assert np.abs(real - m_hi).min() <= ulps
        assert np.abs(real + m_lo).min() <= ulps


@pytest.mark.parametrize("dtype", bits.DTYPES)
def test_gapless_and_mixed_rows(dtype):
    """The gapless family's levels lie within 20 kT of 0, so within 60 kT
    of mu; the mixed family has a NaN level and a NaN electron count, and
    both shells."""
    kt = 300 * bits.KB_HARTREE
    eps, nelec, nuhf, mask = bits.inputs("fill", "gapless", dtype, 300,
                                         (190, 16))
    assert (np.abs(eps[mask > 0.5]) <= 20 * kt * (1 + 1e-6)).all()
    eps, nelec, nuhf, mask = bits.inputs("fill", "mixed", dtype, 300,
                                         (190, 16))
    assert np.isnan(eps).sum() == 1 and np.isnan(nelec).sum() == 1
    assert set(nuhf) == {0.0, 1.0, 2.0}


@pytest.mark.gpu
def test_kernel_bits_match_the_fingerprint():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    ff.build()
    assert bits.compare(ff, FIXTURE) == []
