"""The bits of the fragment sums `moment_fock`, `moment_rows`,
`segment_sum` and `fragment_sum` pinned by a fingerprint
(`tests/data/fragment_reduce_bits.json`, `tools/reduce_bits_torch.py`).

The fixture holds SHA-256 fingerprints of the plain versions in the
kernel's order (`ops/fragment_reduce.py` `moment_rows_reference`,
`segment_sum_reference`) as the commit before the kernel's redesign
computed them on the CPU, and of `moment_fock_reference` and
`moment_contract_reference` as the commit before moment_fock's redesign
(759462b) computed them, in every form the main path calls: moment_fock
with the dipoles and quadrupoles, with the dipoles alone, and without the
symmetrisation at d = 6 (moment_rows' backward); moment_rows
with one plane and a mask, d = 3 and 6 into segments, without an index and
with an unsorted index; segment_sum of 1 (masked), 3, 6 and n values an
entry and with an unsorted index; at (B, n) = (4, 16), (2, 48), (1, 97) in
float64 and float32. The kernel equals these plain versions bit for bit on
a card, so the order of every sum is fixed here: a schedule that moved it
would show. Under "row_sums", `row_sum_reference` (fragment_sum's order)
of rows of 11 to 55296 elements in float64 and float32, one row of -0.0
among them, as the commit before fragment_sum's redesign computed it.

On the CPU each case is recomputed from the tool's recipe and its hash
compared; the inputs' hashes hold the recipe itself. The `gpu` case
(`python3 -m pytest --noconftest tests/test_torch_reduce_bits.py -m gpu`)
runs the ops on a card, so the kernel, against the same fingerprints.
"""

import os
import sys

import pytest
import torch

from metalquicha_tpu_torch.ops import fragment_reduce as fr

torch.set_num_threads(1)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import reduce_bits_torch as bits  # noqa: E402

FIXTURE = bits.load_fixture()
CASES = bits.cases()
ROW_CASES = bits.row_cases()


def test_fixture_covers_every_case():
    assert FIXTURE["seed"] == bits.SEED and FIXTURE["recipe"] == bits.RECIPE
    assert FIXTURE["inputs_order"] == list(bits.INPUTS)
    assert set(FIXTURE["cases"]) == {c[0] for c in CASES}
    assert len(CASES) == len(bits.SHAPES) * len(bits.DTYPES) * len(bits.FORMS)
    rows = FIXTURE["row_sums"]
    assert rows["recipe"] == bits.ROW_RECIPE
    assert set(rows["cases"]) == set(rows["inputs"]) == {
        c[0] for c in ROW_CASES}
    assert len(ROW_CASES) == len(bits.ROW_LENGTHS) * len(bits.DTYPES)
    # short and long rows on both sides of the warp's longest
    assert min(bits.ROW_LENGTHS) <= 16 and max(bits.ROW_LENGTHS) > 4097
    assert {fr.lanes_of(n) for n in bits.ROW_LENGTHS} == {
        fr.WARP_LANES, fr.BLOCK_LANES}


@pytest.mark.parametrize("dtype", bits.DTYPES)
@pytest.mark.parametrize("shape", bits.SHAPES)
def test_recipe_remakes_the_hashed_inputs(shape, dtype):
    arrays = bits.inputs(dtype, shape)
    key = f"{dtype}/{'x'.join(map(str, shape))}"
    assert [bits.digest(arrays[k]) for k in bits.INPUTS] == (
        FIXTURE["inputs"][key])
    size = max(1, shape[1] // 3)
    assert arrays["idx"].max() < size and arrays["idx"].min() >= 0
    # the unsorted index holds the same entries, not in runs
    assert (sorted(arrays["mixed"].ravel()) == sorted(arrays["idx"].ravel()))
    assert (arrays["mixed"] != arrays["idx"]).any()


@pytest.mark.parametrize("key, form, dtype, shape", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_version_bits_match_the_fingerprint(key, form, dtype, shape):
    got = bits.run(fr, form, bits.inputs(dtype, shape))
    assert got.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    assert bits.digest(got.contiguous().numpy()) == FIXTURE["cases"][key]


@pytest.mark.parametrize("key, dtype, length", ROW_CASES,
                         ids=[c[0] for c in ROW_CASES])
def test_row_sum_bits_match_the_fingerprint(key, dtype, length):
    x = bits.row_inputs(dtype, length)
    assert x.shape == (bits.ROW_COUNT, length)
    assert bits.digest(x) == FIXTURE["row_sums"]["inputs"][key]
    got = fr.row_sum_reference(torch.from_numpy(x))
    assert bits.digest(got.contiguous().numpy()) == (
        FIXTURE["row_sums"]["cases"][key])
    # the row of -0.0 (exact sum -0.0) sums to +0.0 in the lanes' order
    assert float(got[1]) == 0.0 and not bool(torch.signbit(got[1]))
    # the public op on a CPU tensor is torch's sum, the engine's expression
    assert torch.equal(fr.fragment_sum(torch.from_numpy(x)),
                       torch.from_numpy(x).sum(-1))


@pytest.mark.gpu
def test_kernel_bits_match_the_fingerprint():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    got = bits.fingerprints(fr, "cuda", plain=False)
    assert got["cases"] == FIXTURE["cases"]
    rows = bits.row_fingerprints(fr, "cuda", plain=False)
    assert rows["cases"] == FIXTURE["row_sums"]["cases"]
