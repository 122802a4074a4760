"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a small size, once for each fault an MBE step can have. (A cell on one
card has no exchange between chips to leave out.)"""

import pytest
import torch

from benchmark.harness import cell as cell_run

from ._small import small_cell

SEED = 2**31 + 11


def _stale(energies):
    """A step that returns its state unchanged: each batch's first
    answer, whatever the coordinates."""
    first = {}

    def call(frag):
        key = tuple(frag.coords.shape)
        if key not in first:
            first[key] = energies(frag)
        return first[key]
    return call


def _half(energies):
    """Half of the batch left out: its energies the mean of the rest."""
    def call(frag):
        out = energies(frag)
        e = out[0].clone()
        e[::2] = e[1::2].mean()
        return (e,) + tuple(out[1:])
    return call


def _altered(energies):
    """An answer altered where it is produced: one fragment's energy
    moved by 1e-6 Ha (0.0006 kcal/mol), and its gradient by 1e-5 Ha/Bohr
    where the call gives one."""
    def call(frag):
        out = energies(frag)
        e = out[0].clone()
        e[-1] += 1e-6
        if len(out) == 3:
            g = out[1].clone()
            g[-1, 0, 0] += 1e-5
            return e, g, out[2]
        return (e,) + tuple(out[1:])
    return call


@pytest.fixture(scope="module", params=["energy", "gradient"])
def cell(request, tmp_path_factory):
    return small_cell(tmp_path_factory.mktemp("w4"), waters=4,
                      driver=request.param)


def test_sound_run_is_correct(cell):
    result = cell_run.run_cell(cell, SEED, 0.2, False, "cpu")
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(cell.limits) | {"ref_residual",
                                                          "failed"}
    assert result["failed"] == 0 and result["attempted"] % 10 == 0
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_fault_comes_out_not_correct(cell, fault):
    result = cell_run.run_cell(cell, SEED, 0.2, False, "cpu", wrap=fault)
    assert not result["correct"], result["compared"]


def test_unconverged_fragments_are_failed(cell):
    def unconverged(energies):
        def call(frag):
            out = energies(frag)
            aux = dict(out[-1], scf_residual=torch.ones_like(out[0]))
            return tuple(out[:-1]) + (aux,)
        return call

    result = cell_run.run_cell(cell, SEED, 0.2, False, "cpu",
                               wrap=unconverged)
    assert not result["correct"] and result["failed"] == result["attempted"]
