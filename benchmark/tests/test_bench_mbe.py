"""The MBE enumeration, its batches and weights."""

import itertools
import math

import numpy as np
import pytest

from benchmark.harness import spec, system


def _brute_total(energies: dict, n: int, level: int) -> float:
    """The MBE(level) total by its definition: the sum of every k-body
    increment, k <= level, each by inclusion-exclusion."""
    total = 0.0
    for k in range(1, level + 1):
        for s in itertools.combinations(range(n), k):
            total += sum((-1) ** (k - j) * energies[t]
                         for j in range(1, k + 1)
                         for t in itertools.combinations(s, j))
    return total


@pytest.mark.parametrize("n,level", [(4, 2), (5, 3), (6, 4), (7, 3)])
def test_weights_give_the_expansion(n, level):
    rng = np.random.default_rng(n * 10 + level)
    subsets = [s for k in range(1, level + 1)
               for s in itertools.combinations(range(n), k)]
    energies = {s: rng.normal() for s in subsets}
    weighted = sum(system.mbe_weight(len(s), n, level) * energies[s]
                   for s in subsets)
    assert weighted == pytest.approx(_brute_total(energies, n, level),
                                     abs=1e-9)


def test_weights_of_the_program():
    """The program's own weights (frag/mbe.py) on the w20 MBE(3) family."""
    from metalquicha_tpu_torch.frag.combinatorics import enumerate_polymers
    from metalquicha_tpu_torch.frag.mbe import mbe_weights

    polymers = enumerate_polymers(20, 3)
    k = (polymers >= 0).sum(axis=1)
    assert list(mbe_weights(polymers)) == [system.mbe_weight(int(j), 20, 3)
                                           for j in k]


@pytest.mark.parametrize("name", ["w20-gfn1.mbe4-energy"])
def test_batches_cover_every_subset_once(name):
    cell = spec.load_cell(name)
    _cfg, cluster = system.read_input(cell.config, spec.ROOT)
    batches = system.batches(cluster, cell.traffic)
    level = cell.traffic["level"]
    seen = [s for b in batches for s in b.subsets]
    assert len(seen) == len(set(seen)) == sum(
        math.comb(20, k) for k in range(1, level + 1))
    for b in batches:
        assert b.atoms.shape == (len(b.subsets), 3 * b.k)
        assert (b.atoms >= 0).all()
        for row, s in zip(b.atoms, b.subsets):
            assert list(row) == [a for m in s for a in cluster.monomers[m][0]]
    w = system.weights(batches, 20, level)
    assert w.shape == (len(seen),)


def test_traffic_that_leaves_fragments_out_is_refused():
    cell = spec.load_cell("w20-gfn1.mbe4-energy")
    _cfg, cluster = system.read_input(cell.config, spec.ROOT)
    with pytest.raises(ValueError):
        system.batches(cluster, {"batches": [[1, 20], [2, 100]]})
    with pytest.raises(ValueError):
        system.batches(cluster, {"batches": [[1, 21]]})
