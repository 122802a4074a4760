"""The fragment batches `bench.py` times, rebuilt without jax.

`bench_dimers` is bench.py's water-dimer batch (seed 0; 6 atoms and 16 AOs
per dimer) and `w20_mbe2_fragments` its 20-water MBE(2) fragment list
(20 monomers, then the 190 dimers in (a, b) order, a < b). Both return
(numbers, coords_bohr, charge, multiplicity) tuples.
"""

from __future__ import annotations

import numpy as np

from .constants import ANGSTROM_TO_BOHR

WATER_BOHR = (
    np.array([[0.0, 0.0, 0.117], [0.0, 0.757, -0.471], [0.0, -0.757, -0.471]])
    * ANGSTROM_TO_BOHR
)


def bench_dimers(n: int, seed: int = 0) -> list:
    """The first n dimers of bench.py's batch (same generator and draws)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sep = 5.5 + 0.3 * rng.random()
        c1 = WATER_BOHR + rng.normal(0, 0.05, (1, 3))
        c2 = WATER_BOHR + rng.normal(0, 0.05, (1, 3)) + np.array([[sep, 0, 0]])
        out.append((np.array([8, 1, 1, 8, 1, 1]), np.vstack([c1, c2]), 0, 1))
    return out


def w20_mbe2_fragments(jitter=np.zeros(3)) -> list:
    """bench.py's 20-water MBE(2) fragments: 20 monomers + 190 dimers."""
    centers = np.array(
        [[6.0 * (i % 5), 6.0 * ((i // 5) % 4), 6.0 * (i // 20)]
         for i in range(20)]
    )
    monos = [
        (np.array([8, 1, 1]), WATER_BOHR + centers[i] + jitter, 0, 1)
        for i in range(20)
    ]
    dims = []
    for a in range(20):
        for b in range(a + 1, 20):
            za, ca, *_ = monos[a]
            zb, cb, *_ = monos[b]
            dims.append((np.concatenate([za, zb]), np.vstack([ca, cb]), 0, 1))
    return monos + dims


def w20_mbe2_assemble(energies, gradients):
    """MBE(2) total (monomer weight 1 - 19 = -18, dimer weight 1) and the
    norm of the assembled (60, 3) gradient."""
    total = float(-18.0 * np.sum(energies[:20]) + np.sum(energies[20:]))
    g_sys = np.zeros((60, 3))
    for i in range(20):
        g_sys[3 * i : 3 * i + 3] -= 18.0 * np.asarray(gradients[i])
    k = 20
    for a in range(20):
        for b in range(a + 1, 20):
            g = np.asarray(gradients[k])
            g_sys[3 * a : 3 * a + 3] += g[:3]
            g_sys[3 * b : 3 * b + 3] += g[3:]
            k += 1
    return total, float(np.sqrt((g_sys**2).sum()))
