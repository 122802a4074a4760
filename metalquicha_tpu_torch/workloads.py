"""The fragment batches `bench.py` and `__graft_entry__.py` drive, rebuilt
without jax.

`bench_dimers` is bench.py's water-dimer batch (seed 0; 6 atoms and 16 AOs
per dimer) and `w20_mbe2_fragments` its 20-water MBE(2) fragment list
(20 monomers, then the 190 dimers in (a, b) order, a < b).
`water_fragments` is `__graft_entry__`'s row of jittered waters (seed 0),
`trimer_mbe2_fragments` / `trimer_mbe2_assemble` its water-trimer MBE(2)
set (the multi-device dry run's workload) and `entry` the counterpart of
its `entry()`. Fragments are (numbers, coords_bohr, charge, multiplicity)
tuples.
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
    return dimers_from(np.random.default_rng(seed), n)


def dimers_from(rng, n: int) -> list:
    """n dimers of bench.py's `dimer(i)`, drawn from `rng` in its order
    (bench.py draws its gradient batch from the generator its energy
    batch and eigensolver inputs advanced)."""
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


def water_fragments(n_frag: int, seed: int = 0) -> list:
    """n_frag waters 6 Bohr apart along x, each shifted by a seeded jitter
    (the same generator and draws as `__graft_entry__._water_fragments`)."""
    rng = np.random.default_rng(seed)
    frags = []
    for i in range(n_frag):
        shift = rng.normal(0.0, 0.05, size=(1, 3)) + np.array([[6.0 * i, 0, 0]])
        frags.append((np.array([8, 1, 1]), WATER_BOHR + shift, 0, 1))
    return frags


_TRIMER_PAIRS = ((0, 1), (0, 2), (1, 2))
#: each monomer sits in 2 dimers: weight 1 - 2 = -1
_TRIMER_WEIGHTS = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)


def trimer_mbe2_fragments(atom_jitter: float = 0.0, seed: int = 1) -> list:
    """MBE(2) over a water trimer: 3 monomers, then the 3 dimers. The
    monomers share one internal geometry, so the dimers have exactly
    degenerate cross-monomer spectra (where the reference gradient depends
    on the eigenvector gauge at the 1e-7 level); atom_jitter > 0 moves
    every atom by a seeded normal draw of that width (Bohr) and lifts the
    degeneracy."""
    waters = water_fragments(3)
    if atom_jitter:
        rng = np.random.default_rng(seed)
        waters = [(z, c + rng.normal(0.0, atom_jitter, c.shape), q, m)
                  for z, c, q, m in waters]
    dimers = [
        (np.concatenate([waters[a][0], waters[b][0]]),
         np.vstack([waters[a][1], waters[b][1]]), 0, 1)
        for a, b in _TRIMER_PAIRS
    ]
    return waters + dimers


def trimer_mbe2_assemble(energies, gradients):
    """(MBE(2) total, (9, 3) system gradient) of the trimer set."""
    total = float(sum(w * e for w, e in zip(_TRIMER_WEIGHTS, energies)))
    g_sys = np.zeros((9, 3))
    for k, (w, g) in enumerate(zip(_TRIMER_WEIGHTS, gradients)):
        g = np.asarray(g)
        if k < 3:
            g_sys[3 * k : 3 * k + 3] += w * g
        else:
            a, b = _TRIMER_PAIRS[k - 3]
            g_sys[3 * a : 3 * a + 3] += w * g[:3]
            g_sys[3 * b : 3 * b + 3] += w * g[3:]
    return total, g_sys


def entry(device="cuda"):
    """(fn, example_args): the batched single point of four waters,
    fn(coords, frag) -> summed energy, as `__graft_entry__.entry` gives
    it for the JAX package."""
    from .methods.xtb.calculator import XtbCalculator, single_point_energy

    calc = XtbCalculator(device=device)
    frag = calc.make_batch(water_fragments(4))

    def fn(coords, frag_data):
        e, _aux = single_point_energy(coords, frag_data, calc.settings)
        return e.sum()

    return fn, (frag.coords, frag)
