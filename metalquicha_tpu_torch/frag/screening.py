"""Distance-based fragment screening with subset closure.

An n-mer is dropped when its own minimum inter-monomer distance OR that of
any of its k-subsets (k >= 2) exceeds the per-level cutoff — this preserves
the MBE subset-closure invariant required by the delta assembly
(upstream metalquicha src/fragmentation/common/mqc_frag_utils.f90:63-192).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

from ..geometry import SystemGeometry, min_inter_monomer_distance


def _pairwise_monomer_distances(sys_geom: SystemGeometry) -> np.ndarray:
    """(M, M) min atom-atom distance between monomers, in Angstrom."""
    from ..constants import BOHR_TO_ANGSTROM

    M = sys_geom.n_monomers
    out = np.zeros((M, M))
    coords = [sys_geom.coords[a] for a in sys_geom.fragment_atoms]
    for i in range(M):
        for j in range(i + 1, M):
            d = np.sqrt(
                ((coords[i][:, None, :] - coords[j][None, :, :]) ** 2).sum(-1)
            ).min()
            out[i, j] = out[j, i] = d * BOHR_TO_ANGSTROM
    return out


def subset_min_distance(pair_dist: np.ndarray, monomers) -> float:
    """Min inter-monomer distance of a monomer set (Angstrom; 0 for 1-mers)."""
    monomers = list(monomers)
    if len(monomers) < 2:
        return 0.0
    best = np.inf
    for a in range(len(monomers)):
        for b in range(a + 1, len(monomers)):
            best = min(best, pair_dist[monomers[a], monomers[b]])
    return float(best)


def apply_distance_screening(
    polymers: np.ndarray,
    sys_geom: SystemGeometry,
    cutoffs: dict,
) -> np.ndarray:
    """Filter the polymer table by per-level distance cutoffs (Angstrom).

    cutoffs: {level: max_distance}. Levels without a cutoff are kept.
    Returns the compacted polymer table (same column width).
    """
    if not cutoffs or polymers.shape[0] == 0:
        return polymers
    pair_dist = _pairwise_monomer_distances(sys_geom)
    keep = np.ones(polymers.shape[0], dtype=bool)
    for i, row in enumerate(polymers):
        mono = [int(x) for x in row[row >= 0]]
        n = len(mono)
        if n < 2:
            continue
        # check the n-mer itself and every k-subset (k >= 2) against the
        # cutoff for its own level
        dropped = False
        for k in range(2, n + 1):
            cutoff = cutoffs.get(k)
            if cutoff is None:
                continue
            for combo in combinations(mono, k):
                if subset_min_distance(pair_dist, combo) > cutoff:
                    dropped = True
                    break
            if dropped:
                break
        keep[i] = not dropped
    return polymers[keep]


def distances_for_polymers(polymers: np.ndarray, sys_geom: SystemGeometry):
    """Min inter-monomer distance per polymer row (Angstrom)."""
    return np.array(
        [
            min_inter_monomer_distance(sys_geom, row[row >= 0])
            for row in polymers
        ]
    )


def sort_fragments_by_size(polymers: np.ndarray) -> np.ndarray:
    """Sort by level descending (load balancing; assembly is order-free)."""
    levels = (polymers >= 0).sum(axis=1)
    order = np.argsort(-levels, kind="stable")
    return polymers[order]
