"""Combinatorial fragment enumeration.

Padded polymer tables: each row of `polymers` is an n-mer as monomer indices,
-1 padded (the reference pads 1-based rows with 0:
upstream metalquicha src/fragmentation/common/mqc_combinatorics.f90:89-118).
int64-safe binomials (:39-60). When available, the C++ host runtime
(native/) provides accelerated enumeration; the NumPy path is the reference
implementation and the fallback.
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np


def binomial(n: int, k: int) -> int:
    """int64-safe n choose k (exact integer arithmetic)."""
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def get_nfrags(n_monomers: int, max_level: int) -> int:
    """Total fragments for a full MBE truncated at max_level: sum C(M,k)."""
    return sum(binomial(n_monomers, k) for k in range(1, max_level + 1))


def enumerate_polymers(n_monomers: int, max_level: int) -> np.ndarray:
    """All k-subsets of monomers for k=1..max_level, padded with -1.

    Returns (F, max_level) int64 array ordered by level then lexicographic,
    matching the reference's combine() enumeration order. Uses the C++ host
    runtime when available.
    """
    from .. import native

    if native.available() and n_monomers > 0:
        return native.enumerate_polymers(n_monomers, max_level)
    rows = []
    for k in range(1, max_level + 1):
        for combo in combinations(range(n_monomers), k):
            row = np.full(max_level, -1, dtype=np.int64)
            row[:k] = combo
            rows.append(row)
    if not rows:
        return np.zeros((0, max_level), dtype=np.int64)
    return np.stack(rows)


def polymer_levels(polymers: np.ndarray) -> np.ndarray:
    """Number of monomers in each row (level)."""
    return (polymers >= 0).sum(axis=1)


def polymer_key(row: np.ndarray) -> tuple:
    """Canonical hashable key of a polymer row (sorted monomer tuple)."""
    return tuple(sorted(int(x) for x in row[row >= 0]))


def build_lookup(polymers: np.ndarray) -> dict:
    """Monomer-set -> fragment row index map.

    Replaces the reference's FNV-1a chained hash table
    (mqc_fragment_lookup.f90:20-140) with a host-side dict; used to
    precompute dense subset-index tables for vectorized MBE assembly.
    """
    return {polymer_key(row): i for i, row in enumerate(polymers)}


def subset_index_table(polymers: np.ndarray):
    """For each fragment, the row indices of all its proper non-empty subsets.

    Returns (subsets, counts): subsets is (F, 2^L-2) int64 padded with -1.
    Fails loudly if the family is not subset-closed (the screening invariant,
    mqc_frag_utils.f90:133-192, guarantees closure).
    """
    lookup = build_lookup(polymers)
    F = polymers.shape[0]
    max_level = polymers.shape[1]
    width = (1 << max_level) - 2
    subsets = np.full((F, max(width, 1)), -1, dtype=np.int64)
    counts = np.zeros(F, dtype=np.int64)
    for i, row in enumerate(polymers):
        mono = [int(x) for x in row[row >= 0]]
        n = len(mono)
        k = 0
        for r in range(1, n):
            for combo in combinations(mono, r):
                idx = lookup.get(tuple(sorted(combo)))
                if idx is None:
                    raise ValueError(
                        f"subset {combo} of fragment {mono} missing: "
                        "polymer family is not subset-closed"
                    )
                subsets[i, k] = idx
                k += 1
        counts[i] = k
    return subsets, counts
