"""Vibrational analysis: mass-weighting, trans/rot projection, frequencies,
reduced masses, force constants, IR intensities.

Numerical parity with upstream metalquicha src/vibrational/mqc_vibrational_analysis.f90:
- H_mw[i,j] = H[i,j]/sqrt(m_i m_j), masses in amu (:221-261)
- 6 mass-weighted translation/rotation vectors orthonormalized by SVD,
  P = I - D D^T, H <- P H P (:263-427)
- nu = sign(lambda) * sqrt(|lambda| * AU_TO_CM1) in cm^-1, imaginary
  reported negative (:108-118)
- reduced masses 1/sum(L^2/m) (:429-476); k = lambda * mu in mdyne/A
  (:478-517); IR intensities AU_TO_KMMOL * |sum dipd . L/sqrt(m*AMU)|^2
  (:581-636). All 3N modes are reported (near-zero ones included).
"""

from __future__ import annotations

import numpy as np

from ..constants import AMU_TO_AU, AU_TO_CM1, AU_TO_KMMOL, AU_TO_MDYNE_ANG
from ..elements import masses_for
from ..results import VibrationalResult


def _trans_rot_basis(coords: np.ndarray, masses: np.ndarray) -> np.ndarray:
    """Orthonormal mass-weighted translation+rotation vectors, (3N, k<=6)."""
    n = coords.shape[0]
    sq = np.sqrt(masses)
    com = (masses[:, None] * coords).sum(0) / masses.sum()
    r = coords - com

    vecs = []
    for d in range(3):  # translations
        v = np.zeros((n, 3))
        v[:, d] = sq
        vecs.append(v.ravel())
    axes = np.eye(3)
    for d in range(3):  # rotations: sqrt(m) * (r x e_d)
        v = np.cross(r, axes[d][None, :]) * sq[:, None]
        vecs.append(v.ravel())
    D = np.stack(vecs, axis=1)  # (3N, 6)

    # Orthonormalize, dropping null directions (linear molecules)
    u, s, _ = np.linalg.svd(D, full_matrices=False)
    keep = s > 1e-8 * s.max()
    return u[:, keep]


def compute_vibrational_analysis(
    hessian: np.ndarray,
    numbers: np.ndarray,
    coords: np.ndarray,
    dipole_derivatives: np.ndarray = None,
    project: bool = True,
) -> VibrationalResult:
    """Full normal-mode analysis of a (3N, 3N) Cartesian Hessian (a.u.)."""
    n = len(numbers)
    masses = masses_for(numbers)  # amu
    sq = np.sqrt(np.repeat(masses, 3))
    h_mw = hessian / (sq[:, None] * sq[None, :])

    if project:
        D = _trans_rot_basis(coords, masses)
        P = np.eye(3 * n) - D @ D.T
        h_mw = P @ h_mw @ P

    h_mw = 0.5 * (h_mw + h_mw.T)
    evals, evecs = np.linalg.eigh(h_mw)

    freqs = np.sign(evals) * np.sqrt(np.abs(evals) * AU_TO_CM1)

    # reduced masses and cartesian displacements
    l_over_sqm = evecs / sq[:, None]  # cartesian displacement directions
    inv_mu = (l_over_sqm**2).sum(axis=0)
    reduced_masses = 1.0 / np.where(inv_mu > 1e-300, inv_mu, 1.0)

    force_constants = evals * reduced_masses * AU_TO_MDYNE_ANG

    ir = None
    if dipole_derivatives is not None:
        # dipd: (3, 3N); mode vector in mass-weighted coords -> cartesian
        # divided by sqrt(mass in electron masses)
        scale = evecs / (sq[:, None] * np.sqrt(AMU_TO_AU))
        trans = dipole_derivatives @ scale  # (3, nmodes)
        ir = AU_TO_KMMOL * (trans**2).sum(axis=0)

    # Gaussian-style displacement normalization (max component 1) for output
    disp = l_over_sqm / np.abs(l_over_sqm).max(axis=0, keepdims=True).clip(1e-300)

    return VibrationalResult(
        frequencies=freqs,
        reduced_masses=reduced_masses,
        force_constants=force_constants,
        ir_intensities=ir,
        displacements=disp,
    )
