"""Result containers.

Pythonic analog of the reference result types
(upstream metalquicha src/core/mqc_result_types.f90:59-115): optional fields stand
in for the has_* flag idiom. `CalculationResult` is per-fragment;
`MbeResult` aggregates the expansion; `ThermoResult` carries RRHO output.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Energy:
    """Energy decomposition (scf + correlation channels)."""

    scf: float = 0.0
    mp2_ss: float = 0.0
    mp2_os: float = 0.0
    cc_singles: float = 0.0
    cc_doubles: float = 0.0
    cc_triples: float = 0.0

    def total(self) -> float:
        return (
            self.scf
            + self.mp2_ss
            + self.mp2_os
            + self.cc_singles
            + self.cc_doubles
            + self.cc_triples
        )


@dataclass
class CalculationResult:
    """Result of one fragment calculation (arrays in atomic units)."""

    energy: Energy = field(default_factory=Energy)
    gradient: Optional[np.ndarray] = None  # (n_atoms, 3)
    sigma: Optional[np.ndarray] = None  # (3, 3) virial
    hessian: Optional[np.ndarray] = None  # (3n, 3n)
    dipole: Optional[np.ndarray] = None  # (3,)
    dipole_derivatives: Optional[np.ndarray] = None  # (3, 3n)
    distance: float = 0.0  # min inter-monomer distance (Angstrom)

    @property
    def has_gradient(self) -> bool:
        return self.gradient is not None

    @property
    def has_hessian(self) -> bool:
        return self.hessian is not None


@dataclass
class MbeResult:
    """Aggregated many-body expansion result in SYSTEM coordinates."""

    total_energy: float = 0.0
    gradient: Optional[np.ndarray] = None  # (n_atoms_system, 3)
    hessian: Optional[np.ndarray] = None  # (3N, 3N)
    dipole: Optional[np.ndarray] = None
    dipole_derivatives: Optional[np.ndarray] = None  # (3, 3N)
    # per-fragment breakdown (MBE)
    fragment_energies: Optional[np.ndarray] = None
    delta_energies: Optional[np.ndarray] = None
    fragment_distances: Optional[np.ndarray] = None
    sum_by_level: Optional[np.ndarray] = None
    # GMBE PIE breakdown
    pie_energies: Optional[np.ndarray] = None
    pie_coefficients: Optional[np.ndarray] = None


@dataclass
class ThermoResult:
    """RRHO thermochemistry output (units as named in the JSON schema)."""

    temperature: float = 298.15
    pressure: float = 1.0
    total_mass: float = 0.0
    symmetry_number: int = 1
    spin_multiplicity: int = 1
    is_linear: bool = False
    n_real_freqs: int = 0
    n_imag_freqs: int = 0
    moments: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rot_const: np.ndarray = field(default_factory=lambda: np.zeros(3))
    q_trans: float = 0.0
    q_rot: float = 0.0
    q_vib: float = 1.0
    E_trans: float = 0.0
    S_trans: float = 0.0
    Cv_trans: float = 0.0
    E_rot: float = 0.0
    S_rot: float = 0.0
    Cv_rot: float = 0.0
    E_vib: float = 0.0
    S_vib: float = 0.0
    Cv_vib: float = 0.0
    E_elec: float = 0.0
    S_elec: float = 0.0
    zpe_hartree: float = 0.0
    zpe_kcalmol: float = 0.0
    thermal_correction_energy: float = 0.0
    thermal_correction_enthalpy: float = 0.0
    thermal_correction_gibbs: float = 0.0


@dataclass
class VibrationalResult:
    frequencies: np.ndarray = field(default_factory=lambda: np.zeros(0))
    reduced_masses: np.ndarray = field(default_factory=lambda: np.zeros(0))
    force_constants: np.ndarray = field(default_factory=lambda: np.zeros(0))
    ir_intensities: Optional[np.ndarray] = None
    displacements: Optional[np.ndarray] = None  # (3N, n_modes)
