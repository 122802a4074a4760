"""RRHO thermochemistry.

Numerical parity with upstream metalquicha src/vibrational/mqc_thermochemistry.f90:
- inertia tensor -> principal moments; linear if a moment < 1e-6 amu A^2
  (:106-191); rotational constants in GHz (:193-221)
- ZPE = 1/2 sum nu * CM1_TO_KELVIN * k_B over REAL frequencies (:223-264)
- translational Sackur-Tetrode (:266-306); rigid-rotor E/S/Cv with symmetry
  number (:308-371); harmonic vib E/S/Cv skipping nu < 10 cm^-1 and
  u > VIB_CLASSICAL_LIMIT (:373-436); electronic S = R ln(2S+1) (:438-448)
- E_corr = ZPE + E_t + E_r + E_v; H = E + RT; G = H - T S (:522-608)

Energies per molecule in Hartree; entropies/heat capacities in cal/mol/K.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import (
    AMU_TO_KG,
    ATM_TO_PA,
    BOHR_TO_ANGSTROM,
    CM1_TO_KELVIN,
    HARTREE_TO_KCALMOL,
    H_SI,
    KB_HARTREE,
    KB_SI,
    R_CALMOLK,
    ROTCONST_AMUA2_TO_GHZ,
    ROTTEMP_AMUA2_TO_K,
    VIB_CLASSICAL_LIMIT,
)
from ..elements import masses_for
from ..results import ThermoResult

LINEAR_MOMENT_THRESHOLD = 1e-6  # amu Angstrom^2
VIB_FREQ_FLOOR_CM1 = 10.0


def principal_moments(numbers, coords_bohr) -> np.ndarray:
    """Principal moments of inertia in amu Angstrom^2 (ascending)."""
    masses = masses_for(numbers)
    coords = np.asarray(coords_bohr) * BOHR_TO_ANGSTROM
    com = (masses[:, None] * coords).sum(0) / masses.sum()
    r = coords - com
    x, y, z = r[:, 0], r[:, 1], r[:, 2]
    I = np.zeros((3, 3))
    I[0, 0] = (masses * (y**2 + z**2)).sum()
    I[1, 1] = (masses * (x**2 + z**2)).sum()
    I[2, 2] = (masses * (x**2 + y**2)).sum()
    I[0, 1] = I[1, 0] = -(masses * x * y).sum()
    I[0, 2] = I[2, 0] = -(masses * x * z).sum()
    I[1, 2] = I[2, 1] = -(masses * y * z).sum()
    return np.sort(np.linalg.eigvalsh(I))


def compute_thermochemistry(
    frequencies_cm1,
    numbers,
    coords_bohr,
    temperature: float = 298.15,
    pressure_atm: float = 1.0,
    symmetry_number: int = 1,
    spin_multiplicity: int = 1,
) -> ThermoResult:
    T = float(temperature)
    R = R_CALMOLK  # cal/mol/K
    kT_ha = KB_HARTREE * T

    masses = masses_for(numbers)
    total_mass = float(masses.sum())
    moments = principal_moments(numbers, coords_bohr)
    n_atoms = len(numbers)
    is_linear = bool(moments[0] < LINEAR_MOMENT_THRESHOLD) and n_atoms > 1

    freqs = np.asarray(frequencies_cm1, dtype=float)
    n_imag = int((freqs < -VIB_FREQ_FLOOR_CM1).sum())
    real_freqs = freqs[freqs > VIB_FREQ_FLOOR_CM1]
    n_real = int(real_freqs.size)

    # --- ZPE over real frequencies
    theta_v = real_freqs * CM1_TO_KELVIN  # K
    zpe_ha = 0.5 * (theta_v * KB_HARTREE).sum()

    # --- translational
    mass_kg = total_mass * AMU_TO_KG
    p_pa = pressure_atm * ATM_TO_PA
    q_trans = (
        (2.0 * math.pi * mass_kg * KB_SI * T / H_SI**2) ** 1.5 * KB_SI * T / p_pa
    )
    E_trans = 1.5 * kT_ha
    S_trans = R * (math.log(q_trans) + 1.0 + 1.5)
    Cv_trans = 1.5 * R

    # --- rotational
    if n_atoms == 1:
        q_rot, E_rot, S_rot, Cv_rot = 1.0, 0.0, 0.0, 0.0
        rot_const = np.zeros(3)
    else:
        nz = moments[moments > LINEAR_MOMENT_THRESHOLD]
        rot_const = np.array(
            [ROTCONST_AMUA2_TO_GHZ / m if m > LINEAR_MOMENT_THRESHOLD else 0.0
             for m in moments[::-1]]
        )  # descending moments -> A >= B >= C in GHz
        theta_r = np.array([ROTTEMP_AMUA2_TO_K / m for m in nz])
        if is_linear:
            q_rot = T / (symmetry_number * theta_r[-1])
            E_rot = kT_ha
            S_rot = R * (math.log(q_rot) + 1.0)
            Cv_rot = R
        else:
            q_rot = (
                math.sqrt(math.pi)
                / symmetry_number
                * math.sqrt(T**3 / np.prod(theta_r))
            )
            E_rot = 1.5 * kT_ha
            S_rot = R * (math.log(q_rot) + 1.5)
            Cv_rot = 1.5 * R

    # --- vibrational (thermal part; ZPE separate) over real frequencies
    E_vib = S_vib = Cv_vib = 0.0
    q_vib = 1.0
    for tv in theta_v:
        u = tv / T
        if u > VIB_CLASSICAL_LIMIT:
            continue  # frozen out
        emu = math.exp(-u)
        q_vib *= 1.0 / (1.0 - emu)
        E_vib += KB_HARTREE * tv * emu / (1.0 - emu)
        S_vib += R * (u * emu / (1.0 - emu) - math.log(1.0 - emu))
        Cv_vib += R * u**2 * emu / (1.0 - emu) ** 2

    # --- electronic
    S_elec = R * math.log(float(spin_multiplicity))
    E_elec = 0.0

    # --- totals (Hartree per molecule)
    corr_E = zpe_ha + E_trans + E_rot + E_vib
    corr_H = corr_E + kT_ha
    S_total_ha_per_K = (S_trans + S_rot + S_vib + S_elec) / R * KB_HARTREE
    corr_G = corr_H - T * S_total_ha_per_K

    return ThermoResult(
        temperature=T,
        pressure=pressure_atm,
        total_mass=total_mass,
        symmetry_number=symmetry_number,
        spin_multiplicity=spin_multiplicity,
        is_linear=is_linear,
        n_real_freqs=n_real,
        n_imag_freqs=n_imag,
        moments=moments,
        rot_const=rot_const,
        q_trans=q_trans,
        q_rot=q_rot,
        q_vib=q_vib,
        E_trans=E_trans,
        S_trans=S_trans,
        Cv_trans=Cv_trans,
        E_rot=E_rot,
        S_rot=S_rot,
        Cv_rot=Cv_rot,
        E_vib=E_vib,
        S_vib=S_vib,
        Cv_vib=Cv_vib,
        E_elec=E_elec,
        S_elec=S_elec,
        zpe_hartree=zpe_ha,
        zpe_kcalmol=zpe_ha * HARTREE_TO_KCALMOL,
        thermal_correction_energy=corr_E,
        thermal_correction_enthalpy=corr_H,
        thermal_correction_gibbs=corr_G,
    )
