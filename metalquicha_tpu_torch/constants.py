"""Physical constants and unit conversion factors.

All values in atomic units unless noted. CODATA 2018 where applicable.

Numeric parity: values match the reference implementation
(upstream metalquicha src/core/mqc_physical_constants.f90) digit-for-digit, since
energy/frequency/thermochemistry agreement at the 1e-8 Ha level requires
identical conversion factors.
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------------------
# Fundamental constants
# ---------------------------------------------------------------------------

#: Bohr radius in Angstrom
BOHR_TO_ANGSTROM = 0.52917721092
ANGSTROM_TO_BOHR = 1.0 / BOHR_TO_ANGSTROM

#: Atomic mass unit in electron masses
AMU_TO_AU = 1822.888
AU_TO_AMU = 1.0 / AMU_TO_AU

#: Atomic mass unit in kg (CODATA 2018)
AMU_TO_KG = 1.66053906660e-27

# ---------------------------------------------------------------------------
# Vibrational spectroscopy conversions
# ---------------------------------------------------------------------------

#: sqrt(Hartree/(Bohr^2 * amu)) -> cm^-1
AU_TO_CM1 = 2.642461e7

#: Hartree/Bohr^2 -> mdyne/Angstrom
AU_TO_MDYNE_ANG = 15.569141

#: atomic units of (d mu / dQ)^2 -> km/mol IR intensity
AU_TO_KMMOL = 1.7770969e6

# ---------------------------------------------------------------------------
# Dipole moment conversions
# ---------------------------------------------------------------------------

AU_TO_DEBYE = 2.541746
DEBYE_TO_AU = 1.0 / AU_TO_DEBYE

# ---------------------------------------------------------------------------
# Energy conversions
# ---------------------------------------------------------------------------

HARTREE_TO_EV = 27.211386245988
EV_TO_HARTREE = 1.0 / HARTREE_TO_EV
HARTREE_TO_KCALMOL = 627.5094740631
HARTREE_TO_KJMOL = 2625.4996394799
HARTREE_TO_CALMOL = 627.5094740631 * 1000.0
HARTREE_TO_JMOL = 2625.4996394799 * 1000.0
CAL_TO_J = 4.184

# ---------------------------------------------------------------------------
# Thermochemistry constants (CODATA 2018)
# ---------------------------------------------------------------------------

#: Boltzmann constant in Hartree/K
KB_HARTREE = 3.1668115634556e-6
KB_SI = 1.380649e-23

#: Planck constant in Hartree*s
H_HARTREE_S = 1.5198298460574e-16
H_SI = 6.62607015e-34

#: Speed of light in cm/s
C_CM_S = 2.99792458e10

#: h*c/k_B in cm: multiply by wavenumber (cm^-1) to get Kelvin
CM1_TO_KELVIN = 1.4387773538277

#: Gas constant in cal/(mol K)
R_CALMOLK = 1.98720425864

#: Gas constant in Hartree/K (per molecule; equals k_B in atomic units)
R_HARTREE = 3.1668115634556e-6

#: 1 atm in Hartree/Bohr^3
ATM_TO_AU = 3.39893097e-9
ATM_TO_PA = 101325.0

PI = math.pi

AVOGADRO = 6.02214076e23

#: Rotational constant: B(GHz) = ROTCONST_AMUA2_TO_GHZ / I(amu*Angstrom^2)
ROTCONST_AMUA2_TO_GHZ = 505379.07

#: Rotational temperature: theta_rot(K) = ROTTEMP_AMUA2_TO_K / I(amu*Angstrom^2)
ROTTEMP_AMUA2_TO_K = 24.2637

#: u = theta_v/T above which a vibrational mode is treated as frozen out
VIB_CLASSICAL_LIMIT = 100.0
