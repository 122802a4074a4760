"""Physical constants of the reference (CODATA 2010, as tblite)."""

BOHR_TO_ANGSTROM = 0.52917721092
ANGSTROM_TO_BOHR = 1.0 / BOHR_TO_ANGSTROM
#: Boltzmann's constant in Hartree per Kelvin
KB_HARTREE = 3.1668115634556e-6
