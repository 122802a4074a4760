"""Program limits and calculation defaults.

Values mirror the reference defaults
(upstream metalquicha src/core/mqc_program_limits.f90,
 upstream metalquicha src/core/mqc_calculation_defaults.f90) so that default-driven
numerics (FD displacement, temperatures, solvation settings) agree.
"""

from __future__ import annotations

# Program limits
MAX_MBE_LEVEL = 10
GROUP_RESULT_BATCH_SIZE = 256  # kept for parity; batching is mesh-sharded here
DEFAULT_FD_DISPLACEMENT = 0.005  # Bohr
MIN_ATOM_DISTANCE = 0.01  # Bohr — duplicate-atom detection threshold

# Calculation defaults
DEFAULT_TEMPERATURE = 298.15  # K
DEFAULT_PRESSURE_ATM = 1.0
DEFAULT_SCF_MAXITER = 100
DEFAULT_SCF_TOLERANCE = 1.0e-6
DEFAULT_AIMD_DT_FS = 1.0
DEFAULT_AIMD_NSTEPS = 100
DEFAULT_XTB_ACCURACY = 0.01
DEFAULT_ELECTRONIC_TEMP = 300.0  # K
DEFAULT_CPCM_NANG = 110
DEFAULT_CPCM_RSCALE = 1.0
DEFAULT_MAX_INTERSECTION = 999

# Wire-protocol fragment discriminators (kept for schema parity; used to tag
# whether a work item is a monomer-index set or an explicit atom list)
FRAGMENT_TYPE_MONOMERS = 0
FRAGMENT_TYPE_ATOMS = 1
