"""Verbose per-fragment observability.

Mirrors the reference's verbose-mode MBE IO
(upstream metalquicha src/fragmentation/mbe/mqc_mbe_io.f90:15-155): per-fragment
XYZ dumps, the detailed per-level energy/deltaE breakdown, and n-mer level
naming. Emitted through the package logger at `verbose` level.
"""

from __future__ import annotations

import numpy as np

from ..constants import BOHR_TO_ANGSTROM
from ..elements import number_to_symbol
from ..logging_ import global_logger as logger

_LEVEL_NAMES = {
    1: "monomers", 2: "dimers", 3: "trimers", 4: "tetramers",
    5: "pentamers", 6: "hexamers", 7: "heptamers", 8: "octamers",
    9: "nonamers", 10: "decamers",
}


def get_frag_level_name(frag_level: int) -> str:
    """n-mer level name (mqc_mbe_io.f90:15-46)."""
    return _LEVEL_NAMES.get(frag_level, f"{frag_level}-mers")


def print_fragment_xyz(fragment_idx: int, frag) -> None:
    """Fragment geometry in XYZ format, Angstroms (mqc_mbe_io.f90:48-70)."""
    logger.info("=========================================")
    logger.info(f" Fragment {fragment_idx}")
    logger.info(f" Number of atoms: {frag.n_total}")
    logger.info(" Coordinates in Angstroms:")
    logger.info("-----------------------------------------")
    for z, xyz in zip(frag.numbers, np.asarray(frag.coords)):
        sym = number_to_symbol(int(z))
        x, y, zc = (float(c) * BOHR_TO_ANGSTROM for c in xyz)
        logger.info(f"{sym:<2s}{x:15.8f}{y:15.8f}{zc:15.8f}")
    logger.info("=========================================")


def print_detailed_breakdown(polymers, energies, delta_energies, max_level):
    """Per-level fragment energy/deltaE listing (mqc_mbe_io.f90:72-155).

    `polymers` is the padded (F, L) monomer-index table (0-based, -1 pad);
    printed indices are 1-based like the reference's output.
    """
    polymers = np.asarray(polymers)
    sizes = (polymers >= 0).sum(axis=1)

    logger.verbose(" ")
    logger.verbose("============================================")
    logger.verbose("Detailed Energy Breakdown by Fragment")
    logger.verbose("============================================")
    if max_level > 10:
        logger.warning(
            "Fragment levels exceed decamers (10-mers). "
            "Using generic N-mers notation."
        )

    for lvl in range(1, max_level + 1):
        rows = np.nonzero(sizes == lvl)[0]
        if rows.size == 0:
            continue
        logger.verbose(" ")
        logger.verbose(
            f"{get_frag_level_name(lvl).capitalize()} ({rows.size} fragments):"
        )
        logger.verbose("--------------------------------------------")
        for i in rows:
            members = ",".join(str(int(m) + 1) for m in polymers[i] if m >= 0)
            if lvl == 1:
                logger.verbose(
                    f"  Fragment [{members}]{float(energies[i]):20.10f}"
                )
            else:
                logger.verbose(
                    f"  Fragment [{members}]{float(energies[i]):20.10f}"
                    f"   deltaE: {float(delta_energies[i]):20.10f}"
                )
    logger.verbose(" ")
    logger.verbose("============================================")
