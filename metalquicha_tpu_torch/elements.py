"""Periodic table: symbol <-> atomic number and standard atomic masses.

Masses are IUPAC standard atomic weights, matching the reference data table
(upstream metalquicha src/core/mqc_elements.f90) so mass-weighted Hessians and
thermochemistry agree numerically.
"""

from __future__ import annotations

import numpy as np

N_ELEMENTS = 118

ELEMENT_SYMBOLS: tuple[str, ...] = (
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy",
    "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt",
    "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn",
    "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
)

#: Standard atomic masses in amu, indexed by Z-1.
ELEMENT_MASSES = np.array([
    1.008, 4.0026,
    6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845,
    58.933, 58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971,
    79.904, 83.798,
    85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 98.0, 101.07,
    102.91, 106.42, 107.87, 112.41, 114.82, 118.71, 121.76, 127.60,
    126.90, 131.29,
    132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36,
    151.96, 157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05,
    174.97, 178.49, 180.95, 183.84, 186.21, 190.23, 192.22, 195.08,
    196.97, 200.59, 204.38, 207.2, 208.98, 209.0, 210.0, 222.0,
    223.0, 226.0, 227.0, 232.04, 231.04, 238.03, 237.0, 244.0,
    243.0, 247.0, 247.0, 251.0, 252.0, 257.0, 258.0, 259.0,
    262.0, 267.0, 268.0, 271.0, 272.0, 270.0, 276.0, 281.0,
    280.0, 285.0, 284.0, 289.0, 288.0, 293.0, 294.0, 294.0,
])

_SYMBOL_TO_Z = {sym.lower(): z + 1 for z, sym in enumerate(ELEMENT_SYMBOLS)}


def symbol_to_number(symbol: str) -> int:
    """Atomic number for an element symbol (case-insensitive); 0 if unknown."""
    return _SYMBOL_TO_Z.get(symbol.strip().lower(), 0)


def number_to_symbol(z: int) -> str:
    """Element symbol for an atomic number; 'Xx' if out of range."""
    if 1 <= z <= N_ELEMENTS:
        return ELEMENT_SYMBOLS[z - 1]
    return "Xx"


def element_mass(z: int) -> float:
    """Standard atomic mass in amu; 0.0 if out of range."""
    if 1 <= z <= N_ELEMENTS:
        return float(ELEMENT_MASSES[z - 1])
    return 0.0


def masses_for(numbers) -> np.ndarray:
    """Vectorized masses (amu) for an array of atomic numbers."""
    z = np.asarray(numbers, dtype=np.int64)
    out = np.zeros(z.shape, dtype=np.float64)
    ok = (z >= 1) & (z <= N_ELEMENTS)
    out[ok] = ELEMENT_MASSES[z[ok] - 1]
    return out
