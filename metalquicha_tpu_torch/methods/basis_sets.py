"""Gaussian-format basis set machinery (for the HF/DFT path).

Parity with the reference's basis layer: CGTO/atomic/molecular basis types
(mqc_cgto.f90:10-52), the Gaussian-format text
parser with ATOM/SHELL/FUNCTION line classification and L-shells split into
s+p (mqc_basis_reader.f90:507-566), and basis-name normalization / file
lookup (mqc_basis_utils.f90:13-113).

The xTB engine uses its own STO-nG machinery (methods/xtb/basis.py); this
module serves externally-supplied basis sets for future integral-based
methods.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..elements import symbol_to_number
from ..errors import InputError

ANGMOM = {"s": 0, "p": 1, "d": 2, "f": 3, "g": 4}


@dataclass
class CGTO:
    """Contracted Gaussian: angular momentum + primitives.

    For L (sp) shells the parser emits two CGTOs (s and p)."""

    ang_mom: int
    exponents: np.ndarray
    coefficients: np.ndarray

    @property
    def n_primitives(self) -> int:
        return len(self.exponents)


@dataclass
class AtomicBasis:
    element: str
    shells: list = field(default_factory=list)

    @property
    def n_shells(self) -> int:
        return len(self.shells)

    def n_basis_functions(self, spherical: bool = True) -> int:
        total = 0
        for shell in self.shells:
            l = shell.ang_mom
            total += (2 * l + 1) if spherical else (l + 1) * (l + 2) // 2
        return total


@dataclass
class MolecularBasis:
    element_bases: dict = field(default_factory=dict)  # symbol -> AtomicBasis
    atom_symbols: list = field(default_factory=list)

    def n_basis_functions(self, spherical: bool = True) -> int:
        return sum(
            self.element_bases[sym].n_basis_functions(spherical)
            for sym in self.atom_symbols
        )


def _classify(line: str) -> str:
    """ATOM (element + 0), SHELL (label nprim scale), FUNCTION (numbers)."""
    parts = line.split()
    if not parts:
        return "BLANK"
    if parts[0] in ("****",):
        return "SEPARATOR"
    first = parts[0]
    if first[0].isalpha():
        if symbol_to_number(first) > 0 and len(parts) >= 2 and parts[1] in ("0",):
            return "ATOM"
        label = first.lower()
        if all(ch in "spdfgl" for ch in label):
            return "SHELL"
        return "UNKNOWN"
    return "FUNCTION"


def parse_basis_text(text: str) -> dict:
    """Parse Gaussian-format basis text into {element symbol: AtomicBasis}."""
    bases: dict = {}
    current_atom = None
    current_shell = None  # (label, nprim, rows)

    def flush_shell():
        nonlocal current_shell
        if current_shell is None or current_atom is None:
            return
        label, nprim, rows = current_shell
        if len(rows) != nprim:
            raise InputError(
                f"shell {label} for {current_atom.element}: declared "
                f"{nprim} primitives, found {len(rows)}"
            )
        arr = np.array(rows)
        if label == "l" or label == "sp":
            # L shell: column 1 = s coeff, column 2 = p coeff
            current_atom.shells.append(
                CGTO(0, arr[:, 0].copy(), arr[:, 1].copy())
            )
            current_atom.shells.append(
                CGTO(1, arr[:, 0].copy(), arr[:, 2].copy())
            )
        else:
            current_atom.shells.append(
                CGTO(ANGMOM[label], arr[:, 0].copy(), arr[:, 1].copy())
            )
        current_shell = None

    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        kind = _classify(line)
        if kind == "SEPARATOR":
            flush_shell()
            current_atom = None
        elif kind == "ATOM":
            flush_shell()
            sym = line.split()[0]
            current_atom = AtomicBasis(element=sym.capitalize())
            bases[current_atom.element] = current_atom
        elif kind == "SHELL":
            flush_shell()
            parts = line.split()
            current_shell = (parts[0].lower(), int(parts[1]), [])
        elif kind == "FUNCTION":
            if current_shell is None:
                raise InputError(f"primitive line outside a shell: {raw!r}")
            row = [float(x.replace("D", "E").replace("d", "e"))
                   for x in line.split()]
            current_shell[2].append(row)
    flush_shell()
    return bases


def read_basis_file(path: str) -> str:
    """Whole basis file as text (reference: mqc_basis_file_reader.f90)."""
    if not os.path.exists(path):
        raise InputError(f"basis file not found: {path}")
    with open(path, "r", encoding="utf-8") as fh:
        return fh.read()


def normalize_basis_name(name: str) -> str:
    """Filesystem-safe basis name: '*' -> 's', lowercase, strip spaces."""
    return name.strip().lower().replace("*", "s").replace(" ", "")


def find_basis_file(name: str, search_dirs=None) -> str:
    """Locate `<name>.txt` under basis_sets/ directories."""
    norm = normalize_basis_name(name)
    if search_dirs is None:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        search_dirs = [
            os.path.join(os.path.dirname(here), "basis_sets"),
            os.path.join(here, "basis_sets"),
            "basis_sets",
        ]
    for d in search_dirs:
        candidate = os.path.join(d, f"{norm}.txt")
        if os.path.exists(candidate):
            return candidate
    raise InputError(f"basis set file for {name!r} not found")


def build_molecular_basis(symbols, basis_text: str) -> MolecularBasis:
    """Per-element bases + atom map for a molecule."""
    bases = parse_basis_text(basis_text)
    mb = MolecularBasis(element_bases=bases, atom_symbols=list(symbols))
    for sym in mb.atom_symbols:
        if sym.capitalize() not in bases:
            raise InputError(f"basis text lacks element {sym!r}")
    return mb
