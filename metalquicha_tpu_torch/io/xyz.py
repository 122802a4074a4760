"""Standard XYZ file reading (Angstrom).

Parity with upstream metalquicha src/io/mqc_xyz_reader.f90: natoms line, comment
line, then `element x y z` records.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..elements import symbol_to_number
from ..errors import InputError


@dataclass
class Geometry:
    """Raw geometry: symbols + coordinates in Angstrom."""

    symbols: list
    coords_angstrom: np.ndarray
    comment: str = ""
    numbers: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))

    def __post_init__(self):
        self.coords_angstrom = np.asarray(
            self.coords_angstrom, dtype=np.float64
        ).reshape(-1, 3)
        if self.numbers.size == 0:
            nums = []
            for s in self.symbols:
                z = symbol_to_number(s)
                if z == 0:
                    raise InputError(f"unknown element symbol: {s!r}")
                nums.append(z)
            self.numbers = np.array(nums, dtype=np.int64)

    @property
    def n_atoms(self) -> int:
        return len(self.symbols)


def read_xyz_string(text: str) -> Geometry:
    lines = text.splitlines()
    if not lines:
        raise InputError("empty XYZ content")
    try:
        natoms = int(lines[0].split()[0])
    except (ValueError, IndexError) as exc:
        raise InputError(f"invalid XYZ atom count line: {lines[0]!r}") from exc
    comment = lines[1].rstrip() if len(lines) > 1 else ""
    symbols, coords = [], []
    for raw in lines[2:]:
        parts = raw.split()
        if not parts:
            continue
        if len(parts) < 4:
            raise InputError(f"invalid XYZ atom record: {raw!r}")
        symbols.append(parts[0])
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
        if len(symbols) == natoms:
            break
    if len(symbols) != natoms:
        raise InputError(
            f"XYZ header declares {natoms} atoms but found {len(symbols)}"
        )
    return Geometry(symbols=symbols, coords_angstrom=np.array(coords), comment=comment)


def read_xyz_file(path: str) -> Geometry:
    with open(path, "r", encoding="utf-8") as fh:
        return read_xyz_string(fh.read())
