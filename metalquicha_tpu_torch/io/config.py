""".mqc input format parser.

Line-oriented section format: `%section ... end`, `key = value` pairs,
`!`/`#` comments, nested sections (%fragment/%indices, %molecule,
%cutoffs). Unknown sections are skipped. Grammar parity with
upstream metalquicha src/io/mqc_config_parser.F90:360-460 and the section
submodules under upstream metalquicha src/io/parsers/.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..errors import InputError
from ..limits import (
    DEFAULT_CPCM_NANG,
    DEFAULT_CPCM_RSCALE,
    DEFAULT_FD_DISPLACEMENT,
    DEFAULT_PRESSURE_ATM,
    DEFAULT_SCF_MAXITER,
    DEFAULT_SCF_TOLERANCE,
    DEFAULT_TEMPERATURE,
    MAX_MBE_LEVEL,
)
from .xyz import Geometry, read_xyz_string


# ---------------------------------------------------------------------------
# Config data model
# ---------------------------------------------------------------------------


@dataclass
class FragmentSpec:
    charge: int = 0
    multiplicity: int = 1
    indices: list = field(default_factory=list)  # 0-indexed atom indices


@dataclass
class BondSpec:
    atom_i: int
    atom_j: int
    order: int = 1
    is_broken: bool = False


@dataclass
class MoleculeConfig:
    name: str = ""
    charge: int = 0
    multiplicity: int = 1
    geometry: Optional[Geometry] = None
    fragments: list = field(default_factory=list)
    bonds: list = field(default_factory=list)


@dataclass
class MqcConfig:
    # %schema
    schema_name: str = ""
    schema_version: str = ""
    index_base: int = 0
    units: str = "angstrom"
    # %model
    method: str = ""
    basis: str = ""
    aux_basis: str = ""
    # %driver
    driver_type: str = "Energy"
    # %system
    log_level: str = "info"
    skip_json_output: bool = False
    # %structure + %geometry (single molecule)
    charge: int = 0
    multiplicity: int = 1
    geometry: Optional[Geometry] = None
    # %fragments / %connectivity
    fragments: list = field(default_factory=list)
    bonds: list = field(default_factory=list)
    # %molecules
    molecules: list = field(default_factory=list)
    # %scf
    scf_maxiter: int = DEFAULT_SCF_MAXITER
    scf_tolerance: float = DEFAULT_SCF_TOLERANCE
    # %xtb
    solvent: str = ""
    solvation_model: str = ""
    # reference defaults: ON (mqc_config_parser.F90:80-81)
    use_cds: bool = True
    use_shift: bool = True
    dielectric: Optional[float] = None
    cpcm_nang: int = DEFAULT_CPCM_NANG
    cpcm_rscale: float = DEFAULT_CPCM_RSCALE
    # %hessian
    fd_displacement: float = DEFAULT_FD_DISPLACEMENT
    temperature: float = DEFAULT_TEMPERATURE
    pressure: float = DEFAULT_PRESSURE_ATM
    # %aimd (parsed for parity; AIMD itself is driven via the calc interface)
    aimd_dt: float = 1.0
    aimd_nsteps: int = 100
    aimd_initial_temperature: float = DEFAULT_TEMPERATURE
    aimd_output_frequency: int = 1
    # %fragmentation
    frag_method: str = "MBE"
    allow_overlapping_fragments: bool = False
    level: int = 2
    embedding: str = "none"
    cutoff_method: str = "distance"
    distance_metric: str = "min"
    cutoffs: dict = field(default_factory=dict)  # n-mer level -> Angstrom
    global_groups: Optional[int] = None
    nodes_per_group: Optional[int] = None
    max_intersection_level: Optional[int] = None


# ---------------------------------------------------------------------------
# Tokenizer / block reader
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    for marker in ("!", "#"):
        idx = line.find(marker)
        if idx >= 0:
            line = line[:idx]
    return line.strip()


class _Lines:
    """Cursor over comment-stripped non-empty lines."""

    def __init__(self, text: str):
        self.lines = []
        for raw in text.splitlines():
            s = _strip_comment(raw)
            if s:
                self.lines.append(s)
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def next(self) -> Optional[str]:
        line = self.peek()
        if line is not None:
            self.pos += 1
        return line


def _parse_bool(value: str) -> bool:
    return value.strip().lower() in ("true", "t", "yes", "on", "1", ".true.")


def _kv(line: str):
    if "=" not in line:
        return None
    key, _, value = line.partition("=")
    return key.strip().lower(), value.strip()


# ---------------------------------------------------------------------------
# Section parsers
# ---------------------------------------------------------------------------


def _collect_section(cur: _Lines) -> list:
    """Collect raw lines of a section until the matching `end`, tracking depth."""
    depth = 1
    body = []
    while True:
        line = cur.next()
        if line is None:
            raise InputError("unterminated section (missing 'end')")
        low = line.lower()
        if low.startswith("%"):
            depth += 1
        elif low == "end" or low.startswith("end "):
            depth -= 1
            if depth == 0:
                return body
        body.append(line)


def _parse_geometry_block(body: list) -> Geometry:
    if not body:
        raise InputError("empty %geometry section")
    return read_xyz_string(body[0] + "\n\n" + "\n".join(body[1:]))


def _parse_indices(cur: _Lines) -> list:
    vals = []
    for line in _collect_section(cur):
        vals.extend(int(tok) for tok in line.split())
    return vals


def _parse_fragment(cur: _Lines) -> FragmentSpec:
    frag = FragmentSpec()
    while True:
        line = cur.next()
        if line is None:
            raise InputError("unterminated %fragment")
        low = line.lower()
        if low == "end" or low.startswith("end "):
            return frag
        if low.startswith("%indices"):
            frag.indices = _parse_indices(cur)
            continue
        kv = _kv(line)
        if kv:
            key, value = kv
            if key == "charge":
                frag.charge = int(value)
            elif key == "multiplicity":
                frag.multiplicity = int(value)


def _parse_fragments(cur: _Lines) -> list:
    frags = []
    declared = None
    while True:
        line = cur.next()
        if line is None:
            raise InputError("unterminated %fragments")
        low = line.lower()
        if low == "end" or low.startswith("end "):
            break
        if low.startswith("%fragment"):
            frags.append(_parse_fragment(cur))
            continue
        kv = _kv(line)
        if kv and kv[0] == "nfrag":
            declared = int(kv[1])
    if declared is not None and declared != len(frags):
        raise InputError(
            f"%fragments declares nfrag={declared} but {len(frags)} found"
        )
    return frags


def _parse_connectivity(body: list) -> list:
    bonds = []
    for line in body:
        kv = _kv(line)
        if kv:
            continue  # nbonds = / nbroken = counters
        parts = line.split()
        if len(parts) < 2:
            continue
        order = int(parts[2]) if len(parts) > 2 else 1
        is_broken = len(parts) > 3 and parts[3].lower() == "broken"
        bonds.append(
            BondSpec(int(parts[0]), int(parts[1]), order=order, is_broken=is_broken)
        )
    return bonds


def _parse_structure(body: list):
    charge, mult = 0, 1
    for line in body:
        kv = _kv(line)
        if not kv:
            continue
        if kv[0] == "charge":
            charge = int(kv[1])
        elif kv[0] == "multiplicity":
            mult = int(kv[1])
    return charge, mult


def _parse_molecule(cur: _Lines) -> MoleculeConfig:
    mol = MoleculeConfig()
    while True:
        line = cur.next()
        if line is None:
            raise InputError("unterminated %molecule")
        low = line.lower()
        if low == "end" or low.startswith("end "):
            return mol
        if low.startswith("%structure"):
            mol.charge, mol.multiplicity = _parse_structure(_collect_section(cur))
        elif low.startswith("%geometry"):
            mol.geometry = _parse_geometry_block(_collect_section(cur))
        elif low.startswith("%fragments"):
            mol.fragments = _parse_fragments(cur)
        elif low.startswith("%connectivity"):
            mol.bonds = _parse_connectivity(_collect_section(cur))
        elif low.startswith("%"):
            _collect_section(cur)  # skip unknown nested section
        else:
            kv = _kv(line)
            if kv and kv[0] == "name":
                mol.name = kv[1]


def _parse_molecules(cur: _Lines) -> list:
    mols = []
    declared = None
    while True:
        line = cur.next()
        if line is None:
            raise InputError("unterminated %molecules")
        low = line.lower()
        if low == "end" or low.startswith("end "):
            break
        if low.startswith("%molecule"):
            mols.append(_parse_molecule(cur))
            continue
        kv = _kv(line)
        if kv and kv[0] == "nmol":
            declared = int(kv[1])
    if declared is not None and declared != len(mols):
        raise InputError(f"%molecules declares nmol={declared} but {len(mols)} found")
    return mols


def _parse_cutoffs(body: list) -> dict:
    cutoffs = {}
    for line in body:
        kv = _kv(line)
        if not kv:
            continue
        nmer = int(kv[0])
        if not (2 <= nmer <= MAX_MBE_LEVEL):
            raise InputError(f"cutoff level {nmer} outside 2..{MAX_MBE_LEVEL}")
        cutoffs[nmer] = float(kv[1])
    return cutoffs


def _parse_fragmentation(cfg: MqcConfig, cur: _Lines) -> None:
    while True:
        line = cur.next()
        if line is None:
            raise InputError("unterminated %fragmentation")
        low = line.lower()
        if low == "end" or low.startswith("end "):
            return
        if low.startswith("%cutoffs"):
            cfg.cutoffs = _parse_cutoffs(_collect_section(cur))
            continue
        kv = _kv(line)
        if not kv:
            continue
        key, value = kv
        if key == "method":
            cfg.frag_method = value
        elif key == "allow_overlapping_fragments":
            cfg.allow_overlapping_fragments = _parse_bool(value)
        elif key == "level":
            cfg.level = int(value)
        elif key == "embedding":
            cfg.embedding = value
        elif key == "cutoff_method":
            cfg.cutoff_method = value
        elif key == "distance_metric":
            cfg.distance_metric = value
        elif key == "global_groups":
            cfg.global_groups = int(value)
        elif key == "nodes_per_group":
            cfg.nodes_per_group = int(value)
        elif key == "max_intersection_level":
            cfg.max_intersection_level = int(value)


_SIMPLE_SECTION_KEYS = {
    "schema": {
        "name": ("schema_name", str),
        "version": ("schema_version", str),
        "index_base": ("index_base", int),
        "units": ("units", str),
    },
    "model": {
        "method": ("method", str),
        "basis": ("basis", str),
        "aux_basis": ("aux_basis", str),
    },
    "driver": {"type": ("driver_type", str)},
    "system": {
        "log_level": ("log_level", str),
        "skip_json_output": ("skip_json_output", _parse_bool),
    },
    "scf": {
        "maxiter": ("scf_maxiter", int),
        "tolerance": ("scf_tolerance", float),
    },
    "xtb": {
        "solvent": ("solvent", str),
        "solvation_model": ("solvation_model", str),
        "use_cds": ("use_cds", _parse_bool),
        "use_shift": ("use_shift", _parse_bool),
        "dielectric": ("dielectric", float),
        "cpcm_nang": ("cpcm_nang", int),
        "cpcm_rscale": ("cpcm_rscale", float),
    },
    "hessian": {
        "finite_difference_displacement": ("fd_displacement", float),
        "displacement": ("fd_displacement", float),
        "temperature": ("temperature", float),
        "pressure": ("pressure", float),
    },
    "aimd": {
        "dt": ("aimd_dt", float),
        "nsteps": ("aimd_nsteps", int),
        "initial_temperature": ("aimd_initial_temperature", float),
        "output_frequency": ("aimd_output_frequency", int),
    },
}


def parse_mqc_string(text: str) -> MqcConfig:
    cfg = MqcConfig()
    cur = _Lines(text)
    while True:
        line = cur.next()
        if line is None:
            break
        if not line.startswith("%"):
            continue
        section = line[1:].split()[0].lower()
        if section == "structure":
            cfg.charge, cfg.multiplicity = _parse_structure(_collect_section(cur))
        elif section == "geometry":
            cfg.geometry = _parse_geometry_block(_collect_section(cur))
        elif section == "fragments":
            cfg.fragments = _parse_fragments(cur)
        elif section == "connectivity":
            cfg.bonds = _parse_connectivity(_collect_section(cur))
        elif section == "molecules":
            cfg.molecules = _parse_molecules(cur)
        elif section == "fragmentation":
            _parse_fragmentation(cfg, cur)
        elif section in _SIMPLE_SECTION_KEYS:
            keymap = _SIMPLE_SECTION_KEYS[section]
            for body_line in _collect_section(cur):
                kv = _kv(body_line)
                if not kv:
                    continue
                key, value = kv
                if key in keymap:
                    attr, conv = keymap[key]
                    setattr(cfg, attr, conv(value))
        else:
            _collect_section(cur)  # unknown section: skip

    _validate(cfg)
    return cfg


def _validate(cfg: MqcConfig) -> None:
    if not cfg.schema_name:
        raise InputError("missing %schema section (name)")
    if cfg.geometry is None and not cfg.molecules:
        raise InputError("missing %geometry (or %molecules) section")
    for mol in cfg.molecules:
        if mol.geometry is None:
            raise InputError("a %molecule block is missing its %geometry")
    if cfg.index_base not in (0, 1):
        raise InputError(f"index_base must be 0 or 1, got {cfg.index_base}")
    if cfg.index_base == 1:
        # Normalize everything to 0-based internally.
        for holder in [cfg] + list(cfg.molecules):
            for frag in holder.fragments:
                frag.indices = [i - 1 for i in frag.indices]
            for bond in holder.bonds:
                bond.atom_i -= 1
                bond.atom_j -= 1
        cfg.index_base = 0


def read_mqc_file(path: str) -> MqcConfig:
    with open(path, "r", encoding="utf-8") as fh:
        return parse_mqc_string(fh.read())
