"""Config adaptation: parse-time MqcConfig -> run-time DriverConfig/geometry.

Parity with upstream metalquicha src/io/mqc_config_adapter.f90:
- nlevel forced to 0 when no fragments are defined (:90-94)
- unfragmented systems become a single monomer (:182-213)
- fragment overlap is an input error unless allow_overlapping_fragments
  (:381-414)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..errors import InputError
from ..geometry import Bond, SystemGeometry, coords_angstrom_to_bohr
from ..limits import (
    DEFAULT_ELECTRONIC_TEMP,
    DEFAULT_MAX_INTERSECTION,
    DEFAULT_XTB_ACCURACY,
)
from .config import MoleculeConfig, MqcConfig


class CalcType(enum.IntEnum):
    ENERGY = 1
    GRADIENT = 2
    HESSIAN = 3


class MethodType(enum.IntEnum):
    GFN1 = 1
    GFN2 = 2
    HF = 10
    DFT = 11
    MCSCF = 20
    MP2 = 30
    RIMP2 = 31
    CCSD = 40
    CCSD_T = 41
    CCSDT = 42
    CCSD_T_F12 = 43


_CALC_ALIASES = {
    "energy": CalcType.ENERGY,
    "gradient": CalcType.GRADIENT,
    "forces": CalcType.GRADIENT,
    "hessian": CalcType.HESSIAN,
    "frequencies": CalcType.HESSIAN,
}

_METHOD_ALIASES = {
    "xtb-gfn1": MethodType.GFN1,
    "gfn1-xtb": MethodType.GFN1,
    "gfn1": MethodType.GFN1,
    "xtb-gfn2": MethodType.GFN2,
    "gfn2-xtb": MethodType.GFN2,
    "gfn2": MethodType.GFN2,
    "hf": MethodType.HF,
    "rhf": MethodType.HF,
    "uhf": MethodType.HF,
    "scf": MethodType.HF,
    "dft": MethodType.DFT,
    "mcscf": MethodType.MCSCF,
    "casscf": MethodType.MCSCF,
    "mp2": MethodType.MP2,
    "ri-mp2": MethodType.RIMP2,
    "rimp2": MethodType.RIMP2,
    "ccsd": MethodType.CCSD,
    "ccsd(t)": MethodType.CCSD_T,
    "ccsdt": MethodType.CCSDT,
    "ccsd(t)-f12": MethodType.CCSD_T_F12,
}


def calc_type_from_string(s: str) -> CalcType:
    try:
        return _CALC_ALIASES[s.strip().lower()]
    except KeyError as exc:
        raise InputError(f"unknown driver/calc type: {s!r}") from exc


def method_type_from_string(s: str) -> MethodType:
    try:
        return _METHOD_ALIASES[s.strip().lower()]
    except KeyError as exc:
        raise InputError(f"unknown method: {s!r}") from exc


@dataclass
class ScfConfig:
    maxiter: int = 100
    tolerance: float = 1.0e-6


@dataclass
class XtbConfig:
    accuracy: float = DEFAULT_XTB_ACCURACY
    electronic_temp: float = DEFAULT_ELECTRONIC_TEMP
    solvent: str = ""
    solvation_model: str = ""  # "", "alpb", "gbsa", "cpcm"
    use_cds: bool = True
    use_shift: bool = True
    dielectric: Optional[float] = None
    cpcm_nang: int = 110
    cpcm_rscale: float = 1.0

    def has_solvation(self) -> bool:
        return bool(self.solvation_model) or bool(self.solvent)


@dataclass
class DftConfig:
    """DFT settings (mqc_method_config.f90:66-93). The DFT method itself is
    a placeholder in the reference too; the config round-trips inputs."""

    functional: str = "b3lyp"
    grid_type: str = "medium"
    radial_points: int = 75
    angular_points: int = 302
    use_density_fitting: bool = False
    aux_basis_set: str = ""
    use_dispersion: bool = False
    dispersion_type: str = "d3bj"


@dataclass
class McscfConfig:
    """MCSCF/CASSCF settings (mqc_method_config.f90:96-134)."""

    n_active_electrons: int = 0
    n_active_orbitals: int = 0
    n_inactive_orbitals: int = -1
    n_states: int = 1
    state_weights: Optional[list] = None
    max_macro_iter: int = 100
    max_micro_iter: int = 50
    orbital_convergence: float = 1.0e-6
    ci_convergence: float = 1.0e-8
    use_pt2: bool = False
    pt2_type: str = "nevpt2"
    ipea_shift: float = 0.25
    imaginary_shift: float = 0.0


@dataclass
class CorrelationConfig:
    """Shared post-HF correlation settings (mqc_method_config.f90:137-171)."""

    energy_convergence: float = 1.0e-8
    n_frozen_core: int = -1
    freeze_core: bool = True
    use_df: bool = True
    aux_basis: str = ""
    use_local: bool = False
    local_type: str = "dlpno"
    pno_threshold: float = 1.0e-7
    use_scs: bool = False
    scs_ss: float = 1.0 / 3.0
    scs_os: float = 1.2


@dataclass
class CcConfig:
    """Coupled-cluster settings (mqc_method_config.f90:174-200)."""

    max_iter: int = 100
    amplitude_convergence: float = 1.0e-7
    include_triples: bool = False
    perturbative_triples: bool = True
    use_diis: bool = True
    diis_size: int = 8
    n_roots: int = 0
    eom_type: str = "ee"


@dataclass
class F12Config:
    """F12 explicitly-correlated settings (mqc_method_config.f90:203-223)."""

    geminal_exponent: float = 1.0
    ansatz: str = "3c"
    cabs_basis: str = ""
    optri_basis: str = ""
    use_exponent_fit: bool = False
    scale_triples: bool = True


@dataclass
class MethodConfig:
    """Master method configuration mirroring the reference's composition
    (mqc_method_config.f90:226-266): common settings + per-family configs."""

    method_type: MethodType = MethodType.GFN1
    basis: str = ""
    aux_basis: str = ""
    use_spherical: bool = True
    scf: ScfConfig = field(default_factory=ScfConfig)
    xtb: XtbConfig = field(default_factory=XtbConfig)
    dft: DftConfig = field(default_factory=DftConfig)
    mcscf: McscfConfig = field(default_factory=McscfConfig)
    corr: CorrelationConfig = field(default_factory=CorrelationConfig)
    cc: CcConfig = field(default_factory=CcConfig)
    f12: F12Config = field(default_factory=F12Config)
    verbose: bool = False


@dataclass
class HessianKeywords:
    displacement: float = 0.005  # Bohr
    temperature: float = 298.15
    pressure: float = 1.0


@dataclass
class DriverConfig:
    calc_type: CalcType = CalcType.ENERGY
    method: MethodConfig = field(default_factory=MethodConfig)
    nlevel: int = 0  # 0 = unfragmented
    use_gmbe: bool = False
    max_intersection_level: int = DEFAULT_MAX_INTERSECTION
    cutoffs: dict = field(default_factory=dict)  # n-mer level -> Angstrom
    global_groups: Optional[int] = None
    nodes_per_group: Optional[int] = None
    hessian: HessianKeywords = field(default_factory=HessianKeywords)
    skip_json_output: bool = False
    log_level: str = "info"
    #: mixed-precision control: "auto" polishes f32-device results in f64
    #: on the host CPU (methods/xtb/polish.py), "off" disables. Only
    #: active when the working dtype is f32 (i.e. non-CPU backends).
    host_polish: str = "auto"
    #: pin the working dtype ("f32"/"f64"); None = by backend (factory)
    force_dtype: Optional[str] = None


def config_to_driver(cfg: MqcConfig) -> DriverConfig:
    method = MethodConfig(
        method_type=method_type_from_string(cfg.method),
        basis=cfg.basis,
        aux_basis=cfg.aux_basis,
        scf=ScfConfig(maxiter=cfg.scf_maxiter, tolerance=cfg.scf_tolerance),
        xtb=XtbConfig(
            solvent=cfg.solvent,
            solvation_model=cfg.solvation_model.lower(),
            use_cds=cfg.use_cds,
            use_shift=cfg.use_shift,
            dielectric=cfg.dielectric,
            cpcm_nang=cfg.cpcm_nang,
            cpcm_rscale=cfg.cpcm_rscale,
        ),
        verbose=cfg.log_level.strip().lower() in ("verbose", "debug"),
    )

    has_fragments = bool(cfg.fragments) or any(
        m.fragments for m in cfg.molecules
    )
    nlevel = cfg.level if has_fragments else 0

    return DriverConfig(
        calc_type=calc_type_from_string(cfg.driver_type),
        method=method,
        nlevel=nlevel,
        use_gmbe=cfg.allow_overlapping_fragments,
        max_intersection_level=(
            cfg.max_intersection_level
            if cfg.max_intersection_level is not None
            else DEFAULT_MAX_INTERSECTION
        ),
        cutoffs=dict(cfg.cutoffs),
        global_groups=cfg.global_groups,
        nodes_per_group=cfg.nodes_per_group,
        hessian=HessianKeywords(
            displacement=cfg.fd_displacement,
            temperature=cfg.temperature,
            pressure=cfg.pressure,
        ),
        skip_json_output=cfg.skip_json_output,
        log_level=cfg.log_level,
    )


def _check_overlap(fragments, allow_overlapping: bool) -> None:
    seen = {}
    for fi, frag in enumerate(fragments):
        for atom in frag.indices:
            if atom in seen and not allow_overlapping:
                raise InputError(
                    f"atom {atom} appears in fragments {seen[atom]} and {fi}; "
                    "set allow_overlapping_fragments for GMBE"
                )
            seen.setdefault(atom, fi)


def _molecule_to_system_geometry(
    mol, charge: int, multiplicity: int, allow_overlapping: bool
) -> SystemGeometry:
    geom = mol.geometry
    coords = coords_angstrom_to_bohr(geom.coords_angstrom)
    bonds = [
        Bond(b.atom_i, b.atom_j, order=b.order, is_broken=b.is_broken)
        for b in mol.bonds
    ]
    if mol.fragments:
        _check_overlap(mol.fragments, allow_overlapping)
        frag_atoms = [np.asarray(f.indices, dtype=np.int64) for f in mol.fragments]
        covered = set()
        for arr in frag_atoms:
            if arr.size and (arr.min() < 0 or arr.max() >= geom.n_atoms):
                raise InputError("fragment atom index out of range")
            covered.update(int(a) for a in arr)
        if not allow_overlapping and len(covered) != geom.n_atoms:
            raise InputError(
                f"fragments cover {len(covered)} of {geom.n_atoms} atoms"
            )
        sys_geom = SystemGeometry(
            numbers=geom.numbers,
            coords=coords,
            charge=charge,
            multiplicity=multiplicity,
            fragment_atoms=frag_atoms,
            fragment_charges=[f.charge for f in mol.fragments],
            fragment_multiplicities=[f.multiplicity for f in mol.fragments],
            bonds=bonds,
        )
    else:
        sys_geom = SystemGeometry(
            numbers=geom.numbers,
            coords=coords,
            charge=charge,
            multiplicity=multiplicity,
            bonds=bonds,
        ).as_single_monomer()
    sys_geom.validate()
    return sys_geom


def config_to_system_geometry(cfg: MqcConfig) -> SystemGeometry:
    """Single-molecule system geometry (fragmented or whole-system monomer)."""
    if cfg.molecules:
        raise InputError("multi-molecule config: use config_to_system_geometries")
    holder = MoleculeConfig(
        charge=cfg.charge,
        multiplicity=cfg.multiplicity,
        geometry=cfg.geometry,
        fragments=cfg.fragments,
        bonds=cfg.bonds,
    )
    return _molecule_to_system_geometry(
        holder, cfg.charge, cfg.multiplicity, cfg.allow_overlapping_fragments
    )


def config_to_system_geometries(cfg: MqcConfig) -> list:
    """All molecules of a (possibly multi-molecule) config as (name, geometry)."""
    out = []
    if cfg.molecules:
        for i, mol in enumerate(cfg.molecules):
            name = mol.name or f"molecule_{i + 1}"
            out.append(
                (
                    name,
                    _molecule_to_system_geometry(
                        mol,
                        mol.charge,
                        mol.multiplicity,
                        cfg.allow_overlapping_fragments,
                    ),
                )
            )
    else:
        out.append(("", config_to_system_geometry(cfg)))
    return out
