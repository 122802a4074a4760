"""Geometry and fragment data model.

Host-side (NumPy) data model for molecular systems and physical fragments.
Coordinates are stored in Bohr internally; fragment `distance` (minimum
inter-monomer separation) is in Angstrom — matching the reference semantics
(upstream metalquicha src/fragmentation/common/mqc_physical_fragment.f90:43-100).

Behavioral parity notes (cited against the reference):
- n-mer charge = sum of constituent fragment charges; multiplicity is the
  fragment's own for monomers, the system's for n-mers (:356-379).
- Fragments built from explicit atom lists (GMBE PIE intersections) are always
  neutral singlets (:438-443).
- Hydrogen caps: one per broken bond with exactly one endpoint inside the
  fragment (XOR test, :185-197); the cap H is placed AT THE POSITION of the
  excluded atom (:222-239) and `cap_replaces_atom` records that atom's global
  index so cap derivatives can be redistributed onto it (:454-501).
- Atom pairs closer than MIN_ATOM_DISTANCE Bohr are an input error (:647-699).

Device-side padded/batched representations live in `parallel.executor`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import ANGSTROM_TO_BOHR, BOHR_TO_ANGSTROM
from .errors import InputError
from .limits import MIN_ATOM_DISTANCE


@dataclass
class Bond:
    """A bond between two atoms (0-indexed global atom indices)."""

    atom_i: int
    atom_j: int
    order: int = 1
    is_broken: bool = False


@dataclass
class SystemGeometry:
    """Full molecular system with its monomer partition.

    Attributes
    ----------
    numbers : (n_atoms,) int array of atomic numbers
    coords : (n_atoms, 3) float array in Bohr
    charge, multiplicity : total system charge / multiplicity
    fragment_atoms : list of int arrays — 0-indexed atoms of each monomer
    fragment_charges, fragment_multiplicities : per-monomer
    bonds : connectivity (for hydrogen capping of overlapping fragments)
    """

    numbers: np.ndarray
    coords: np.ndarray
    charge: int = 0
    multiplicity: int = 1
    fragment_atoms: list = field(default_factory=list)
    fragment_charges: list = field(default_factory=list)
    fragment_multiplicities: list = field(default_factory=list)
    bonds: list = field(default_factory=list)

    def __post_init__(self):
        self.numbers = np.asarray(self.numbers, dtype=np.int64)
        self.coords = np.asarray(self.coords, dtype=np.float64).reshape(-1, 3)
        if self.numbers.shape[0] != self.coords.shape[0]:
            raise InputError("numbers and coords length mismatch")

    @property
    def n_atoms(self) -> int:
        return int(self.numbers.shape[0])

    @property
    def n_monomers(self) -> int:
        return len(self.fragment_atoms)

    def validate(self) -> None:
        """Reject duplicate/overlapping atoms (< MIN_ATOM_DISTANCE Bohr)."""
        validate_min_distances(self.coords)

    def as_single_monomer(self) -> "SystemGeometry":
        """View of the whole system as one monomer (unfragmented path)."""
        return SystemGeometry(
            numbers=self.numbers,
            coords=self.coords,
            charge=self.charge,
            multiplicity=self.multiplicity,
            fragment_atoms=[np.arange(self.n_atoms, dtype=np.int64)],
            fragment_charges=[self.charge],
            fragment_multiplicities=[self.multiplicity],
            bonds=self.bonds,
        )


@dataclass
class PhysicalFragment:
    """A fragment ready for a QC calculation.

    Real atoms first, hydrogen caps appended at the end.
    `local_to_global[i]` maps each REAL atom to its system atom index;
    `cap_replaces_atom[k]` is the global index of the atom replaced by cap k.
    """

    numbers: np.ndarray
    coords: np.ndarray  # (n_atoms + n_caps, 3) Bohr
    charge: int
    multiplicity: int
    local_to_global: np.ndarray
    n_caps: int = 0
    cap_replaces_atom: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    distance: float = 0.0  # min inter-monomer distance, Angstrom
    monomer_indices: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )

    @property
    def n_total(self) -> int:
        """Real atoms + caps."""
        return int(self.numbers.shape[0])

    @property
    def n_real(self) -> int:
        return self.n_total - self.n_caps

    @property
    def n_electrons(self) -> int:
        return int(self.numbers.sum()) - self.charge


def validate_min_distances(coords: np.ndarray, threshold: float = MIN_ATOM_DISTANCE):
    """Raise InputError if any atom pair is closer than `threshold` Bohr."""
    n = coords.shape[0]
    if n < 2:
        return
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    iu = np.triu_indices(n, k=1)
    bad = dist[iu] < threshold
    if bad.any():
        i = int(iu[0][bad.argmax()])
        j = int(iu[1][bad.argmax()])
        raise InputError(
            f"atoms {i} and {j} are {dist[i, j]:.6f} Bohr apart "
            f"(< {threshold} Bohr): duplicate or overlapping atoms"
        )


def min_inter_monomer_distance(
    sys_geom: SystemGeometry, monomer_indices: np.ndarray
) -> float:
    """Minimum distance (Angstrom) between atoms of distinct monomers.

    Returns 0.0 for single monomers, matching the reference
    (mqc_physical_fragment.f90:757-835).
    """
    mono = np.asarray(monomer_indices, dtype=np.int64)
    if mono.shape[0] < 2:
        return 0.0
    best = np.inf
    for a in range(mono.shape[0]):
        atoms_a = sys_geom.fragment_atoms[mono[a]]
        ca = sys_geom.coords[atoms_a]
        for b in range(a + 1, mono.shape[0]):
            atoms_b = sys_geom.fragment_atoms[mono[b]]
            cb = sys_geom.coords[atoms_b]
            d = np.sqrt(((ca[:, None, :] - cb[None, :, :]) ** 2).sum(-1)).min()
            best = min(best, float(d))
    return best * BOHR_TO_ANGSTROM


def _find_caps(atom_set: set, bonds) -> list:
    """Broken bonds with exactly one endpoint inside the fragment.

    Returns [(inside_atom, excluded_atom), ...] — one H cap each.
    """
    caps = []
    for bond in bonds:
        if not bond.is_broken:
            continue
        i_in = bond.atom_i in atom_set
        j_in = bond.atom_j in atom_set
        if i_in != j_in:  # XOR: bond crosses the fragment boundary
            inside, outside = (
                (bond.atom_i, bond.atom_j) if i_in else (bond.atom_j, bond.atom_i)
            )
            caps.append((inside, outside))
    return caps


def _assemble_fragment(
    sys_geom: SystemGeometry,
    atoms: np.ndarray,
    charge: int,
    multiplicity: int,
    monomer_indices: np.ndarray,
    distance: float,
) -> PhysicalFragment:
    atoms = np.asarray(atoms, dtype=np.int64)
    atom_set = set(int(a) for a in atoms)
    caps = _find_caps(atom_set, sys_geom.bonds)

    numbers = sys_geom.numbers[atoms]
    coords = sys_geom.coords[atoms]
    cap_replaces = np.array([out for (_, out) in caps], dtype=np.int64)
    if caps:
        cap_coords = sys_geom.coords[cap_replaces]
        numbers = np.concatenate([numbers, np.ones(len(caps), dtype=np.int64)])
        coords = np.concatenate([coords, cap_coords], axis=0)

    frag = PhysicalFragment(
        numbers=numbers,
        coords=coords,
        charge=charge,
        multiplicity=multiplicity,
        local_to_global=atoms,
        n_caps=len(caps),
        cap_replaces_atom=cap_replaces,
        distance=distance,
        monomer_indices=np.asarray(monomer_indices, dtype=np.int64),
    )
    validate_min_distances(frag.coords[: frag.n_real])
    return frag


def build_fragment_from_indices(
    sys_geom: SystemGeometry, monomer_indices
) -> PhysicalFragment:
    """Build an n-mer fragment as the union of monomers.

    Charge is the sum of constituent fragment charges; multiplicity is the
    monomer's own for 1-mers and the system's for n-mers
    (mqc_physical_fragment.f90:356-379).
    """
    mono = np.asarray(monomer_indices, dtype=np.int64)
    mono = mono[mono >= 0]
    if mono.size == 0:
        raise InputError("empty monomer index list")
    atoms = np.concatenate([sys_geom.fragment_atoms[m] for m in mono])
    charge = int(sum(sys_geom.fragment_charges[m] for m in mono))
    if mono.size == 1:
        multiplicity = int(sys_geom.fragment_multiplicities[mono[0]])
    else:
        multiplicity = int(sys_geom.multiplicity)
    distance = min_inter_monomer_distance(sys_geom, mono)
    return _assemble_fragment(sys_geom, atoms, charge, multiplicity, mono, distance)


def build_fragment_from_atom_list(
    sys_geom: SystemGeometry, atom_list
) -> PhysicalFragment:
    """Build a fragment from an explicit 0-indexed atom list.

    Used for GMBE PIE intersection terms — always a neutral singlet
    (mqc_physical_fragment.f90:438-443).
    """
    atoms = np.asarray(atom_list, dtype=np.int64)
    atoms = atoms[atoms >= 0]
    return _assemble_fragment(
        sys_geom,
        atoms,
        charge=0,
        multiplicity=1,
        monomer_indices=np.zeros(0, dtype=np.int64),
        distance=0.0,
    )


# ---------------------------------------------------------------------------
# Cap derivative redistribution (mqc_physical_fragment.f90:454-645)
# ---------------------------------------------------------------------------


def redistribute_gradient(
    frag: PhysicalFragment, grad_frag: np.ndarray, grad_sys: np.ndarray, scale=1.0
) -> None:
    """Scatter-add a fragment gradient (n_total,3) into the system gradient.

    Real-atom rows go to their global atoms; each cap row is ADDED to the atom
    it replaces (:454-501).
    """
    np.add.at(grad_sys, frag.local_to_global, scale * grad_frag[: frag.n_real])
    if frag.n_caps:
        np.add.at(grad_sys, frag.cap_replaces_atom, scale * grad_frag[frag.n_real:])


def _global_rows(frag: PhysicalFragment) -> np.ndarray:
    """Global atom index for every fragment row (real atoms then caps)."""
    if frag.n_caps:
        return np.concatenate([frag.local_to_global, frag.cap_replaces_atom])
    return frag.local_to_global


def redistribute_hessian(
    frag: PhysicalFragment, hess_frag: np.ndarray, hess_sys: np.ndarray, scale=1.0
) -> None:
    """Scatter-add a fragment Hessian (3m,3m) into the system Hessian (3N,3N).

    Handles real-real, cap-row, cap-col and cap-cap 3x3 blocks by mapping caps
    onto their replaced atoms (:503-595).
    """
    gidx = _global_rows(frag)
    m = gidx.shape[0]
    h = hess_frag.reshape(m, 3, m, 3)
    for a in range(m):
        ga = gidx[a]
        for b in range(m):
            gb = gidx[b]
            hess_sys[3 * ga: 3 * ga + 3, 3 * gb: 3 * gb + 3] += scale * h[a, :, b, :]


def redistribute_dipole_derivatives(
    frag: PhysicalFragment, dmu_frag: np.ndarray, dmu_sys: np.ndarray, scale=1.0
) -> None:
    """Scatter-add fragment dipole derivatives (3, 3m) into system (3, 3N)."""
    gidx = _global_rows(frag)
    for a, ga in enumerate(gidx):
        dmu_sys[:, 3 * ga: 3 * ga + 3] += scale * dmu_frag[:, 3 * a: 3 * a + 3]


def coords_angstrom_to_bohr(coords: np.ndarray) -> np.ndarray:
    return np.asarray(coords, dtype=np.float64) * ANGSTROM_TO_BOHR
