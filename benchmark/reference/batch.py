"""Padded, batched fragment representation for the xTB engine.

The port's copy of metalquicha_tpu's `batch.py`, built on the port's own
`params_gfn1` and `basis`. The NumPy arrays it builds are
held equal to the JAX package's by `tests/test_torch_host_tables.py`;
`calculator.fragment_data_from_batch` turns them into batch-first tensors
on the device.

Padding conventions:
- atoms: mask=0, numbers=0, coords placed far away on a diagonal line to
  keep pair distances finite and distinct (no 0/0 in traced math)
- shells: mask=0, level=+PAD_LEVEL (Hartree) so padded orbitals stay empty
- AOs: prim_coeff=0 rows; overlap gives identity on the padded diagonal
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .units import ANGSTROM_TO_BOHR
from .basis import (
    CARTESIAN_COMPONENTS,
    D_SPHERICAL_FROM_CART,
    orthogonalize_against,
    primitive_norm,
    slater_to_gauss,
)
from . import params_gfn1

PAD_LEVEL = 100.0  # Hartree; self-energy of padded shells
PAD_COORD_STEP = 1000.0  # Bohr between padded atoms

#: order of the traced global-constant vector carried per fragment
#: (differentiable in the parameter fit, sourced from params.GLOBALS)
GLB_FIELDS = ("kss", "ksp", "ksd", "kpp", "kpd", "kdd", "kpol", "ken",
              "kexp", "rexp", "gexp", "kcn_exp",
              "disp_s6", "disp_s8", "disp_a1", "disp_a2",
              "disp_s9", "disp_rs9")


def _params_module(variant: str):
    if variant != "gfn1":
        raise ValueError(f"the reference holds GFN1 alone, not {variant!r}")
    return params_gfn1


def global_vector(variant: str = "gfn1") -> np.ndarray:
    g = _params_module(variant).GLOBALS
    return np.array([getattr(g, f) for f in GLB_FIELDS], dtype=np.float64)


@dataclass
class ElementBasis:
    """Precomputed per-element basis/parameter data (host-side)."""

    z: int
    n_shells: int
    shell_l: np.ndarray
    shell_level: np.ndarray  # Hartree
    shell_kcn: np.ndarray    # Hartree
    shell_poly: np.ndarray
    shell_eta: np.ndarray    # Hartree (shell-scaled hardness)
    shell_refocc: np.ndarray
    shell_pol: np.ndarray    # bool
    prim_alpha: list         # per shell: (nprim,) arrays
    prim_coeff: list         # per shell: (nprim,) arrays (contraction coeffs)
    gam3: float
    alpha_rep: float
    zeff: float
    en: float
    rcov_bohr: float
    rad_bohr: float
    n_ao: int
    e0: float = 0.0
    xbond: float = 0.0
    aes: tuple = (3.0, 1.0, 0.1, 3.0, 4.0)  # mrad, dkernel, qkernel, d4ga, d4zref


@lru_cache(maxsize=None)
def element_basis(z: int, variant: str = "gfn1") -> ElementBasis:
    params = _params_module(variant)

    rec = params.get_element(z)
    nsh = len(rec.shells)
    shell_l = np.zeros(nsh, dtype=np.int64)
    alphas_list, coeffs_list = [], []
    for i, shell in enumerate(rec.shells):
        n, l = params.shell_n_l(shell)
        shell_l[i] = l
        a, c = slater_to_gauss(rec.ngauss[i], n, l, rec.slater[i])
        alphas_list.append(a)
        coeffs_list.append(c)

    # Orthogonalize same-l same-atom shell pairs (H/He valence vs polarization)
    for i in range(nsh):
        for j in range(i + 1, nsh):
            if shell_l[i] == shell_l[j]:
                alphas_list[j], coeffs_list[j] = orthogonalize_against(
                    alphas_list[i], coeffs_list[i],
                    alphas_list[j], coeffs_list[j],
                    int(shell_l[i]),
                )

    pol = rec.polarization if rec.polarization else tuple(False for _ in range(nsh))
    # spherical AO counts: 1 (s), 3 (p), 5 (d; cartesian components are
    # contracted into spherical harmonics at batch-build time)
    n_ao = int(sum(2 * l + 1 for l in shell_l))
    return ElementBasis(
        z=z,
        n_shells=nsh,
        shell_l=shell_l,
        shell_level=np.array(rec.levels) * params_gfn1.EV2AU,
        shell_kcn=np.array(rec.kcn) * params_gfn1.EV2AU,
        shell_poly=np.array(rec.shpoly),
        shell_eta=rec.gam * np.array(rec.lgam),
        shell_refocc=np.array(rec.refocc),
        shell_pol=np.array(pol, dtype=bool),
        prim_alpha=alphas_list,
        prim_coeff=coeffs_list,
        gam3=rec.gam3,
        alpha_rep=rec.alpha,
        zeff=rec.zeff,
        en=rec.en,
        rcov_bohr=float(params.COVALENT_RADII_A[z]) * ANGSTROM_TO_BOHR,
        rad_bohr=float(params.ATOMIC_RADII_A[z]) * ANGSTROM_TO_BOHR,
        n_ao=n_ao,
        e0=float(getattr(rec, "e0", 0.0)),
        xbond=float(getattr(rec, "xbond", 0.0)),
        aes=(
            float(getattr(rec, "mrad", 3.0)),
            float(getattr(rec, "dkernel", 1.0)),
            float(getattr(rec, "qkernel", 0.1)),
            float(getattr(rec, "d4ga", 3.0)),
            float(getattr(rec, "d4zref", rec.refocc and sum(rec.refocc) or 4.0)),
        ),
    )


def valence_electrons(z: int, variant: str = "gfn1") -> float:
    return float(element_basis(z, variant).shell_refocc.sum())


@dataclass
class XtbBatch:
    """Dense padded batch (all arrays NumPy; converted to tensors by the
    calculator).

    Leading axis B = fragments. Static sizes: nat, nsh, nao, nprim.
    """

    numbers: np.ndarray      # (B, nat) int
    coords: np.ndarray       # (B, nat, 3) f64, Bohr
    atom_mask: np.ndarray    # (B, nat) f64 0/1
    nelec: np.ndarray        # (B,) valence electron count
    nuhf: np.ndarray         # (B,) unpaired electrons
    charge: np.ndarray       # (B,)
    # shells
    sh_atom: np.ndarray      # (B, nsh)
    sh_mask: np.ndarray      # (B, nsh)
    sh_l: np.ndarray         # (B, nsh)
    sh_level: np.ndarray
    sh_kcn: np.ndarray
    sh_poly: np.ndarray
    sh_eta: np.ndarray
    sh_refocc: np.ndarray
    sh_pol: np.ndarray       # (B, nsh) 0/1
    # AOs
    ao_atom: np.ndarray      # (B, nao)
    ao_shell: np.ndarray     # (B, nao)
    ao_lxyz: np.ndarray      # (B, nao, nprim, 3) cartesian powers PER ENTRY
    ao_mask: np.ndarray      # (B, nao)
    prim_alpha: np.ndarray   # (B, nao, nprim)
    prim_coeff: np.ndarray   # (B, nao, nprim) includes cartesian norms
    # atoms
    at_gam3: np.ndarray
    at_alpha: np.ndarray
    at_zeff: np.ndarray
    at_en: np.ndarray
    at_rcov: np.ndarray
    at_rad: np.ndarray
    at_e0: np.ndarray
    at_xbond: np.ndarray
    at_aes: np.ndarray       # (B, nat, 5) mrad/dkernel/qkernel/d4ga/d4zref
    at_kpair: np.ndarray     # (B, nat, nat) element-pair H0 scaling K_AB
    glb: np.ndarray          # (B, len(GLB_FIELDS)) global constants

    @property
    def n_fragments(self) -> int:
        return self.numbers.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.numbers.shape[1]


def _sizes_for(numbers_list, variant: str):
    nat = nsh = nao = nprim = 0
    for numbers in numbers_list:
        a = s = o = 0
        for z in numbers:
            eb = element_basis(int(z), variant)
            a += 1
            s += eb.n_shells
            o += eb.n_ao
            for l, al in zip(eb.shell_l, eb.prim_alpha):
                # d AOs fold up to 3 cartesian components into the
                # primitive axis (spherical-harmonic contraction)
                comps = 3 if int(l) == 2 else 1
                nprim = max(nprim, comps * len(al))
        nat, nsh, nao = max(nat, a), max(nsh, s), max(nao, o)
    return nat, nsh, nao, nprim


def build_batch(
    fragments,
    variant: str = "gfn1",
    pad_to=None,
) -> XtbBatch:
    """Build a padded batch from (numbers, coords_bohr, charge, multiplicity)
    tuples or PhysicalFragment objects.

    pad_to: optional (nat, nsh, nao) to force bucket sizes (the executor's
    size buckets).
    """
    norm = []
    for frag in fragments:
        if hasattr(frag, "numbers"):
            charge = getattr(frag, "charge", 0)
            mult = getattr(frag, "multiplicity", 1)
            norm.append((np.asarray(frag.numbers), np.asarray(frag.coords), charge, mult))
        else:
            numbers, coords, charge, mult = frag
            norm.append((np.asarray(numbers), np.asarray(coords), charge, mult))

    nat0, nsh0, nao0, nprim = _sizes_for([n for n, *_ in norm], variant)
    if pad_to is not None:
        nat, nsh, nao = max(nat0, pad_to[0]), max(nsh0, pad_to[1]), max(nao0, pad_to[2])
    else:
        nat, nsh, nao = nat0, nsh0, nao0
    B = len(norm)

    out = XtbBatch(
        numbers=np.zeros((B, nat), dtype=np.int64),
        coords=np.zeros((B, nat, 3)),
        atom_mask=np.zeros((B, nat)),
        nelec=np.zeros(B),
        nuhf=np.zeros(B),
        charge=np.zeros(B),
        sh_atom=np.zeros((B, nsh), dtype=np.int64),
        sh_mask=np.zeros((B, nsh)),
        sh_l=np.zeros((B, nsh), dtype=np.int64),
        sh_level=np.full((B, nsh), PAD_LEVEL),
        sh_kcn=np.zeros((B, nsh)),
        sh_poly=np.zeros((B, nsh)),
        sh_eta=np.full((B, nsh), 1.0),
        sh_refocc=np.zeros((B, nsh)),
        sh_pol=np.zeros((B, nsh)),
        ao_atom=np.zeros((B, nao), dtype=np.int64),
        ao_shell=np.zeros((B, nao), dtype=np.int64),
        ao_lxyz=np.zeros((B, nao, nprim, 3), dtype=np.int64),
        ao_mask=np.zeros((B, nao)),
        prim_alpha=np.zeros((B, nao, nprim)),
        prim_coeff=np.zeros((B, nao, nprim)),
        at_gam3=np.zeros((B, nat)),
        at_alpha=np.full((B, nat), 1.0),
        at_zeff=np.zeros((B, nat)),
        at_en=np.zeros((B, nat)),
        at_rcov=np.zeros((B, nat)),
        at_rad=np.full((B, nat), 1.0),
        at_e0=np.zeros((B, nat)),
        at_xbond=np.zeros((B, nat)),
        at_aes=np.tile(
            np.array([3.0, 1.0, 0.1, 3.0, 4.0]), (B, nat, 1)
        ),
        at_kpair=np.ones((B, nat, nat)),
        glb=np.tile(global_vector(variant), (B, 1)),
    )

    for b, (numbers, coords, charge, mult) in enumerate(norm):
        na = len(numbers)
        out.numbers[b, :na] = numbers
        out.coords[b, :na] = coords
        out.atom_mask[b, :na] = 1.0
        # park padded atoms far apart from everything and each other
        for pad_i in range(na, nat):
            out.coords[b, pad_i] = (pad_i + 1) * PAD_COORD_STEP
        out.charge[b] = charge
        out.nuhf[b] = mult - 1
        _kp = _params_module(variant)
        if _kp.KPAIR:  # all-1.0 default already allocated; fill only if set
            kv = _kp.kpair_value
            for ia, zi in enumerate(numbers):
                for ja, zj in enumerate(numbers):
                    out.at_kpair[b, ia, ja] = kv(zi, zj)
        isx = iao = 0
        nelec = 0.0
        for ia, z in enumerate(numbers):
            eb = element_basis(int(z), variant)
            nelec += eb.shell_refocc.sum()
            out.at_gam3[b, ia] = eb.gam3
            out.at_alpha[b, ia] = eb.alpha_rep
            out.at_zeff[b, ia] = eb.zeff
            out.at_en[b, ia] = eb.en
            out.at_rcov[b, ia] = eb.rcov_bohr
            out.at_rad[b, ia] = eb.rad_bohr
            out.at_e0[b, ia] = eb.e0
            out.at_xbond[b, ia] = eb.xbond
            out.at_aes[b, ia] = eb.aes
            for s in range(eb.n_shells):
                out.sh_atom[b, isx] = ia
                out.sh_mask[b, isx] = 1.0
                out.sh_l[b, isx] = eb.shell_l[s]
                out.sh_level[b, isx] = eb.shell_level[s]
                out.sh_kcn[b, isx] = eb.shell_kcn[s]
                out.sh_poly[b, isx] = eb.shell_poly[s]
                out.sh_eta[b, isx] = eb.shell_eta[s]
                out.sh_refocc[b, isx] = eb.shell_refocc[s]
                out.sh_pol[b, isx] = float(eb.shell_pol[s])
                l = int(eb.shell_l[s])
                alphas = eb.prim_alpha[s]
                coeffs = eb.prim_coeff[s]
                if l < 2:
                    for lxyz in CARTESIAN_COMPONENTS[l]:
                        out.ao_atom[b, iao] = ia
                        out.ao_shell[b, iao] = isx
                        out.ao_mask[b, iao] = 1.0
                        for ip, (a, c) in enumerate(zip(alphas, coeffs)):
                            out.prim_alpha[b, iao, ip] = a
                            out.prim_coeff[b, iao, ip] = c * primitive_norm(a, *lxyz)
                            out.ao_lxyz[b, iao, ip] = lxyz
                        iao += 1
                else:
                    # 5 spherical d AOs: contract normalized cartesian
                    # components into the primitive axis
                    cart = CARTESIAN_COMPONENTS[2]
                    for row in D_SPHERICAL_FROM_CART:
                        out.ao_atom[b, iao] = ia
                        out.ao_shell[b, iao] = isx
                        out.ao_mask[b, iao] = 1.0
                        ip = 0
                        for ci, lxyz in zip(row, cart):
                            if ci == 0.0:
                                continue
                            for a, c in zip(alphas, coeffs):
                                out.prim_alpha[b, iao, ip] = a
                                out.prim_coeff[b, iao, ip] = (
                                    ci * c * primitive_norm(a, *lxyz)
                                )
                                out.ao_lxyz[b, iao, ip] = lxyz
                                ip += 1
                        iao += 1
                isx += 1
        out.nelec[b] = nelec - charge
        # padded AOs point at padded atom slots so distances stay huge
        for pad_ao in range(iao, nao):
            out.ao_atom[b, pad_ao] = min(nat - 1, na + (pad_ao - iao) % max(1, nat - na))
        for pad_sh in range(isx, nsh):
            out.sh_atom[b, pad_sh] = nat - 1

    return out
