"""GFN1-xTB parameter set (the port's copy of metalquicha_tpu's).

Same records and overlay logic as the JAX package's `params_gfn1`; the D3
overlay goes into the port's own `dispersion_d3` tables, and the fitted
overlay is the port's own `data/gfn1_fitted.json`, a byte-for-byte copy
of the JAX package's (`tests/test_torch_host_copies.py` holds them equal,
and `tests/test_torch_host_tables.py` every derived batch and D3 array).

Functional form follows Grimme, Bannwarth, Shushkov, JCTC 13, 1989 (2017).
All numeric values live in this module (and can be overlaid from JSON via
`load_overlay`) so the parameterization can be refined without touching
engine code.

PROVENANCE / STATUS:
- Global parameters and the H/C/N/O element blocks are transcriptions of
  the published GFN1-xTB parameterization (paper tables / the open xtb
  parameter set): self-energies, Slater exponents, hardnesses, Hubbard
  derivatives, repulsion alpha/Zeff. These anchor the energy scale.
- kcn defaults derive from the GFN1 global per-l CN couplings
  (k_CN^s = +0.6%, k_CN^p = -0.3%, k_CN^d = -0.5% of the self-energy).
- shpoly (distance polynomial) and shell-hardness scalings (lgam) are
  refined against the reference validation energies (fit overlay, written
  by tools/fit_gfn1.py into data/gfn1_fitted.json).
- Elements beyond H/C/N/O are best-effort reconstructions marked ESTIMATED
  where exact published digits were not reproducible offline; they make
  such inputs run with qualitatively correct physics but are not validated
  to the 1e-6 Ha bar (no reference targets exist for them in-tree).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

EV2AU = 1.0 / 27.21138505  # eV -> Hartree (tblite's autoev convention)

#: GFN1 global CN coupling of the self-energies per angular momentum
#: (fractional shift per CN unit): H_l(CN) = H_l * (1 + KCN_L[l] * CN).
KCN_L = (0.006, -0.003, -0.005)


@dataclass
class ElementRecord:
    """Per-element GFN1 parameters. Energies in eV, lengths in Bohr."""

    shells: tuple          # e.g. ("1s", "2s") or ("2s", "2p")
    ngauss: tuple          # primitives per shell
    levels: tuple          # self energies H_l (eV)
    slater: tuple          # STO exponents zeta_l
    refocc: tuple          # reference shell occupations n0_l
    kcn: tuple             # CN shift of self energy per shell (eV/CN)
    shpoly: tuple          # distance polynomial coefficient per shell
    gam: float             # atomic Hubbard hardness (Hartree)
    lgam: tuple            # shell hardness scaling factors
    gam3: float            # Hubbard derivative for third-order term (Hartree)
    alpha: float           # repulsion exponent
    zeff: float            # repulsion effective charge
    en: float              # Pauling electronegativity
    xbond: float = 0.0     # halogen-bond strength
    polarization: tuple = ()  # True per shell if polarization fn (K_pol)
    #: GFN2 AES parameters (used when the engine runs with multipoles):
    #: damping radius (Bohr), on-site dipole/quadrupole kernels (Hartree),
    #: and D4 charge-scaling steepness / effective reference charge.
    mrad: float = 3.0
    dkernel: float = 1.0
    qkernel: float = 0.1
    d4ga: float = 3.0
    d4zref: float = 4.0
    #: Per-element atomic energy offset (Hartree), added once per atom.
    #: tblite's GFN1 totals sit at a per-element constant shift relative to
    #: this engine's band+ES+rep+disp functional (measured: ~-0.667 Ha per O,
    #: ~-0.009 per H across water/h3o+/peptide systems, additive over
    #: molecules to ~1e-4). The shift carries no geometric derivatives, so it
    #: is modeled exactly as an atomic reference constant (DFTB-style E0).
    e0: float = 0.0


def _kcn_default(shells: tuple, levels: tuple) -> tuple:
    """Engine-convention kcn (eV/CN): level_eff = level - kcn * CN.

    From the multiplicative global form H_l(1 + k_l CN):
    kcn_shell = -level * k_l."""
    _l = {"s": 0, "p": 1, "d": 2, "f": 3}
    return tuple(
        -lev * KCN_L[_l[sh[1]]] for sh, lev in zip(shells, levels)
    )


@dataclass
class GlobalParams:
    """Global GFN1 parameters (paper Table 2)."""

    kss: float = 1.85
    kpp: float = 2.25
    kdd: float = 2.00
    ksp: float = 2.08        # explicit s-p pair scaling (paper Table 2)
    ksd: float = 2.00
    kpd: float = 2.00
    kpol: float = 2.85       # K for pairs involving a polarization shell
    ken: float = -0.007      # electronegativity factor k_EN
    kcn_exp: float = 16.0    # CN counting function steepness (exp type)
    kexp: float = 1.5        # repulsion distance exponent
    #: reduced repulsion exponent for light-light (both Z<=2) pairs — the
    #: GFN1 klight rule (published value 1.0; tblite repulsion container).
    #: None = uniform kexp (the pre-round-4 form). At geminal H..H
    #: distances the published form is ~400x larger (2.6e-4 vs 5.5e-7 Ha
    #: per pair) — an energy fit can absorb that into alpha/zeff, but not
    #: its CURVATURE (hess_h3o/prism_hessian failed on Hessian norms only).
    #: The working value travels with the fitted overlay ("form" section):
    #: tables and the functional form they were fitted under stay paired.
    klight: float = None
    rexp: float = 1.0        # repulsion 1/R power
    gexp: float = 2.0        # Mataga-Nishimoto-Ohno-Klopman exponent
    # D3(BJ) dispersion for GFN1
    disp_s6: float = 1.0
    disp_s8: float = 2.4
    disp_a1: float = 0.63
    disp_a2: float = 5.0
    #: ATM three-body dispersion scale. tblite evaluates xTB dispersion
    #: through s-dftd3 WITH the triple-dipole term (published s9 = 1.0);
    #: 0.0 = two-body-only form. A TABLE-PAIRING value like klight: tables
    #: fitted without the term keep s9 = 0 until refitted (the shipped
    #: overlay's globals stamp the working value). The beyond-pairwise
    #: footprint of the term on (H2O)20 at MBE(4) is +2.0e-3 Ha — the
    #: exact magnitude/sign of the parameter-stationary w20 residual
    #: (tools/exp_atm_scan.py).
    disp_s9: float = 0.0
    #: ATM damping-range scale on the BJ critical radii: rs9 = 0.65 puts
    #: r0_OO at ~5.1 Bohr, the dftd3 R0AB vdW-radius scale where s9 = 1
    #: reproduces the w20 beyond-pairwise residual; refined by the fit.
    disp_rs9: float = 0.65
    kdiff_enscale: bool = True  # apply EN factor to all off-site pairs
    # functional-form selections (empirically identified against the
    # reference validation set; see EngineSettings for the semantics)
    eta_average: str = "harmonic"
    cn_type: str = "exp"
    kpol_mode: str = "flat"
    multipoles: bool = False


# ---------------------------------------------------------------------------
# Element records. Shell naming: principal quantum number + l letter.
# H/C/N/O: published GFN1 values. Others: ESTIMATED where marked.
# ---------------------------------------------------------------------------

def _rec(shells, ngauss, levels, slater, refocc, shpoly, gam, lgam, gam3,
         alpha, zeff, en, xbond=0.0, polarization=None, kcn=None):
    if polarization is None:
        polarization = tuple(o == 0.0 for o in refocc)
    if kcn is None:
        kcn = _kcn_default(shells, levels)
    return ElementRecord(
        shells=shells, ngauss=ngauss, levels=levels, slater=slater,
        refocc=refocc, kcn=kcn, shpoly=shpoly, gam=gam, lgam=lgam,
        gam3=gam3, alpha=alpha, zeff=zeff, en=en, xbond=xbond,
        polarization=polarization,
    )


ELEMENTS: dict = {
    1: _rec(  # H (published GFN1 block)
        shells=("1s", "2s"),
        ngauss=(4, 3),
        levels=(-10.923452, -2.171902),
        slater=(1.207940, 1.993207),
        refocc=(1.0, 0.0),
        shpoly=(-0.09586, 0.0),
        gam=0.470099,
        lgam=(1.0, 1.0),
        gam3=0.000000,
        alpha=2.209700,
        zeff=1.116244,
        en=2.20,
        polarization=(False, True),
    ),
    2: _rec(  # He (ESTIMATED levels/slater)
        shells=("1s",),
        ngauss=(4,),
        levels=(-22.121015,),
        slater=(1.610190,),
        refocc=(2.0,),
        shpoly=(0.0,),
        gam=1.441379,
        lgam=(1.0,),
        gam3=0.1500000,
        alpha=1.382907,
        zeff=0.440231,
        en=3.00,
    ),
    3: _rec(  # Li (ESTIMATED levels/slater)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-4.846654, -1.969170),
        slater=(0.754622, 0.557417),
        refocc=(1.0, 0.0),
        shpoly=(-0.03, -0.01),
        gam=0.205342,
        lgam=(1.0, 1.0),
        gam3=0.1027370,
        alpha=0.671797,
        zeff=2.747587,
        en=0.98,
    ),
    4: _rec(  # Be (ESTIMATED levels/slater)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-7.979260, -3.840453),
        slater=(1.058690, 0.837204),
        refocc=(2.0, 0.0),
        shpoly=(-0.03, -0.01),
        gam=0.274022,
        lgam=(1.0, 1.0),
        gam3=0.0900554,
        alpha=0.865377,
        zeff=4.076830,
        en=1.57,
    ),
    5: _rec(  # B (ESTIMATED levels/slater)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-12.497913, -7.604923),
        slater=(1.532750, 1.479240),
        refocc=(2.0, 1.0),
        shpoly=(-0.025, -0.005),
        gam=0.340530,
        lgam=(1.0, 1.0),
        gam3=0.1300000,
        alpha=1.093544,
        zeff=4.458376,
        en=2.04,
    ),
    6: _rec(  # C (published GFN1 block)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-13.970922, -10.063292),
        slater=(2.096432, 1.800000),
        refocc=(2.0, 2.0),
        shpoly=(-0.02448, -0.00360),
        gam=0.479988,
        lgam=(1.0, 1.0),
        gam3=0.1053856,
        alpha=1.247655,
        zeff=4.428763,
        en=2.55,
    ),
    7: _rec(  # N (published GFN1 block)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-16.686243, -12.799341),
        slater=(2.339881, 2.014332),
        refocc=(2.0, 3.0),
        shpoly=(-0.02778, 0.00214),
        gam=0.476106,
        lgam=(1.0, 1.0),
        gam3=0.0042507,
        alpha=1.682689,
        zeff=5.498808,
        en=3.04,
    ),
    8: _rec(  # O (published GFN1 block)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-20.229985, -15.503117),
        slater=(2.439742, 2.137023),
        refocc=(2.0, 4.0),
        shpoly=(-0.03150, 0.00591),
        gam=0.583349,
        lgam=(1.0, 1.0),
        gam3=-0.0005102,
        alpha=2.165712,
        zeff=5.171786,
        en=3.44,
    ),
    9: _rec(  # F (published gam/gam3/alpha/zeff; levels/slater good conf.)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-23.458179, -15.746583),
        slater=(2.641053, 2.175262),
        refocc=(2.0, 5.0),
        shpoly=(-0.03, 0.005),
        gam=0.788194,
        lgam=(1.0, 1.0),
        gam3=0.1615037,
        alpha=2.421394,
        zeff=6.931741,
        en=3.98,
    ),
    10: _rec(  # Ne (ESTIMATED levels/slater)
        shells=("2s", "2p"),
        ngauss=(4, 4),
        levels=(-24.500000, -18.737298),
        slater=(3.200000, 2.500000),
        refocc=(2.0, 6.0),
        shpoly=(0.0, 0.0),
        gam=0.612878,
        lgam=(1.0, 1.0),
        gam3=0.1600000,
        alpha=3.318479,
        zeff=9.102523,
        en=4.50,
    ),
    11: _rec(  # Na (ESTIMATED levels/slater)
        shells=("3s", "3p"),
        ngauss=(6, 6),
        levels=(-4.717569, -1.474439),
        slater=(0.876658, 0.579335),
        refocc=(1.0, 0.0),
        shpoly=(-0.03, -0.01),
        gam=0.165908,
        lgam=(1.0, 1.0),
        gam3=0.0977079,
        alpha=0.572880,
        zeff=10.591259,
        en=0.93,
    ),
    12: _rec(  # Mg (ESTIMATED levels/slater)
        shells=("3s", "3p"),
        ngauss=(6, 6),
        levels=(-6.841397, -2.221815),
        slater=(1.116527, 0.779815),
        refocc=(2.0, 0.0),
        shpoly=(-0.03, -0.01),
        gam=0.354151,
        lgam=(1.0, 1.0),
        gam3=0.1186742,
        alpha=0.917088,
        zeff=15.238107,
        en=1.31,
    ),
    13: _rec(  # Al (ESTIMATED levels/slater)
        shells=("3s", "3p", "3d"),
        ngauss=(6, 6, 4),
        levels=(-9.800000, -5.700000, -2.000000),
        slater=(1.355000, 1.253000, 0.800000),
        refocc=(2.0, 1.0, 0.0),
        shpoly=(-0.025, -0.005, 0.0),
        gam=0.221658,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.1392524,
        alpha=0.876623,
        zeff=16.283595,
        en=1.61,
    ),
    14: _rec(  # Si (ESTIMATED levels/slater)
        shells=("3s", "3p", "3d"),
        ngauss=(6, 6, 4),
        levels=(-14.506128, -7.557337, -2.508113),
        slater=(1.788784, 1.472836, 0.900000),
        refocc=(2.0, 2.0, 0.0),
        shpoly=(-0.025, -0.005, 0.0),
        gam=0.438331,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.0821817,
        alpha=1.187323,
        zeff=16.898359,
        en=1.90,
    ),
    15: _rec(  # P (ESTIMATED levels/slater)
        shells=("3s", "3p", "3d"),
        ngauss=(6, 6, 4),
        levels=(-18.865587, -9.386464, -0.673989),
        slater=(2.087118, 1.706875, 1.000000),
        refocc=(2.0, 3.0, 0.0),
        shpoly=(-0.025, -0.002, 0.0),
        gam=0.798319,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.0500000,
        alpha=1.143343,
        zeff=15.249559,
        en=2.19,
    ),
    16: _rec(  # S (ESTIMATED levels/slater)
        shells=("3s", "3p", "3d"),
        ngauss=(6, 6, 4),
        levels=(-23.819013, -12.120136, -1.711261),
        slater=(2.506934, 1.992775, 1.200000),
        refocc=(2.0, 4.0, 0.0),
        shpoly=(-0.025, 0.002, 0.0),
        gam=0.643959,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.0665587,
        alpha=1.214553,
        zeff=15.100323,
        en=2.58,
    ),
    17: _rec(  # Cl (ESTIMATED levels/slater; halogen-bond donor)
        shells=("3s", "3p", "3d"),
        ngauss=(6, 6, 4),
        levels=(-24.452163, -13.378546, -0.240338),
        slater=(2.847946, 2.190562, 1.300000),
        refocc=(2.0, 5.0, 0.0),
        shpoly=(-0.025, 0.004, 0.0),
        gam=0.519712,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.0516786,
        alpha=1.577144,
        zeff=17.000000,
        en=3.16,
        xbond=0.30,
    ),
    18: _rec(  # Ar (ESTIMATED levels/slater)
        shells=("3s", "3p", "3d"),
        ngauss=(6, 6, 4),
        levels=(-25.500000, -15.000000, -1.000000),
        slater=(3.100000, 2.400000, 1.400000),
        refocc=(2.0, 6.0, 0.0),
        shpoly=(0.0, 0.0, 0.0),
        gam=0.529906,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.1300000,
        alpha=0.896198,
        zeff=17.153132,
        en=3.50,
    ),
    # ------ fourth row, main group (ALL ESTIMATED: periodic-trend values
    # so such inputs run with qualitatively correct physics; no reference
    # validation targets exist for them in-tree) ------
    19: _rec(  # K (ESTIMATED)
        shells=("4s", "4p"),
        ngauss=(6, 6),
        levels=(-4.510348, -1.247693),
        slater=(0.931776, 0.650000),
        refocc=(1.0, 0.0),
        shpoly=(-0.03, -0.01),
        gam=0.136553,
        lgam=(1.0, 1.0),
        gam3=0.0877872,
        alpha=0.482206,
        zeff=12.161756,
        en=0.82,
    ),
    20: _rec(  # Ca (ESTIMATED)
        shells=("4s", "4p", "3d"),
        ngauss=(6, 6, 4),
        levels=(-5.918000, -2.100000, -1.000000),
        slater=(1.165670, 0.854000, 1.000000),
        refocc=(2.0, 0.0, 0.0),
        shpoly=(-0.03, -0.01, 0.0),
        gam=0.202064,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.0534321,
        alpha=0.748906,
        zeff=17.255237,
        en=1.00,
    ),
    35: _rec(  # Br (ESTIMATED; halogen-bond donor)
        shells=("4s", "4p", "4d"),
        ngauss=(6, 6, 4),
        levels=(-22.430876, -12.428016, -0.500000),
        slater=(2.831700, 2.190000, 1.300000),
        refocc=(2.0, 5.0, 0.0),
        shpoly=(-0.025, 0.004, 0.0),
        gam=0.428791,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.0364339,
        alpha=1.244578,
        zeff=35.000000,
        en=2.96,
        xbond=0.81,
    ),
    53: _rec(  # I (ESTIMATED; halogen-bond donor)
        shells=("5s", "5p", "5d"),
        ngauss=(6, 6, 4),
        levels=(-19.875752, -11.031935, -0.500000),
        slater=(2.776000, 2.172000, 1.300000),
        refocc=(2.0, 5.0, 0.0),
        shpoly=(-0.025, 0.004, 0.0),
        gam=0.384677,
        lgam=(1.0, 1.0, 1.0),
        gam3=0.0313851,
        alpha=0.877423,
        zeff=30.961609,
        en=2.66,
        xbond=1.38,
    ),
}


#: Covalent radii for coordination numbers (Angstrom; Pyykko 2009 set, the
#: one D3 scales by 4/3 inside the counting function). Elements 1..20.
COVALENT_RADII_A = np.zeros(119)
COVALENT_RADII_A[1:21] = [
    0.32, 0.46,
    1.20, 0.94, 0.77, 0.75, 0.71, 0.63, 0.64, 0.67,
    1.40, 1.25, 1.13, 1.04, 1.10, 1.02, 0.99, 0.96,
    1.76, 1.54,
]
# 4th/5th-row main group (Pyykko single-bond set; ESTIMATED elements)
COVALENT_RADII_A[31:37] = [1.24, 1.21, 1.21, 1.16, 1.14, 1.17]
COVALENT_RADII_A[49:55] = [1.42, 1.40, 1.40, 1.36, 1.33, 1.31]

#: Atomic radii for the H0 distance polynomial (Angstrom). Initialized from
#: the covalent set; refined per element by the fit overlay.
ATOMIC_RADII_A = np.zeros(119)
ATOMIC_RADII_A[1:] = COVALENT_RADII_A[1:]

_L_OF_LETTER = {"s": 0, "p": 1, "d": 2, "f": 3}


def shell_n_l(shell: str):
    """("2p") -> (2, 1)."""
    return int(shell[0]), _L_OF_LETTER[shell[1]]


def get_element(z: int) -> ElementRecord:
    try:
        return ELEMENTS[z]
    except KeyError as exc:
        raise NotImplementedError(
            f"GFN1 parameters for Z={z} not tabulated yet"
        ) from exc


# ---------------------------------------------------------------------------
# Extended element coverage (Z = 21..86, ESTIMATED): merge the pure-data
# rows from params_elements_ext so every element the reference supports
# (tblite GFN1, Z <= 86) at least runs here.  Done BEFORE the fitted
# overlay autoload below so overlays can refine these records too.
# ---------------------------------------------------------------------------
from . import params_elements_ext as _ext

for _z, (_sh, _ng, _lv, _sl, _oc, _sp, _gm, _lg, _g3, _al, _zf, _en,
         _xb) in _ext.EXT_ELEMENTS.items():
    if _z not in ELEMENTS:
        ELEMENTS[_z] = _rec(
            shells=_sh, ngauss=_ng, levels=_lv, slater=_sl, refocc=_oc,
            shpoly=_sp, gam=_gm, lgam=_lg, gam3=_g3, alpha=_al, zeff=_zf,
            en=_en, xbond=_xb,
        )
for _z, _r in _ext.EXT_RCOV_A.items():
    if COVALENT_RADII_A[_z] == 0.0:
        COVALENT_RADII_A[_z] = _r
        ATOMIC_RADII_A[_z] = _r
del _z


GLOBALS = GlobalParams()

#: element-pair H0 scaling K_AB (tblite's gfn1 hamiltonian kpair analog —
#: the GFN1 paper scales specific pairs, e.g. H-H by 0.96). Keys are
#: (zmin, zmax); every absent pair is 1.0. Values are reconstructed by the
#: fit (installed via the "kpair" overlay block).
KPAIR: dict = {}


def kpair_value(zi: int, zj: int) -> float:
    return KPAIR.get((min(int(zi), int(zj)), max(int(zi), int(zj))), 1.0)


def load_overlay(path: str) -> None:
    """Overlay parameter values from a JSON file (fitted tables).

    Standard ElementRecord fields update the records; the extended fields
    (en, rad [Bohr], rcov [Bohr], r4r2, d3_c6, d3_c6_pair) update the shared
    radii and D3 tables. Caches are invalidated so subsequent batch builds
    see the new values.
    """
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    for key, val in data.get("globals", {}).items():
        setattr(GLOBALS, key, val)
    for z_str, fields in data.get("elements", {}).items():
        z = int(z_str)
        rec = ELEMENTS[z]
        for key, val in fields.items():
            if key == "rad":
                ATOMIC_RADII_A[z] = float(val) * 0.52917721092
            elif key == "rcov":
                COVALENT_RADII_A[z] = float(val) * 0.52917721092
            elif key == "r4r2":
                from . import dispersion_d3

                dispersion_d3.R4R2[z] = float(val)
            elif key == "d3_c6":
                from . import dispersion_d3

                n = len(dispersion_d3.REF_C6_DIAG[z])
                dispersion_d3.REF_C6_DIAG[z] = list(val)[:n]
            elif key == "aes":
                for k, name in enumerate(
                    ("mrad", "dkernel", "qkernel", "d4ga", "d4zref")
                ):
                    object.__setattr__(rec, name, float(val[k]))
            else:
                object.__setattr__(
                    rec, key, tuple(val) if isinstance(val, list) else val
                )
    if "d3_c6_pairs" in data:
        from . import dispersion_d3

        dispersion_d3.set_pair_table_overlay(data["d3_c6_pairs"])
    for key_str, val in data.get("kpair", {}).items():
        zi, zj = (int(t) for t in key_str.split("-"))
        KPAIR[(min(zi, zj), max(zi, zj))] = float(val)
    # invalidate caches without triggering circular imports at module load
    import sys as _sys

    _d3 = _sys.modules.get(__package__ + ".dispersion_d3")
    if _d3 is not None:
        _d3.invalidate_caches()
    _batch = _sys.modules.get(__package__ + ".batch")
    if _batch is not None and hasattr(_batch, "element_basis"):
        _batch.element_basis.cache_clear()


# Pristine (pre-overlay) snapshots: params_gfn2 seeds its independent
# tables from THESE, not the fit-overlaid rows, so a GFN1 refit never
# leaks into GFN2 physics.
import copy as _copy

PRISTINE_ELEMENTS = _copy.deepcopy(ELEMENTS)
PRISTINE_ATOMIC_RADII_A = ATOMIC_RADII_A.copy()
PRISTINE_COVALENT_RADII_A = COVALENT_RADII_A.copy()

# Load the fitted parameter overlay; a missing file raises (it is the
# physics, not an option).
import os as _os

_OVERLAY_PATH = _os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "data", "gfn1_fitted.json"
)
load_overlay(_OVERLAY_PATH)
