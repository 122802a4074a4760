"""D3(BJ) two-body and ATM three-body dispersion for xTB, in torch.

Counterpart of metalquicha_tpu's `dispersion_d3.py`. Its NumPy half (the
reference tables, the ext-element merge, `build_d3_tables` and
`full_pair_table`) is the port's own copy; `params_gfn1.load_overlay`
writes the fitted overlay into THESE tables; GFN2 reads the pristine
snapshots taken before it (`fitted=False`) and scales the pair C6 by its
charge functions (`d3_energy(c6_scale=)`).

CN-interpolated reference C6 coefficients with Becke-Johnson rational
damping (Grimme et al., JCP 132, 154104 (2010); JCC 32, 1456 (2011)):

    C6_AB(cnA, cnB) = sum_ij wA_i(cnA) wB_j(cnB) C6ref[zA, zB, i, j]

The energy functions take batch-first tensors with a leading fragment axis.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .plain import fragment_sum, pair_bilinear
from .params_elements_ext import (
    EXT_C6_REFS as _EXT_C6,
    EXT_R4R2 as _EXT_R4R2,
)

# Reference coordination numbers per element (dftd3 reference systems)
REF_CN = {
    1: [0.9118, 0.0000],
    6: [0.0000, 0.9868, 1.9985, 2.9987, 3.9844],
    7: [0.0000, 0.9944, 2.0143, 2.9903],
    8: [0.0000, 0.9925, 1.9887],
    9: [0.0000, 0.9982],
    11: [0.0000, 0.9684],
    12: [0.0000, 1.9465],
    14: [0.0000, 0.9573, 1.9444, 2.9413, 3.8677],
    15: [0.0000, 0.9888, 2.9834],
    16: [0.0000, 0.9948, 1.9902],
    17: [0.0000, 0.9972],
    13: [0.0000, 2.9153],
    18: [0.0000],
    19: [0.0000, 0.9339],
    20: [0.0000, 1.9264],
    35: [0.0000, 0.9967],
    53: [0.0000, 0.9955],
}

# Diagonal (same element, same reference) C6 values in a.u.
# H/C/N/O from the dftd3 set; others best-effort (refined by overlay).
REF_C6_DIAG = {
    1: [3.0267, 7.5916],
    6: [49.1130, 43.2452, 29.3602, 25.7809, 18.2067],
    7: [25.2685, 22.1241, 19.6745, 15.5817],
    8: [15.5059, 12.8161, 10.3708],
    9: [9.6916, 7.1443],
    11: [1608.0286, 144.0948],
    12: [683.3758, 171.1804],
    14: [504.0000, 381.0000, 327.0000, 305.0000, 285.0000],
    15: [185.0000, 161.0000, 136.0000],
    16: [134.0000, 115.0000, 98.0000],
    17: [92.3460, 67.1400],
    13: [540.5406, 306.3773],
    18: [64.6462],
    19: [3889.9025, 305.6094],
    20: [2352.6862, 436.0038],
    35: [162.0000, 124.0000],
    53: [385.0000, 305.0000],
}

# sqrt(Z) <r^4>/<r^2> derived factors (dftd3 r2r4 array)
R4R2 = {
    1: 2.00734898,
    2: 1.56637132,
    3: 5.01986934,
    4: 3.85379032,
    5: 3.64446594,
    6: 3.10492822,
    7: 2.71175247,
    8: 2.59361680,
    9: 2.38825250,
    10: 2.21522516,
    11: 6.58585536,
    12: 5.46295967,
    13: 5.65216669,
    14: 4.88284902,
    15: 4.29727576,
    16: 4.04108902,
    17: 3.72932356,
    18: 3.44677275,
    19: 7.97762753,
    20: 7.07623947,
    31: 6.12101997,
    32: 5.54005982,
    33: 5.26619080,
    34: 5.12452205,
    35: 4.85787964,
    36: 4.60044341,
    53: 5.53441907,
}

#: the CORE element set carries the dense reference PAIR table; extended
#: elements interact via the geometric-mean factorization instead
D3_CORE = tuple(sorted(REF_CN))

# Extended element coverage (Z = 21..86, ESTIMATED trend data) — diagonal
# reference systems only; pair C6 for any pair involving an extended
# element factorizes as sqrt(C6_ii) * sqrt(C6_jj).
for _z, _refs in _EXT_C6.items():
    if _z not in REF_CN:
        REF_CN[_z] = [cn for cn, _ in _refs]
        REF_C6_DIAG[_z] = [c6 for _, c6 in _refs]
R4R2.update({_z: _v for _z, _v in _EXT_R4R2.items() if _z not in R4R2})
del _z

# Pristine (pre-overlay) snapshots. params_gfn1.load_overlay mutates
# REF_C6_DIAG / R4R2 in place with GFN1-fitted values; the GFN2 path reads
# THESE instead (fitted=False below) so a GFN1 refit can never move GFN2
# dispersion.
PRISTINE_REF_C6_DIAG = {z: list(v) for z, v in REF_C6_DIAG.items()}
PRISTINE_R4R2 = dict(R4R2)

K1 = 16.0  # CN counting steepness
K3 = 4.0   # gaussian weighting exponent

MAX_REFS = 5

#: fixed element index space for the pair table (core elements only;
#: extended elements use the sqrt-diagonal factorization with zidx = -1)
D3_ELEMENTS = D3_CORE
_Z_TO_IDX = {z: i for i, z in enumerate(D3_ELEMENTS)}

#: fitted pair-table overrides: {(zlo, zhi): np.ndarray (n_lo, n_hi)}
_PAIR_OVERRIDES: dict = {}


def set_pair_table_overlay(data: dict) -> None:
    """Install fitted pair C6 grids: {"z1-z2": [[...]]} (z1 <= z2)."""
    for key, grid in data.items():
        z1, z2 = (int(p) for p in key.split("-"))
        zlo, zhi = min(z1, z2), max(z1, z2)
        _PAIR_OVERRIDES[(zlo, zhi)] = np.asarray(grid, dtype=float)
    invalidate_caches()


def invalidate_caches() -> None:
    _element_ref_arrays.cache_clear()
    full_pair_table.cache_clear()


@lru_cache(maxsize=None)
def _element_ref_arrays(z: int, fitted: bool = True):
    cns = REF_CN.get(z)
    if cns is None:
        raise NotImplementedError(f"D3 reference data for Z={z} not tabulated")
    c6 = (REF_C6_DIAG if fitted else PRISTINE_REF_C6_DIAG)[z]
    n = len(cns)
    cn_pad = np.full(MAX_REFS, 1.0e6)  # huge CN -> zero weight
    c6_pad = np.zeros(MAX_REFS)
    cn_pad[:n] = cns
    c6_pad[:n] = c6
    return cn_pad, c6_pad, n


@lru_cache(maxsize=None)
def full_pair_table(fitted: bool = True):
    """(NZ, NZ, MAX_REFS, MAX_REFS) reference pair C6 table.

    Geometric-mean seed from the diagonal values; with fitted=True (GFN1)
    overridden per pair by the fitted grids. fitted=False (GFN2) keeps the
    pure geometric-mean factorization of the pristine diagonal: the pair
    grids are refined against GFN1 energies and must not reach GFN2's
    in-loop charge-scaled dispersion. Symmetric: T[i,j,a,b] == T[j,i,b,a]."""
    nz = len(D3_ELEMENTS)
    table = np.zeros((nz, nz, MAX_REFS, MAX_REFS))
    sqrt_diag = {}
    for z in D3_ELEMENTS:
        _cn, c6, n = _element_ref_arrays(z, fitted)
        sqrt_diag[z] = np.sqrt(c6)
    for i, zi in enumerate(D3_ELEMENTS):
        for j, zj in enumerate(D3_ELEMENTS):
            table[i, j] = np.outer(sqrt_diag[zi], sqrt_diag[zj])
    if not fitted:
        return table
    for (zlo, zhi), grid in _PAIR_OVERRIDES.items():
        if zlo not in _Z_TO_IDX or zhi not in _Z_TO_IDX:
            continue
        i, j = _Z_TO_IDX[zlo], _Z_TO_IDX[zhi]
        nlo, nhi = grid.shape
        table[i, j, :nlo, :nhi] = grid
        table[j, i, :nhi, :nlo] = grid.T
    return table


def build_d3_tables(numbers: np.ndarray, fitted: bool = True):
    """Host-side per-atom D3 data for a (padded) fragment.

    Returns dict of arrays: ref_cn (nat, R), zidx (nat,) index into
    D3_ELEMENTS (-1 for extended elements outside the core pair table),
    sqrtc6 (nat, R) sqrt of the diagonal reference C6 (the geometric-mean
    fallback factor), r4r2 (nat,). Padded atoms (z=0) get zero tables and
    zidx=0 (masked downstream by atom_mask and their huge ref_cn).
    fitted=False (GFN2) reads the pristine diagonal C6 / r4r2 snapshots."""
    nat = len(numbers)
    ref_cn = np.full((nat, MAX_REFS), 1.0e6)
    zidx = np.zeros(nat, dtype=np.int64)
    sqrtc6 = np.zeros((nat, MAX_REFS))
    r4r2 = np.zeros(nat)
    for i, z in enumerate(numbers):
        z = int(z)
        if z == 0:
            continue
        cn_pad, c6_pad, _n = _element_ref_arrays(z, fitted)
        ref_cn[i] = cn_pad
        zidx[i] = _Z_TO_IDX.get(z, -1)
        sqrtc6[i] = np.sqrt(np.maximum(c6_pad, 0.0))
        r4r2[i] = (R4R2 if fitted else PRISTINE_R4R2)[z]
    return {"ref_cn": ref_cn, "zidx": zidx, "sqrtc6": sqrtc6, "r4r2": r4r2}


# ---------------------------------------------------------------------------
# Energies (batch-first: every tensor carries a leading fragment axis B)
# ---------------------------------------------------------------------------


def ref_weights(cn, ref_cn):
    """Per-atom Gaussian reference weights (B, nat, R), normalized.

    Falls back to the closest reference when every weight underflows."""
    w = torch.exp(-K3 * (cn[..., None] - ref_cn) ** 2)
    wsum = w.sum(-1, keepdim=True)
    closest = torch.argmin(torch.abs(cn[..., None] - ref_cn), dim=-1)
    onehot = (
        torch.arange(ref_cn.shape[-1], device=cn.device) == closest[..., None]
    ).to(cn.dtype)
    use_fb = wsum < 1.0e-30
    return torch.where(
        use_fb, onehot, w / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    )


def c6_coefficients(cn, ref_cn, zidx, pair_table, sqrtc6):
    """CN-interpolated pairwise C6 (B, nat, nat) from the pair table.

    pair_table is (B, NZ, NZ, R, R); the per-pair (R, R) grids are gathered
    first, then contracted with the weights on both sides (the JAX version
    contracts one side against every table row before gathering; the sums
    run in the same order). Atoms with zidx = -1 use the geometric-mean
    factorization (w_i . sqrtc6_i)(w_j . sqrtc6_j)."""
    w = ref_weights(cn, ref_cn)                               # (B, nat, R)
    zsafe = torch.clamp(zidx, min=0)
    bidx = torch.arange(zidx.shape[0], device=zidx.device)[:, None, None]
    grids = pair_table[bidx, zsafe[:, :, None], zsafe[:, None, :]]
    c6 = pair_bilinear(w, grids)                              # (B,nat,nat)
    s = fragment_sum(w * sqrtc6)                              # (B, nat)
    core = zidx >= 0
    both_core = core[:, :, None] & core[:, None, :]
    return torch.where(both_core, c6, s[:, :, None] * s[:, None, :])


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def atm_energy(coords, cn, d3tab, atom_mask, s9, rs9, a1, a2, alp=16.0):
    """Axilrod-Teller-Muto three-body dispersion (zero-damped), (B,).

    E3 = s9 * sum_{A<B<C} sqrt(C6_AB C6_BC C6_CA) * ang * fdamp
                          / (r_AB r_BC r_CA)^3
    with r0_AB = rs9 * (a1*sqrt(3 r4r2_A r4r2_B) + a2). s9, rs9, a1, a2 are
    per-fragment (B,) globals. Builds (B, N, N, N) triple tensors. Padded
    atoms and coincident pairs (GMBE caps) are masked with safe substitutes
    so the backward pass stays finite.
    """
    nat = coords.shape[1]
    eye = _eye(nat, coords)
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    r2 = (diff**2).sum(-1) + eye  # diagonal shifted off zero

    c6 = c6_coefficients(
        cn, d3tab["ref_cn"], d3tab["zidx"], d3tab["pair_table"],
        d3tab["sqrtc6"],
    )
    r4r2 = d3tab["r4r2"]
    qq = 3.0 * r4r2[:, :, None] * r4r2[:, None, :]
    # padded atoms have r4r2 == 0 and are fully masked below, so the 1.0
    # substitute never reaches the sum
    r0 = rs9[:, None, None] * (
        a1[:, None, None] * torch.sqrt(torch.where(qq > 0, qq, 1.0))
        + a2[:, None, None]
    )

    pair_ok = (
        atom_mask[:, :, None] * atom_mask[:, None, :]
        * (1.0 - eye)
        * (r2 > 1e-10)  # skip coincident pairs (GMBE caps)
    )
    # safe pair quantities: masked entries get inert substitutes BEFORE any
    # sqrt/division so the backward pass never sees inf * 0
    r2s = torch.where(pair_ok > 0, r2, 1.0)
    rs = torch.sqrt(r2s)
    c6s = torch.where(pair_ok > 0, torch.clamp(c6, min=0.0), 0.0)

    # (B,N,N,N) triple tensors; axes (a,b,c) carry pairs ab, bc, ca
    r2t = r2s.transpose(1, 2)
    r2ab = r2s[:, :, :, None]
    r2bc = r2s[:, None, :, :]
    r2ca = r2t[:, :, None, :]
    rrr = rs[:, :, :, None] * rs[:, None, :, :] * rs.transpose(1, 2)[:, :, None, :]
    c9 = torch.sqrt(
        torch.clamp(
            c6s[:, :, :, None] * c6s[:, None, :, :]
            * c6s.transpose(1, 2)[:, :, None, :],
            min=1e-30,
        )
    )
    ang = (
        0.375
        * (r2ab + r2bc - r2ca)
        * (r2ab - r2bc + r2ca)
        * (-r2ab + r2bc + r2ca)
        / (r2ab * r2bc * r2ca)
        + 1.0
    )
    r0p = (
        r0[:, :, :, None] * r0[:, None, :, :] * r0.transpose(1, 2)[:, :, None, :]
    )
    fd = 1.0 / (1.0 + 6.0 * (r0p / rrr) ** (alp / 3.0))

    tmask = (
        pair_ok[:, :, :, None] * pair_ok[:, None, :, :]
        * pair_ok.transpose(1, 2)[:, :, None, :]
    )
    # each unordered triple appears 6x in the full (a,b,c) tensor
    e3 = fragment_sum(c9 * ang * fd / rrr**3 * tmask, (1, 2, 3)) / 6.0
    return s9 * e3


def d3_energy(coords, cn, d3tab, atom_mask, s6, s8, a1, a2, c6_scale=None):
    """Two-body D3(BJ) energy (B,). s6, s8, a1, a2 are (B,) globals.

    c6_scale: optional (B, nat, nat) factor on the pair C6 (GFN2's
    D4-style charge scaling zeta_A zeta_B)."""
    nat = coords.shape[1]
    eye = _eye(nat, coords)
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    r2 = (diff**2).sum(-1) + eye
    r6 = r2**3
    r8 = r2**4

    c6 = c6_coefficients(
        cn, d3tab["ref_cn"], d3tab["zidx"], d3tab["pair_table"],
        d3tab["sqrtc6"],
    )
    if c6_scale is not None:
        c6 = c6 * c6_scale
    qq = 3.0 * d3tab["r4r2"][:, :, None] * d3tab["r4r2"][:, None, :]
    c8 = c6 * qq

    # guard on qq, not c6: padded atoms can carry a positive table C6 but
    # always have r4r2 == 0, and sqrt(0) under a c6 guard makes the
    # BACKWARD pass inf * mask = NaN. qq > 0 iff both atoms are real, and
    # other pairs are fully masked below, so the 1.0 substitute is inert.
    r0 = torch.sqrt(torch.where(qq > 0, qq, 1.0))
    damp = a1[:, None, None] * r0 + a2[:, None, None]
    e = (
        s6[:, None, None] * c6 / (r6 + damp**6)
        + s8[:, None, None] * c8 / (r8 + damp**8)
    )

    pair_mask = atom_mask[:, :, None] * atom_mask[:, None, :] * (1.0 - eye)
    pair_mask = pair_mask * (r2 > 1e-10)  # skip coincident pairs (GMBE caps)
    return -0.5 * fragment_sum(e * pair_mask, (1, 2))
