"""Minimal valence STO basis expanded in Gaussians (STO-nG).

Each xTB shell is a Slater-type orbital with exponent zeta, expanded into
`ngauss` primitive Gaussians using R. F. Stewart's least-squares STO-nG
expansions (J. Chem. Phys. 52, 431 (1970)): alpha_i = a_i * zeta^2 with
tabulated (a_i, c_i) for each (n, l).

The reference outsources this to tblite's basis machinery; here the expansion
is precomputed host-side into dense padded arrays consumed by the batched
JAX integral code (`overlap.py`).

Hydrogen's second (polarization) `ns` shell is Gram-Schmidt orthogonalized
against its valence 1s so same-atom overlap blocks are exactly the identity
(tblite does the same for H/He).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# ---------------------------------------------------------------------------
# Stewart STO-nG expansion tables: {(n_gauss, n, l): (alphas, coeffs)}
# for a Slater exponent zeta = 1. Scaling rule: alpha_i -> alpha_i * zeta^2.
# Coefficients are for NORMALIZED primitive Gaussians.
# ---------------------------------------------------------------------------

STO_NG: dict = {
    # --- STO-1G ---
    (1, 1, 0): ([0.2709498091], [1.0]),
    (1, 2, 0): ([0.1012151084], [1.0]),
    (1, 2, 1): ([0.1759666885], [1.0]),
    (1, 3, 0): ([0.0529688998], [1.0]),
    (1, 3, 1): ([0.0815477530], [1.0]),
    (1, 3, 2): ([0.1057017300], [1.0]),
    # --- STO-2G ---
    (2, 1, 0): ([0.8518186635, 0.1516232927], [0.4301284983, 0.6789135305]),
    (2, 2, 0): ([0.1292278611, 0.0490858420], [0.7470867124, 0.2855980556]),
    (2, 2, 1): ([0.4323908358, 0.1069439065], [0.4522627513, 0.6713122642]),
    (2, 3, 0): ([0.0742572439, 0.0340150070], [0.6621844819, 0.3515522085]),
    (2, 3, 1): ([0.1458620964, 0.0485690875], [0.5349653144, 0.5299607212]),
    (2, 3, 2): ([0.2777427345, 0.0830981204], [0.4666137923, 0.6644706516]),
    # --- STO-3G ---
    (3, 1, 0): (
        [2.2276605842, 0.4057711562, 0.1098175104],
        [0.1543289673, 0.5353281423, 0.4446345422],
    ),
    (3, 2, 0): (
        [2.5815783978, 0.1567622104, 0.0601833227],
        [-0.0599444893, 0.5960385398, 0.4581786291],
    ),
    (3, 2, 1): (
        [0.9192379002, 0.2359194503, 0.0800980575],
        [0.1623948553, 0.5661708862, 0.4223071752],
    ),
    (3, 3, 0): (
        [0.5641487309, 0.0692696042, 0.0328029621],
        [-0.1717944577, 0.5805100462, 0.5427854879],
    ),
    (3, 3, 1): (
        [0.2692279851, 0.1489358920, 0.0495145570],
        [0.0046162072, 0.5774724509, 0.4846125686],
    ),
    (3, 3, 2): (
        [0.5229112225, 0.1639595876, 0.0648958621],
        [0.1686596060, 0.5847984817, 0.4058464000],
    ),
    # --- STO-4G ---
    (4, 1, 0): (
        [5.2168445340, 0.9546182760, 0.2652034102, 0.0880186277],
        [0.0567524208, 0.2601413550, 0.5328461143, 0.2916254405],
    ),
    (4, 2, 0): (
        [11.6152555160, 2.0533439700, 0.1603718110, 0.0652095396],
        [-0.0119841174, -0.0542852867, 0.5794582930, 0.4896294736],
    ),
    (4, 2, 1): (
        [1.7982609920, 0.4662622228, 0.1643718620, 0.0654392707],
        [0.0543672797, 0.3053853119, 0.4695600840, 0.2457767340],
    ),
    (4, 3, 0): (
        [1.5137130120, 0.4262141340, 0.0768060569, 0.0372803858],
        [-0.0332921341, -0.1030107245, 0.6455293480, 0.4639344950],
    ),
    (4, 3, 1): (
        [1.8531544160, 0.3954047700, 0.1599349406, 0.0510677871],
        [-0.0189172868, 0.2538511984, 0.5693578437, 0.2551580981],
    ),
    (4, 3, 2): (
        [0.9185846715, 0.2920461109, 0.1187568890, 0.0528684300],
        [0.0826963314, 0.4411172299, 0.4509247356, 0.2313407778],
    ),
    # --- STO-5G ---
    (5, 1, 0): (
        [11.3056595355, 2.0717112250, 0.5786484833, 0.1975724573, 0.0744527174],
        [0.0226062139, 0.1139436689, 0.3387256084, 0.4627282607, 0.2421768818],
    ),
    (5, 2, 0): (
        [8.9849956030, 1.6737123940, 0.1944726668, 0.0880634563, 0.0424990374],
        [-0.0078295432, -0.0347810356, 0.4712896940, 0.4861311528, 0.0683724342],
    ),
    (5, 2, 1): (
        [3.3498596923, 0.8428085391, 0.2829899916, 0.1111058964, 0.0476253323],
        [0.0209942016, 0.1331608774, 0.3866417281, 0.4442762422, 0.1697799828],
    ),
    (5, 3, 0): (
        [4.2751877308, 1.1329424191, 0.1015708262, 0.0548840350, 0.0292482001],
        [-0.0255409962, -0.0552138695, 0.4530711893, 0.5618541193, 0.0635408607],
    ),
    (5, 3, 1): (
        [0.6190052680, 0.2648418407, 0.1310994954, 0.0565018181, 0.0256936606],
        [-0.0127243061, 0.2761523957, 0.4573181103, 0.2903266260, 0.0419314882],
    ),
    (5, 3, 2): (
        [1.5393845388, 0.4393021269, 0.1748797482, 0.0772092228, 0.0356186518],
        [0.0435647526, 0.2814182178, 0.4533747473, 0.2732591638, 0.0676817667],
    ),
    # --- STO-6G ---
    (6, 1, 0): (
        [23.1030314900, 4.2359155340, 1.1850565190, 0.4070988982,
         0.1580884151, 0.0651095395],
        [0.0091635963, 0.0493614929, 0.1685383049, 0.3705627997,
         0.4164915298, 0.1303340841],
    ),
    (6, 2, 0): (
        [27.6849624100, 5.0771406270, 1.4267860500, 0.2040335729,
         0.0926029840, 0.0441618398],
        [-0.0041512778, -0.0206702415, -0.0515030334, 0.3346271174,
         0.5621061301, 0.1712994697],
    ),
    (6, 2, 1): (
        [5.8682859130, 1.5303296310, 0.5475665231, 0.2288932733,
         0.1046655969, 0.0494822013],
        [0.0079242336, 0.0514410483, 0.1898400060, 0.4049863191,
         0.4012362861, 0.1051855189],
    ),
    (6, 3, 0): (
        [3.2737159130, 0.9200360104, 0.3593613493, 0.0863542312,
         0.0480514465, 0.0272194944],
        [-0.0077578354, -0.0459129533, -0.0212712161, 0.3807459564,
         0.5244184631, 0.1429895700],
    ),
    (6, 3, 1): (
        [5.0778648690, 1.3409154250, 0.2142914069, 0.0921901091,
         0.0457154725, 0.0246269505],
        [-0.0035402386, -0.0159503628, 0.2950115229, 0.4822052170,
         0.2599703367, 0.0412912584],
    ),
    (6, 3, 2): (
        [2.4884014360, 0.7441160556, 0.3035483827, 0.1389733766,
         0.0668713454, 0.0329651398],
        [0.0066336018, 0.0563349572, 0.2188152075, 0.3882801246,
         0.2960302273, 0.0934345115],
    ),
}


def slater_to_gauss(ngauss: int, n: int, l: int, zeta: float):
    """Expand an STO(zeta, n, l) into `ngauss` normalized primitive Gaussians.

    Returns (alphas, coeffs) with the contracted function renormalized to
    unit self-overlap.
    """
    # Stewart tables cover n <= 3. Higher-row valence shells (4s..5d) use
    # the n=3 radial expansion with the element's effective zeta: for
    # valence-only tight binding the inner nodal structure is screened out,
    # and the long-range exponential (what the overlaps sample) matches.
    # (ESTIMATED-element territory; H/C/N/O are unaffected.)
    if n > 3:
        n = 3
    key = (ngauss, n, l)
    if key not in STO_NG:
        raise KeyError(f"no STO-{ngauss}G expansion tabulated for n={n}, l={l}")
    a, c = STO_NG[key]
    alphas = np.asarray(a, dtype=np.float64) * zeta * zeta
    coeffs = np.asarray(c, dtype=np.float64).copy()
    coeffs /= math.sqrt(_contracted_self_overlap(alphas, coeffs, l))
    return alphas, coeffs


def _contracted_self_overlap(alphas, coeffs, l: int) -> float:
    """<phi|phi> for a contraction of normalized primitives with ang. mom l."""
    ai = alphas[:, None]
    aj = alphas[None, :]
    s = (2.0 * np.sqrt(ai * aj) / (ai + aj)) ** (l + 1.5)
    return float(coeffs @ s @ coeffs)


def orthogonalize_against(
    alphas_v, coeffs_v, alphas_p, coeffs_p, l: int
):
    """Gram-Schmidt orthogonalize shell p against shell v (same center, same l).

    Returns combined (alphas, coeffs) for p' = (p - <v|p> v) / ||...||.
    Used for hydrogen's polarization ns shell vs its valence 1s.
    """
    ai = alphas_v[:, None]
    aj = alphas_p[None, :]
    s_vp = (2.0 * np.sqrt(ai * aj) / (ai + aj)) ** (l + 1.5)
    ovlp = float(coeffs_v @ s_vp @ coeffs_p)
    alphas = np.concatenate([alphas_p, alphas_v])
    coeffs = np.concatenate([coeffs_p, -ovlp * coeffs_v])
    coeffs /= math.sqrt(_contracted_self_overlap(alphas, coeffs, l))
    return alphas, coeffs


# Cartesian components per angular momentum, ordered (lx, ly, lz).
# p order (x, y, z); d order (x2, y2, z2, xy, xz, yz) — matches the
# spherical-harmonic transform below.
CARTESIAN_COMPONENTS = {
    0: [(0, 0, 0)],
    1: [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
    2: [(2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1)],
}

N_CART = {0: 1, 1: 3, 2: 6}
N_SPH = {0: 1, 1: 3, 2: 5}


def _double_factorial(n: int) -> int:
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def primitive_norm(alpha: float, lx: int, ly: int, lz: int) -> float:
    """Normalization constant of a cartesian Gaussian primitive."""
    l = lx + ly + lz
    num = (2.0 * alpha / math.pi) ** 0.75 * (4.0 * alpha) ** (l / 2.0)
    den = math.sqrt(
        _double_factorial(2 * lx - 1)
        * _double_factorial(2 * ly - 1)
        * _double_factorial(2 * lz - 1)
    )
    return num / den


# d-shell: transform 6 cartesians -> 5 spherical harmonics.
# Rows: (z2 "d0", xz "d+1", yz "d-1", x2-y2 "d+2", xy "d-2")
# Columns follow CARTESIAN_COMPONENTS[2] order, cartesians taken as
# NORMALIZED (xx-type normalized to 1).
_S3 = math.sqrt(3.0)
D_SPHERICAL_FROM_CART = np.array(
    [
        # x2        y2        z2      xy   xz   yz
        [-0.5, -0.5, 1.0, 0.0, 0.0, 0.0],  # d_z2 (unnormalized row; fixed below)
        [0.0, 0.0, 0.0, 0.0, 1.0, 0.0],  # d_xz
        [0.0, 0.0, 0.0, 0.0, 0.0, 1.0],  # d_yz
        [_S3 / 2.0, -_S3 / 2.0, 0.0, 0.0, 0.0, 0.0],  # d_x2-y2
        [0.0, 0.0, 0.0, 1.0, 0.0, 0.0],  # d_xy
    ],
    dtype=np.float64,
)
