"""AO multipole-moment integrals for GFN2's anisotropic electrostatics.

Counterpart of metalquicha_tpu's `multipole.py`, batch-first. Dipole and
quadrupole matrix elements relative to the BRA atom's center:
    D^d_ij   = <i| (r - R_A)_d |j>          d in {x, y, z}
    Q^dd'_ij = <i| (r - R_A)_d (r - R_A)_d' |j>

computed with the same Obara-Saika 1D machinery as the overlap
(overlap.py): a moment of order m about center A is a 1D overlap with the
bra angular index raised by m, since (x - A_x) g_i = g_{i+1} for an
unnormalized cartesian Gaussian.

The nine 1D tables (three dimensions, bra index raised by 0, 1, 2) are
(B, nao, nao, nprim, nprim) each, beside the three of `overlap_matrix`;
`work_elements` is what the executor's chunk cap counts for them.
"""

from __future__ import annotations

import math

import torch

from .overlap import MAX_L, _s1d


def work_elements(nao: int, nprim: int) -> int:
    """Elements of `moment_matrices`' largest intermediates for one
    fragment: the nine raised 1D tables of (nao, nao, nprim, nprim). With
    the executor's cap of 2e8 elements a gradient chunk of water dimers
    (nao 16, nprim 7) holds 1767 fragments and peaks at 44.8 GiB on an
    NVIDIA H100 80GB HBM3 (`chip_smoke.py`, gfn2 phase)."""
    return 9 * nao * nao * nprim * nprim


def _sdim_tables(coords, ao_atom, ao_lxyz, prim_alpha, max_extra=2):
    """Per-dimension 1D overlap factors with the BRA index raised by 0..2.

    Returns pref (B, nao, nao, np, np) and tables[d][k], the 1D factor of
    dimension d with the bra angular index raised by k."""
    bidx = torch.arange(ao_atom.shape[0], device=ao_atom.device)[:, None]
    A = coords[bidx, ao_atom]
    AB = A[:, :, None, :] - A[:, None, :, :]
    rab2 = (AB**2).sum(-1)

    ai = prim_alpha[:, :, None, :, None]
    aj = prim_alpha[:, None, :, None, :]
    p = ai + aj
    p = torch.where(p > 0, p, 1.0)
    inv2p = 0.5 / p
    mu = ai * aj / p
    pref = (math.pi / p) ** 1.5 * torch.exp(-mu * rab2[..., None, None])

    tables = []
    for d in range(3):
        li = ao_lxyz[:, :, None, :, None, d]
        lj = ao_lxyz[:, None, :, None, :, d]
        ab_d = AB[..., d][..., None, None]
        xpa = -aj * ab_d / p
        xpb = ai * ab_d / p
        per_k = []
        # each (i, j) factor of this dimension is built once for all three
        # raises (and kept once for the backward pass)
        cache = {}
        for k in range(max_extra + 1):
            s_d = torch.zeros_like(pref)
            # later (i, j) overwrite earlier ones where both select: keep
            # the loop order and the selection as they are
            for i in range(MAX_L + max_extra + 1):
                for j in range(MAX_L + 1):
                    if i - k < 0 or i > MAX_L + k:
                        continue
                    sel = (li == i - k) & (lj == j) & (li >= 0)
                    s_d = torch.where(
                        sel, _s1d(i, j, xpa, xpb, inv2p, cache), s_d)
            per_k.append(s_d)
        tables.append(per_k)
    return pref, tables


def moment_matrices(coords, ao_atom, ao_lxyz, prim_alpha, prim_coeff):
    """(S, D, Q): overlap (B, nao, nao), dipole (B, 3, nao, nao),
    quadrupole (B, 6, nao, nao).

    Moments are about the BRA atom center; quadrupole components ordered
    (xx, yy, zz, xy, xz, yz). S is the raw contraction (no on-site
    identity, no coincident-pair handling): the engine takes S from
    `overlap_matrix`."""
    pref, tabs = _sdim_tables(coords, ao_atom, ao_lxyz, prim_alpha)
    cc = prim_coeff[:, :, None, :, None] * prim_coeff[:, None, :, None, :]

    def contract(kx, ky, kz):
        val = pref * tabs[0][kx] * tabs[1][ky] * tabs[2][kz]
        return (val * cc).sum((3, 4))

    S = contract(0, 0, 0)
    D = torch.stack(
        [contract(1, 0, 0), contract(0, 1, 0), contract(0, 0, 1)], 1
    )
    Q = torch.stack(
        [
            contract(2, 0, 0),
            contract(0, 2, 0),
            contract(0, 0, 2),
            contract(1, 1, 0),
            contract(1, 0, 1),
            contract(0, 1, 1),
        ],
        1,
    )
    return S, D, Q
