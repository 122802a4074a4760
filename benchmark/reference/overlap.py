"""Batched Gaussian overlap integrals in torch.

Counterpart of metalquicha_tpu's `overlap.py`: all (AO, AO, primitive,
primitive) combinations of every fragment are evaluated densely with the
Obara-Saika 1D factors and reduced, so the whole batch is a fixed sequence
of tensor ops and autograd differentiates it directly.

The intermediates are (B, nao, nao, nprim, nprim); the executor's chunk cap
(B * nao^2 <= 2e8, and on a card its byte model `fragment_bytes`) bounds
them.

The 1D overlap factors S_ij follow the standard recursion
    S_{i+1,j} = XPA S_ij + (i S_{i-1,j} + j S_{i,j-1}) / (2p)
unrolled in Python up to l = MAX_L per side.
"""

from __future__ import annotations

import math

import torch

MAX_L = 2  # up to d functions


def _s1d(i, j, xpa, xpb, inv2p, cache=None):
    """Recursive closed form of the 1D OS overlap factor (unrolled).

    cache: optional dict (i, j) -> factor for one (xpa, xpb, inv2p); a
    caller that needs many (i, j) of one dimension passes one, so that
    each factor is built, and kept for the backward pass, once. The values
    are the same with and without it."""
    if i < 0 or j < 0:
        return torch.zeros_like(xpa)
    if i == 0 and j == 0:
        return torch.ones_like(xpa)
    if cache is not None and (i, j) in cache:
        return cache[(i, j)]
    if i >= j:
        term = xpa * _s1d(i - 1, j, xpa, xpb, inv2p, cache)
        if i - 1 > 0:
            term = term + (i - 1) * inv2p * _s1d(i - 2, j, xpa, xpb, inv2p,
                                                 cache)
        if j > 0:
            term = term + j * inv2p * _s1d(i - 1, j - 1, xpa, xpb, inv2p,
                                           cache)
    else:
        term = xpb * _s1d(i, j - 1, xpa, xpb, inv2p, cache)
        if j - 1 > 0:
            term = term + (j - 1) * inv2p * _s1d(i, j - 2, xpa, xpb, inv2p,
                                                 cache)
        if i > 0:
            term = term + i * inv2p * _s1d(i - 1, j - 1, xpa, xpb, inv2p,
                                           cache)
    if cache is not None:
        cache[(i, j)] = term
    return term


def overlap_matrix(coords, ao_atom, ao_lxyz, prim_alpha, prim_coeff):
    """Dense AO overlap matrices (B, nao, nao).

    coords (B, nat, 3) Bohr; ao_atom (B, nao) int; ao_lxyz (B, nao, np, 3)
    int cartesian powers per entry (spherical d AOs fold several cartesian
    components into the primitive axis); prim_alpha, prim_coeff (B, nao, np)
    with zero coefficients on padded entries.

    Padded AOs come out with zero rows and columns, then the on-site
    identity puts 1 on the full diagonal (same-atom shells are orthonormal
    by construction in the xTB basis; it keeps the padded block
    well-conditioned for eigensolves).
    """
    bsz, nao = ao_atom.shape
    bidx = torch.arange(bsz, device=ao_atom.device)[:, None]

    A = coords[bidx, ao_atom]                          # (B, nao, 3)
    AB = A[:, :, None, :] - A[:, None, :, :]           # (B, nao, nao, 3)
    rab2 = (AB**2).sum(-1)                             # (B, nao, nao)

    ai = prim_alpha[:, :, None, :, None]               # (B, nao, 1, np, 1)
    aj = prim_alpha[:, None, :, None, :]               # (B, 1, nao, 1, np)
    p = ai + aj
    p = torch.where(p > 0, p, 1.0)                     # guard padded pairs
    inv2p = 0.5 / p
    mu = ai * aj / p

    # Gaussian product prefactor
    pref = (math.pi / p) ** 1.5 * torch.exp(-mu * rab2[..., None, None])
    del mu

    # Gaussian product center offsets per dimension:
    # XPA = P - A = aj*(B-A)/p; XPB = P - B = ai*(A-B)/p
    sdim = None
    for d in range(3):
        li = ao_lxyz[:, :, None, :, None, d]           # (B, nao, 1, np, 1)
        lj = ao_lxyz[:, None, :, None, :, d]           # (B, 1, nao, 1, np)
        ab_d = AB[..., d][..., None, None]             # A_d - B_d
        xpa = -aj * ab_d / p
        xpb = ai * ab_d / p
        s_d = torch.zeros_like(pref)
        # each (i, j) factor of this dimension is built once (and kept
        # once for the backward pass), as in multipole._sdim_tables
        cache = {}
        for i in range(MAX_L + 1):
            for j in range(MAX_L + 1):
                mask = (li == i) & (lj == j)
                s_ij = _s1d(i, j, xpa, xpb, inv2p, cache)
                s_d = torch.where(mask, s_ij, s_d)
                if i == MAX_L:
                    # no later (i, j) reads a factor of the last row: an
                    # energy (no graph) need not hold it
                    del cache[(i, j)], s_ij
        del xpa, xpb, cache
        sdim = s_d if sdim is None else sdim * s_d
        del s_d

    prim_s = pref * sdim                               # (B,nao,nao,np,np)
    cc = prim_coeff[:, :, None, :, None] * prim_coeff[:, None, :, None, :]
    S = (prim_s * cc).sum((3, 4))

    # Coincident atoms (two hydrogen caps replacing the same excluded atom
    # in gappy GMBE intersection terms) are NON-interacting, matching the
    # tblite behavior of skipping r ~ 0 pairs.
    same_atom = ao_atom[:, :, None] == ao_atom[:, None, :]
    S = torch.where((rab2 < 1e-10) & ~same_atom, 0.0, S)

    # Same-atom blocks are orthonormal by construction; snap them to the
    # identity to remove integration noise and keep padded AOs
    # well-conditioned.
    eye = torch.eye(nao, dtype=S.dtype, device=S.device)
    return torch.where(same_atom, eye, S)
