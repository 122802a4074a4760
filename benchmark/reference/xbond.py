"""GFN1 halogen-bond correction, batch-first torch counterpart of
metalquicha_tpu's `xbond.py`.

For every halogen X (Cl, Br, I) covalently bound to a neighbor A, and every
donor atom D (N, O, P, S), a Lennard-Jones-like damped radial factor
favoring the sigma-hole distance with an angular factor favoring linear
A-X...D arrangements:

    E_XB = sum_XD  k_X * fangl(theta_AXD) * (t12 - damp * t6) / (1 + t12)
    t6 = (rscale * (Rcov_X + Rcov_D) / R_XD)^6,  t12 = t6^2
    fangl = ((1 - cos theta) / 2)^6

The covalent neighbor A is the nearest atom to X (a discrete choice that
carries no gradient).
"""

from __future__ import annotations

import torch

from .plain import fragment_sum

XB_DAMP = 0.44
XB_RSCALE = 1.3

#: donor elements (N, O, P, S + heavier chalcogen/pnictogen analogs)
DONOR_Z = (7, 8, 15, 16, 33, 34, 51, 52)


def halogen_bond_energy(coords, numbers, xbond_strength, rcov, atom_mask):
    """Halogen-bond correction energy (B,), differentiable in coords.

    xbond_strength: (B, nat) per-atom k_X (zero for non-halogens).
    rcov: (B, nat) covalent radii in Bohr (the CN radii set).
    """
    bsz, nat = numbers.shape
    eye = torch.eye(nat, dtype=coords.dtype, device=coords.device)
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    r = torch.sqrt((diff**2).sum(-1) + eye)

    is_x = (xbond_strength > 0.0) & (atom_mask > 0.5)
    # compared with each donor number in turn: no table copied from the
    # host, so a captured program can hold it
    is_d = torch.zeros_like(is_x)
    for z in DONOR_Z:
        is_d = is_d | (numbers == z)
    is_d = is_d & (atom_mask > 0.5)

    # covalent neighbor of each X: nearest other real atom
    big = 1.0e6
    r_nn = r + eye * big
    r_nn = torch.where(atom_mask[:, None, :] > 0.5, r_nn, big)
    nn = torch.argmin(r_nn.detach(), dim=2)                 # (B, nat)

    bidx = torch.arange(bsz, device=coords.device)[:, None]
    a_pos = coords[bidx, nn]                  # neighbor position per X
    # vectors for the A-X...D angle at X
    xa = a_pos[:, :, None, :] - coords[:, :, None, :]       # X->A
    xd = coords[:, None, :, :] - coords[:, :, None, :]      # X->D
    na = torch.sqrt((xa**2).sum(-1) + 1e-30)
    nd = torch.sqrt((xd**2).sum(-1) + 1e-30)
    cos_t = (xa * xd).sum(-1) / (na * nd)
    fangl = ((1.0 - cos_t) * 0.5) ** 6

    r0 = XB_RSCALE * (rcov[:, :, None] + rcov[:, None, :])
    t6 = (r0 / torch.clamp(r, min=1e-2)) ** 6
    t12 = t6 * t6
    frad = (t12 - XB_DAMP * t6) / (1.0 + t12)

    idx = torch.arange(nat, device=coords.device)
    pair = (
        is_x[:, :, None]
        & is_d[:, None, :]
        & (idx[:, None] != idx[None, :])
        & (nn[:, :, None] != idx[None, None, :])  # donor != own neighbor
    )
    e = torch.where(pair, xbond_strength[:, :, None] * fangl * frad, 0.0)
    return fragment_sum(e, (1, 2))
