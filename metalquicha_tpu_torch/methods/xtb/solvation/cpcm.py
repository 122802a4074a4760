"""CPCM (conductor-like polarizable continuum) solvation, batch-first.

Counterpart of metalquicha_tpu's `solvation/cpcm.py`. Surface charges on a
vdW cavity screen the atomic partial charges:
    A s = -f B q        E_solv = 1/2 q^T Gamma q,  Gamma = -f B^T A^-1 B
with f = (eps-1)/(eps+x). Every atom carries a full angular grid; buried
points are smoothly switched off via their effective area (their
self-interaction diverges, driving their charge to zero), so the shapes
are static and a whole batch is one LU solve of (B, nat*nang, nat*nang)
systems (`ops/batched_eigh.solve`).

Grid: exact Lebedev rules for tabulated orders, Gauss-Legendre x phi
product quadrature otherwise (grids.angular_grid); cpcm_nang selects the
order (upstream metalquicha src/methods/mqc_method_xtb.f90:557-671).

Distances are written sqrt(d^2) with the unit diagonal added under the
root for the point-point matrix (as born.py does for atoms): the values
are those of the JAX package, and the derivative on the diagonal is 0
where the norm of a zero vector has none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ....constants import ANGSTROM_TO_BOHR
from ....ops.batched_eigh import solve as batched_solve
from ..engine import _mm
from .born import (
    PARAM_SETS,
    _const,
    _eye,
    _per_fragment,
    device_grid,
    prod_last,
)

COSMO_X = 0.5          # f = (eps-1)/(eps+COSMO_X)
SELF_INTERACTION = 1.07  # zeta in A_kk = zeta*sqrt(4 pi / a_k)
SWITCH_WIDTH = 0.3     # Bohr, burial switching smoothness


@dataclass
class CpcmSolvation:
    dielectric: float
    nang: int = 110
    rscale: float = 1.0
    kind: str = "cpcm"

    def host_tables(self, numbers):
        nat = len(numbers)
        rvdw = np.zeros(nat)
        for i, z in enumerate(numbers):
            z = int(z)
            if z:
                rvdw[i] = PARAM_SETS["cpcm"]["vdw"][z] * ANGSTROM_TO_BOHR * self.rscale
        return {"solv_rvdw": rvdw, "solv_sx": np.zeros(nat)}

    def default_scalars(self):
        """[cosmo_x, self_interaction_zeta, unused, unused]."""
        return np.array([COSMO_X, SELF_INTERACTION, 0.0, 0.0])

    def work_elements(self, nat: int) -> int:
        """Elements of the largest per-fragment intermediate at `nat`
        padded atoms (the point-point matrix A), for the executor's chunk
        cap."""
        from .grids import angular_grid

        return (nat * len(angular_grid(self.nang)[1])) ** 2

    def gamma_atoms(self, coords, rvdw, sx, atom_mask, scalars=None):
        """Atom-level solvation kernel (B, nat, nat); `scalars` is the
        optional (B, 4) [cosmo_x, zeta, ...] per fragment."""
        cosmo_x = _per_fragment(
            scalars[:, 0] if scalars is not None else COSMO_X, coords
        )
        zeta = _per_fragment(
            scalars[:, 1] if scalars is not None else SELF_INTERACTION, coords
        )
        bsz, nat = coords.shape[:2]
        unit, gw = device_grid(self.nang, coords)
        nang = gw.shape[0]

        radii = torch.where(rvdw > 0, rvdw, 1.0)
        # surface points: (B, nat, nang, 3)
        pts = coords[:, :, None, :] + radii[:, :, None, None] * unit
        npts = nat * nang
        pts_flat = pts.reshape(bsz, npts, 3)

        # smooth burial switch: product over OTHER atoms of a sigmoid in the
        # signed distance outside each sphere
        d_at = torch.sqrt(
            ((pts[:, :, :, None, :] - coords[:, None, None, :, :]) ** 2).sum(-1)
        )  # (B, nat, nang, nat)
        signed = d_at - radii[:, None, None, :]
        sw = 1.0 / (1.0 + torch.exp(-signed / SWITCH_WIDTH))
        not_self = (1.0 - _eye(nat, coords))[None, :, None, :]
        sw = torch.where(
            (not_self > 0.5) & (atom_mask[:, None, None, :] > 0.5), sw, 1.0
        )
        weight = prod_last(sw) * atom_mask[:, :, None]  # (B, nat, nang)
        area = (4.0 * math.pi * gw) * radii[:, :, None] ** 2 * weight
        area_flat = area.reshape(bsz, npts)

        # A matrix
        eye = _eye(npts, coords)
        dpp = torch.sqrt(
            ((pts_flat[:, :, None, :] - pts_flat[:, None, :, :]) ** 2).sum(-1)
            + eye
        )
        a_kk = zeta[:, None] * torch.sqrt(
            4.0 * math.pi / torch.maximum(area_flat, _const(1e-8, coords))
        )
        A = (1.0 / dpp) * (1.0 - eye) + torch.diag_embed(a_kk)

        # B matrix: points x atoms
        dpa = d_at.reshape(bsz, npts, nat)
        Bm = 1.0 / torch.maximum(dpa, _const(0.1, coords))
        Bm = Bm * atom_mask[:, None, :]

        eps = self.dielectric
        f = (eps - 1.0) / (eps + cosmo_x)
        # on a card cuSOLVER's LU with its info folded into the calling
        # stage's status (read after the call); torch.linalg.solve_ex on
        # the CPU
        AinvB = batched_solve(A, Bm)
        # B^T A^-1 B: (nat, points) by (points, nat) on the batch-invariant
        # product kernel (k, the points, of any length)
        gamma = -f[:, None, None] * _mm(Bm, AinvB, trans_a=True)
        gamma = 0.5 * (gamma + gamma.transpose(-1, -2))
        return gamma * (atom_mask[:, :, None] * atom_mask[:, None, :])
