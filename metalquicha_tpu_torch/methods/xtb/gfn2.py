"""GFN2-specific physics: anisotropic electrostatics (AES) and
charge-dependent (D4-style) dispersion scaling, batch-first in torch.

Counterpart of metalquicha_tpu's `gfn2.py`. GFN2's distinguishing terms
over GFN1 are

1. AES: cumulative atomic dipole (mu_A) and quadrupole (theta_A) moments
   enter a short-range damped multipole electrostatics
       E_AES = sum_{A!=B} f3(R) [ q_A mu_B + ... ] + f5(R) [ mu.mu,
               q.theta terms ]  +  sum_A (dkernel_A |mu_A|^2
               + qkernel_A |theta_A|^2)
   made self-consistent by including dE_AES/d(moments) in the Fock
   potential (engine.py differentiates the interaction functional with
   respect to the moments, which are linear maps of the density matrix).
2. Shell-resolved third order (handled by per-shell gam3 scaling).
3. D4-style dispersion: the D3 reference-C6 interpolation is scaled by
   charge functions zeta_A(q_A), also self-consistently.

Functional forms follow Bannwarth, Ehlert, Grimme, JCTC 15, 1652 (2019).
Every function is built from plain differentiable tensor ops, so the
potentials (first derivatives with respect to the moments) can themselves
be differentiated with respect to the coordinates.
"""

from __future__ import annotations

import torch

from ...ops.fragment_reduce import fragment_sum, moment_rows

#: global AES damping constants (GFN2 conventions: critical radii scaled
#: pair radii, steepness a3/a5)
AES_A3 = 3.0
AES_A5 = 4.0
AES_DMP_EXPO = 6.0


def camm_moments(P, S, D, Q, ao_atom, nat):
    """Cumulative atomic multipole moments from the density matrix.

    Mulliken-style symmetric partition: for kappa on atom A,
        mu_A^d     = - sum_{kappa in A, lambda} P_kl D^d_kl   (D about R_A)
        theta_A^ab = - sum_{kappa in A, lambda} P_kl Q^ab_kl
    P (B, nao, nao), D (B, 3, nao, nao), Q (B, 6, nao, nao). Returns
    (mu (B, nat, 3), theta (B, nat, 6)); theta is made traceless in the
    (xx, yy, zz) components. S is unused (the JAX signature).
    """
    # the row sums sum_l P_kl M_kl (B, nao, 3 | 6) summed over each atom's
    # AOs (`moment_rows`: one launch each on a card)
    mu = -moment_rows(P, D, ao_atom, nat)
    th = -moment_rows(P, Q, ao_atom, nat)
    # traceless quadrupole: subtract tr/3 from diagonal components
    tr = (th[..., 0] + th[..., 1] + th[..., 2]) / 3.0
    th = torch.cat([th[..., :3] - tr[..., None], th[..., 3:]], -1)
    return mu, th


def _damp(r, r0, a):
    """Short-range damping 1/(1 + 6 (r0/r)^a) (GFN2 f_n form)."""
    return 1.0 / (1.0 + AES_DMP_EXPO * (r0 / r) ** a)


def _r_theta_r(th, dvec):
    """R . theta . R over the pair vectors dvec (B, nat, nat, 3) for th
    broadcastable to (B, nat, nat, 6): xx yy zz xy xz yz."""
    x, y, z = dvec[..., 0], dvec[..., 1], dvec[..., 2]
    return (
        th[..., 0] * x**2
        + th[..., 1] * y**2
        + th[..., 2] * z**2
        + 2.0 * th[..., 3] * x * y
        + 2.0 * th[..., 4] * x * z
        + 2.0 * th[..., 5] * y * z
    )


def aes_energy(coords, q_at, mu, theta, at_mrad, at_dkernel, at_qkernel,
               atom_mask):
    """Damped multipole electrostatics + on-site multipole penalties, (B,).

    coords (B, nat, 3) Bohr; q_at (B, nat); mu (B, nat, 3); theta
    (B, nat, 6) traceless (xx,yy,zz,xy,xz,yz); at_mrad per-atom critical
    radii (Bohr); at_dkernel/at_qkernel per-atom on-site kernels.

    Coincident pairs (stacked GMBE caps) are skipped as in the JAX
    package, which masks r <= 1e-5 and clamps r there. Here the masked
    entries get r^2 = 1 BEFORE the square root instead: the energy is the
    same number, and the derivative with respect to the coordinates stays
    finite where sqrt(0) would give 0 * inf.
    """
    nat = coords.shape[1]
    eye = torch.eye(nat, dtype=coords.dtype, device=coords.device)
    dvec = coords[:, :, None, :] - coords[:, None, :, :]   # R_A - R_B
    r2 = (dvec**2).sum(-1) + eye
    apart = r2 > 1e-10                                    # r > 1e-5
    pair = atom_mask[:, :, None] * atom_mask[:, None, :] * (1.0 - eye)
    pair = pair * apart
    rs = torch.sqrt(torch.where(apart, r2, 1.0))

    r0 = 0.5 * (at_mrad[:, :, None] + at_mrad[:, None, :])
    f3 = _damp(rs, r0, AES_A3) / rs**3
    f5 = _damp(rs, r0, AES_A5) / rs**5

    # charge-dipole: q_B (mu_A . R_AB) - q_A (mu_B . R_AB)
    mu_dot_r_A = (mu[:, :, None, :] * dvec).sum(-1)   # mu_A . (R_A - R_B)
    mu_dot_r_B = (mu[:, None, :, :] * dvec).sum(-1)   # mu_B . (R_A - R_B)
    e_qd = f3 * (q_at[:, None, :] * mu_dot_r_A - q_at[:, :, None] * mu_dot_r_B)

    # dipole-dipole: (mu_A.mu_B) r^2 - 3 (mu_A.R)(mu_B.R), scaled f5
    mumu = (mu[:, :, None, :] * mu[:, None, :, :]).sum(-1)
    e_dd = f5 * (mumu * rs**2 - 3.0 * mu_dot_r_A * mu_dot_r_B)

    # charge-quadrupole: q_B (R . theta_A . R) + q_A (R . theta_B . R)
    e_qt = f5 * (
        q_at[:, :, None] * _r_theta_r(theta[:, None, :, :], dvec)
        + q_at[:, None, :] * _r_theta_r(theta[:, :, None, :], dvec)
    )

    e_pair = 0.5 * fragment_sum(pair * (e_qd + e_dd + e_qt), (1, 2))

    # on-site penalties keep the moments bounded (GFN2 self-interaction);
    # the weights (1, 1, 1, 2, 2, 2) are filled on the device: a copy from
    # the host cannot be captured in the SCC loop's CUDA graph
    weights = torch.full((6,), 2.0, dtype=theta.dtype, device=theta.device)
    weights[:3] = 1.0
    e_self = (
        at_dkernel * fragment_sum(mu**2)
        + at_qkernel * fragment_sum(theta**2 * weights)
    )
    return e_pair + fragment_sum(e_self * atom_mask)


def d4_zeta(q_at, at_ga, at_zref, atom_mask):
    """Charge-scaling function for D4-style dispersion, (B, nat).

    zeta_A = exp( beta (1 - exp( ga_A (1 - zref_A/(zref_A + q_A)) )) )
    with beta = 3 (global); neutral charges give zeta = 1.
    """
    beta = 3.0
    zref = torch.clamp(at_zref, min=0.1)
    arg = at_ga * (1.0 - zref / (zref + q_at * atom_mask))
    zeta = torch.exp(beta * (1.0 - torch.exp(arg)))
    return torch.where(atom_mask > 0.5, zeta, 1.0)
