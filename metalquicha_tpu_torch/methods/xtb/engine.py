"""Batched xTB engine (GFN1 and GFN2): H0 + SCC in torch, batch-first.

Counterpart of metalquicha_tpu's `engine.py`. Every function
takes tensors with an explicit leading fragment axis B where the JAX
version is written for one fragment under `vmap`; `batch` is a
`calculator.FragmentData` of such tensors.

Gradient strategy (as in the JAX package): the SCC total energy is
evaluated through a variational functional

    E(R; q*, f*) = sum_i f*_i eps_i(R, q*) + sum_sh v_sh(q*, R) n*_sh
                   + E_coul(q*, R) + E_rep(R) + E_disp(R) - T S_el*

which is stationary in the converged shell charges q* and occupations f*,
so autograd w.r.t. R with q*/f* detached is the exact analytic gradient,
and only eigenvalue derivatives of `eigh_safe` are exercised.

GFN2 generalizes the SCC state from shell charges to the packed vector
z = (q_sh, mu_A, theta_A) of shell charges, atomic dipoles and traceless
quadrupoles. Its interaction energy is a function of these moments, the
SCC potentials are its derivatives with respect to them (taken by
autograd, inside the loop and inside the variational functional), and the
Fock contribution follows from the moments being linear maps of P.
"""

from __future__ import annotations

import json
import os
import warnings
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ...ops.anderson_window import anderson_window
from ...ops.batched_eigh import EighStatus, eigh_folded
from ...ops.batched_eigh import eigh as batched_eigh
from ...ops.fermi_fill import DENSITY_MAX_N, fermi_density, fermi_occupations
from ...ops.fragment_gemm import takes as _small
from ...ops.fragment_gemm import (
    fragment_bmm,
    fragment_matvec,
    sandwich,
)
from ...ops.fragment_reduce import (
    fragment_sum,
    moment_fock,
    moment_rows,
    segment_sum,
    take,
    take2,
)
from ...ops.jacobi_eigh import MAX_N as PALLAS_EIGH_MAX_N
from ...ops.jacobi_eigh import jacobi_eigh
from ...ops.sp2 import sp2_density
from . import scc_graph
from .batch import PAD_LEVEL
from .multipole import moment_matrices
from .overlap import overlap_matrix


class EngineSettings(NamedTuple):
    """Static engine knobs (the JAX package's fields and defaults)."""

    max_scf_iter: int = 32
    #: SCC early-exit residual tolerance: a fragment stops iterating (its
    #: charges freeze) once its charge residual drops below this value.
    #: 0.0 = never exit early (fixed-iteration semantics).
    scf_tol: float = 0.0
    electronic_temp: float = 300.0  # Kelvin
    mixer_damping: float = 0.4
    broyden_memory: int = 12
    include_entropy: bool = True
    kpol: float = 2.85
    ken: float = -0.007
    kcn_steep: float = 16.0
    kexp_rep: float = 1.5
    rexp_rep: float = 1.0
    #: reduced repulsion distance exponent for light-light (Z<=2) pairs —
    #: the klight rule. None = uniform kexp (legacy overlay form).
    klight_rep: float = None
    gexp: float = 2.0
    kll: tuple = ((1.85, 2.08, 2.00), (2.08, 2.25, 2.00), (2.00, 2.00, 2.00))
    third_order: bool = True
    fixed_occupations: bool = False
    disp_s6: float = 1.0
    disp_s8: float = 2.4
    disp_a1: float = 0.63
    disp_a2: float = 5.0
    #: ATM three-body dispersion gate (s9 = 0 keeps the two-body form);
    #: the values used ride FragmentData.glb[16]/glb[17]
    disp_s9: float = 0.0
    disp_rs9: float = 0.65
    #: K rule for pairs involving a polarization shell: "flat", "avg",
    #: with an optional "_noen" suffix (no electronegativity factor)
    kpol_mode: str = "flat"
    #: shell-hardness average in the second-order kernel: "harmonic",
    #: "arithmetic", "geometric" or "invpow"
    eta_average: str = "harmonic"
    #: CN counting function for the H0 self-energy shifts: "exp" or "gfn"
    cn_type: str = "exp"
    #: CN counting function for D3 dispersion C6 interpolation
    cn_type_d3: str = "exp"
    #: fast in-loop SCC solve, in float32 only (as the JAX package): the
    #: hand-written Jacobi kernel (ops/jacobi_eigh.py) for AO dims <=
    #: PALLAS_EIGH_MAX_N, SP2 purification (ops/sp2.py) above. A float64
    #: SCC takes the exact route whatever this says. The final
    #: variational energy always uses `eigh_safe`.
    use_pallas_eigh: bool = False
    #: GFN2 mode: self-consistent atomic dipoles/quadrupoles (AES) and
    #: charge-scaled (D4-style) dispersion inside the SCC
    multipoles: bool = False


def settings_from_params(variant: str = "gfn1", **overrides) -> EngineSettings:
    """Build EngineSettings from a parameter module's GlobalParams."""
    if variant == "gfn2":
        from . import params_gfn2 as params
    else:
        from . import params_gfn1 as params
    g = params.GLOBALS
    base = dict(
        kpol=g.kpol,
        ken=g.ken,
        kcn_steep=g.kcn_exp,
        kexp_rep=g.kexp,
        rexp_rep=g.rexp,
        klight_rep=getattr(g, "klight", None),
        gexp=g.gexp,
        kll=(
            (g.kss, g.ksp, g.ksd),
            (g.ksp, g.kpp, g.kpd),
            (g.ksd, g.kpd, g.kdd),
        ),
        disp_s6=g.disp_s6,
        disp_s8=g.disp_s8,
        disp_a1=g.disp_a1,
        disp_a2=g.disp_a2,
        disp_s9=getattr(g, "disp_s9", 0.0),
        disp_rs9=getattr(g, "disp_rs9", 0.65),
        multipoles=bool(getattr(g, "multipoles", False)),
        eta_average=getattr(g, "eta_average", "harmonic"),
        cn_type=getattr(g, "cn_type", "exp"),
        cn_type_d3=getattr(g, "cn_type_d3", "exp"),
        kpol_mode=getattr(g, "kpol_mode", "flat"),
    )
    base.update(overrides)
    env = os.environ.get("MQC_FORM_VARIANT")
    if env:
        # fitting-tool escape hatch: overrides functional-form selection for
        # every engine in this process. Warn loudly so a stale env var can
        # never silently change production energies.
        warnings.warn(
            f"MQC_FORM_VARIANT active — engine form overridden by {env}",
            stacklevel=2,
        )
        base.update(json.loads(env))
    return EngineSettings(**base)


# ---------------------------------------------------------------------------
# Batch-first helpers
# ---------------------------------------------------------------------------


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


#: x[b, idx[b, k]] for a (B, n) or (B, n, ...) x, and m[b, idx[b, i],
#: idx[b, j]] for a (B, n, n) m (on a card their backward passes sum in a
#: fixed order)
_take, _take2 = take, take2


def _mm(a, b, trans_a=False, trans_b=False):
    """op(a) @ op(b) of (B, r, c) batches (op: the transpose where asked):
    `fragment_bmm` where the output's m and n are up to the op's MAX_N (k
    any length), whose bits for a fragment do not depend on its batch on a
    card (torch.matmul on the CPU). The shape decides (`_small`): above it
    torch.matmul, as the JAX package leaves every product to XLA."""
    m = a.shape[-1] if trans_a else a.shape[-2]
    n = b.shape[-2] if trans_b else b.shape[-1]
    if _small(m, n):
        return fragment_bmm(a, b, trans_a, trans_b)
    return torch.matmul(a.transpose(-1, -2) if trans_a else a,
                        b.transpose(-1, -2) if trans_b else b)


def _sandwich(x, f, shift):
    """x @ f @ x + shift: `sandwich` up to the op's MAX_N (one launch on a
    card up to its STAGED_N, two products and an add above)."""
    if _small(x.shape[-1], x.shape[-1]):
        return sandwich(x, f, shift)
    return x @ f @ x + shift


# ---------------------------------------------------------------------------
# Geometry-dependent ingredients
# ---------------------------------------------------------------------------


def coordination_numbers(coords, rcov, atom_mask, steepness, cn_type="exp",
                         cutoff=25.0):
    """Exponential counting function CN (GFN1/D3 style, k2 = 4/3), (B, nat).

    steepness is per fragment (B,). The 25 Bohr real-space cutoff keeps the
    CN size-consistent (the counting function tends to ~1.1e-7 per pair,
    not zero, as r -> inf), as tblite and the JAX package do."""
    nat = coords.shape[1]
    eye = _eye(nat, coords)
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    # clamp before sqrt: coincident pairs (GMBE caps) otherwise produce
    # inf * 0 = NaN in the backward pass
    r = torch.sqrt(torch.clamp((diff**2).sum(-1), min=1e-12) + eye)
    r0 = (4.0 / 3.0) * (rcov[:, :, None] + rcov[:, None, :])
    k = steepness[:, None, None]
    cf = 1.0 / (1.0 + torch.exp(-k * (r0 / r - 1.0)))
    if cn_type == "gfn":
        # double-exponential counting (tblite ncoord "gfn")
        cf = cf / (1.0 + torch.exp(-2.0 * k * ((r0 + 2.0) / r - 1.0)))
    pair_mask = atom_mask[:, :, None] * atom_mask[:, None, :]
    pair_mask = pair_mask * (1.0 - eye)
    pair_mask = pair_mask * (r > 1e-5)  # skip coincident pairs (GMBE caps)
    pair_mask = pair_mask * (r < cutoff)
    return (cf * pair_mask).sum(-1)


def pair_distances(coords):
    nat = coords.shape[1]
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    # clamped sqrt: keeps gradients finite at coincident pairs (GMBE caps)
    return torch.sqrt(
        torch.clamp((diff**2).sum(-1), min=1e-12) + _eye(nat, coords)
    )


def repulsion_energy(coords, zeff, alpha, atom_mask, kexp, rexp,
                     light_mask=None, klight=None):
    """E_rep = sum_{A<B} ZA ZB / R^rexp * exp(-sqrt(aA aB) R^k_AB), (B,).

    kexp, rexp are per fragment (B,). k_AB = klight for pairs of light
    (Z <= 2) atoms when klight is set (the GFN klight rule), kexp
    otherwise. Coincident pairs (r ~ 0, stacked GMBE caps) are skipped."""
    nat = coords.shape[1]
    r = pair_distances(coords)
    pair_mask = (
        atom_mask[:, :, None] * atom_mask[:, None, :] * (1.0 - _eye(nat, coords))
    )
    pair_mask = pair_mask * (r > 1e-5)
    r = torch.clamp(r, min=1e-5)  # masked pairs must stay finite (0*inf)
    zz = zeff[:, :, None] * zeff[:, None, :]
    ab = torch.sqrt(alpha[:, :, None] * alpha[:, None, :])
    kexp = kexp[:, None, None]
    if klight is not None and light_mask is not None:
        light_pair = light_mask[:, :, None] * light_mask[:, None, :]
        k_ab = kexp + (klight - kexp) * light_pair
    else:
        k_ab = kexp
    e = zz / r ** rexp[:, None, None] * torch.exp(-ab * r**k_ab)
    return 0.5 * fragment_sum(e * pair_mask, (1, 2))


def h0_matrix(S, coords, batch, cn, settings: EngineSettings):
    """Extended-Hueckel core Hamiltonian (GFN1 form), (B, nao, nao)."""
    sh_level = batch.sh_level - batch.sh_kcn * _take(cn, batch.sh_atom)
    ao_level = _take(sh_level, batch.ao_shell)               # (B, nao)
    ao_l = _take(batch.sh_l, batch.ao_shell)
    ao_pol = _take(batch.sh_pol, batch.ao_shell)
    ao_poly = _take(batch.sh_poly, batch.ao_shell)
    ao_en = _take(batch.at_en, batch.ao_atom)
    ao_rad = _take(batch.at_rad, batch.ao_atom)

    # global constants ride batch.glb; GLB_FIELDS order:
    # kss ksp ksd kpp kpd kdd kpol ken kexp rexp gexp kcn ...
    glb = batch.glb
    kll = torch.stack([
        torch.stack([glb[:, 0], glb[:, 1], glb[:, 2]], -1),
        torch.stack([glb[:, 1], glb[:, 3], glb[:, 4]], -1),
        torch.stack([glb[:, 2], glb[:, 4], glb[:, 5]], -1),
    ], -2)                                                   # (B, 3, 3)
    kpol = glb[:, 6, None, None]
    ken = glb[:, 7, None, None]
    bidx = torch.arange(S.shape[0], device=S.device)[:, None, None]
    K = kll[bidx, ao_l[:, :, None], ao_l[:, None, :]]
    pol_i = ao_pol[:, :, None] > 0.5
    pol_j = ao_pol[:, None, :] > 0.5
    pol_pair = (ao_pol[:, :, None] + ao_pol[:, None, :]) > 0.5
    if settings.kpol_mode.startswith("avg"):
        kdiag = torch.stack([glb[:, 0], glb[:, 3], glb[:, 5]], -1)
        k_self = torch.gather(kdiag, 1, ao_l)
        k_mix = 0.5 * (k_self[:, :, None] + kpol)
        k_mix_t = 0.5 * (kpol + k_self[:, None, :])
        both_pol = pol_i & pol_j
        one_pol = pol_pair & ~both_pol
        K = torch.where(one_pol, torch.where(pol_i, k_mix_t, k_mix), K)
        K = torch.where(both_pol, kpol, K)
    else:
        K = torch.where(pol_pair, kpol, K)

    en_fac = 1.0 + ken * (ao_en[:, :, None] - ao_en[:, None, :]) ** 2
    if settings.kpol_mode.endswith("_noen"):
        en_fac = torch.where(pol_pair, 1.0, en_fac)

    r_ao = _take2(pair_distances(coords), batch.ao_atom)
    r0 = ao_rad[:, :, None] + ao_rad[:, None, :]
    rr = torch.sqrt(r_ao / r0)
    pi_fac = (1.0 + ao_poly[:, :, None] * rr) * (1.0 + ao_poly[:, None, :] * rr)

    havg = 0.5 * (ao_level[:, :, None] + ao_level[:, None, :])
    # element-pair scaling K_AB (1.0 by default)
    kp_ao = _take2(batch.at_kpair, batch.ao_atom)
    H = K * kp_ao * havg * S * en_fac * pi_fac

    same_atom = batch.ao_atom[:, :, None] == batch.ao_atom[:, None, :]
    H = torch.where(same_atom, 0.0, H)
    # padded AOs get DISTINCT high levels: exact degeneracy would NaN the
    # eigenvector backward pass (1/(eps_i - eps_j))
    nao = batch.ao_mask.shape[1]
    pad_levels = PAD_LEVEL + 0.1 * torch.arange(
        nao, dtype=H.dtype, device=H.device
    )
    diag = torch.where(batch.ao_mask > 0.5, ao_level, pad_levels)
    return H + torch.diag_embed(diag)


def gamma_matrix(coords, batch, settings: EngineSettings):
    """Shell-resolved second-order Coulomb kernel (MNOK), (B, nsh, nsh)."""
    nat = coords.shape[1]
    r_at = pair_distances(coords) * (1.0 - _eye(nat, coords))
    r_sh = _take2(r_at, batch.sh_atom)
    eta_i = batch.sh_eta[:, :, None]
    eta_j = batch.sh_eta[:, None, :]
    g = batch.glb[:, 10, None, None]
    if settings.eta_average == "arithmetic":
        eta_avg = 0.5 * (eta_i + eta_j)
    elif settings.eta_average == "geometric":
        eta_avg = torch.sqrt(eta_i * eta_j)
    elif settings.eta_average == "invpow":
        # average the kernel-space eta^{-g} values directly
        eta_avg = (0.5 * (eta_i ** (-g) + eta_j ** (-g))) ** (-1.0 / g)
    else:
        eta_avg = 2.0 * eta_i * eta_j / (eta_i + eta_j)
    return (r_sh**g + eta_avg ** (-g)) ** (-1.0 / g)


# ---------------------------------------------------------------------------
# Occupations
# ---------------------------------------------------------------------------


def _aufbau_fill(eps, n_el, ao_mask):
    """Integer/aufbau filling of one spin channel."""
    big = 1.0e3
    e = torch.where(ao_mask > 0.5, eps, big)
    ranks = torch.argsort(torch.argsort(e, dim=-1), dim=-1).to(eps.dtype)
    f = torch.clamp(n_el[:, None] - ranks, 0.0, 1.0)
    return f, torch.zeros_like(n_el)


def occupations(eps, nelec, nuhf, kt, ao_mask, fixed: bool):
    """Two-channel filling; returns (f_total in [0,2] (B, nao), entropy (B,)).

    The Fermi filling is `ops/fermi_fill.py` (the CUDA kernel on a card,
    its plain version on the CPU). The aufbau filling fills the alpha and
    beta channels in one call on a (2B, nao) stack; each row is
    independent, so this equals two separate fills."""
    if not fixed:
        return fermi_occupations(eps, nelec, nuhf, kt, ao_mask)
    n_ch = torch.cat([0.5 * (nelec + nuhf), 0.5 * (nelec - nuhf)])
    eps2 = torch.cat([eps, eps])
    mask2 = torch.cat([ao_mask, ao_mask])
    f2, s2 = _aufbau_fill(eps2, n_ch, mask2)
    bsz = eps.shape[0]
    return f2[:bsz] + f2[bsz:], s2[:bsz] + s2[bsz:]


# ---------------------------------------------------------------------------
# SCF machinery
# ---------------------------------------------------------------------------


class _EighSafe(torch.autograd.Function):
    """Symmetric eigendecomposition with a degeneracy-safe backward pass.

    `torch.linalg.eigh`'s own backward divides by eigenvalue gaps, giving
    NaN for exactly degenerate spectra and amplified noise for
    numerically degenerate ones (the round-3 bug: f32 gradients 40-200x
    too large). Gaps below sqrt(eps_mach) (f32: 3.5e-4, f64: 1.5e-8 Ha)
    are treated as exact degeneracies and their coupling zeroed, the
    correct limit for gauge-invariant outputs (energies, equal-occupation
    densities).

    The forward pass is `batched_eigh.eigh_folded`: `torch.linalg.eigh` on
    the CPU; on a card the cuSOLVER binding, whose status goes to the
    calling stage of the call (no host synchronization, so the stage can
    be captured)."""

    @staticmethod
    def forward(ctx, a):
        w, v = eigh_folded(a)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, dw, dv):
        w, v = ctx.saved_tensors
        gap = w[..., None, :] - w[..., :, None]  # (i, j): w_j - w_i
        tol = torch.finfo(w.dtype).eps ** 0.5
        keep = torch.abs(gap) > tol
        f = torch.where(keep, 1.0 / torch.where(keep, gap, 1.0), 0.0)
        inner = f * _mm(v, dv, trans_a=True) + torch.diag_embed(dw)
        da = _mm(_mm(v, inner), v, trans_b=True)
        return 0.5 * (da + da.transpose(-1, -2))


def eigh_safe(a):
    """(eigenvalues, eigenvectors) with the degeneracy-safe backward."""
    return _EighSafe.apply(a)


class _EighValues(_EighSafe):
    """`eigh_safe` whose backward, where the eigenvectors take no gradient,
    is `torch.linalg.eigvalsh`'s (V diag(dw) V^T, the same products)."""

    @staticmethod
    def forward(ctx, a):
        ctx.set_materialize_grads(False)
        return _EighSafe.forward(ctx, a)

    @staticmethod
    def backward(ctx, dw, dv):
        w, v = ctx.saved_tensors
        if dv is None:
            return _mm(v * dw.unsqueeze(-2), v, trans_b=True)
        return _EighSafe.backward(
            ctx, torch.zeros_like(w) if dw is None else dw, dv)


def eigvalsh(a):
    """Eigenvalues (..., n) of a batch of symmetric matrices: on the CPU
    `torch.linalg.eigvalsh`'s values and gradient, bit for bit; on a card
    the binding of `eigh_safe`'s forward pass, with no host sync."""
    return _EighValues.apply(a)[0]


def _ortho_factors(S):
    """Canonical orthogonalizer with linear-dependence removal.

    X = U s^-1/2 U^T with combos below 1e-7 projected out (tblite's lindep
    handling); the removed directions are pinned at +PAD_LEVEL in the
    transformed Fock so they are never occupied."""
    s, U = eigh_safe(S)
    keep = (s > 1e-7).to(S.dtype)
    w = torch.where(s > 1e-7, torch.rsqrt(torch.clamp(s, min=1e-7)), 0.0)
    Xs = _mm(U * w[:, None, :], U, trans_b=True)
    proj_out = _eye(S.shape[-1], S) - _mm(U * keep[:, None, :], U,
                                          trans_b=True)
    return Xs, proj_out


def _general_eigh(F, ortho, status=None):
    """Generalized eigenproblem via canonical orthogonalization factors.

    status: given by the (not differentiated) SCC loops, whose eigh is
    then `batched_eigh.eigh` (cuSOLVER's batched routine, its status kept
    on the device in `status`); otherwise `eigh_safe`."""
    Xs, proj_out = ortho
    a = _sandwich(Xs, F, PAD_LEVEL * proj_out)
    eps, Cp = eigh_safe(a) if status is None else batched_eigh(a, status)
    return eps, _mm(Xs, Cp)


def _atom_charges(q_sh, batch):
    nat = batch.at_gam3.shape[1]
    return segment_sum(q_sh, batch.sh_atom, nat, batch.sh_mask)


def _matvec(m, x):
    if _small(*m.shape[-2:]):
        return fragment_matvec(m, x)
    return (m @ x[..., None])[..., 0]


def _coulomb_potential(q_sh, gamma, batch, settings, gamma_at=None):
    """v_sh = dE_coul/dq_sh (shell); third-order + atom-level (solvation,
    gamma_at (B, nat, nat))."""
    v = _matvec(gamma, q_sh)
    if settings.third_order or gamma_at is not None:
        q_at = _atom_charges(q_sh, batch)
        v_at = torch.zeros_like(q_at)
        if settings.third_order:
            v_at = v_at + batch.at_gam3 * q_at**2
        if gamma_at is not None:
            v_at = v_at + _matvec(gamma_at, q_at)
        v = v + _take(v_at, batch.sh_atom)
    return v


def _coulomb_energy(q_sh, gamma, batch, settings, gamma_at=None):
    e2 = 0.5 * fragment_sum(q_sh * _matvec(gamma, q_sh))
    if settings.third_order or gamma_at is not None:
        q_at = _atom_charges(q_sh, batch)
        if settings.third_order:
            e2 = e2 + fragment_sum(batch.at_gam3 * q_at**3) / 3.0
        if gamma_at is not None:
            e2 = e2 + 0.5 * fragment_sum(q_at * _matvec(gamma_at, q_at))
    return e2


def _fock(H0, S, q_sh, gamma, batch, settings, gamma_at=None):
    v_sh = _coulomb_potential(q_sh, gamma, batch, settings, gamma_at)
    v_ao = _take(v_sh, batch.ao_shell)
    # population derivative: dE/dn = -dE/dq
    return H0 - 0.5 * (v_ao[:, :, None] + v_ao[:, None, :]) * S


def _shell_populations(P, S, batch):
    """The shell populations: (PS)_mumu for symmetric S (the row sums of
    P * S) summed into shells, one launch on a card (`moment_rows`)."""
    nsh = batch.sh_mask.shape[1]
    return moment_rows(P, S[:, None], batch.ao_shell, nsh,
                       batch.ao_mask)[..., 0]


def _jacobi_route(S):
    """Orthogonalizer for the fast in-loop solvers (Jacobi kernel, SP2):
    canonical S^-1/2 with linear dependence removed below 1e-5 (the JAX
    in-loop route's threshold) and the removed combos pinned at +PAD_LEVEL,
    so they are never occupied by the eigensolver's filling nor by SP2's
    trace projection. Its eigh is `batched_eigh.eigh_folded`, as
    `eigh_safe`'s forward pass."""
    s_eig, U = eigh_folded(S)
    lindep = 1e-5
    s_keep = (s_eig > lindep).to(S.dtype)
    winv = torch.where(
        s_eig > lindep, torch.rsqrt(torch.clamp(s_eig, min=lindep)), 0.0
    )
    Xs = _mm(U * winv[:, None, :], U, trans_b=True)
    shift_out = PAD_LEVEL * (
        _eye(S.shape[-1], S) - _mm(U * s_keep[:, None, :], U, trans_b=True)
    )
    return Xs, shift_out


def scc_orthogonalizer(S, settings: EngineSettings):
    """The SCC loop's orthogonalizer of S: (Xs, shift_out) of
    `_jacobi_route` on GFN1's fast in-loop route (settings.use_pallas_eigh
    in float32), else (Xs, proj_out) of `_ortho_factors`. GFN2's loop
    (`_aes_fixed_point`) takes `_ortho_factors` whatever use_pallas_eigh
    says, as the JAX package's does."""
    if (settings.use_pallas_eigh and S.dtype == torch.float32
            and not settings.multipoles):
        return _jacobi_route(S)
    return _ortho_factors(S)


#: SCC iterations between two checks whether every fragment has met
#: scf_tol (each check is one device-to-host sync; skipping iterations of
#: frozen fragments changes no result)
_DONE_CHECK_EVERY = 4


class _AndersonState(NamedTuple):
    """The Anderson loop's state, the JAX while_loop's carry. The JAX carry
    is immutable; here `_anderson_step` updates these tensors in place
    (`copy_`), so that a captured iteration reads and writes the same
    buffers at every replay. `it` is the iteration counter as a 0-d int64
    tensor on the device: every active fragment has done exactly `it`
    iterations."""

    x: torch.Tensor         # (B, nx) the states
    resid: torch.Tensor     # (B,) each fragment's last residual
    active: torch.Tensor    # (B,) bool: still above scf_tol
    hist_x: torch.Tensor    # (B, m, nx) the window of states
    hist_f: torch.Tensor    # (B, m, nx) and of residual vectors
    it: torch.Tensor        # () int64


def _anderson_state(x0, settings: EngineSettings) -> _AndersonState:
    bsz, nx = x0.shape
    m = settings.broyden_memory
    dtype, dev = x0.dtype, x0.device
    return _AndersonState(
        # a copy: the state is updated in place, x0 may be the caller's
        x=x0.clone(),
        resid=torch.ones(bsz, dtype=dtype, device=dev),
        active=torch.ones(bsz, dtype=torch.bool, device=dev),
        hist_x=torch.zeros(bsz, m, nx, dtype=dtype, device=dev),
        hist_f=torch.zeros(bsz, m, nx, dtype=dtype, device=dev),
        it=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _anderson_step(fixed_point, state: _AndersonState,
                   settings: EngineSettings) -> None:
    """One Anderson iteration on `state`, in place; the iteration counter
    lives on the device, so the step reads no host value that changes
    between iterations and can be captured once and replayed. The window
    algebra after f_res = g(x) - x is `ops/anderson_window.py` (one kernel
    launch on a card); the counter's increment is a launch of its own."""
    x = state.x
    f32 = x.dtype == torch.float32
    f_res = fixed_point(x) - x
    anderson_window(
        x, f_res, state.hist_x, state.hist_f, state.resid, state.active,
        state.it, beta=settings.mixer_damping, reg=1e-4 if f32 else 1e-12,
        c_lim=2.0 if f32 else 1e3, scf_tol=settings.scf_tol,
    )
    state.it.add_(1)


def _all_done(state: _AndersonState, settings: EngineSettings,
              it: int) -> bool:
    """Whether the loop stops before iteration `it`: every fragment has
    met scf_tol, asked every _DONE_CHECK_EVERY iterations (a host sync)."""
    return (settings.scf_tol > 0 and it > 0 and it % _DONE_CHECK_EVERY == 0
            and not bool(state.active.any()))


class _SccLoop:
    """One SCC loop: the fixed-point map over its inputs, the state it
    updates in place, and its step. make_fixed_point(inputs) returns the
    map and the `EighStatus` its in-loop eigh folds into (or None)."""

    def __init__(self, make_fixed_point, inputs, x0,
                 settings: EngineSettings):
        self.fixed_point, self.status = make_fixed_point(inputs)
        self.settings = settings
        self.state = _anderson_state(x0, settings)

    def step(self) -> None:
        _anderson_step(self.fixed_point, self.state, self.settings)

    def done(self, it: int) -> bool:
        return _all_done(self.state, self.settings, it)

    def restart_state(self) -> tuple:
        """What a restart from iteration 0 sets, whatever the state before:
        (x, to the new start; the counter, to 0). Nothing else of the
        state is read before a solve writes it: the first iteration counts
        every fragment as active and writes every residual, its step,
        rejected at it = 0, is the only one that reads the window's older
        slots (every later one reads slots written in the same solve), and
        the eigh status is 0 unless a failure was read, which zeroes it
        (`EighStatus.check`)."""
        return self.state.x, self.state.it

    def owned(self) -> list:
        """The device tensors the loop allocated."""
        out = list(self.state)
        if self.status is not None:
            out.append(self.status.worst)
            if self.status.work is not None:
                out.append(self.status.work)
        return out


def _loop_fields(batch, names) -> dict:
    """The fields of `batch` the SCC loop reads, as a dict (the loop sees
    them as attributes of a namespace: a field left out raises)."""
    return {k: getattr(batch, k) for k in names}


#: the fields of FragmentData the SCC loops read: the charge-only loop's
#: and, for GFN2's multipole loop, these and its own
_LOOP_FIELDS = ("at_gam3", "sh_atom", "sh_mask", "sh_refocc", "ao_shell",
                "ao_mask", "nelec", "nuhf")
_LOOP_FIELDS_MULTIPOLE = _LOOP_FIELDS + ("atom_mask", "ao_atom", "glb")


def _anderson_solve(make_fixed_point, inputs: dict, x0,
                    settings: EngineSettings, key, graph: bool = True):
    """Anderson-mixed fixed-point iteration x <- g(x) on a batch of state
    vectors x0 (B, nx); returns the states and the final residuals (B,).

    make_fixed_point(inputs) gives g and the in-loop eigh's `EighStatus`
    (or None), built over the tensors of `inputs` (a dict); key: what
    besides the inputs' shapes and the settings fixes g's launches (its
    route, kT, SP2's closed-shell flag).

    Each fragment iterates until its residual max|g(x) - x| drops below
    settings.scf_tol or max_scf_iter is reached; a fragment that stops
    keeps its state while the others iterate, as the JAX package's vmapped
    while_loop does. Window of broyden_memory with Tikhonov-regularized
    normal equations, a c_lim safeguard and damped steps as fallback.

    On a card the iterations run as replays of one captured CUDA graph,
    kept across calls of the same key and shapes (`scc_graph.solve`), the
    counterpart of the JAX package's compiled while_loop, with the same
    results and the same stop. A failed capture raises. graph=False runs
    them launch by launch instead, for a caller that compares the two; a
    CPU tensor always does.
    """
    def build(inp):
        return _SccLoop(make_fixed_point, inp, x0, settings)

    if graph and x0.device.type == "cuda":
        loop = scc_graph.solve((key, settings), inputs, x0, build,
                               settings.max_scf_iter)
    else:
        if x0.device.type == "cuda":
            scc_graph.stats["eager"] += 1
        loop = build(inputs)
        for it in range(settings.max_scf_iter):
            if loop.done(it):
                break
            loop.step()
    call = scc_graph.current_call()
    if call is not None:
        call.defer(loop.status)
    elif loop.status is not None:
        loop.status.check()
    # copies: a cached loop's state is the next solve's
    return loop.state.x.clone(), loop.state.resid.clone()


def _warm_start(x0, shape, like):
    if x0 is None:
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return x0.to(dtype=like.dtype, device=like.device)


def _scc_density(eps, C, batch, kt, settings: EngineSettings):
    """The SCC loop's density P = C diag(f) C^T (not differentiated).

    The Fermi filling up to DENSITY_MAX_N AOs is `fermi_density`: the
    fill and the product in one kernel launch on a card. Above it, and
    for the aufbau filling, the fill and a product (`_mm`: the
    batch-invariant kernel up to the op's MAX_N, torch.matmul above, where the
    JAX package leaves it to XLA; chosen by shape, not a fallback)."""
    if not settings.fixed_occupations and C.shape[-1] <= DENSITY_MAX_N:
        return fermi_density(eps, C, batch.nelec, batch.nuhf, kt,
                             batch.ao_mask)
    f, _ = occupations(
        eps, batch.nelec, batch.nuhf, kt, batch.ao_mask,
        settings.fixed_occupations,
    )
    return _mm(C * f[:, None, :], C, trans_b=True)


def scf_solve(H0, S, gamma, batch, kt, settings: EngineSettings,
              gamma_at=None, q0=None, graph: bool = True, ortho=None):
    """Bounded SCC loop (not differentiated) with Anderson mixing
    (`_anderson_solve`).

    Returns converged shell charges q* (B, nsh) and the final charge
    residual (B,).

    gamma_at: optional atom-level kernel addition (solvation), (B, nat,
    nat). q0: optional warm-start shell charges (B, nsh); the fixed point
    is unique, so the warm start only changes how fast the tolerance is
    reached.

    With settings.use_pallas_eigh a float32 SCC takes the fast in-loop
    route, as the JAX package: the Jacobi kernel for nao <=
    PALLAS_EIGH_MAX_N, and above it SP2 density purification
    (ops/sp2.py): 48 batched (N, N) products replace the eigensolver,
    valid inside the fixed-point loop because only the density is needed
    there. A float64 SCC always takes the exact route (`_ortho_factors`,
    `_general_eigh`), whose in-loop eigh reports its status once, after
    the loop.

    graph: on a card, run the iterations as replays of one captured CUDA
    graph (`_anderson_solve`); False runs them launch by launch, to compare.
    ortho: the loop's orthogonalizer (`scc_orthogonalizer(S, settings)`)
    where the caller built it.
    """
    fast_inloop = settings.use_pallas_eigh and S.dtype == torch.float32
    use_sp2 = fast_inloop and S.shape[-1] > PALLAS_EIGH_MAX_N
    inputs = {"H0": H0, "S": S, "gamma": gamma, "gamma_at": gamma_at,
              "batch": _loop_fields(batch, _LOOP_FIELDS)}
    Xs, shift = ortho if ortho is not None else scc_orthogonalizer(
        S, settings)
    inputs["Xs"] = Xs
    inputs["shift_out" if fast_inloop else "proj_out"] = shift
    # one device-to-host sync per solve, not one per iteration
    closed_shell = bool((batch.nuhf == 0).all()) if use_sp2 else None

    def make_fixed_point(inp):
        H0, S, gamma, gamma_at = (inp[k] for k in ("H0", "S", "gamma",
                                                   "gamma_at"))
        batch, Xs = SimpleNamespace(**inp["batch"]), inp["Xs"]
        status = None
        if use_sp2:
            def make_density(F):
                Po = sp2_density(
                    _sandwich(Xs, F, inp["shift_out"]), batch.nelec,
                    batch.nuhf, batch.ao_mask, closed_shell=closed_shell,
                )
                return _mm(_mm(Xs, Po), Xs)
        elif fast_inloop:
            def make_density(F):
                eps, Cp = jacobi_eigh(_sandwich(Xs, F, inp["shift_out"]))
                return _scc_density(eps, _mm(Xs, Cp), batch, kt, settings)
        else:
            status = EighStatus(S)
            ortho = (Xs, inp["proj_out"])

            def make_density(F):
                eps, C = _general_eigh(F, ortho, status)
                return _scc_density(eps, C, batch, kt, settings)

        def fixed_point(q):
            P = make_density(_fock(H0, S, q, gamma, batch, settings,
                                   gamma_at))
            n_sh = _shell_populations(P, S, batch)
            return (batch.sh_refocc - n_sh) * batch.sh_mask

        return fixed_point, status

    route = "sp2" if use_sp2 else "jacobi" if fast_inloop else "exact"
    return _anderson_solve(
        make_fixed_point, inputs, _warm_start(q0, batch.sh_mask.shape, S),
        settings, (route, closed_shell, float(kt)), graph,
    )


def scf_refine(H0, S, gamma, batch, kt, settings: EngineSettings, q0,
               n_iter: int, gamma_at=None):
    """Differentiable fixed-point refinement from a converged warm start.

    n_iter plain half-damped iterations that autograd records, so q*(R)
    carries derivatives by truncated backpropagation, which converges
    geometrically since |q0 - q*| is already at solver tolerance. The
    occupations are detached (exact for gapped systems)."""
    ortho = _ortho_factors(S)
    q = q0
    for _ in range(n_iter):
        F = _fock(H0, S, q, gamma, batch, settings, gamma_at)
        eps, C = _general_eigh(F, ortho)
        f, _ = occupations(
            eps, batch.nelec, batch.nuhf, kt, batch.ao_mask,
            settings.fixed_occupations,
        )
        f = f.detach()
        P = _mm(C * f[:, None, :], C, trans_b=True)
        n_sh = _shell_populations(P, S, batch)
        q_new = (batch.sh_refocc - n_sh) * batch.sh_mask
        q = q + 0.5 * (q_new - q)
    return q


# ---------------------------------------------------------------------------
# GFN2 multipole (AES) machinery on the packed state z = (q_sh, mu, theta)
# ---------------------------------------------------------------------------


def _aes_pack(q, mu, th):
    return torch.cat([q, mu.flatten(1), th.flatten(1)], -1)


def _aes_unpack(z, nsh, nat):
    q = z[:, :nsh]
    mu = z[:, nsh : nsh + 3 * nat].reshape(-1, nat, 3)
    th = z[:, nsh + 3 * nat :].reshape(-1, nat, 6)
    return q, mu, th


def _aes_interaction(q_sh, mu, th, coords, gamma, batch, settings,
                     gamma_at, mp):
    """Moment-dependent interaction energy for GFN2, (B,): isotropic second
    + third order + AES + charge-scaled dispersion."""
    from .dispersion_d3 import d3_energy
    from .gfn2 import aes_energy, d4_zeta

    e = _coulomb_energy(q_sh, gamma, batch, settings, gamma_at)
    q_at = _atom_charges(q_sh, batch)
    aes_p = mp["at_aes"]
    e = e + aes_energy(
        coords, q_at, mu, th,
        aes_p[..., 0], aes_p[..., 1], aes_p[..., 2], batch.atom_mask,
    )
    if mp.get("d4", False):
        zeta = d4_zeta(q_at, aes_p[..., 3], aes_p[..., 4], batch.atom_mask)
        glb = batch.glb
        # scale the pair C6 table by zeta_A zeta_B (charge-dependent C6)
        e = e + d3_energy(
            coords, mp["cn"], mp["d3tab"], batch.atom_mask,
            glb[:, 12], glb[:, 13], glb[:, 14], glb[:, 15],
            c6_scale=zeta[:, :, None] * zeta[:, None, :],
        )
    return e


def _aes_potentials(q, mu, th, coords, gamma, batch, settings, gamma_at, mp):
    """(vq, vmu, vth) = d E_int / d (q, mu, th), by autograd.

    Called with autograd off (the SCC loop, an energy-only evaluation) the
    derivative is taken on detached copies of the moments and carries no
    graph. Called with autograd on (the variational functional, the
    differentiable refinement) it is built with create_graph=True, so the
    outer derivative with respect to the coordinates, and to a
    differentiable state, flows through the potentials."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        leaves = [
            t if outer and t.requires_grad else t.detach().requires_grad_(True)
            for t in (q, mu, th)
        ]
        e = _aes_interaction(
            *leaves, coords, gamma, batch, settings, gamma_at, mp
        ).sum()
        return torch.autograd.grad(e, leaves, create_graph=outer)


def _aes_fock(H0, S, z, coords, gamma, batch, settings, gamma_at, mp):
    """Fock matrix for the multipole SCC state z = (q_sh, mu, theta), and
    the potentials (vq, vmu, vth_eff) it was built from."""
    nsh = batch.sh_mask.shape[1]
    nat = batch.atom_mask.shape[1]
    q, mu, th = _aes_unpack(z, nsh, nat)
    vq, vmu, vth = _aes_potentials(
        q, mu, th, coords, gamma, batch, settings, gamma_at, mp
    )
    # charge part: dE/dn = -dE/dq, standard shift
    v_ao = _take(vq, batch.ao_shell)
    F = H0 - 0.5 * (v_ao[:, :, None] + v_ao[:, None, :]) * S
    # multipole part: mu_A = -sum_{k in A, l} P_kl D_kl  (linear in P).
    # theta is stored TRACELESS (camm_moments subtracts tr/3 from the
    # diagonal); the adjoint of that projection must be applied to the
    # theta-potential before contracting with the RAW quadrupole integrals,
    # or the variational trace identity (and the stationarity the gradient
    # path relies on) breaks.
    tr_v = (vth[..., 0] + vth[..., 1] + vth[..., 2]) / 3.0
    vth_eff = torch.cat([vth[..., :3] - tr_v[..., None], vth[..., 3:]], -1)
    # F + (G + G^T) / 2, G = -sum_d v_mu D - sum_d v_th Q (`moment_fock`:
    # one launch on a card)
    F = moment_fock(F, _take(vmu, batch.ao_atom), mp["D"],
                    _take(vth_eff, batch.ao_atom), mp["Q"])
    return F, (vq, vmu, vth_eff)


def _aes_moments_of_P(P, S, batch, mp):
    from .gfn2 import camm_moments

    n_sh = _shell_populations(P, S, batch)
    q = (batch.sh_refocc - n_sh) * batch.sh_mask
    mu, th = camm_moments(
        P, S, mp["D"], mp["Q"], batch.ao_atom, batch.atom_mask.shape[1]
    )
    mu = mu * batch.atom_mask[:, :, None]
    th = th * batch.atom_mask[:, :, None]
    return q, mu, th


def _aes_fixed_point(H0, S, coords, gamma, batch, kt, settings, gamma_at, mp,
                     ortho, status=None):
    """The multipole SCC map z -> z' (Fock, generalized eigh, filling,
    moments of the new density). It always diagonalizes through
    `_general_eigh`, whatever use_pallas_eigh says, as the JAX package.

    status: an `EighStatus` where the map runs in the (not differentiated)
    SCC loop: its eigh keeps cuSOLVER's status on the device and its
    density is `_scc_density`'s; None where autograd records the map
    through C, with the occupations detached (exact for gapped systems)."""
    scc_loop = status is not None

    def fixed_point(z):
        F, _ = _aes_fock(H0, S, z, coords, gamma, batch, settings,
                         gamma_at, mp)
        eps, C = _general_eigh(F, ortho, status)
        if scc_loop:
            P = _scc_density(eps, C, batch, kt, settings)
        else:
            f, _ = occupations(
                eps, batch.nelec, batch.nuhf, kt, batch.ao_mask,
                settings.fixed_occupations,
            )
            f = f.detach()
            P = _mm(C * f[:, None, :], C, trans_b=True)
        return _aes_pack(*_aes_moments_of_P(P, S, batch, mp))

    return fixed_point


def scf_solve_multipole(H0, S, coords, gamma, batch, kt,
                        settings: EngineSettings, gamma_at, mp, z0=None,
                        graph: bool = True, ortho=None):
    """Anderson-mixed SCC over the extended moment state (GFN2/AES):
    `_anderson_solve` on z (B, nsh + 9 nat). Not differentiated.

    z0: optional warm start (packed AES state); the fixed point is unique,
    so it only changes how fast the tolerance is reached. graph and ortho:
    as `scf_solve`'s; the captured iteration holds the autograd pass of
    `_aes_potentials`."""
    bsz, nsh = batch.sh_mask.shape
    nat = batch.atom_mask.shape[1]
    inputs = {"H0": H0, "S": S, "coords": coords, "gamma": gamma,
              "gamma_at": gamma_at, "mp": mp,
              "batch": _loop_fields(batch, _LOOP_FIELDS_MULTIPOLE)}
    inputs["Xs"], inputs["proj_out"] = (
        ortho if ortho is not None else _ortho_factors(S))

    def make_fixed_point(inp):
        status = EighStatus(inp["S"])
        return _aes_fixed_point(
            inp["H0"], inp["S"], inp["coords"], inp["gamma"],
            SimpleNamespace(**inp["batch"]), kt, settings, inp["gamma_at"],
            inp["mp"], (inp["Xs"], inp["proj_out"]), status,
        ), status

    return _anderson_solve(
        make_fixed_point, inputs, _warm_start(z0, (bsz, nsh + 9 * nat), S),
        settings, ("multipole", None, float(kt)), graph,
    )


def scf_refine_multipole(H0, S, coords, gamma, batch, kt,
                         settings: EngineSettings, gamma_at, mp, z0,
                         n_iter: int):
    """Differentiable damped refinement of the packed AES state (GFN2): the
    multipole analog of `scf_refine`, n_iter damped fixed-point steps that
    autograd records, occupations detached."""
    fixed_point = _aes_fixed_point(
        H0, S, coords, gamma, batch, kt, settings, gamma_at, mp,
        _ortho_factors(S),
    )
    beta = settings.mixer_damping
    z = z0
    for _ in range(n_iter):
        z = z + beta * (fixed_point(z) - z)
    return z


def electronic_energy_multipole(coords, z_star, batch, kt,
                                settings: EngineSettings, gamma_at, mp):
    """Variational energy at the converged moment state (GFN2/AES), (B,).

    mp: the static AES/D4 tables (`calculator._mp_tables`); its
    coordination number and moment integrals are rebuilt here from
    `coords`, so their geometric derivatives flow."""
    # S from overlap_matrix (padded-diagonal identity handling);
    # moment_matrices supplies the dipole/quadrupole integrals
    S = overlap_matrix(
        coords, batch.ao_atom, batch.ao_lxyz, batch.prim_alpha,
        batch.prim_coeff,
    )
    _S_mm, D, Q = moment_matrices(
        coords, batch.ao_atom, batch.ao_lxyz, batch.prim_alpha,
        batch.prim_coeff,
    )
    cn = coordination_numbers(
        coords, batch.at_rcov, batch.atom_mask, batch.glb[:, 11],
        settings.cn_type,
    )
    H0 = h0_matrix(S, coords, batch, cn, settings)
    gamma = gamma_matrix(coords, batch, settings)
    mp = dict(mp)
    # D4-style dispersion uses the D3 counting function, not the H0 one
    mp["cn"] = coordination_numbers(
        coords, batch.at_rcov, batch.atom_mask, batch.glb[:, 11],
        settings.cn_type_d3,
    )
    mp["D"], mp["Q"] = D, Q

    F, (vq, vmu, vth) = _aes_fock(
        H0, S, z_star, coords, gamma, batch, settings, gamma_at, mp
    )
    eps, C = _general_eigh(F, _ortho_factors(S))
    f, entropy = occupations(
        eps, batch.nelec, batch.nuhf, kt, batch.ao_mask,
        settings.fixed_occupations,
    )
    f = f.detach()
    e_band = fragment_sum(f * eps)

    nsh = batch.sh_mask.shape[1]
    nat = batch.atom_mask.shape[1]
    q, mu, th = _aes_unpack(z_star, nsh, nat)
    n_star = (batch.sh_refocc - q) * batch.sh_mask
    # Tr(P(F-H0)) = -sum v_q n + v_mu.mu + v_th.th  (moments linear in P);
    # the potentials are NOT detached: their coordinate derivative is part
    # of the gradient
    e_el = (
        e_band
        + fragment_sum(vq * n_star)
        - fragment_sum(vmu * mu, (1, 2))
        - fragment_sum(vth * th, (1, 2))
        + _aes_interaction(
            q, mu, th, coords, gamma, batch, settings, gamma_at, mp
        )
    )
    if settings.include_entropy and not settings.fixed_occupations:
        e_el = e_el - kt * entropy.detach()
    return e_el, eps, f, entropy


def electronic_energy(coords, q_star, batch, kt, settings: EngineSettings,
                      gamma_at=None):
    """Variational total electronic energy at converged charges q*, (B,).

    Differentiable in `coords`; q* must be detached by the caller.
    gamma_at: optional atom-level kernel addition (solvation), a function
    of coords upstream so its geometric derivatives flow. Returns
    (E_el, eps, f, entropy)."""
    S = overlap_matrix(
        coords, batch.ao_atom, batch.ao_lxyz, batch.prim_alpha,
        batch.prim_coeff,
    )
    cn = coordination_numbers(
        coords, batch.at_rcov, batch.atom_mask, batch.glb[:, 11],
        settings.cn_type,
    )
    H0 = h0_matrix(S, coords, batch, cn, settings)
    gamma = gamma_matrix(coords, batch, settings)

    F = _fock(H0, S, q_star, gamma, batch, settings, gamma_at)
    eps, C = _general_eigh(F, _ortho_factors(S))
    f, entropy = occupations(
        eps, batch.nelec, batch.nuhf, kt, batch.ao_mask,
        settings.fixed_occupations,
    )
    f = f.detach()
    e_band = fragment_sum(f * eps)

    v_sh = _coulomb_potential(q_star, gamma, batch, settings, gamma_at)
    n_star = (batch.sh_refocc - q_star) * batch.sh_mask
    # E_band = tr(P H0) - sum_sh v_sh n_sh, so adding back sum v n* recovers
    # tr(P H0); E_coul then adds the charge-fluctuation energy once.
    e_el = e_band + fragment_sum(v_sh * n_star) + _coulomb_energy(
        q_star, gamma, batch, settings, gamma_at
    )
    if settings.include_entropy and not settings.fixed_occupations:
        e_el = e_el - kt * entropy.detach()
    return e_el, eps, f, entropy
