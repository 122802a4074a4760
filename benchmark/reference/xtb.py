"""GFN1-xTB single-point energies of a batch of fragments, in plain torch:
the benchmark's reference.

It works everything out from the atomic numbers, charges, multiplicities
and coordinates it is handed: the basis and parameter tables (the copied
`params_gfn1` with its fitted overlay, `basis`, `batch` and
`dispersion_d3`), the overlap integrals (`overlap`), the Hamiltonian,
the SCC and the energy functional. The equations are those of the program's
engine, frozen here: each call of a hand-written kernel is the torch
expression it replaced (`plain.py`), every eigenproblem is
`torch.linalg.eigh`, and the SCC is a plain Anderson-mixed fixed-point loop
run to a tighter tolerance than the program's, so that the reference's own
stop leaves no mark on what is compared.

Usage:
    tables = build(fragments, "gfn1", device, torch.float64)
    energies, residuals = energies_at(tables, coords, settings_for("gfn1"))
fragments are (numbers, coords_bohr, charge, multiplicity) tuples; coords
(B, nat, 3) in Bohr.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import batch as _batch
from . import dispersion_d3 as _d3
from .overlap import overlap_matrix
from .plain import fragment_sum, segment_sum, take, take2
from .units import KB_HARTREE
from .xbond import halogen_bond_energy

PAD_LEVEL = _batch.PAD_LEVEL


class Settings(NamedTuple):
    """The functional's form and the SCC's stop."""

    variant: str
    electronic_temp: float = 300.0
    mixer_damping: float = 0.4
    memory: int = 12
    #: the loop stops where max |q' - q| of every fragment is below this
    scf_tol: float = 1e-10
    max_iter: int = 500
    klight_rep: float = None
    kpol_mode: str = "flat"
    eta_average: str = "harmonic"
    cn_type: str = "exp"
    cn_type_d3: str = "exp"
    disp_s9: float = 0.0


def settings_for(variant: str, **overrides) -> Settings:
    """The form flags of the variant's parameter set (its GLOBALS)."""
    params = _batch._params_module(variant)
    g = params.GLOBALS
    base = dict(
        variant=variant,
        klight_rep=getattr(g, "klight", None),
        kpol_mode=getattr(g, "kpol_mode", "flat"),
        eta_average=getattr(g, "eta_average", "harmonic"),
        cn_type=getattr(g, "cn_type", "exp"),
        cn_type_d3=getattr(g, "cn_type_d3", "exp"),
        disp_s9=getattr(g, "disp_s9", 0.0),
    )
    base.update(overrides)
    return Settings(**base)


class Tables:
    """A batch's tables as tensors on one device: the fields of
    `batch.XtbBatch` and the D3 tables, each with a leading fragment
    axis."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _tensor(x, device, dtype):
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return torch.tensor(x, dtype=dtype, device=device)
    return torch.tensor(x, dtype=torch.int64, device=device)


def build(fragments, variant: str, device, dtype=torch.float64) -> Tables:
    """The tables of a list of fragments, padded to the largest. Fragments
    of one composition (numbers, charge, multiplicity) share one build."""
    groups, order = {}, []
    for numbers, coords, charge, mult in fragments:
        key = (tuple(int(z) for z in numbers), int(charge), int(mult))
        if key not in groups:
            groups[key] = len(groups)
        order.append(groups[key])
    keys = sorted(groups, key=groups.get)
    nat = max(len(k[0]) for k in keys)
    _n, nsh, nao, _p = _batch._sizes_for([np.array(k[0]) for k in keys],
                                         variant)
    one = _batch.build_batch(
        [(np.array(k[0]), np.zeros((len(k[0]), 3)), k[1], k[2])
         for k in keys], variant=variant, pad_to=(nat, nsh, nao))
    rows = np.asarray(order)
    fields = {}
    for name in _batch.XtbBatch.__dataclass_fields__:
        fields[name] = _tensor(getattr(one, name)[rows], device, dtype)
    coords = np.array(one.coords[rows])
    for b, (numbers, xyz, _c, _m) in enumerate(fragments):
        coords[b, :len(numbers)] = xyz
    fields["coords"] = _tensor(coords, device, dtype)
    d3 = [_d3.build_d3_tables(one.numbers[g], fitted=True)
          for g in range(len(keys))]
    for name in ("ref_cn", "zidx", "sqrtc6", "r4r2"):
        fields["d3_" + name] = _tensor(
            np.stack([t[name] for t in d3])[rows], device, dtype)
    table = _tensor(_d3.full_pair_table(fitted=True), device, dtype)
    fields["d3_c6_pair"] = table.expand(len(fragments), *table.shape)
    return Tables(**fields)


def rows(tables: Tables, lo: int, hi: int) -> Tables:
    """Fragments lo..hi-1 of a batch."""
    return Tables(**{k: v[lo:hi] for k, v in tables.__dict__.items()})


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def pair_distances(coords):
    nat = coords.shape[1]
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    return torch.sqrt(
        torch.clamp((diff**2).sum(-1), min=1e-12) + _eye(nat, coords))


def coordination_numbers(coords, rcov, atom_mask, steepness, cn_type="exp",
                         cutoff=25.0):
    """Counting-function coordination numbers (B, nat), 25 Bohr cutoff."""
    nat = coords.shape[1]
    eye = _eye(nat, coords)
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    r = torch.sqrt(torch.clamp((diff**2).sum(-1), min=1e-12) + eye)
    r0 = (4.0 / 3.0) * (rcov[:, :, None] + rcov[:, None, :])
    k = steepness[:, None, None]
    cf = 1.0 / (1.0 + torch.exp(-k * (r0 / r - 1.0)))
    if cn_type == "gfn":
        cf = cf / (1.0 + torch.exp(-2.0 * k * ((r0 + 2.0) / r - 1.0)))
    pair_mask = atom_mask[:, :, None] * atom_mask[:, None, :] * (1.0 - eye)
    pair_mask = pair_mask * (r > 1e-5) * (r < cutoff)
    return (cf * pair_mask).sum(-1)


def repulsion_energy(coords, t: Tables, s: Settings):
    """Pairwise repulsion (B,), the klight rule for light-light pairs."""
    nat = coords.shape[1]
    r = pair_distances(coords)
    mask = t.atom_mask[:, :, None] * t.atom_mask[:, None, :]
    mask = mask * (1.0 - _eye(nat, coords)) * (r > 1e-5)
    r = torch.clamp(r, min=1e-5)
    zz = t.at_zeff[:, :, None] * t.at_zeff[:, None, :]
    ab = torch.sqrt(t.at_alpha[:, :, None] * t.at_alpha[:, None, :])
    kexp = t.glb[:, 8, None, None]
    rexp = t.glb[:, 9, None, None]
    k_ab = kexp
    if s.klight_rep is not None:
        light = ((t.numbers > 0) & (t.numbers <= 2)).to(coords.dtype)
        k_ab = kexp + (s.klight_rep - kexp) * (light[:, :, None]
                                               * light[:, None, :])
    e = zz / r**rexp * torch.exp(-ab * r**k_ab)
    return 0.5 * fragment_sum(e * mask, (1, 2))


def h0_matrix(S, coords, t: Tables, cn, s: Settings):
    """The extended-Hueckel core Hamiltonian (B, nao, nao)."""
    sh_level = t.sh_level - t.sh_kcn * take(cn, t.sh_atom)
    ao_level = take(sh_level, t.ao_shell)
    ao_l = take(t.sh_l, t.ao_shell)
    ao_pol = take(t.sh_pol, t.ao_shell)
    ao_poly = take(t.sh_poly, t.ao_shell)
    ao_en = take(t.at_en, t.ao_atom)
    ao_rad = take(t.at_rad, t.ao_atom)
    glb = t.glb
    kll = torch.stack([
        torch.stack([glb[:, 0], glb[:, 1], glb[:, 2]], -1),
        torch.stack([glb[:, 1], glb[:, 3], glb[:, 4]], -1),
        torch.stack([glb[:, 2], glb[:, 4], glb[:, 5]], -1),
    ], -2)
    kpol = glb[:, 6, None, None]
    ken = glb[:, 7, None, None]
    bidx = torch.arange(S.shape[0], device=S.device)[:, None, None]
    K = kll[bidx, ao_l[:, :, None], ao_l[:, None, :]]
    pol_i = ao_pol[:, :, None] > 0.5
    pol_j = ao_pol[:, None, :] > 0.5
    pol_pair = (ao_pol[:, :, None] + ao_pol[:, None, :]) > 0.5
    if s.kpol_mode.startswith("avg"):
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
    if s.kpol_mode.endswith("_noen"):
        en_fac = torch.where(pol_pair, 1.0, en_fac)
    r_ao = take2(pair_distances(coords), t.ao_atom)
    rr = torch.sqrt(r_ao / (ao_rad[:, :, None] + ao_rad[:, None, :]))
    pi_fac = (1.0 + ao_poly[:, :, None] * rr) * (1.0 + ao_poly[:, None, :] * rr)
    havg = 0.5 * (ao_level[:, :, None] + ao_level[:, None, :])
    H = K * take2(t.at_kpair, t.ao_atom) * havg * S * en_fac * pi_fac
    H = torch.where(t.ao_atom[:, :, None] == t.ao_atom[:, None, :], 0.0, H)
    nao = t.ao_mask.shape[1]
    pad = PAD_LEVEL + 0.1 * torch.arange(nao, dtype=H.dtype, device=H.device)
    return H + torch.diag_embed(torch.where(t.ao_mask > 0.5, ao_level, pad))


def gamma_matrix(coords, t: Tables, s: Settings):
    """The shell-resolved second-order kernel (B, nsh, nsh)."""
    nat = coords.shape[1]
    r_sh = take2(pair_distances(coords) * (1.0 - _eye(nat, coords)),
                 t.sh_atom)
    eta_i = t.sh_eta[:, :, None]
    eta_j = t.sh_eta[:, None, :]
    g = t.glb[:, 10, None, None]
    if s.eta_average == "arithmetic":
        eta_avg = 0.5 * (eta_i + eta_j)
    elif s.eta_average == "geometric":
        eta_avg = torch.sqrt(eta_i * eta_j)
    elif s.eta_average == "invpow":
        eta_avg = (0.5 * (eta_i ** (-g) + eta_j ** (-g))) ** (-1.0 / g)
    else:
        eta_avg = 2.0 * eta_i * eta_j / (eta_i + eta_j)
    return (r_sh**g + eta_avg ** (-g)) ** (-1.0 / g)


def _fermi_fill(e, n_el, kt, mask):
    """One spin channel's Fermi occupations and entropy, mu by 80
    bisection steps."""
    e = torch.where(mask > 0.5, e, 1.0e3)

    def occ(mu):
        x = torch.clamp((e - mu[:, None]) / kt, -60.0, 60.0)
        return 1.0 / (1.0 + torch.exp(x))

    lo = e.min(-1).values - 10.0
    hi = torch.where(mask > 0.5, e, -1.0e3).max(-1).values + 10.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        too_many = occ(mid).sum(-1) > n_el
        lo, hi = torch.where(too_many, lo, mid), torch.where(too_many, mid, hi)
    f = occ(0.5 * (lo + hi))
    fc = torch.clamp(f, 1.0e-30, 1.0 - 1.0e-30)
    ent = -(fc * torch.log(fc) + (1 - fc) * torch.log(1 - fc))
    ent = torch.where((f > 1e-12) & (f < 1.0 - 1e-12), ent, 0.0)
    return f, ent.sum(-1)


def occupations(eps, t: Tables, kt):
    """Both spin channels filled: (f in [0, 2] (B, nao), entropy (B,))."""
    fa, sa = _fermi_fill(eps, 0.5 * (t.nelec + t.nuhf), kt, t.ao_mask)
    fb, sb = _fermi_fill(eps, 0.5 * (t.nelec - t.nuhf), kt, t.ao_mask)
    return fa + fb, sa + sb


def orthogonalizer(S):
    """X = U s^-1/2 U^T with combinations below 1e-7 removed, and the
    projector onto the removed ones."""
    s, U = torch.linalg.eigh(S)
    keep = (s > 1e-7).to(S.dtype)
    w = torch.where(s > 1e-7, torch.rsqrt(torch.clamp(s, min=1e-7)), 0.0)
    X = (U * w[:, None, :]) @ U.transpose(-1, -2)
    proj_out = _eye(S.shape[-1], S) - (U * keep[:, None, :]) @ U.transpose(
        -1, -2)
    return X, proj_out


def general_eigh(F, ortho):
    """Orbital energies and coefficients of F C = S C eps."""
    X, proj_out = ortho
    eps, Cp = torch.linalg.eigh(X @ F @ X + PAD_LEVEL * proj_out)
    return eps, X @ Cp


def general_eigvals(F, S):
    """Orbital energies of F C = S C eps through the Cholesky factor of S,
    the eigenvalues of L^-1 F L^-T. Their derivative needs no eigenvectors of S, so
    it holds where S has coinciding eigenvalues (a water's oxygen p
    shells, which the card's eigh returns exactly equal), where the
    orthogonalizer's derivative divides by their difference; the unused
    eigenvectors of L^-1 F L^-T add nothing to it.
    S must be positive definite: a linearly dependent basis raises."""
    L, info = torch.linalg.cholesky_ex(S)
    if bool((info != 0).any()):
        raise ValueError("the overlap matrix is not positive definite")
    A = torch.linalg.solve_triangular(L, F, upper=False)
    A = torch.linalg.solve_triangular(L, A.transpose(-1, -2), upper=False)
    # eigh, not eigvalsh: the same routine with and without autograd
    return torch.linalg.eigh(A)[0]


def density(eps, C, t: Tables, kt):
    f, _ = occupations(eps, t, kt)
    return (C * f[:, None, :]) @ C.transpose(-1, -2)


def shell_populations(P, S, t: Tables):
    nsh = t.sh_mask.shape[1]
    return segment_sum((P * S).sum(-1), t.ao_shell, nsh, t.ao_mask)


def atom_charges(q_sh, t: Tables):
    return segment_sum(q_sh, t.sh_atom, t.at_gam3.shape[1], t.sh_mask)


def coulomb_potential(q_sh, gamma, t: Tables):
    """dE_coul / dq_sh: second order and the atoms' third order."""
    q_at = atom_charges(q_sh, t)
    v_at = t.at_gam3 * q_at**2
    return (gamma @ q_sh[..., None])[..., 0] + take(v_at, t.sh_atom)


def coulomb_energy(q_sh, gamma, t: Tables):
    q_at = atom_charges(q_sh, t)
    e2 = 0.5 * fragment_sum(q_sh * (gamma @ q_sh[..., None])[..., 0])
    return e2 + fragment_sum(t.at_gam3 * q_at**3) / 3.0


def fock(H0, S, q_sh, gamma, t: Tables):
    v_ao = take(coulomb_potential(q_sh, gamma, t), t.ao_shell)
    return H0 - 0.5 * (v_ao[:, :, None] + v_ao[:, None, :]) * S


def anderson(fixed_point, x0, s: Settings):
    """x = g(x) by Anderson mixing over a window of `s.memory` steps
    (Tikhonov-regularized normal equations, damped steps where the
    extrapolation is wild or not finite). A fragment whose residual
    max |g(x) - x| is below s.scf_tol keeps its state. Returns the states
    and each fragment's last residual."""
    x = x0.clone()
    bsz, nx = x.shape
    m = s.memory
    hist_x = x.new_zeros(bsz, m, nx)
    hist_f = x.new_zeros(bsz, m, nx)
    resid = x.new_ones(bsz)
    active = torch.ones(bsz, dtype=torch.bool, device=x.device)
    beta = s.mixer_damping
    reg = 1e-12 if x.dtype == torch.float64 else 1e-4
    c_lim = 1e3 if x.dtype == torch.float64 else 2.0
    eye_m = torch.eye(m, dtype=x.dtype, device=x.device)
    slots = torch.arange(m, device=x.device)
    for it in range(s.max_iter):
        f_res = fixed_point(x) - x
        # a map that left the finite numbers stops its fragment: failed
        finite = torch.isfinite(f_res).all(-1)
        f_res = torch.where(finite[:, None], f_res, 0.0)
        it_resid = torch.where(finite, f_res.abs().amax(-1), float("inf"))
        hist_x[:, it % m] = x
        hist_f[:, it % m] = f_res
        prev = (it - 1) % m
        valid = ((slots <= it) & (slots != prev))[None, :, None]
        dX = torch.where(valid, hist_x - hist_x[:, prev:prev + 1], 0.0)
        dF = torch.where(valid, hist_f - hist_f[:, prev:prev + 1], 0.0)
        G = dF @ dF.transpose(-1, -2)
        trace = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
        G = G + (reg * trace / m + 1e-30)[:, None, None] * eye_m
        c, _ = torch.linalg.solve_ex(G, (dF @ f_res[..., None])[..., 0])
        step = (c[:, None, :] @ (dX + beta * dF))[:, 0]
        x_and = x + beta * f_res - step
        bad = ((it < 1) | ~torch.isfinite(x_and).all(-1)
               | (c.abs().amax(-1) > c_lim))
        x_next = torch.where(bad[:, None], x + beta * f_res, x_and)
        x = torch.where(active[:, None], x_next, x)
        resid = torch.where(active, it_resid, resid)
        active = active & finite & (resid > s.scf_tol)
        if not bool(active.any()):
            break
    return x, resid


def _operands(coords, t: Tables, s: Settings):
    S = overlap_matrix(coords, t.ao_atom, t.ao_lxyz, t.prim_alpha,
                       t.prim_coeff)
    cn = coordination_numbers(coords, t.at_rcov, t.atom_mask, t.glb[:, 11],
                              s.cn_type)
    return S, h0_matrix(S, coords, t, cn, s), gamma_matrix(coords, t, s)


def _d3_tables(t: Tables):
    return {"ref_cn": t.d3_ref_cn, "zidx": t.d3_zidx, "sqrtc6": t.d3_sqrtc6,
            "pair_table": t.d3_c6_pair, "r4r2": t.d3_r4r2}


def _dispersion(coords, t: Tables, s: Settings, cn_d3):
    """GFN1's D3(BJ) two-body term and, where the set has it, ATM."""
    glb = t.glb
    e = _d3.d3_energy(coords, cn_d3, _d3_tables(t), t.atom_mask,
                      glb[:, 12], glb[:, 13], glb[:, 14], glb[:, 15])
    if s.disp_s9:
        e = e + _d3.atm_energy(coords, cn_d3, _d3_tables(t), t.atom_mask,
                               glb[:, 16], glb[:, 17], glb[:, 14], glb[:, 15])
    return e


def _gfn1_solve(coords, t: Tables, s: Settings, kt):
    """GFN1's SCC: the converged shell charges and residuals."""
    S, H0, gamma = _operands(coords, t, s)
    ortho = orthogonalizer(S)

    def fixed_point(q):
        eps, C = general_eigh(fock(H0, S, q, gamma, t), ortho)
        n_sh = shell_populations(density(eps, C, t, kt), S, t)
        return (t.sh_refocc - n_sh) * t.sh_mask

    return anderson(fixed_point, torch.zeros_like(t.sh_mask), s)


def _gfn1_functional(coords, q, t: Tables, s: Settings, kt):
    """GFN1's energy at the converged charges q, stationary in them (so
    its derivative in coords with q and the occupations held is the
    gradient): the band, Coulomb and entropy terms, the D3(BJ) and ATM
    dispersion, the halogen bond term."""
    S, H0, gamma = _operands(coords, t, s)
    eps = general_eigvals(fock(H0, S, q, gamma, t), S)
    f, entropy = occupations(eps.detach(), t, kt)
    n_star = (t.sh_refocc - q) * t.sh_mask
    e_el = (fragment_sum(f * eps)
            + fragment_sum(coulomb_potential(q, gamma, t) * n_star)
            + coulomb_energy(q, gamma, t) - kt * entropy)
    cn = coordination_numbers(coords, t.at_rcov, t.atom_mask, t.glb[:, 11],
                              s.cn_type_d3)
    e_xb = halogen_bond_energy(coords, t.numbers, t.at_xbond, t.at_rcov,
                               t.atom_mask)
    return e_el + _dispersion(coords, t, s, cn) + e_xb


def energies_at(t: Tables, coords, s: Settings, grad: bool = False):
    """(total energies (B,), SCC residuals (B,)) of the batch at coords
    (B, nat, 3) in Bohr, padded atoms at the tables' own positions; with
    `grad`, (energies, gradients (B, nat, 3), residuals)."""
    real = t.atom_mask[..., None] > 0.5
    coords = torch.where(real, coords.to(t.coords.dtype), t.coords)
    kt = s.electronic_temp * KB_HARTREE
    with torch.no_grad():
        state, resid = _gfn1_solve(coords, t, s, kt)
    with torch.enable_grad() if grad else torch.no_grad():
        c = coords.detach().requires_grad_(grad)
        e = _gfn1_functional(c, state, t, s, kt)
        e = e + repulsion_energy(c, t, s)
        e = e + fragment_sum(t.at_e0 * t.atom_mask)
        if not grad:
            return e, resid
        (g,) = torch.autograd.grad(e.sum(), c)
    return e.detach(), g * real, resid
