"""Batched GFN1-xTB single-point calculator: energies and autograd gradients.

Counterpart of metalquicha_tpu's `calculator.py` on its GFN1 path, with
or without implicit solvation. A whole list of fragments is one padded batch of
tensors with a leading fragment axis; gradients are `torch.autograd.grad`
of the summed variational energies with the SCC charges detached.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...constants import KB_HARTREE

from .batch import XtbBatch, build_batch
from .dispersion_d3 import atm_energy, build_d3_tables, d3_energy, full_pair_table
from . import engine as _engine
from .engine import (
    EngineSettings,
    _atom_charges,
    coordination_numbers,
    electronic_energy,
    gamma_matrix,
    h0_matrix,
    repulsion_energy,
    scf_solve,
    settings_from_params,
)
from .overlap import overlap_matrix
from .xbond import halogen_bond_energy


class FragmentData(NamedTuple):
    """Per-fragment tensors, each with a leading fragment axis B (the JAX
    package's field names; the solvation fields are zero without a
    solvation model)."""

    numbers: torch.Tensor
    coords: torch.Tensor
    atom_mask: torch.Tensor
    nelec: torch.Tensor
    nuhf: torch.Tensor
    sh_atom: torch.Tensor
    sh_mask: torch.Tensor
    sh_l: torch.Tensor
    sh_level: torch.Tensor
    sh_kcn: torch.Tensor
    sh_poly: torch.Tensor
    sh_eta: torch.Tensor
    sh_refocc: torch.Tensor
    sh_pol: torch.Tensor
    ao_atom: torch.Tensor
    ao_shell: torch.Tensor
    ao_lxyz: torch.Tensor
    ao_mask: torch.Tensor
    prim_alpha: torch.Tensor
    prim_coeff: torch.Tensor
    at_gam3: torch.Tensor
    at_alpha: torch.Tensor
    at_zeff: torch.Tensor
    at_en: torch.Tensor
    at_rcov: torch.Tensor
    at_rad: torch.Tensor
    at_e0: torch.Tensor
    at_xbond: torch.Tensor
    at_aes: torch.Tensor
    at_kpair: torch.Tensor
    glb: torch.Tensor
    d3_ref_cn: torch.Tensor
    d3_zidx: torch.Tensor
    d3_sqrtc6: torch.Tensor
    d3_c6_pair: torch.Tensor
    d3_r4r2: torch.Tensor
    solv_rvdw: torch.Tensor
    solv_sx: torch.Tensor
    solv_tension: torch.Tensor
    solv_scalars: torch.Tensor


def _to_tensor(x, device, dtype):
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return torch.tensor(x, dtype=dtype, device=device)
    return torch.tensor(x, dtype=torch.int64, device=device)


def fragment_data_from_arrays(arrays, device, dtype=torch.float64):
    """FragmentData from a mapping of NumPy arrays (field name -> array).

    Floating arrays become `dtype`, integer arrays int64, all on `device`.
    Accepts the JAX package's state as `{k: np.asarray(v) for k, v in
    jax_frag._asdict().items()}`."""
    return FragmentData(
        **{k: _to_tensor(arrays[k], device, dtype) for k in FragmentData._fields}
    )


def fragment_data_from_batch(batch: XtbBatch, device, dtype=torch.float64,
                             solvation=None):
    """FragmentData for a GFN1 batch; `solvation` (a model of
    `solvation/`) fills the per-atom solvation tables and scalars."""
    nfrag = batch.n_fragments
    d3 = [build_d3_tables(batch.numbers[b]) for b in range(nfrag)]
    if solvation is not None:
        solv = [solvation.host_tables(batch.numbers[b]) for b in range(nfrag)]
        solv_rvdw = np.stack([t["solv_rvdw"] for t in solv])
        solv_sx = np.stack([t["solv_sx"] for t in solv])
        solv_tension = np.stack(
            [t.get("solv_tension", np.zeros_like(t["solv_rvdw"])) for t in solv]
        )
        solv_scalars = np.tile(solvation.default_scalars(), (nfrag, 1))
    else:
        solv_rvdw = np.zeros_like(batch.at_rcov)
        solv_sx = np.zeros_like(batch.at_rcov)
        solv_tension = np.zeros_like(batch.at_rcov)
        solv_scalars = np.zeros((nfrag, 4))
    arrays = {
        k: getattr(batch, k)
        for k in FragmentData._fields
        if not k.startswith(("d3_", "solv_"))
    }
    arrays.update(
        d3_ref_cn=np.stack([t["ref_cn"] for t in d3]),
        d3_zidx=np.stack([t["zidx"] for t in d3]),
        d3_sqrtc6=np.stack([t["sqrtc6"] for t in d3]),
        d3_r4r2=np.stack([t["r4r2"] for t in d3]),
        solv_rvdw=solv_rvdw,
        solv_sx=solv_sx,
        solv_tension=solv_tension,
        solv_scalars=solv_scalars,
    )
    tensors = {k: _to_tensor(v, device, dtype) for k, v in arrays.items()}
    # every fragment shares the one pair table: a broadcast view, not B
    # copies (the JAX package materializes the copies)
    table = _to_tensor(full_pair_table(), device, dtype)
    tensors["d3_c6_pair"] = table.expand(nfrag, *table.shape)
    return FragmentData(**tensors)


def _d3_tables(frag: FragmentData):
    return {
        "ref_cn": frag.d3_ref_cn,
        "zidx": frag.d3_zidx,
        "sqrtc6": frag.d3_sqrtc6,
        "pair_table": frag.d3_c6_pair,
        "r4r2": frag.d3_r4r2,
    }


def _solv_gamma(coords, frag: FragmentData, solvation):
    """The solvation model's atom-level kernel (B, nat, nat), or None."""
    if solvation is None:
        return None
    return solvation.gamma_atoms(
        coords, frag.solv_rvdw, frag.solv_sx, frag.atom_mask,
        scalars=frag.solv_scalars,
    )


def _converge_charges(coords, frag: FragmentData, kt,
                      settings: EngineSettings, solvation=None):
    """Run the SCC on detached inputs: converged shell charges q* (B, nsh)
    and residuals (B,), neither of which carries a gradient. The
    variational functional downstream carries the exact derivatives."""
    with torch.no_grad():
        c = coords.detach()
        cn = coordination_numbers(
            c, frag.at_rcov, frag.atom_mask, frag.glb[:, 11], settings.cn_type
        )
        gamma = gamma_matrix(c, frag, settings)
        gamma_at = _solv_gamma(c, frag, solvation)
        S = overlap_matrix(
            c, frag.ao_atom, frag.ao_lxyz, frag.prim_alpha, frag.prim_coeff
        )
        H0 = h0_matrix(S, c, frag, cn, settings)
        return scf_solve(H0, S, gamma, frag, kt, settings, gamma_at)


def single_point_energy(coords, frag: FragmentData, settings: EngineSettings,
                        solvation=None):
    """Total GFN1 energies (B,) of a padded batch; differentiable in coords.

    solvation: optional model (ALPB/GBSA/CPCM); its kernel enters the SCC
    detached and the variational functional differentiably, and its
    surface term (CDS + shift, ALPB/GBSA) is added to the total.

    Returns (energy, aux) with aux = {charges, shell_charges, scf_residual,
    dipole, e_el, e_rep, e_disp}, each with a leading fragment axis."""
    if settings.multipoles:
        raise NotImplementedError("GFN2 multipoles are ROADMAP A10")
    kt = settings.electronic_temp * KB_HARTREE
    q_star, resid = _converge_charges(coords, frag, kt, settings, solvation)
    gamma_at = _solv_gamma(coords, frag, solvation)

    # dispersion rides its OWN coordination number (tblite's d3 container
    # uses the classic single-exponential D3 CN)
    cn = coordination_numbers(
        coords, frag.at_rcov, frag.atom_mask, frag.glb[:, 11],
        settings.cn_type_d3,
    )
    e_el, _eps, _f, _entropy = electronic_energy(
        coords, q_star, frag, kt, settings, gamma_at
    )
    d3tab = _d3_tables(frag)
    glb = frag.glb
    e_disp = d3_energy(
        coords, cn, d3tab, frag.atom_mask,
        glb[:, 12], glb[:, 13], glb[:, 14], glb[:, 15],
    )
    if settings.disp_s9:
        # ATM triple-dipole term (static gate; s9/rs9 ride glb)
        e_disp = e_disp + atm_energy(
            coords, cn, d3tab, frag.atom_mask,
            glb[:, 16], glb[:, 17], glb[:, 14], glb[:, 15],
        )
    q_at = _atom_charges(q_star, frag)
    dipole = ((frag.atom_mask * q_at)[:, :, None] * coords).sum(1)

    light_mask = ((frag.numbers > 0) & (frag.numbers <= 2)).to(coords.dtype)
    e_rep = repulsion_energy(
        coords, frag.at_zeff, frag.at_alpha, frag.atom_mask,
        glb[:, 8], glb[:, 9],
        light_mask=light_mask, klight=settings.klight_rep,
    )
    # per-element atomic reference constants (zero geometric derivatives)
    e_atomic = (frag.at_e0 * frag.atom_mask).sum(-1)
    e_xb = halogen_bond_energy(
        coords, frag.numbers, frag.at_xbond, frag.at_rcov, frag.atom_mask
    )

    energy = e_el + e_rep + e_disp + e_atomic + e_xb
    # CDS surface + solution-state shift terms (ALPB/GBSA; the reference
    # wires them via tblite and defaults them ON)
    if solvation is not None and hasattr(solvation, "surface_energy"):
        energy = energy + solvation.surface_energy(coords, frag)
    aux = {
        "charges": q_at,
        "shell_charges": q_star,
        "scf_residual": resid,
        "dipole": dipole,
        "e_el": e_el,
        "e_rep": e_rep,
        "e_disp": e_disp,
    }
    return energy, aux


def check_device(device) -> torch.device:
    """The device to run on; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (--device cpu on the "
            "command line) to run on the CPU"
        )
    return device


class XtbCalculator:
    """High-level batched GFN1 calculator on one device (the card unless
    the caller asks for the CPU).

    Usage:
        calc = XtbCalculator(settings)              # device="cuda"
        frag = calc.make_batch(fragments)           # host-side padding
        energies, aux = calc.energies(frag)         # (B,)
        energies, grads, aux = calc.gradients(frag)
    """

    #: the one parameterization the port covers (GFN2 is ROADMAP A10)
    variant = "gfn1"

    def __init__(self, settings: EngineSettings = None, dtype=torch.float64,
                 device="cuda", solvation=None):
        self.settings = settings or settings_from_params(self.variant)
        self.dtype = dtype
        self.device = check_device(device)
        self.solvation = solvation

    def _settings_for(self, frag: FragmentData):
        """Per-batch settings: keep SP2 off batches where it is unsafe.

        SP2 builds a T=0 integer-occupation projector; it agrees with the
        production 300 K Fermi-smeared fixed point only for closed-shell
        fragments with a clear HOMO-LUMO gap. Open-shell batches (nuhf > 0)
        and d/f-block elements (near-degenerate partially filled d levels)
        above the Jacobi kernel's ceiling get the exact in-loop eigensolver
        instead. One host check per batch, in either dtype."""
        s = self.settings
        if not s.use_pallas_eigh:
            return s
        if frag.ao_mask.shape[-1] <= _engine.PALLAS_EIGH_MAX_N:
            return s  # Jacobi kernel: a true eigh, smearing intact
        nums = frag.numbers
        d_block = (
            ((nums >= 21) & (nums <= 30))
            | ((nums >= 39) & (nums <= 48))
            | ((nums >= 57) & (nums <= 80))
            | (nums >= 89)
        )
        if bool(d_block.any() | (frag.nuhf != 0).any()):
            return s._replace(use_pallas_eigh=False)
        return s

    def make_batch(self, fragments, pad_to=None) -> FragmentData:
        batch = build_batch(fragments, variant=self.variant, pad_to=pad_to)
        return fragment_data_from_batch(batch, self.device, self.dtype,
                                        solvation=self.solvation)

    def energies(self, frag: FragmentData):
        with torch.no_grad():
            return single_point_energy(frag.coords, frag,
                                       self._settings_for(frag),
                                       self.solvation)

    def gradients(self, frag: FragmentData):
        coords = frag.coords.detach().requires_grad_(True)
        e, aux = single_point_energy(coords, frag, self._settings_for(frag),
                                     self.solvation)
        (g,) = torch.autograd.grad(e.sum(), coords)
        aux = {k: v.detach() for k, v in aux.items()}
        return e.detach(), g, aux
