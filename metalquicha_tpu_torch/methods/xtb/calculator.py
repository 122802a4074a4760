"""Batched xTB single-point calculator (GFN1 and GFN2): energies and
autograd gradients.

Counterpart of metalquicha_tpu's `calculator.py`, with or without implicit
solvation. A whole list of fragments is one padded batch of tensors with a
leading fragment axis; gradients are `torch.autograd.grad` of the summed
variational energies with the SCC state detached.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...constants import KB_HARTREE
from ...ops.fragment_reduce import fragment_sum

from . import scc_graph
from .batch import PAD_LEVEL, XtbBatch, build_batch
from .dispersion_d3 import atm_energy, build_d3_tables, d3_energy, full_pair_table
from . import engine as _engine
from .engine import (
    EngineSettings,
    _aes_unpack,
    _atom_charges,
    coordination_numbers,
    electronic_energy,
    electronic_energy_multipole,
    gamma_matrix,
    h0_matrix,
    repulsion_energy,
    scf_refine,
    scf_refine_multipole,
    scf_solve,
    scf_solve_multipole,
    settings_from_params,
)
from .multipole import moment_matrices
from .overlap import overlap_matrix
from .solvation import born as _born
from .solvation import cpcm as _cpcm
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
                             solvation=None, variant="gfn1"):
    """FragmentData for a batch; `solvation` (a model of `solvation/`)
    fills the per-atom solvation tables and scalars.

    GFN2 keeps the pristine dispersion state (diagonal C6, r4r2 and the
    geometric-mean pair table): the fitted values are GFN1 state."""
    nfrag = batch.n_fragments
    fitted = variant != "gfn2"
    d3 = [build_d3_tables(batch.numbers[b], fitted=fitted)
          for b in range(nfrag)]
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
    table = _to_tensor(full_pair_table(fitted=fitted), device, dtype)
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


def _mp_tables(frag: FragmentData, cn):
    """Static AES/D4 inputs for the GFN2 multipole SCC."""
    return {"at_aes": frag.at_aes, "d4": True, "cn": cn,
            "d3tab": _d3_tables(frag)}


def _scc_operands(coords, frag: FragmentData, settings: EngineSettings):
    """What the SCC map is built from at `coords`: (S, H0, gamma, mp), with
    mp None for GFN1 and the AES/D4 tables (own D3 coordination number,
    moment integrals) for GFN2."""
    cn = coordination_numbers(
        coords, frag.at_rcov, frag.atom_mask, frag.glb[:, 11], settings.cn_type
    )
    gamma = gamma_matrix(coords, frag, settings)
    S = overlap_matrix(
        coords, frag.ao_atom, frag.ao_lxyz, frag.prim_alpha, frag.prim_coeff
    )
    H0 = h0_matrix(S, coords, frag, cn, settings)
    mp = None
    if settings.multipoles:
        _S_mm, D, Q = moment_matrices(
            coords, frag.ao_atom, frag.ao_lxyz, frag.prim_alpha,
            frag.prim_coeff,
        )
        cn_d3 = coordination_numbers(
            coords, frag.at_rcov, frag.atom_mask, frag.glb[:, 11],
            settings.cn_type_d3,
        )
        mp = _mp_tables(frag, cn_d3)
        mp["D"], mp["Q"] = D, Q
    return S, H0, gamma, mp


def _converge_charges(coords, frag: FragmentData, kt,
                      settings: EngineSettings, solvation=None, q0=None):
    """Run the SCC on detached inputs: the converged state (GFN1: shell
    charges q* (B, nsh); GFN2: the packed AES state z* (B, nsh + 9 nat))
    and residuals (B,), neither of which carries a gradient. The
    variational functional downstream carries the exact derivatives.

    q0: optional warm start of the same layout."""
    with torch.no_grad():
        c = coords.detach()
        if q0 is not None:
            q0 = q0.detach()
        S, H0, gamma, mp = _scc_operands(c, frag, settings)
        gamma_at = _solv_gamma(c, frag, solvation)
        if settings.multipoles:
            return scf_solve_multipole(
                H0, S, c, gamma, frag, kt, settings, gamma_at, mp, z0=q0
            )
        return scf_solve(H0, S, gamma, frag, kt, settings, gamma_at, q0=q0)


def _refiner(coords, frag, kt, settings, gamma_at):
    """refine(q, n_iter): n_iter differentiable damped SCC steps from q,
    on operands built once at `coords` (so their derivatives flow)."""
    S, H0, gamma, mp = _scc_operands(coords, frag, settings)

    def refine(q, n_iter):
        if settings.multipoles:
            return scf_refine_multipole(
                H0, S, coords, gamma, frag, kt, settings, gamma_at, mp, q,
                n_iter,
            )
        return scf_refine(H0, S, gamma, frag, kt, settings, q, n_iter,
                          gamma_at)

    return refine


def single_point_energy(coords, frag: FragmentData, settings: EngineSettings,
                        solvation=None, diff_scf_iters: int = 0,
                        q_init=None):
    """Total energies (B,) of a padded batch; differentiable in coords.

    solvation: optional model (ALPB/GBSA/CPCM); its kernel enters the SCC
    detached and the variational functional differentiably, and its
    surface term (CDS + shift, ALPB/GBSA) is added to the total.

    diff_scf_iters > 0 re-refines the converged state with that many
    damped fixed-point iterations that autograd records, making the state
    itself differentiable (first derivatives are already exact through the
    variational functional).

    q_init: warm-start the (non-differentiated) SCC solve from the
    supplied state (GFN1: shell charges; GFN2: the packed AES state, i.e.
    an earlier aux["shell_charges"]), then refine with
    max(diff_scf_iters, 2) recorded steps; the reported scf_residual is
    then the post-refine fixed-point residual. The entry for sequential
    geometries (finite-difference sweeps, dynamics).

    Returns (energy, aux) with aux = {charges, shell_charges, scf_residual,
    dipole, e_el, e_rep, e_disp}, each with a leading fragment axis."""
    kt = settings.electronic_temp * KB_HARTREE
    q_star, resid = _converge_charges(coords, frag, kt, settings, solvation,
                                      q0=q_init)
    gamma_at = _solv_gamma(coords, frag, solvation)
    if q_init is not None:
        # the warm-started solve has reached this calculator's tolerance;
        # the last refine step alone gives the residual that is reported
        refine = _refiner(coords, frag, kt, settings, gamma_at)
        q_prev = refine(q_star, max(diff_scf_iters, 2) - 1)
        q_star = refine(q_prev, 1)
        resid = (q_star - q_prev).abs().amax(-1)
    elif diff_scf_iters:
        q_star = _refiner(coords, frag, kt, settings, gamma_at)(
            q_star, diff_scf_iters)
    energy, aux = _functional(coords, frag, q_star, kt, settings, solvation,
                              gamma_at)
    return energy, _aux(aux, q_star, resid)


def _aux(aux: dict, q_star, resid) -> dict:
    """The functional's aux with the converged state and residual, in the
    JAX package's order."""
    # GFN2's shell_charges: the packed AES state, the hand-off point for a
    # warm start
    return {"charges": aux["charges"], "shell_charges": q_star,
            "scf_residual": resid, "dipole": aux["dipole"],
            "e_el": aux["e_el"], "e_rep": aux["e_rep"],
            "e_disp": aux["e_disp"]}


def _functional(coords, frag: FragmentData, q_star, kt,
                settings: EngineSettings, solvation, gamma_at):
    """Everything after the SCC: the total energies (B,) at the converged
    state q_star, differentiable in coords, and their parts (charges,
    dipole, e_el, e_rep, e_disp)."""
    # dispersion rides its OWN coordination number (tblite's d3 container
    # uses the classic single-exponential D3 CN)
    cn = coordination_numbers(
        coords, frag.at_rcov, frag.atom_mask, frag.glb[:, 11],
        settings.cn_type_d3,
    )
    d3tab = _d3_tables(frag)
    glb = frag.glb
    if settings.multipoles:
        # GFN2: AES + charge-scaled dispersion live INSIDE the interaction
        # functional (self-consistent); no separate two-body e_disp
        e_el, _eps, _f, _entropy = electronic_energy_multipole(
            coords, q_star, frag, kt, settings, gamma_at, _mp_tables(frag, cn)
        )
        q_sh, mu_at, _th_at = _aes_unpack(
            q_star, frag.sh_mask.shape[1], frag.atom_mask.shape[1]
        )
        q_at = _atom_charges(q_sh, frag)
        # dipole = sum q R + sum mu (atomic dipoles added)
        dipole = fragment_sum(
            (frag.atom_mask * q_at)[:, :, None] * coords, 1
        ) + fragment_sum(mu_at * frag.atom_mask[:, :, None], 1)
        e_disp = torch.zeros_like(e_el)
        if settings.disp_s9:
            # ATM term: charge-INdependent (D4 keeps the three-body term
            # unscaled), so it sits outside the SCC
            e_disp = atm_energy(
                coords, cn, d3tab, frag.atom_mask,
                glb[:, 16], glb[:, 17], glb[:, 14], glb[:, 15],
            )
    else:
        e_el, _eps, _f, _entropy = electronic_energy(
            coords, q_star, frag, kt, settings, gamma_at
        )
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
        dipole = fragment_sum((frag.atom_mask * q_at)[:, :, None] * coords, 1)

    light_mask = ((frag.numbers > 0) & (frag.numbers <= 2)).to(coords.dtype)
    e_rep = repulsion_energy(
        coords, frag.at_zeff, frag.at_alpha, frag.atom_mask,
        glb[:, 8], glb[:, 9],
        light_mask=light_mask, klight=settings.klight_rep,
    )
    # per-element atomic reference constants (zero geometric derivatives)
    e_atomic = fragment_sum(frag.at_e0 * frag.atom_mask)

    energy = e_el + e_rep + e_disp + e_atomic
    if not settings.multipoles:
        # halogen-bond correction: GFN1 only (tblite's GFN2 calculator has
        # no halogen container)
        energy = energy + halogen_bond_energy(
            coords, frag.numbers, frag.at_xbond, frag.at_rcov, frag.atom_mask
        )
    # CDS surface + solution-state shift terms (ALPB/GBSA; the reference
    # wires them via tblite and defaults them ON)
    if solvation is not None and hasattr(solvation, "surface_energy"):
        energy = energy + solvation.surface_energy(coords, frag)
    aux = {"charges": q_at, "dipole": dipole, "e_el": e_el, "e_rep": e_rep,
           "e_disp": e_disp}
    return energy, aux


def _solvation_key(solvation):
    """What of a solvation model a stage bakes into its launches: its
    class and fields, and the module constants its kernels read where a
    batch carries no `solv_scalars` (the fitted overlay resets them at run
    time, `solvation/born.py:load_solvation_overlay`)."""
    if solvation is None:
        return None
    return (type(solvation).__name__, tuple(sorted(vars(solvation).items())),
            _cpcm.COSMO_X, _cpcm.SELF_INTERACTION, _born.RHO_OFFSET,
            _born.ALPB_ALPHA)


def _operand_stage(inp, settings: EngineSettings, solvation):
    """The operand build of a call (not differentiated): S, H0, gamma, the
    solvation kernel, GFN2's moment tables and the SCC's orthogonalizer,
    from the stage's inputs (coords and the batch's fields)."""
    c = inp["coords"]
    frag = FragmentData(coords=c, **inp["frag"])
    S, H0, gamma, mp = _scc_operands(c, frag, settings)
    out = {"S": S, "H0": H0, "gamma": gamma,
           "gamma_at": _solv_gamma(c, frag, solvation)}
    out["Xs"], out["ortho_shift"] = _engine.scc_orthogonalizer(S, settings)
    if mp is not None:
        out.update(cn_d3=mp["cn"], D=mp["D"], Q=mp["Q"])
    return out


def _functional_stage(inp, kt, settings: EngineSettings, solvation,
                      grad: bool):
    """The functional of a call at the converged state: the energies and
    their parts and, with `grad`, the gradient (autograd in the stage)."""
    c = inp["coords"]
    if grad:
        c = c.detach().requires_grad_(True)
    frag = FragmentData(coords=c, **inp["frag"])
    gamma_at = _solv_gamma(c, frag, solvation)
    energy, aux = _functional(c, frag, inp["q_star"], kt, settings,
                              solvation, gamma_at)
    out = {"energy": energy.detach()}
    if grad:
        (g,) = torch.autograd.grad(energy.sum(), c)
        out["gradient"] = g
    out.update({k: v.detach() for k, v in aux.items()})
    return out


def evaluate(frag: FragmentData, settings: EngineSettings, solvation=None,
             grad: bool = False, graph: bool = True):
    """(energies (B,), gradients (B, nat, 3) or None, aux) of a padded
    batch: what `XtbCalculator.energies` and `.gradients` return.

    The counterpart of the JAX calculator's compiled programs
    (metalquicha_tpu/methods/xtb/calculator.py:483-505): on a card the
    call is three replayed device programs (`scc_graph.Call`), each kept
    across calls of the same key and shapes: the operand build, the SCC
    loop and the functional (with the gradient's backward pass). A call
    reads the device at the loop's done-checks (and SP2's closed-shell
    flag) and once at its end, for every solver's status. graph=False runs
    each stage launch by launch, with the same kernels and bits, for a
    caller that compares; off a card the stages always do."""
    kt = settings.electronic_temp * KB_HARTREE
    fields = {k: v for k, v in frag._asdict().items() if k != "coords"}
    coords = frag.coords.detach()
    base = (settings, float(kt), _solvation_key(solvation), PAD_LEVEL)
    with scc_graph.Call(frag.coords.device, graph) as call:
        with torch.no_grad():
            ops = call.stage(
                ("operands",) + base, {"coords": coords, "frag": fields},
                lambda inp: _operand_stage(inp, settings, solvation))
            ortho = (ops["Xs"], ops["ortho_shift"])
            if settings.multipoles:
                mp = _mp_tables(frag, ops["cn_d3"])
                mp["D"], mp["Q"] = ops["D"], ops["Q"]
                q_star, resid = scf_solve_multipole(
                    ops["H0"], ops["S"], coords, ops["gamma"], frag, kt,
                    settings, ops["gamma_at"], mp, graph=graph, ortho=ortho)
            else:
                q_star, resid = scf_solve(
                    ops["H0"], ops["S"], ops["gamma"], frag, kt, settings,
                    ops["gamma_at"], graph=graph, ortho=ortho)
        del ops, ortho
        inputs = {"coords": coords, "q_star": q_star, "frag": fields}
        # grad mode is per thread: set here, whatever the caller's
        with torch.enable_grad() if grad else torch.no_grad():
            out = call.stage(
                ("functional", grad) + base, inputs,
                lambda inp: _functional_stage(inp, kt, settings, solvation,
                                              grad))
        call.finish()
    return out["energy"], out.get("gradient"), _aux(out, q_star, resid)


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
    """High-level batched GFN1/GFN2 calculator on one device (the card
    unless the caller asks for the CPU; `on(device)` gives the same
    calculator on another).

    Usage:
        calc = XtbCalculator(settings, variant="gfn2")   # device="cuda"
        frag = calc.make_batch(fragments)           # host-side padding
        energies, aux = calc.energies(frag)         # (B,)
        energies, grads, aux = calc.gradients(frag)
    """

    def __init__(self, settings: EngineSettings = None,
                 variant: str = "gfn1", dtype=torch.float64, device="cuda",
                 solvation=None):
        # derived from the variant's GLOBALS when not given (form flags
        # such as eta_average and multipoles live there)
        self.settings = settings or settings_from_params(variant)
        self.variant = variant
        self.dtype = dtype
        self.device = check_device(device)
        self.solvation = solvation

    def on(self, device) -> "XtbCalculator":
        """This calculator bound to `device`: itself if that is its own
        device, else a copy that shares settings and solvation model (a
        mesh of several devices evaluates each piece of a batch with the
        copy for its device)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return XtbCalculator(self.settings, self.variant, self.dtype, device,
                             self.solvation)

    def _settings_for(self, frag: FragmentData):
        """Per-batch settings: keep SP2 off batches where it is unsafe.

        SP2 builds a T=0 integer-occupation projector; it agrees with the
        production 300 K Fermi-smeared fixed point only for closed-shell
        fragments with a clear HOMO-LUMO gap. Open-shell batches (nuhf > 0)
        and d/f-block elements (near-degenerate partially filled d levels)
        above the Jacobi kernel's ceiling get the exact in-loop eigensolver
        instead. One host check per float32 batch: a float64 SCC takes the
        exact route anyway (`engine.scf_solve`), as the JAX package's."""
        s = self.settings
        if not (s.use_pallas_eigh and self.dtype == torch.float32):
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
                                        solvation=self.solvation,
                                        variant=self.variant)

    def energies(self, frag: FragmentData, graph: bool = True):
        """(energies (B,), aux). On a card the call runs as replayed
        device programs (`evaluate`); graph=False runs it launch by launch,
        only to compare the two."""
        e, _g, aux = evaluate(frag, self._settings_for(frag), self.solvation,
                              grad=False, graph=graph)
        return e, aux

    def gradients(self, frag: FragmentData, graph: bool = True):
        """(energies (B,), gradients (B, nat, 3), aux), as `energies`."""
        return evaluate(frag, self._settings_for(frag), self.solvation,
                        grad=True, graph=graph)
