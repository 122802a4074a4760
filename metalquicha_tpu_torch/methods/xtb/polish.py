"""f64 polish of f32 fragment results (mixed precision).

Counterpart of metalquicha_tpu's `methods/xtb/polish.py`. An f32 SCC
leaves raw energies about 1e-4 Ha off the f64 path. The energy functional
is VARIATIONAL in the SCC state, so an O(eps) f32 state error costs only
O(eps^2) energy error when the functional is re-evaluated in f64 at the
refined state. Gradients are only FIRST order in the remaining residual
(stationarity holds exactly at q*, not near it), and FD Hessians divide
that error by the displacement step, so the polish warm-starts the full
f64 Anderson solve from the f32 state (`single_point_energy`'s q_init
entry) and runs it to POLISH_SCF_TOL, putting polished gradients at the
all-f64 path's own residual scale. That makes FD Hessians and frequencies
f64-accurate too, since the driver assembles them from these gradients.

Where the f64 leg runs. In the JAX package it runs on the host CPU,
because the TPU it was written for has no f64 solve. A CUDA card has
FP64, so here the f64 leg runs on the device the f32 leg ran on: `polish`
evaluates on the device of the state it is handed, `rescue` on the device
calculator's own. Neither ever moves work to the CPU on its own; with
`device="cpu"` both legs are on the CPU. The names (`HostPolisher`,
`host_polish_available`, the driver's `host_polish` knob) are the JAX
package's and are kept so that inputs and callers carry over.
"""

from __future__ import annotations

import numpy as np
import torch

from .calculator import XtbCalculator, single_point_energy

#: differentiable refine-tail steps AFTER the warm-started f64 Anderson
#: solve (single_point_energy re-solves to calc64's scf_tol from the f32
#: state, so the tail only reports the true post-solve residual; 2 is the
#: minimum the q_init path uses).
POLISH_ITERS = 2

#: early-exit tolerance for the polisher's warm-started f64 solve. FD
#: Hessians difference polished gradients, whose error is FIRST order in
#: the charge residual (stationarity holds only exactly at q*), divided by
#: the 0.005 Bohr step: a 1e-7 residual shows up as ~0.1 cm^-1 frequency
#: noise. 1e-11 puts the polish at the all-f64 path's own residual scale;
#: the warm start makes the extra Anderson iterations cheap.
POLISH_SCF_TOL = 1e-11


def host_polish_available() -> bool:
    """True: the f64 leg needs nothing beside the device the f32 leg runs
    on (a CUDA card and the CPU both compute in float64)."""
    return True


class HostPolisher:
    """Re-evaluates fragment observables in f64.

    Built from the device calculator so variant/settings/solvation stay
    identical; only the dtype and the in-loop solver differ (the polish
    does exact f64 eighs).
    """

    def __init__(self, device_calc: XtbCalculator, k: int = POLISH_ITERS):
        self.k = int(k)
        settings = device_calc.settings
        if settings.use_pallas_eigh:
            settings = settings._replace(use_pallas_eigh=False)
        # tighten the early exit: the device calculator's tol is scaled for
        # f32; the polish's warm-started f64 solve must go to ~machine
        # residual (see POLISH_SCF_TOL). scf_tol == 0.0 (fixed-iteration
        # semantics, runs the full budget) is already at least as tight.
        if settings.scf_tol and settings.scf_tol > POLISH_SCF_TOL:
            settings = settings._replace(scf_tol=POLISH_SCF_TOL)
        self.calc64 = XtbCalculator(
            settings=settings,
            variant=device_calc.variant,
            dtype=torch.float64,
            device=device_calc.device,
            solvation=device_calc.solvation,
        )

    def supports(self) -> bool:
        # GFN1 refines the shell-charge vector; GFN2 refines the packed
        # AES state (engine.scf_refine_multipole): both wired
        return True

    def rescue(self, tuples, pad_to, what: str):
        """FULL f64 SCC for fragments whose f32 SCC failed.

        The polish warm-starts its f64 solve from the f32 state; a
        diverged f32 SCC (slow-contracting fragments: GMBE coincident-cap
        intersections, highly charged clusters can oscillate in f32) hands
        it a garbage warm start that may burn the whole bounded budget and
        still miss tolerance. Those fragments are re-solved from scratch
        (zeros start) in f64 with the full iteration budget, exactly like
        the all-f64 path. Returns NumPy (energies, gradients or None, aux).
        """
        frag = self.calc64.make_batch(tuples, pad_to=pad_to)
        if what == "gradient":
            e, g, aux = self.calc64.gradients(frag)
            g = g.cpu().numpy()
        else:
            e, aux = self.calc64.energies(frag)
            g = None
        aux = {k: v.cpu().numpy() for k, v in aux.items()}
        return e.cpu().numpy(), g, aux

    def polish(self, tuples, pad_to, shell_charges, what: str):
        """Polished (energies, gradients or None, aux) for one padded batch.

        tuples/pad_to are the executor's host-side batch description;
        shell_charges is the f32 leg's aux['shell_charges'] (GFN2: the
        packed AES state), same padding as the batch. The f64 leg runs on
        the device that tensor lies on; a NumPy array goes to the device
        calculator's.
        """
        calc = self.calc64
        if isinstance(shell_charges, torch.Tensor):
            calc = calc.on(shell_charges.device)
        else:
            shell_charges = torch.from_numpy(np.asarray(shell_charges))
        q0 = shell_charges.to(device=calc.device, dtype=torch.float64)
        frag = calc.make_batch(tuples, pad_to=pad_to)
        settings = calc.settings
        if what != "gradient":
            with torch.no_grad():
                e, aux = single_point_energy(
                    frag.coords, frag, settings, calc.solvation,
                    diff_scf_iters=self.k, q_init=q0,
                )
            return e, None, aux
        with torch.enable_grad():  # per thread, as in `gradients`
            coords = frag.coords.detach().requires_grad_(True)
            e, aux = single_point_energy(
                coords, frag, settings, calc.solvation,
                diff_scf_iters=self.k, q_init=q0,
            )
            (g,) = torch.autograd.grad(e.sum(), coords)
        return e.detach(), g, {k: v.detach() for k, v in aux.items()}
