"""Method factory: GFN1/GFN2-xTB with or without implicit solvation, and
the placeholder HF/DFT/MCSCF methods.

Counterpart of metalquicha_tpu's `methods/factory.py`. It copies the
driver's method configuration into the calculator as the JAX factory does
(SCC budget clamped to [32, 256], early exit at a tenth of the user
tolerance, electronic temperature, solvation model) and keeps
`use_pallas_eigh=False`.

The working dtype is EXPLICIT: float64 on every device unless the driver
pins it (`force_dtype`, the CLI's --f32). This is the one deliberate
difference from the JAX factory, which runs f32 on any backend but the
CPU because its TPU has no f64 solve and leaves accuracy to the f64 polish
(methods/xtb/polish.py). A CUDA card has FP64, and the SCC is bound by
kernel launches, not by FP64 arithmetic, so f32 + polish buys nothing
there (PERF.md has the measurement); an f32 calculator still gets the
polisher from the driver, so either dtype lands on the f64 result.
"""

from __future__ import annotations

import torch

from ..io.adapter import DriverConfig, MethodType
from .stubs import DFTMethod, HFMethod, MCSCFMethod
from .xtb.calculator import XtbCalculator
from .xtb.engine import settings_from_params


def create_calculator(drv: DriverConfig, device="cuda"):
    mt = drv.method.method_type
    if mt in (MethodType.GFN1, MethodType.GFN2):
        variant = "gfn1" if mt == MethodType.GFN1 else "gfn2"
        settings = settings_from_params(
            variant,
            max_scf_iter=max(32, min(drv.method.scf.maxiter, 256)),
            # early-exit at a tenth of the user tolerance: well inside the
            # driver's convergence gate (10x tol)
            scf_tol=0.1 * drv.method.scf.tolerance,
            electronic_temp=drv.method.xtb.electronic_temp,
        )
        xtb = drv.method.xtb
        solvation = None
        if xtb.has_solvation():
            from .xtb.solvation import make_solvation_model

            solvation = make_solvation_model(xtb, variant)
        fd = getattr(drv, "force_dtype", None)
        dtype = torch.float32 if fd == "f32" else torch.float64
        return XtbCalculator(settings=settings, variant=variant, dtype=dtype,
                             device=device, solvation=solvation)
    # the placeholders compute on the host and take no device
    if mt == MethodType.HF:
        return HFMethod()
    if mt == MethodType.DFT:
        return DFTMethod()
    if mt == MethodType.MCSCF:
        return MCSCFMethod()
    raise NotImplementedError(f"method {mt.name} is not implemented")
