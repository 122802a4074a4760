"""Method factory: GFN1-xTB, with or without implicit solvation.

Counterpart of metalquicha_tpu's `methods/factory.py`. It copies the
driver's method configuration into the calculator as the JAX factory does
(SCC budget clamped to [32, 256], early exit at a tenth of the user
tolerance, electronic temperature, solvation model) and keeps
`use_pallas_eigh=False`. The working dtype is float64 (the card has native
FP64) unless the driver pins "f32".
"""

from __future__ import annotations

import torch

from ..io.adapter import DriverConfig, MethodType

from .xtb.calculator import XtbCalculator
from .xtb.engine import settings_from_params


def create_calculator(drv: DriverConfig, device="cuda") -> XtbCalculator:
    mt = drv.method.method_type
    if mt == MethodType.GFN2:
        raise NotImplementedError("GFN2-xTB is not ported yet (ROADMAP A10)")
    if mt != MethodType.GFN1:
        raise NotImplementedError(
            f"method {mt.name} is not ported to torch (GFN1 only)"
        )
    settings = settings_from_params(
        "gfn1",
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

        solvation = make_solvation_model(xtb, "gfn1")
    fd = getattr(drv, "force_dtype", None)
    dtype = torch.float32 if fd == "f32" else torch.float64
    return XtbCalculator(settings=settings, dtype=dtype, device=device,
                         solvation=solvation)
