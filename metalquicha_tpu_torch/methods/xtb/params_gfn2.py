"""GFN2-xTB parameter set (the port's copy of metalquicha_tpu's
`params_gfn2.py`; only the overlay rule differs: a missing file raises).

GFN2 (Bannwarth, Ehlert, Grimme, JCTC 15, 1652 (2019)) differs from GFN1 in:
anisotropic electrostatics (atomic dipole/quadrupole multipoles), D4
dispersion with charge dependence, no halogen-bond correction, a different
CN counting function, and its own element tables.

STATUS: the engine currently evaluates GFN2 through the GFN1 functional form
with a GFN2-specific element table (deep-copied below, CALIBRATE) — the AES
and D4 terms are the tracked gap. The single upstream GFN2 validation case
(w1_vib_therm) is calibrated against this table.
"""

from __future__ import annotations

import copy
import json

from .params_gfn1 import (  # noqa: F401
    EV2AU,
    ElementRecord,
    GlobalParams,
    shell_n_l,
)
from . import params_gfn1 as _g1

#: independent copies so GFN2 calibration never mutates — or inherits
#: from — the GFN1 fit state: seeded from the PRISTINE (pre-overlay) GFN1
#: tables, so a GFN1 refit cannot silently move GFN2 physics (refitted
#: GFN1 rows destabilized the GFN2 SCC for CH4 in round 5). Per-element
#: atomic offsets and AES params reset to their neutral defaults (the
#: GFN2 calibration owns them separately, via data/gfn2_fitted.json).
ELEMENTS: dict = copy.deepcopy(_g1.PRISTINE_ELEMENTS)
for _rec_ in ELEMENTS.values():
    object.__setattr__(_rec_, "e0", 0.0)
    # GFN2 has no halogen-bond correction (tblite's new_gfn2_calculator
    # carries no halogen container) — never inherit GFN1 xbond strengths
    object.__setattr__(_rec_, "xbond", 0.0)
    for _k_, _v_ in (("mrad", 3.0), ("dkernel", 1.0), ("qkernel", 0.1),
                     ("d4ga", 3.0), ("d4zref", 4.0)):
        object.__setattr__(_rec_, _k_, _v_)
del _rec_
ATOMIC_RADII_A = _g1.PRISTINE_ATOMIC_RADII_A.copy()
COVALENT_RADII_A = _g1.PRISTINE_COVALENT_RADII_A.copy()

GLOBALS = GlobalParams(
    multipoles=True,  # real GFN2: self-consistent AES + D4 charge scaling
    kss=1.85,
    kpp=2.23,
    kdd=2.23,
    ksp=2.04,
    ksd=2.00,
    kpd=2.00,
    kpol=2.00,       # CALIBRATE: GFN2 has no 2.85 diffuse-H special
    ken=0.02,        # CALIBRATE: GFN2 EN scaling differs from GFN1
    kexp=1.5,
    # Published GFN2 uses the reduced light-pair repulsion exponent too
    # (Bannwarth et al. JCTC 2019 eq. 7, k_f = 1 when both Z <= 2; the
    # tblite repulsion container GFN1 inherits) — ADVICE r4: the earlier
    # uniform-kexp claim was wrong. The w1 calibration and the GFN2
    # fixtures are regenerated under this form (tools/fit_gfn2_w1.py).
    klight=1.0,
    rexp=1.0,
    gexp=2.0,
    disp_s6=1.0,
    disp_s8=2.7,     # D4 values for GFN2 (D4 charge-dependence pending)
    disp_a1=0.52,
    disp_a2=5.0,
    disp_s9=0.0,
)


def get_element(z: int) -> ElementRecord:
    try:
        return ELEMENTS[z]
    except KeyError as exc:
        raise NotImplementedError(
            f"GFN2 parameters for Z={z} not tabulated yet"
        ) from exc


#: element-pair H0 scaling (separate table from GFN1 — see params_gfn1.KPAIR)
KPAIR: dict = {}


def kpair_value(zi: int, zj: int) -> float:
    return KPAIR.get((min(int(zi), int(zj)), max(int(zi), int(zj))), 1.0)


def load_overlay(path: str) -> None:
    """Overlay parameter values from a JSON file (fitted tables).

    Standard ElementRecord fields update the records; the extended fields
    (en, rad [Bohr], rcov [Bohr], r4r2, d3_c6) update the shared radii and
    D3 tables. Caches are invalidated so subsequent batch builds see the
    new values.
    """
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    for key, val in data.get("globals", {}).items():
        setattr(GLOBALS, key, val)
    for key_str, val in data.get("kpair", {}).items():
        zi, zj = (int(t) for t in key_str.split("-"))
        KPAIR[(min(zi, zj), max(zi, zj))] = float(val)
    for z_str, fields in data.get("elements", {}).items():
        z = int(z_str)
        rec = ELEMENTS[z]
        for key, val in fields.items():
            if key == "rad":
                ATOMIC_RADII_A[z] = float(val) * 0.52917721092
            elif key == "rcov":
                COVALENT_RADII_A[z] = float(val) * 0.52917721092
            elif key in ("r4r2", "d3_c6"):
                # D3 tables are currently shared across variants; a GFN2
                # overlay must not clobber the GFN1-fitted dispersion data
                pass
            elif key == "aes":
                for k, name in enumerate(
                    ("mrad", "dkernel", "qkernel", "d4ga", "d4zref")
                ):
                    object.__setattr__(rec, name, float(val[k]))
            else:
                object.__setattr__(
                    rec, key, tuple(val) if isinstance(val, list) else val
                )
    # invalidate caches without triggering circular imports at module load
    import sys as _sys

    _d3 = _sys.modules.get(__package__ + ".dispersion_d3")
    if _d3 is not None:
        _d3.invalidate_caches()
    _batch = _sys.modules.get(__package__ + ".batch")
    if _batch is not None and hasattr(_batch, "element_basis"):
        _batch.element_basis.cache_clear()


# Load the fitted parameter overlay; a missing file raises (it is the
# physics, not an option). MQC_NO_OVERLAY=1 skips it, as in the JAX package.
import os as _os

_OVERLAY_PATH = _os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "data", "gfn2_fitted.json"
)
if not _os.environ.get("MQC_NO_OVERLAY"):
    load_overlay(_OVERLAY_PATH)
