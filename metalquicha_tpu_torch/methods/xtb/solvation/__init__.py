"""Implicit solvation models for xTB (ALPB / GBSA / CPCM).

Counterpart of metalquicha_tpu's `solvation/__init__.py`. Covers the
reference's tblite solvation plumbing
(upstream metalquicha src/methods/mqc_method_xtb.f90:449-671): model
selection by name, solvent lookup (dielectric constants), CDS and
solution-state shift terms. `make_solvation_model` raises for an unknown
model, so that a run fails loudly rather than silently skipping solvation.
"""

from __future__ import annotations

#: solvent -> dielectric constant: EXACT transcription of the reference's
#: lookup incl. aliases (mqc_method_xtb.f90:557-671)
SOLVENT_DIELECTRICS = {
    "water": 78.4, "h2o": 78.4,
    "methanol": 32.7, "ch3oh": 32.7,
    "ethanol": 24.6, "c2h5oh": 24.6,
    "1-propanol": 20.1, "propanol": 20.1,
    "2-propanol": 19.9, "isopropanol": 19.9,
    "1-butanol": 17.5, "butanol": 17.5,
    "2-butanol": 15.8,
    "1-octanol": 9.9, "octanol": 9.9,
    "acetone": 20.7,
    "acetonitrile": 37.5, "ch3cn": 37.5,
    "dmso": 46.7, "dimethylsulfoxide": 46.7,
    "dmf": 36.7, "dimethylformamide": 36.7,
    "thf": 7.6, "tetrahydrofuran": 7.6,
    "formamide": 109.5,
    "benzene": 2.3,
    "toluene": 2.4,
    "pyridine": 12.4,
    "aniline": 6.9,
    "nitrobenzene": 34.8,
    "chlorobenzene": 5.6,
    "chloroform": 4.8, "chcl3": 4.8,
    "carbon tetrachloride": 2.2, "ccl4": 2.2,
    "diethylether": 4.3, "ether": 4.3,
    "dioxane": 2.2,
    "furan": 2.9,
    "pentane": 1.8,
    "hexane": 1.9, "n-hexane": 1.9,
    "cyclohexane": 2.0,
    "heptane": 1.9, "n-heptane": 1.9,
    "octane": 1.9, "n-octane": 1.9,
    "decane": 2.0,
    "hexadecane": 2.0,
    "nitromethane": 35.9,
    "cs2": 2.6, "carbondisulfide": 2.6,
    "ethyl acetate": 6.0, "ethylacetate": 6.0,
    "acetic acid": 6.2, "aceticacid": 6.2,
    "formic acid": 51.1, "formicacid": 51.1,
    "phenol": 9.8,
    "woctanol": 8.1,
    "inf": 1.0e10,
}


def dielectric_for(solvent: str, explicit=None) -> float:
    if explicit is not None:
        return float(explicit)
    key = solvent.strip().lower()
    if key not in SOLVENT_DIELECTRICS:
        raise ValueError(f"unknown solvent: {solvent!r}")
    return SOLVENT_DIELECTRICS[key]


def make_solvation_model(xtb_config, variant: str):
    """Instantiate the requested solvation model.

    xtb_config: io.adapter.XtbConfig (solvation_model, solvent, dielectric,
    cpcm settings, use_cds, use_shift).
    """
    model = (xtb_config.solvation_model or "alpb").strip().lower()
    eps = dielectric_for(xtb_config.solvent or "water", xtb_config.dielectric)
    if model in ("alpb", "gbsa"):
        from .born import BornSolvation

        return BornSolvation(
            dielectric=eps,
            alpb=(model == "alpb"),
            variant=variant,
            solvent=(xtb_config.solvent or "water").strip().lower(),
            use_cds=xtb_config.use_cds,
            use_shift=xtb_config.use_shift,
        )
    if model == "cpcm":
        from .cpcm import CpcmSolvation

        return CpcmSolvation(
            dielectric=eps,
            nang=xtb_config.cpcm_nang,
            rscale=xtb_config.cpcm_rscale,
        )
    raise NotImplementedError(f"solvation model {model!r} not implemented")


# ---------------------------------------------------------------------------
# Fitted-parameter load. It must happen after both submodules are fully
# executed: loading from inside born.py would race the circular born<->cpcm
# import, and cpcm's own constant definitions would clobber the loaded
# values. A missing file raises (it is the physics, not an option);
# MQC_NO_OVERLAY=1 skips it, as for data/gfn1_fitted.json.
# ---------------------------------------------------------------------------
from . import born as _born  # noqa: E402
from . import cpcm as _cpcm  # noqa: E402,F401
import os as _os  # noqa: E402

_SOLV_OVERLAY = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    "data", "solv_fitted.json",
)
if not _os.environ.get("MQC_NO_OVERLAY"):
    _born.load_solvation_overlay(_SOLV_OVERLAY)
