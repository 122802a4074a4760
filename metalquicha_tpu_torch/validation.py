"""What a validation case compares: the observables of a driver run and
their deviations from a reference entry.

Shared by `tools/run_validation_torch.py` (against
validation/expected.json and the frozen JAX results), `chip_smoke.py` and
the tests, so that all three compare the same quantities in the same way
as the JAX package's `validation/run_validation.py`.
"""

from __future__ import annotations

import math

#: how close the port must come to the JAX package's float64 results
#: (tests/data/port_golden_gfn*.json), by label: Ha, Ha/Bohr, Ha/Bohr^2,
#: cm^-1, Ha, Ha
GOLDEN_TOLERANCES = {
    "energy": 1e-7,
    "grad_norm": 1e-6,
    "hess_norm": 1e-5,
    "freq_max_dev_cm1": 0.5,
    "zpe": 1e-6,
    "gibbs": 1e-6,
}


def _norm(x) -> float:
    return float(math.sqrt(float((x**2).sum())))


def observables(outputs) -> dict:
    """The compared quantities of `run_calculation`'s outputs, under the
    keys of validation/expected.json."""
    if "" not in outputs:
        return {"energies": {mol: float(out.result.total_energy)
                             for mol, out in outputs.items()}}
    out = outputs[""]
    obs = {"energy": float(out.result.total_energy)}
    if out.result.gradient is not None:
        obs["gradient_norm"] = _norm(out.result.gradient)
    if out.result.hessian is not None:
        obs["hessian_frobenius_norm"] = _norm(out.result.hessian)
    if out.vibrational is not None:
        obs["frequencies"] = [float(f) for f in out.vibrational.frequencies]
    if out.thermo is not None:
        obs["zpe"] = float(out.thermo.zpe_hartree)
        obs["gibbs_correction"] = float(out.thermo.thermal_correction_gibbs)
    return obs


def checks(obs: dict, ref: dict) -> list:
    """[(label, got, expected)] for every quantity `ref` holds. `ref` is
    an entry of validation/expected.json or of the frozen JAX results
    (which say "total_energy" for "energy"). Frequencies give one row, the
    largest deviation among the significant (non near-zero) modes against
    0.0 (infinite when the two sides differ in their number)."""
    rows = []
    energy = ref.get("energy", ref.get("total_energy"))
    if energy is not None:
        rows.append(("energy", obs["energy"], energy))
    for mol, exp in ref.get("energies", {}).items():
        rows.append((f"energy[{mol}]", obs["energies"][mol], exp))
    for label, key in (("grad_norm", "gradient_norm"),
                       ("hess_norm", "hessian_frobenius_norm"),
                       ("zpe", "zpe"), ("gibbs", "gibbs_correction")):
        if key in ref:
            rows.append((label, obs[key], ref[key]))
    if "frequencies" in ref:
        sig_got = [f for f in sorted(obs["frequencies"]) if abs(f) > 1.0]
        sig_exp = [f for f in sorted(ref["frequencies"]) if abs(f) > 1.0]
        worst = math.inf
        if len(sig_got) == len(sig_exp):
            worst = max(abs(a - b) for a, b in zip(sig_got, sig_exp))
        rows.append(("freq_max_dev_cm1", worst, 0.0))
    return rows


def golden_failures(obs: dict, gold: dict) -> list:
    """The rows of `checks(obs, gold)` beyond GOLDEN_TOLERANCES, as
    (label, got, expected, delta, tolerance)."""
    bad = []
    for label, got, exp in checks(obs, gold):
        tol = GOLDEN_TOLERANCES[label.split("[")[0]]
        if not abs(got - exp) <= tol:
            bad.append((label, got, exp, abs(got - exp), tol))
    return bad
