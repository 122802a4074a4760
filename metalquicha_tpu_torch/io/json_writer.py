"""Structured JSON output.

Schema parity with upstream metalquicha src/io/mqc_json_writer.f90:20-523 — the
same key names and nesting for unfragmented, MBE-breakdown, GMBE-PIE and
vibrational/thermochemistry outputs, so downstream consumers (including the
validation runner) read either implementation's output interchangeably.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

import numpy as np

from ..constants import AU_TO_DEBYE, CAL_TO_J, HARTREE_TO_CALMOL


def output_filename_for(input_path: str, suffix: str = "") -> str:
    """`input.mqc` -> `output_<base>[_<suffix>].json` in the CWD."""
    base = os.path.splitext(os.path.basename(input_path))[0]
    if suffix:
        return f"output_{base}_{suffix}.json"
    return f"output_{base}.json"


def _dipole_obj(dipole) -> dict:
    d = np.asarray(dipole, dtype=float)
    return {
        "x": float(d[0]),
        "y": float(d[1]),
        "z": float(d[2]),
        "magnitude_debye": float(np.linalg.norm(d) * AU_TO_DEBYE),
    }


def _add_common(obj: dict, result) -> None:
    obj["total_energy"] = float(result.total_energy)
    if result.dipole is not None:
        obj["dipole"] = _dipole_obj(result.dipole)
    if result.gradient is not None:
        obj["gradient_norm"] = float(
            math.sqrt(float((np.asarray(result.gradient) ** 2).sum()))
        )
    if result.hessian is not None:
        obj["hessian_frobenius_norm"] = float(
            math.sqrt(float((np.asarray(result.hessian) ** 2).sum()))
        )


def _mbe_levels(result, polymers, max_level: int) -> list:
    levels = []
    sizes = np.array([int((row >= 0).sum()) for row in polymers])
    for lvl in range(1, max_level + 1):
        sel = np.nonzero(sizes == lvl)[0]
        if sel.size == 0:
            continue
        name = {1: "monomers", 2: "dimers", 3: "trimers"}.get(lvl, f"{lvl}-mers")
        level_obj = {"frag_level": lvl, "name": name, "count": int(sel.size)}
        if result.sum_by_level is not None and lvl <= len(result.sum_by_level):
            level_obj["total_energy"] = float(result.sum_by_level[lvl - 1])
        frags = []
        for i in sel:
            row = polymers[i]
            frag_obj = {"indices": [int(x) for x in row[row >= 0]]}
            if result.fragment_energies is not None:
                frag_obj["energy"] = float(result.fragment_energies[i])
            if result.fragment_distances is not None:
                frag_obj["distance"] = float(result.fragment_distances[i])
            if result.delta_energies is not None:
                frag_obj["delta_energy"] = float(result.delta_energies[i])
            frags.append(frag_obj)
        level_obj["fragments"] = frags
        levels.append(level_obj)
    return levels


def _pie_obj(result, pie_atom_sets) -> dict:
    terms = []
    coeffs = np.asarray(result.pie_coefficients)
    for i, coeff in enumerate(coeffs):
        if coeff == 0:
            continue
        atoms = pie_atom_sets[i]
        atoms = [int(a) for a in np.asarray(atoms) if a >= 0]
        energy = float(result.pie_energies[i])
        terms.append(
            {
                "atom_indices": atoms,
                "coefficient": int(coeff),
                "energy": energy,
                "weighted_energy": float(coeff) * energy,
            }
        )
    return {"count": len(terms), "terms": terms}


def _vibrational_obj(vib) -> dict:
    obj = {
        "n_modes": int(len(vib.frequencies)),
        "frequencies_cm1": [float(f) for f in vib.frequencies],
        "reduced_masses_amu": [float(m) for m in vib.reduced_masses],
        "force_constants_mdyne_ang": [float(k) for k in vib.force_constants],
    }
    if vib.ir_intensities is not None:
        obj["ir_intensities_km_mol"] = [float(x) for x in vib.ir_intensities]
    return obj


def _thermo_obj(thermo, total_energy: float) -> dict:
    H_vib_cal = thermo.E_vib * HARTREE_TO_CALMOL
    H_rot_cal = thermo.E_rot * HARTREE_TO_CALMOL
    H_trans_cal = thermo.E_trans * HARTREE_TO_CALMOL
    # internal = vib + rot
    H_int_cal = H_vib_cal + H_rot_cal
    Cv_int = thermo.Cv_vib + thermo.Cv_rot
    S_int = thermo.S_vib + thermo.S_rot
    # translational heat capacity at constant pressure: Cv + R
    Cp_trans = thermo.Cv_trans + 1.98720425864
    H_total_cal = H_int_cal + H_trans_cal
    Cv_total = Cv_int + Cp_trans
    S_total = S_int + thermo.S_trans + thermo.S_elec

    return {
        "temperature_K": float(thermo.temperature),
        "pressure_atm": float(thermo.pressure),
        "molecular_mass_amu": float(thermo.total_mass),
        "symmetry_number": int(thermo.symmetry_number),
        "spin_multiplicity": int(thermo.spin_multiplicity),
        "is_linear": bool(thermo.is_linear),
        "n_real_frequencies": int(thermo.n_real_freqs),
        "n_imaginary_frequencies": int(thermo.n_imag_freqs),
        "moments_of_inertia_amu_ang2": {
            "Ia": float(thermo.moments[0]),
            "Ib": float(thermo.moments[1]),
            "Ic": float(thermo.moments[2]),
        },
        "rotational_constants_GHz": {
            "A": float(thermo.rot_const[0]),
            "B": float(thermo.rot_const[1]),
            "C": float(thermo.rot_const[2]),
        },
        "partition_functions": {
            "translational": float(thermo.q_trans),
            "rotational": float(thermo.q_rot),
            "vibrational": float(thermo.q_vib),
        },
        "contributions": {
            "translational": {
                "energy_hartree": float(thermo.E_trans),
                "entropy_cal_mol_K": float(thermo.S_trans),
                "Cv_cal_mol_K": float(thermo.Cv_trans),
            },
            "rotational": {
                "energy_hartree": float(thermo.E_rot),
                "entropy_cal_mol_K": float(thermo.S_rot),
                "Cv_cal_mol_K": float(thermo.Cv_rot),
            },
            "vibrational": {
                "energy_hartree": float(thermo.E_vib),
                "entropy_cal_mol_K": float(thermo.S_vib),
                "Cv_cal_mol_K": float(thermo.Cv_vib),
            },
            "electronic": {
                "energy_hartree": float(thermo.E_elec),
                "entropy_cal_mol_K": float(thermo.S_elec),
            },
        },
        "contribution_table": {
            "VIB": {
                "H_cal_mol": H_vib_cal,
                "Cp_cal_mol_K": float(thermo.Cv_vib),
                "S_cal_mol_K": float(thermo.S_vib),
                "S_J_mol_K": float(thermo.S_vib) * CAL_TO_J,
            },
            "ROT": {
                "H_cal_mol": H_rot_cal,
                "Cp_cal_mol_K": float(thermo.Cv_rot),
                "S_cal_mol_K": float(thermo.S_rot),
                "S_J_mol_K": float(thermo.S_rot) * CAL_TO_J,
            },
            "INT": {
                "H_cal_mol": H_int_cal,
                "Cp_cal_mol_K": Cv_int,
                "S_cal_mol_K": S_int,
                "S_J_mol_K": S_int * CAL_TO_J,
            },
            "TR": {
                "H_cal_mol": H_trans_cal,
                "Cp_cal_mol_K": Cp_trans,
                "S_cal_mol_K": float(thermo.S_trans),
                "S_J_mol_K": float(thermo.S_trans) * CAL_TO_J,
            },
            "TOT": {
                "H_cal_mol": H_total_cal,
                "Cp_cal_mol_K": Cv_total,
                "S_cal_mol_K": S_total,
                "S_J_mol_K": S_total * CAL_TO_J,
            },
        },
        "zero_point_energy_hartree": float(thermo.zpe_hartree),
        "zero_point_energy_kcal_mol": float(thermo.zpe_kcalmol),
        "thermal_corrections_hartree": {
            "to_energy": float(thermo.thermal_correction_energy),
            "to_enthalpy": float(thermo.thermal_correction_enthalpy),
            "to_gibbs": float(thermo.thermal_correction_gibbs),
        },
        "total_energies_hartree": {
            "electronic": total_energy,
            "electronic_plus_zpe": total_energy + float(thermo.zpe_hartree),
            "electronic_plus_thermal_E": total_energy
            + float(thermo.thermal_correction_energy),
            "electronic_plus_thermal_H": total_energy
            + float(thermo.thermal_correction_enthalpy),
            "electronic_plus_thermal_G": total_energy
            + float(thermo.thermal_correction_gibbs),
        },
    }


def build_output_object(
    result,
    polymers=None,
    max_level: int = 0,
    pie_atom_sets=None,
    vibrational=None,
    thermo=None,
) -> dict:
    """Build the per-molecule JSON object (everything under the basename key)."""
    obj: dict = {}
    _add_common(obj, result)
    if polymers is not None and max_level > 0:
        obj["levels"] = _mbe_levels(result, polymers, max_level)
    if pie_atom_sets is not None and result.pie_coefficients is not None:
        obj["pie_terms"] = _pie_obj(result, pie_atom_sets)
    if vibrational is not None:
        obj["vibrational_analysis"] = _vibrational_obj(vibrational)
    if thermo is not None:
        obj["thermochemistry"] = _thermo_obj(thermo, float(result.total_energy))
    return obj


def write_json_output(
    path: str,
    basename: str,
    result,
    polymers=None,
    max_level: int = 0,
    pie_atom_sets=None,
    vibrational=None,
    thermo=None,
) -> dict:
    root = {
        basename: build_output_object(
            result,
            polymers=polymers,
            max_level=max_level,
            pie_atom_sets=pie_atom_sets,
            vibrational=vibrational,
            thermo=thermo,
        )
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(root, fh, indent=2)
        fh.write("\n")
    return root


def merge_multi_molecule_json(
    path: str, basename: str, molecule_objects: dict
) -> dict:
    """Combine per-molecule objects into one JSON keyed by molecule name."""
    root = {basename: molecule_objects}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(root, fh, indent=2)
        fh.write("\n")
    return root
