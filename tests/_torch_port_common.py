"""Shared inputs for the torch-port parity tests (tests/test_torch_*.py).

The same fragments, made with NumPy, go through the JAX package and the
port; `port_from_jax` hands the JAX package's padded batch to the port
unchanged, so a comparison isolates the function under test.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from metalquicha_tpu.constants import ANGSTROM_TO_BOHR
from metalquicha_tpu.elements import symbol_to_number

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "data", "port_golden_gfn1.json")

WATER = (
    np.array([8, 1, 1]),
    np.array([[0.0, 0.0, 0.117], [0.0, 0.757, -0.471], [0.0, -0.757, -0.471]])
    * ANGSTROM_TO_BOHR,
    0,
    1,
)

H3O = (
    np.array([8, 1, 1, 1]),
    np.array([
        [1.0925940942, -0.1960118985, 0.1054113976],
        [2.0700171780, -0.0708506168, 0.0091166421],
        [0.7807135018, -0.4182867270, -0.8074994503],
        [0.7408717471, 0.7134153793, 0.2734643830],
    ]) * ANGSTROM_TO_BOHR,
    1,
    1,
)

#: CH3Br ... NH3 with a linear C-Br...N arrangement (halogen bond; Br
#: carries a d shell)
HALOGEN = (
    np.array([6, 35, 1, 1, 1, 7, 1, 1, 1]),
    np.array([
        [0.0, 0.0, 0.0], [1.94, 0.0, 0.0],
        [-0.36, 1.03, 0.0], [-0.36, -0.51, 0.89], [-0.36, -0.51, -0.89],
        [4.84, 0.0, 0.0],
        [5.22, 0.94, 0.0], [5.22, -0.47, 0.82], [5.22, -0.47, -0.82],
    ]) * ANGSTROM_TO_BOHR,
    0,
    1,
)


def jittered_trimers(n: int = 40, seed: int = 11) -> list:
    """n water trimers (three WATERs 5.5 Bohr apart along x), every atom
    moved by a seeded normal draw of 0.1 Bohr: no two alike, so their
    gradients do not depend on the eigenvector gauge (ROADMAP C5)."""
    rng = np.random.default_rng(seed)
    numbers = np.tile(WATER[0], 3)
    base = np.concatenate([WATER[1] + np.array([5.5 * k, 0.0, 0.0])
                           for k in range(3)])
    return [(numbers, base + rng.normal(0.0, 0.1, base.shape), 0, 1)
            for _ in range(n)]


def _gly3_fragment():
    """The first residue of validation's gly3 (8 atoms, a doublet)."""
    path = os.path.join(REPO, "validation", "inputs", "sample_inputs",
                        "gly3.xyz")
    with open(path) as fh:
        rows = [ln.split() for ln in fh.read().splitlines()[2:10]]
    numbers = np.array([symbol_to_number(r[0]) for r in rows])
    coords = np.array([[float(x) for x in r[1:4]] for r in rows])
    return numbers, coords * ANGSTROM_TO_BOHR, 0, 2


GLY3_FRAG = _gly3_fragment()


def restore_jax_overlay():
    """Re-apply the JAX package's fitted overlay, for the JAX side of a
    comparison (the port loads its own copy into its own tables).

    Another test file in the same worker (test_param_overlay.py) restores
    most of the JAX tables after its run but clears the fitted D3 pair
    grids; re-loading the shipped overlay (idempotent) brings the JAX
    package back to its import-time state, which the port copies."""
    from metalquicha_tpu.methods.xtb import params_gfn1

    if os.path.exists(params_gfn1._OVERLAY_PATH) and not os.environ.get(
        "MQC_NO_OVERLAY"
    ):
        params_gfn1.load_overlay(params_gfn1._OVERLAY_PATH)


def jax_fragment_data(fragments, pad_to=None):
    from metalquicha_tpu.methods.xtb.batch import build_batch
    from metalquicha_tpu.methods.xtb.calculator import fragment_data_from_batch

    return fragment_data_from_batch(build_batch(fragments, pad_to=pad_to))


def port_from_jax(jax_frag, dtype=torch.float64):
    from metalquicha_tpu_torch.methods.xtb.calculator import (
        fragment_data_from_arrays,
    )

    return fragment_data_from_arrays(
        {k: np.asarray(v) for k, v in jax_frag._asdict().items()}, "cpu", dtype
    )


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_abs_diff(a, b):
    return float(np.abs(to_np(a) - to_np(b)).max())


#: tests/test_elements_spd.py's single points (Angstrom; multiplicity None
#: is that file's rule: singlet for an even electron count, else doublet):
#: name -> (numbers, coords, charge, multiplicity)
SPD_CASES = {
    "sih4": ([14, 1, 1, 1, 1],
             [[0, 0, 0], [0.87, 0.87, 0.87], [-0.87, -0.87, 0.87],
              [0.87, -0.87, -0.87], [-0.87, 0.87, -0.87]], 0, None),
    "si": ([14], [[0, 0, 0]], 0, 3),
    "h": ([1], [[0, 0, 0]], 0, None),
    "nacl": ([11, 17], [[0, 0, 0], [0, 0, 2.36]], 0, None),
    "na": ([11], [[0, 0, 0]], 0, 2),
    "cl": ([17], [[0, 0, 0]], 0, 2),
    "kbr": ([19, 35], [[0, 0, 0], [0, 0, 2.82]], 0, None),
    "ch3i": ([6, 1, 1, 1, 53],
             [[0, 0, 0], [1.03, 0, -0.36], [-0.51, 0.89, -0.36],
              [-0.51, -0.89, -0.36], [0, 0, 2.14]], 0, None),
}

#: tests/test_elements_ext.py::test_heavy_element_single_point_runs:
#: name -> numbers (charge 0, singlet; geometry from `heavy_coords`)
HEAVY_CASES = {
    "fe_co2": [26, 6, 8, 6, 8],
    "zn_water": [30, 8, 1, 1],
    "pt_nh3": [78, 7, 1, 1, 1],
}


def spd_fragment(geometry, name):
    """SPD_CASES[name] as the fragment tests/test_elements_spd.py builds,
    through `geometry` (the JAX package's module or the port's)."""
    nums, coords, charge, mult = SPD_CASES[name]
    if mult is None:
        mult = 1 if (sum(nums) - charge) % 2 == 0 else 2
    s = geometry.SystemGeometry(
        numbers=nums,
        coords=np.array(coords, dtype=float) * ANGSTROM_TO_BOHR,
        charge=charge,
        fragment_atoms=[np.arange(len(nums))],
        fragment_charges=[charge],
        fragment_multiplicities=[mult],
    )
    return geometry.build_fragment_from_indices(s, [0])


def heavy_coords(n):
    """The loose geometry (Bohr) of test_heavy_element_single_point_runs:
    seed 7, the first atom at the origin."""
    coords = 3.5 * np.random.default_rng(7).standard_normal((n, 3))
    coords[0] = 0.0
    return coords


#: tests/test_elements_spd.py::test_nacl_water_driver_input's input
NACL_WATER_MQC = """
%schema
name = mqc-frag
version = 1.0
index_base = 0
units = angstrom
end

%model
method = XTB-GFN1
end

%driver
type = Energy
end

%structure
charge = 0
multiplicity = 1
end

%geometry
5

Na 0.0 0.0 0.0
Cl 0.0 0.0 2.36
O  4.0 0.0 0.0
H  4.0 0.76 0.59
H  4.0 -0.76 0.59
end

%fragments
nfrag = 2

%fragment
charge = 0
multiplicity = 1
%indices
0 1
end
end

%fragment
charge = 0
multiplicity = 1
%indices
2 3 4
end
end

end  ! fragments

%fragmentation
level = 2
end
"""
