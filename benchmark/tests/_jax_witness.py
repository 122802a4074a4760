"""GFN1 energies and gradients of fragments by the JAX package, the
original that the program was ported from and that the reference's copied
modules (`basis`, `batch`, `overlap`, `dispersion_d3`, `xbond`, the
parameter tables) descend from: a second witness beside the reference.

    JAX_PLATFORMS=cpu python3 benchmark/tests/_jax_witness.py IN OUT

IN is a JSON list of [numbers, coords_bohr, charge, multiplicity]; OUT
gets {"e": [...], "g": [...], "resid": [...]}. It runs in a process of
its own: nothing of the benchmark's run or reference loads it.
"""

import json
import sys

import numpy as np


def main(src: str, dst: str) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.methods.xtb.engine import settings_from_params

    with open(src, encoding="utf-8") as fh:
        frags = [(np.asarray(z), np.asarray(x, dtype=np.float64), c, m)
                 for z, x, c, m in json.load(fh)]
    # a tight stop, so the SCC's rounding does not hide a disagreement
    calc = XtbCalculator(settings_from_params("gfn1", max_scf_iter=500,
                                              scf_tol=1e-10))
    e, g, aux = calc.gradients(calc.make_batch(frags))
    with open(dst, "w", encoding="utf-8") as fh:
        json.dump({"e": np.asarray(e).tolist(), "g": np.asarray(g).tolist(),
                   "resid": np.asarray(aux["scf_residual"]).tolist()}, fh)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
