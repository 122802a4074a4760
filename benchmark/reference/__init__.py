"""The benchmark's plain reference: GFN1-xTB energies in plain torch
(`xtb.py`), independent of the program under test.

`xtb.py`, `plain.py` and `units.py` are the reference's own. The other
modules (`basis`, `batch`, `dispersion_d3`, `overlap`, `params_gfn1`,
`params_elements_ext`, `xbond`) and `data/` (the fitted GFN1 parameter
overlay) are frozen copies of the program's modules of the same names
under `metalquicha_tpu_torch/methods/xtb/` at commit 089f0f6, kept with
their docstrings; their imports of the program's hand-written kernels are
replaced by `plain.py`'s torch expressions, the overlay always loads, and
`batch` takes GFN1 alone. Nothing here imports the program, so a change to
the program leaves the reference as it is. Because the copies descend from
the program's code, `benchmark/tests/test_bench_witness.py` holds the
reference against the JAX package, the program's original, in a process
of its own.
"""
