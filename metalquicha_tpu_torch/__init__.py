"""metalquicha-tpu on PyTorch: the batched GFN1-xTB MBE single point.

A port of the JAX package `metalquicha_tpu`, which stays beside it as the
reference. The port imports torch and NumPy, never jax and nothing of
`metalquicha_tpu`: its host layer (input parsing, fragmentation, the
driver, the basis and parameter tables) is its own copy, at the same
relative paths. Its entry points run on the CUDA card unless the caller
asks for the CPU. Its two hand-written kernels, the in-loop batched
Jacobi eigensolver (`ops/jacobi_eigh.py`) and the Fermi-level fill
(`ops/fermi_fill.py`), are CUDA C++ in `csrc/`.
"""

__version__ = "0.1.0"
