"""The roofline arithmetic: the card's published peaks and the least time
any implementation could take for a job, from the job's shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
full power limit of 700 W; a run writes the card's own limit beside its
numbers): 67 TFLOP/s in FP64 on the tensor cores and in FP32 outside them,
34 TFLOP/s in FP64 outside the tensor cores, 3.35 TB/s of HBM3.
`PEAK_FLOPS`, `PEAK_VECTOR`, `PEAK_BYTES`, `EXP_OPS` and the fill's
operation count are copied from the repository's `chip_smoke.py`
(`PEAK_FLOPS`, `PEAK_VECTOR`, `PEAK_BYTES`, `EXP_OPS`, `_fill_ops`,
`fermi_density_bytes_ms`) and `tools/kernel_times_torch.py` (its peaks and
`_flop_bound`); the benchmark does not read those files.

A bound counts the work the job needs at its shapes, whatever implements
it, so that a later implementation is read against the same work:
- operations at the highest rate any implementation could reach: a matrix
  job's at `PEAK_FLOPS` (the tensor cores in FP64), element-wise work at
  `PEAK_VECTOR`;
- bytes: each input read once and each output written once. An operand the
  job's caller has just written may still sit in the 50 MB L2 cache, and a
  kernel can leave its output there, so only what exceeds the L2 cache
  (`L2_BYTES`, 50 MiB, the larger reading of 50 MB) must cross HBM inside
  the kernel: the bound counts max(0, bytes - L2_BYTES) at `PEAK_BYTES`.
  At a batch whose operands fit in L2 the bytes bound nothing.
The bound is the larger of the operations' and the bytes' times, so no
implementation can beat it and no share can pass 100%.
"""

from __future__ import annotations

#: FP64 through the tensor cores (the highest FP64 rate), FP32 outside them
PEAK_FLOPS = {8: 67e12, 4: 67e12}
#: outside the tensor cores: element-wise work
PEAK_VECTOR = {8: 34e12, 4: 67e12}
#: HBM3
PEAK_BYTES = 3.35e12
#: the L2 cache, taken at 50 MiB
L2_BYTES = 50 * 2**20
#: operations per evaluation of exp or log (a range reduction and a
#: polynomial): an estimate, as chip_smoke.py's
EXP_OPS = {8: 20, 4: 8}


def hbm_seconds(nbytes: float) -> float:
    """The least HBM time of a job touching nbytes once: what exceeds L2."""
    return max(0.0, nbytes - L2_BYTES) / PEAK_BYTES


def eigh_bound_s(bsz: int, n: int, itemsize: int) -> float:
    """One batched symmetric eigendecomposition (eigenvalues and vectors)
    of bsz (n, n) matrices: 9 n^3 FLOP a matrix at PEAK_FLOPS; A read, W
    and V written once."""
    flop = 9.0 * bsz * n**3
    nbytes = bsz * (2 * n * n + n) * itemsize
    return max(flop / PEAK_FLOPS[itemsize], hbm_seconds(nbytes))


def fill_ops(rows: int, nao: int, itemsize: int) -> float:
    """The least element-wise work of a Fermi fill: each level of each
    filled row evaluated once (a subtraction, a division, a clamp, an exp,
    an add, a reciprocal and the row sum's add: 7 operations and an exp).
    Finding the Fermi level takes more evaluations in any method; they are
    not counted, so the bound stays below what any implementation takes."""
    return rows * nao * (7 + EXP_OPS[itemsize])


def fermi_density_bound_s(bsz: int, nao: int, itemsize: int,
                          open_shells: int) -> float:
    """The occupations and P = C diag(f) C^T of bsz fragments: the fill of
    one channel a closed shell (both channels equal) and two an open one,
    at PEAK_VECTOR; the product's nao^2 (nao + 1) FLOP (P is symmetric: the
    nao (nao + 1) / 2 distinct entries, nao multiply-adds each) at
    PEAK_FLOPS; eps, the AO mask, nelec, nuhf and C read once and P written
    once (`chip_smoke.fermi_density_bytes_ms`'s bytes)."""
    rows = bsz + open_shells
    vector = fill_ops(rows, nao, itemsize) / PEAK_VECTOR[itemsize]
    flop = bsz * nao * nao * (nao + 1.0) / PEAK_FLOPS[itemsize]
    nbytes = bsz * (2 * nao + 2 + 2 * nao * nao) * itemsize
    return max(vector, flop, hbm_seconds(nbytes))
