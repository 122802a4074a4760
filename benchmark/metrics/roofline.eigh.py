"""roofline.eigh (%): the job of the batched symmetric eigendecompositions
(the orthogonalizer's eigh of S in the operand build, one of the Fock
matrix each SCC iteration, two in the functional) against its bound: the
bound's seconds (`harness/bounds.py` `eigh_bound_s`, 9 n^3 FLOP a matrix)
times the launches the program's tally counted in the traced steps
(`ops/batched_eigh.launches`, one per batched call), over the device
seconds the trace gives the kernels that do this job: cuSOLVER's
batched syev (`cusolverDnXsyevBatched`), which on an H100 with CUDA 12.8
runs as a Householder tridiagonalization (`sytrd4_cta` and its
`epilogue`), divide and conquer on the tridiagonal (`laed*`, `steqr_ker`,
`merge_ker`), the back-transformation (`ormqr_cta_kernel`), the norm and
scaling around them (`lansy_M_*`, `lascl_kernel`, `scale_max`,
`cuds_scal_batch_kernel`, `lacpy_kernel`) and its status words
(`copy_info_kernel`, `fold_info`, `xx_set_info_ker`); a Jacobi route
(`syevj`) is matched too. In these cells nothing else calls cuSOLVER."""

import re

from benchmark.harness import bounds, trace

#: the kernels that do the job, by name (cuSOLVER's batched syev)
KERNELS = re.compile(
    r"sytrd|stedc_params|\blaed\d|\bsteqr|\bmerge_ker<|\bormqr|\bormtr"
    r"|\borgtr|\blansy_M|\blascl_kernel<|\bscale_max<|cuds_scal_batch"
    r"|\blacpy_kernel<|\bcopy_info_kernel\(|\bfold_info\(|xx_set_info_ker"
    r"|syevj|syev_batched|syevBatched")


def read(run):
    if run.trace is None:
        return None
    bound = 0.0
    for ch in run.chunks:
        n = run.traced_launches.get(ch["name"], {}).get("eigh", 0)
        bound += n * bounds.eigh_bound_s(ch["fragments"], ch["nao"],
                                         ch["itemsize"])
    device = trace.kernel_seconds(run.trace, lambda s: bool(KERNELS.search(s)))
    if bound <= 0:
        return None
    if device <= 0:
        # the program launched the job but no traced kernel bears a name
        # above: the names are wrong, and the share must not go silent
        raise RuntimeError("roofline.eigh: launches counted, but no "
                           "traced kernel matches the job's names")
    return 100.0 * bound / device
