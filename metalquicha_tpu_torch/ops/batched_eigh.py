"""Batched eigendecomposition on a card with no host synchronization.

On a card `torch.linalg.eigh` checks cuSOLVER's `info` on the host, which
synchronizes the device with the host in every call: such a call cannot
be captured in a CUDA graph, and in an eager loop it stalls the host once
per iteration. The JAX package's `jnp.linalg.eigh` lowers to a cuSOLVER
call too and keeps its status on the device. `eigh` is the port's
counterpart: a thin binding of cuSOLVER's batched eigensolver
(`csrc/batched_eigh.cu`, built with nvcc at first use into
`metalquicha_tpu_torch/_build/` and bound with ctypes, linking
`-lcusolver`), on the current stream, with `info` folded on the device
into an `EighStatus` that the caller reads once, after its work. The
status also holds cuSOLVER's workspace (about 90 n^2 elements per matrix:
4.4 GB at (5985, 32) in float64), allocated before the work: made inside
a captured program it would come from the CUDA graph's memory pool. The
statuses of one thread on one device share one workspace per shape
(`_shared_workspace`): their calls run one after the other on that
thread's stream.

Callers on a card: the (not differentiated) SCC loops, each with an
`EighStatus` of its own; and the forward pass of `engine.eigh_safe` (the
operand build's orthogonalizer, the functional's two eigendecompositions,
ALPB/GBSA's 3x3 covariances) through `eigh_folded`, which takes its status
from the `StageStatus` the calling stage collects into (`collecting`) or,
outside a stage, makes one and checks it at once. A stage folds other
device-side `info` too (CPCM's `torch.linalg.solve_ex`, `fold_info`).

It is a library call and not a hand-written kernel. Its routine is
cusolverDnXsyevBatched at every shape, with torch's settings and layout
(the lower triangle of a column-major copy; the eigenvector tensor has
torch's column-major strides, so what is computed from it runs the same
kernels):
- for a batch of matrices up to 32 it is the routine `torch.linalg.eigh`
  calls itself, and the eigenpairs equal torch's bit for bit;
- for one matrix, and above 32, torch calls syevd (or syevj in float32
  from 32 to 512) one matrix at a time. Both synchronize inside the
  library, so neither can be captured in a CUDA graph; there the
  eigenpairs differ from torch's in the last bits (held to 1e-12 in
  float64 by chip_smoke.py).

A matrix's eigenpairs do not depend on its batch (ROADMAP C17;
`tools/c17_probe_torch.py --eigh` measured XsyevBatched on an H100): in
any batch of 2 or more its bits are the same up to BATCHED_MAX_N_F64 in
float64 and at every size in float32, so a batch of 1 above SINGLE_MAX_N
(whose call takes another route) is solved as the matrix twice; above
BATCHED_MAX_N_F64 in float64 every matrix is solved by a call of its own
(`one_at_a_time`: the same (1, n, n) call in every cut, 12x the batched
call's time at (41, 241)).

Dispatch is by the tensor's device: a CUDA tensor goes to the binding (or
raises), a CPU tensor to `torch.linalg.eigh`, the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref

import torch

from . import replay_counts
from .kernel_build import KernelLibrary

#: binding calls so far (a caller may reset it to 0)
launches = 0
#: XsyevBatched's eigenpairs, measured on an H100 against the batch count
#: (`tools/c17_probe_torch.py --eigh`): the same bits for a matrix in any
#: batch of 2 or more up to this size in float64 (every size in float32),
#: other bits above it; above it in float64 each matrix is solved by a call
#: of its own, a (1, n, n) call, the same call whatever the batch
#: (`one_at_a_time`)
BATCHED_MAX_N_F64 = 128
#: up to this size a batch of 1 gives a matrix the bits of any batch;
#: above, the call for one matrix is made for two (the matrix twice), as a
#: batch of 2 or more runs it
SINGLE_MAX_N = 32

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = KernelLibrary("batched_eigh", {
    "mqc_eigh_workspace": [_int, _int, _int, _int, ctypes.POINTER(_ll),
                           ctypes.POINTER(_ll)],
    "mqc_eigh": [_int, _ptr, _ptr, _ptr, _ll, _ptr, _ptr, _int, _int, _int,
                 _ptr],
    "mqc_lu_workspace": [_int, _int, _int, ctypes.POINTER(_ll),
                         ctypes.POINTER(_ll)],
    "mqc_lu_factor": [_int, _ptr, _ptr, _ptr, _ll, _ptr, _ptr, _int, _int,
                      _int, _ptr],
    "mqc_lu_solve": [_int, _int, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int,
                     _int, _int, _ptr],
    "mqc_eigh_solver_version": [ctypes.POINTER(_int)],
}, libs=("cusolver",))
_count_lock = threading.Lock()
#: (dtype code, n, batch, device) -> device workspace bytes
_workspace: dict = {}
#: (dtype code, n, device) -> the LU factorization's workspace bytes
_lu_workspace: dict = {}
#: (thread, device, dtype code, n, batch) -> the workspace the statuses of
#: that thread share, while one of them holds it
_shared = weakref.WeakValueDictionary()
#: the calling thread's `StageStatus` (`collecting`)
_local = threading.local()


def build() -> ctypes.CDLL:
    """Compile the binding (once per source hash) and load it; safe to call
    from several threads at once."""
    return _LIB.load()


def _count(stream: int, n: int = 1) -> None:
    global launches
    if replay_counts.record(_count):
        return
    with _count_lock:
        launches += n


class EighStatus:
    """What one solve's calls share: cuSOLVER's workspace for matrices of
    the shape and type of `like` (B, n, n) on a card (the calling
    thread's, `_shared_workspace`), and the largest |info| cuSOLVER
    reported over the calls, kept on the device (an int32 0-d tensor,
    `worst`, or the one given) until `check` reads it."""

    def __init__(self, like: torch.Tensor, worst=None):
        self.shape = (like.dtype, *like.shape)
        self.worst = worst if worst is not None else torch.zeros(
            (), dtype=torch.int32, device=like.device)
        self.work = None
        if like.device.type == "cuda":
            self.work = _shared_workspace(like)

    def check(self) -> None:
        """Raise if any call reported a failure (one device-to-host read);
        the status is zeroed first, so that a cached loop that holds it
        starts its next solve clean."""
        bad = int(self.worst)
        if bad:
            self.worst.zero_()
            raise RuntimeError(
                f"batched eigh: cuSOLVER reported info {bad} (a matrix "
                f"failed to converge, or an argument was wrong)")


def _shared_workspace(like: torch.Tensor) -> torch.Tensor:
    """The workspace for matrices like `like` that this thread's statuses
    share on its device, allocated at the first one."""
    if _LIB.lib is None:
        build()
    dcode = int(like.dtype == torch.float64)
    n, index = like.shape[-1], like.device.index
    bsz = max(_call_batch(like.dtype, n, like.shape[0]), like.shape[0])
    key = (threading.get_ident(), index, dcode, n, bsz)
    work = _shared.get(key)
    if work is None:
        nbytes = _workspace_bytes(dcode, n, bsz, index)
        work = torch.empty((nbytes,), dtype=torch.uint8, device=like.device)
        _shared[key] = work
    return work


class StageStatus:
    """The status of one stage of a call (`calculator.evaluate` on a
    card): one `EighStatus` per matrix shape its eighs see, all folding
    into one `worst`, and the `info` of its other solvers (`fold_info`,
    `solve`). Made at the stage's first run, before any capture; `check`
    reads it (the call reads it with the others, `scc_graph.Call.finish`),
    and a failure read zeroes it."""

    def __init__(self, device):
        self.worst = torch.zeros((), dtype=torch.int32, device=device)
        self.statuses = {}
        #: no new status may be made (a capture reads the ones made)
        self.frozen = False

    def status_for(self, a: torch.Tensor) -> EighStatus:
        key = (a.dtype, *a.shape)
        got = self.statuses.get(key)
        if got is None:
            if self.frozen:
                raise RuntimeError(
                    f"batched eigh: a stage met a new shape {tuple(a.shape)} "
                    f"after its first run")
            got = self.statuses[key] = EighStatus(a, self.worst)
        return got

    def fold(self, info: torch.Tensor) -> None:
        torch.maximum(self.worst, info.abs().max().to(torch.int32),
                      out=self.worst)

    def check(self) -> None:
        bad = int(self.worst)
        if bad:
            self.worst.zero_()
            raise RuntimeError(
                f"a stage's solver reported info {bad} (an eigensolve that "
                f"did not converge, a singular system, or a wrong argument)")

    def owned(self) -> list:
        """The device tensors it holds (the workspaces are shared)."""
        return [self.worst]


@contextlib.contextmanager
def collecting(stage: StageStatus):
    """Within the block, this thread's `eigh_folded` and `fold_info` fold
    into `stage`."""
    prev = getattr(_local, "stage", None)
    _local.stage = stage
    try:
        yield stage
    finally:
        _local.stage = prev


def eigh_folded(a: torch.Tensor):
    """`eigh` of a batch (..., n, n) whose status goes to the calling
    stage (`collecting`), or, outside a stage, is checked at once (which
    synchronizes); `torch.linalg.eigh` on the CPU."""
    if a.device.type != "cuda":
        return eigh_plain(a)
    n = a.shape[-1]
    flat = a.reshape(-1, n, n)
    stage = getattr(_local, "stage", None)
    w, v = eigh(flat, None if stage is None else stage.status_for(flat))
    return w.reshape(a.shape[:-1]), v.reshape(a.shape)


def eigh_plain(a: torch.Tensor):
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched eigh takes float32/float64, not {a.dtype}")
    return torch.linalg.eigh(a)


def fold_info(info: torch.Tensor, what: str) -> None:
    """A solver's `info` (int tensor): folded into the calling stage's
    status on a card, else read at once; raises where it is not 0."""
    stage = getattr(_local, "stage", None)
    if stage is not None and info.device.type == "cuda":
        stage.fold(info)
        return
    if bool((info != 0).any()):
        raise RuntimeError(f"{what}: the solver reported info "
                           f"{int(info.abs().max())}")


def _lu_workspace_bytes(dcode: int, n: int, index: int) -> int:
    key = (dcode, n, index)
    got = _lu_workspace.get(key)
    if got is None:
        dev, host = _ll(0), _ll(0)
        _LIB.check(_LIB.lib.mqc_lu_workspace(dcode, n, index,
                                             ctypes.byref(dev),
                                             ctypes.byref(host)),
                   "LU workspace query")
        got = _lu_workspace[key] = max(int(dev.value), 1)
    return got


def _worst_for(stage, device):
    """(the int32 status a solver call folds into, whether it is the call's
    own, to be read at once)."""
    if stage is not None:
        return stage.worst, False
    return torch.zeros((), dtype=torch.int32, device=device), True


def _lu_factor(a: torch.Tensor, stage):
    """LU factors of A^T for a batch of row-major A (B, n, n), read as
    column-major: (the factors, int64 pivots)."""
    bsz, n, _ = a.shape
    dcode = int(a.dtype == torch.float64)
    index = a.device.index
    lu = a.contiguous().clone()
    ipiv = torch.empty((bsz, n), dtype=torch.int64, device=a.device)
    work = torch.empty((_lu_workspace_bytes(dcode, n, index),),
                       dtype=torch.uint8, device=a.device)
    info = torch.empty((bsz,), dtype=torch.int32, device=a.device)
    worst, own = _worst_for(stage, a.device)
    stream = torch._C._cuda_getCurrentRawStream(index)
    _LIB.check(_LIB.lib.mqc_lu_factor(
        dcode, lu.data_ptr(), ipiv.data_ptr(), work.data_ptr(), work.numel(),
        info.data_ptr(), worst.data_ptr(), n, bsz, index, stream),
        "LU factorization")
    _count(stream)
    if own:
        _raise_if(worst, "LU factorization")
    return lu, ipiv


def _lu_solve(lu, ipiv, b: torch.Tensor, trans: bool, stage):
    """X with op(M) X = b from M's factors (`_lu_factor`: M = A^T), b
    (B, n, k) row-major; trans solves M^T X = A X = b."""
    bsz, n, k = b.shape
    index = b.device.index
    # B_i column-major: its transpose row-major, solved in place
    x = b.transpose(-1, -2).contiguous()
    info = torch.empty((bsz,), dtype=torch.int32, device=b.device)
    worst, own = _worst_for(stage, b.device)
    stream = torch._C._cuda_getCurrentRawStream(index)
    _LIB.check(_LIB.lib.mqc_lu_solve(
        int(b.dtype == torch.float64), int(trans), lu.data_ptr(),
        ipiv.data_ptr(), x.data_ptr(), info.data_ptr(), worst.data_ptr(), n,
        k, bsz, index, stream), "LU solve")
    _count(stream)
    if own:
        _raise_if(worst, "LU solve")
    return x.transpose(-1, -2)


def _raise_if(worst, what: str) -> None:
    bad = int(worst)
    if bad:
        raise RuntimeError(f"{what}: cuSOLVER reported info {bad}")


class _Solve(torch.autograd.Function):
    """X = A^-1 B on a card through the LU binding; the backward pass
    solves with the saved factors (A^T gB = gX, gA = -gB X^T), its infos
    folded into the forward's stage."""

    @staticmethod
    def forward(ctx, a, b, stage):
        lu, ipiv = _lu_factor(a, stage)
        x = _lu_solve(lu, ipiv, b, True, stage)
        ctx.stage = stage
        ctx.save_for_backward(lu, ipiv, x)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gx):
        lu, ipiv, x = ctx.saved_tensors
        gb = _lu_solve(lu, ipiv, gx, False, ctx.stage)
        return -gb @ x.transpose(-1, -2), gb, None


def solve(a: torch.Tensor, b: torch.Tensor):
    """X with A X = B for a batch (B, n, n) and (B, n, k), differentiable
    in both. On a card cuSOLVER's LU (getrf, getrs) through the binding,
    its infos folded into the calling stage's status (`collecting`) or,
    outside a stage, read at once; on the CPU `torch.linalg.solve_ex`, its
    info read at once (the bits of `torch.linalg.solve`)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != a.shape[-2] or (
            b.shape[:2] != a.shape[:2]):
        raise ValueError(f"expected (B, n, n) and (B, n, k), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cuda":
        if _LIB.lib is None:
            build()
        return _Solve.apply(a, b, getattr(_local, "stage", None))
    if a.device.type == "cpu":
        x, info = torch.linalg.solve_ex(a, b)
        fold_info(info, "linear solve")
        return x
    raise ValueError(f"no batched solve for device {a.device}")


def _workspace_bytes(dcode: int, n: int, bsz: int, index: int) -> int:
    key = (dcode, n, bsz, index)
    got = _workspace.get(key)
    if got is None:
        dev, host = _ll(0), _ll(0)
        err = _LIB.lib.mqc_eigh_workspace(dcode, n, bsz, index,
                                          ctypes.byref(dev),
                                          ctypes.byref(host))
        _LIB.check(err, "eigh workspace query")
        got = _workspace[key] = max(int(dev.value), 1)
    return got


def workspace_bytes(dtype, n: int, device, batch: int = 1024) -> float:
    """cuSOLVER's workspace per (n, n) matrix of `dtype` on card `device`,
    from its query for a batch of `batch` (linear in the batch to within
    bytes: 745248 per matrix at (2581, 32) and (5985, 32) in float64)."""
    if _LIB.lib is None:
        build()
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return _workspace_bytes(int(dtype == torch.float64), n, batch,
                            index) / batch


def one_at_a_time(dtype, n: int) -> bool:
    """Whether the binding solves (n, n) matrices of `dtype` one call a
    matrix: float64 above BATCHED_MAX_N_F64, where XsyevBatched's
    eigenpairs depend on the batch count (ROADMAP C17)."""
    return dtype == torch.float64 and n > BATCHED_MAX_N_F64


def _call_batch(dtype, n: int, bsz: int) -> int:
    """The matrices of each XsyevBatched call for a batch of bsz: 1 where
    `one_at_a_time`, else the batch, a batch of 1 made 2 above
    SINGLE_MAX_N."""
    if one_at_a_time(dtype, n):
        return 1
    return 2 if bsz == 1 and n > SINGLE_MAX_N else bsz


def _launch(a: torch.Tensor, status: EighStatus, single=None):
    """XsyevBatched on the batch, or (`single`; by default
    `one_at_a_time`) on each matrix alone, a (1, n, n) call each: the
    same call whatever the batch, so a matrix's eigenpairs do not depend
    on it; a batch of 1 above SINGLE_MAX_N solved as a batch of 2 (the
    matrix twice), whose bits are a batch's. Either way one launch
    counted."""
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched eigh takes float32/float64, not {a.dtype}")
    if status.shape != (a.dtype, *a.shape) or status.work is None or (
            status.work.device != a.device):
        raise ValueError("the status was made for other matrices")
    bsz, n, _ = a.shape
    dcode = int(a.dtype == torch.float64)
    index = a.device.index
    # torch's layout: the lower triangle of a column-major copy (A^T
    # row-major), overwritten in place by the eigenvectors in columns
    if single is None:
        single = one_at_a_time(a.dtype, n)
    rows = 2 if not single and _call_batch(a.dtype, n, bsz) == 2 else bsz
    vt = a.transpose(-1, -2).expand(rows, n, n).contiguous()
    w = a.new_empty((rows, n))
    info = torch.empty((rows,), dtype=torch.int32, device=a.device)
    work = status.work
    stream = torch._C._cuda_getCurrentRawStream(index)
    # a matrix's offset in vt and w, and the matrices a call takes
    calls = ([(i * n * n * vt.element_size(), i * n * w.element_size(), i, 1)
              for i in range(bsz)] if single else [(0, 0, 0, rows)])
    for off_v, off_w, i, count in calls:
        err = _LIB.lib.mqc_eigh(
            dcode, vt.data_ptr() + off_v, w.data_ptr() + off_w,
            work.data_ptr(), work.numel(),
            info.data_ptr() + i * info.element_size(),
            status.worst.data_ptr(), n, count, index, stream)
        _LIB.check(err, "batched eigh")
    _count(stream)
    return w[:bsz], vt[:bsz].transpose(-1, -2)


def eigh(a: torch.Tensor, status: EighStatus | None = None):
    """Eigenvalues (B, n), ascending, and eigenvectors (B, n, n) in columns
    of a batch of symmetric matrices (B, n, n), from the lower triangle, as
    `torch.linalg.eigh`. No graph is recorded through it.

    status: an `EighStatus` made for matrices like `a`, whose workspace a
    card's call uses and where it folds cuSOLVER's `info` (read it with
    `status.check()` after the loop); None makes one and checks this call
    at once, which synchronizes."""
    if a.dim() != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (B, n, n), got {tuple(a.shape)}")
    if a.device.type == "cuda":
        own = status is None
        if own:
            status = EighStatus(a)
        out = _launch(a, status)
        if own:
            status.check()
        return out
    if a.device.type == "cpu":
        return eigh_plain(a)
    raise ValueError(f"no batched eigh for device {a.device}")


def solver_version() -> int:
    """The version of the cuSOLVER the binding runs against."""
    v = _int(0)
    _LIB.check(build().mqc_eigh_solver_version(ctypes.byref(v)),
               "cusolverGetVersion")
    return int(v.value)
