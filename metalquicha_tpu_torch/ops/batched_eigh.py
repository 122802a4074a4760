"""The SCC loop's eigendecomposition, with no host synchronization.

On a card `torch.linalg.eigh` checks cuSOLVER's `info` on the host, which
synchronizes the device with the host in every call: such a call cannot
be captured in a CUDA graph, and in an eager loop it stalls the host once
per iteration. The JAX package's `jnp.linalg.eigh` lowers to a cuSOLVER
call too and keeps its status on the device. `eigh` is the port's
counterpart: a thin binding of cuSOLVER's batched eigensolver
(`csrc/batched_eigh.cu`, built with nvcc at first use into
`metalquicha_tpu_torch/_build/` and bound with ctypes, linking
`-lcusolver`), on the current stream, with `info` folded on the device
into an `EighStatus` that the caller reads once, after its loop. The
status also holds cuSOLVER's workspace, allocated once per solve before
the loop (about 90 n^2 elements per matrix: 4.4 GB at (5985, 32) in
float64): made inside the loop it would come from the side stream's
cache and from the CUDA graph's memory pool, neither of which the rest of
the program can reuse.

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

Dispatch is by the tensor's device: a CUDA tensor goes to the binding (or
raises), a CPU tensor to `torch.linalg.eigh`, the plain version. Only the
not-differentiated SCC loops call it; `engine.eigh_safe` (autograd) stays
on `torch.linalg.eigh`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import replay_counts
from .kernel_build import KernelLibrary

#: binding calls so far (a caller may reset it to 0)
launches = 0

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = KernelLibrary("batched_eigh", {
    "mqc_eigh_workspace": [_int, _int, _int, _int, ctypes.POINTER(_ll),
                           ctypes.POINTER(_ll)],
    "mqc_eigh": [_int, _ptr, _ptr, _ptr, _ll, _ptr, _ptr, _int, _int, _int,
                 _ptr],
    "mqc_eigh_solver_version": [ctypes.POINTER(_int)],
}, libs=("cusolver",))
_count_lock = threading.Lock()
#: (dtype code, n, batch, device) -> device workspace bytes
_workspace: dict = {}


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
    the shape and type of `like` (B, n, n), allocated here on a card, and
    the largest |info| cuSOLVER reported over the calls, kept on the
    device (an int32 0-d tensor) until `check` reads it."""

    def __init__(self, like: torch.Tensor):
        self.shape = (like.dtype, *like.shape)
        self.worst = torch.zeros((), dtype=torch.int32, device=like.device)
        self.work = None
        if like.device.type == "cuda":
            if _LIB.lib is None:
                build()
            nbytes = _workspace_bytes(int(like.dtype == torch.float64),
                                      like.shape[-1], like.shape[0],
                                      like.device.index)
            self.work = torch.empty((nbytes,), dtype=torch.uint8,
                                    device=like.device)

    def check(self) -> None:
        """Raise if any call reported a failure (one device-to-host read)."""
        bad = int(self.worst)
        if bad:
            raise RuntimeError(
                f"batched eigh: cuSOLVER reported info {bad} (a matrix "
                f"failed to converge, or an argument was wrong)")


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


def _launch(a: torch.Tensor, status: EighStatus):
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
    vt = a.transpose(-1, -2).contiguous()
    w = a.new_empty((bsz, n))
    info = torch.empty((bsz,), dtype=torch.int32, device=a.device)
    work = status.work
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = _LIB.lib.mqc_eigh(dcode, vt.data_ptr(), w.data_ptr(),
                            work.data_ptr(), work.numel(), info.data_ptr(),
                            status.worst.data_ptr(), n, bsz, index, stream)
    _LIB.check(err, "batched eigh")
    _count(stream)
    return w, vt.transpose(-1, -2)


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
        if a.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"batched eigh takes float32/float64, not "
                            f"{a.dtype}")
        return torch.linalg.eigh(a)
    raise ValueError(f"no batched eigh for device {a.device}")


def solver_version() -> int:
    """The version of the cuSOLVER the binding runs against."""
    v = _int(0)
    _LIB.check(build().mqc_eigh_solver_version(ctypes.byref(v)),
               "cusolverGetVersion")
    return int(v.value)
