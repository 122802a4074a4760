"""Batched symmetric eigendecomposition by parallel-order Jacobi sweeps.

Counterpart of metalquicha_tpu's `ops/jacobi_eigh.py` (the Pallas kernel
`_jacobi_kernel` behind `batched_jacobi_eigh`). The kernel is CUDA C++ for
sm_90a in `csrc/jacobi_eigh.cu`, compiled with nvcc at first use into
`metalquicha_tpu_torch/_build/` (keyed by a hash of the source) and bound
through its plain C interface with ctypes (`ops/kernel_build.py`).

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to `jacobi_eigh_reference`, the plain torch version
of the same algorithm with the same round-robin ordering, so the two run
the same sequence of rotations. Eigenvalues come out UNSORTED, with
v[..., :, k] the eigenvector of w[..., k]; the SCC's Fermi filling does not
depend on their order.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import replay_counts
from .kernel_build import KernelLibrary

#: largest matrix dimension the kernel takes (A and V in shared memory)
MAX_N = 64

#: kernel launches so far (a caller may reset it to 0)
launches = 0
#: the same launches per CUDA stream handle (a caller may clear it): shows
#: which streams of this process ran the kernel
launches_by_stream: dict = {}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_LIB = KernelLibrary("jacobi_eigh", {
    name: [_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr]
    for name in ("mqc_jacobi_eigh_f32", "mqc_jacobi_eigh_f64")
})
#: guards the launch counts
_count_lock = threading.Lock()


def round_robin_pairs(n: int) -> list:
    """Per round, the (p, q) pairs of one round-robin sweep over n indices.

    n - 1 rounds (n even) or n rounds (n odd, with a phantom index whose
    pairs are dropped); together they hold every pair p < q once. The same
    formula as `round_robin_pair` in the CUDA source."""
    m = n + (n & 1)
    rounds = []
    for r in range(m - 1):
        pairs = []
        for k in range(m // 2):
            if k == 0:
                a, b = m - 1, r
            else:
                a, b = (r + k) % (m - 1), (r - k) % (m - 1)
            p, q = min(a, b), max(a, b)
            if q < n:
                pairs.append((p, q))
        rounds.append(np.asarray(pairs, dtype=np.int64).reshape(-1, 2))
    return rounds


def jacobi_eigh_reference(a: torch.Tensor, sweeps: int):
    """Plain torch version of the kernel: (w (B, N), v (B, N, N)).

    Each round computes its disjoint rotations from the A it starts from,
    rotates the rows of A, then the columns of A and V."""
    A = a.clone()
    n = A.shape[-1]
    V = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(A).clone()
    rounds = [
        torch.as_tensor(pq, device=a.device) for pq in round_robin_pairs(n)
    ]
    for _ in range(sweeps):
        for pq in rounds:
            if pq.shape[0] == 0:
                continue
            p, q = pq[:, 0], pq[:, 1]
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]   # (B, k)
            denom = 2.0 * apq
            safe = denom.abs() > 1e-12 * (app.abs() + aqq.abs() + 1.0)
            tau = (aqq - app) / torch.where(safe, denom, 1.0)
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(a.dtype)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(safe, t, 0.0)
            c = torch.rsqrt(1.0 + t * t)
            s = t * c
            rp, rq = A[:, p, :], A[:, q, :]                       # (B, k, N)
            A[:, p, :] = c[..., None] * rp - s[..., None] * rq
            A[:, q, :] = s[..., None] * rp + c[..., None] * rq
            cr, sr = c[:, None, :], s[:, None, :]
            for M in (A, V):
                cp, cq = M[:, :, p], M[:, :, q]                   # (B, N, k)
                M[:, :, p] = cr * cp - sr * cq
                M[:, :, q] = sr * cp + cr * cq
    return torch.diagonal(A, dim1=-2, dim2=-1).clone(), V


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it; safe to call
    from several threads at once."""
    return _LIB.load()


def _count(stream: int, n: int = 1) -> None:
    """Count n launches on `stream` (under capture, hand them to the
    capture's tally: each replay counts them)."""
    global launches
    if replay_counts.record(_count):
        return
    with _count_lock:
        launches += n
        launches_by_stream[stream] = launches_by_stream.get(stream, 0) + n


def add_launches(n: int) -> None:
    """Add launches made in another process (a mesh slot's worker) to the
    count."""
    global launches
    with _count_lock:
        launches += n


def _launch(a: torch.Tensor, sweeps: int):
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Jacobi kernel takes float32/float64, not {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("Jacobi kernel needs a contiguous input")
    lib = build()
    bsz, n, _ = a.shape
    w = torch.empty((bsz, n), dtype=a.dtype, device=a.device)
    v = torch.empty((bsz, n, n), dtype=a.dtype, device=a.device)
    fn = (lib.mqc_jacobi_eigh_f64 if a.dtype == torch.float64
          else lib.mqc_jacobi_eigh_f32)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), w.data_ptr(), v.data_ptr(), bsz, n, sweeps,
             a.device.index, stream)
    _LIB.check(err, "Jacobi kernel")
    _count(stream)
    return w, v


def batched_jacobi_eigh(a: torch.Tensor, sweeps: int = 12):
    """Eigendecomposition of a batch (B, N, N) of symmetric matrices,
    N <= MAX_N. Returns (w (B, N) UNSORTED, v (B, N, N))."""
    if a.dim() != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (B, N, N), got {tuple(a.shape)}")
    if a.shape[-1] > MAX_N:
        raise ValueError(f"N = {a.shape[-1]} exceeds MAX_N = {MAX_N}")
    if a.device.type == "cuda":
        return _launch(a, sweeps)
    if a.device.type == "cpu":
        return jacobi_eigh_reference(a, sweeps)
    raise ValueError(f"no Jacobi eigensolver for device {a.device}")


def jacobi_eigh(a: torch.Tensor, sweeps: int = 10):
    """The SCC loop's entry: `batched_jacobi_eigh` with 10 sweeps, as the
    JAX package's `jacobi_eigh`."""
    return batched_jacobi_eigh(a, sweeps=sweeps)
