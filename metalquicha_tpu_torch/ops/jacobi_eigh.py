"""Batched symmetric eigendecomposition by parallel-order Jacobi sweeps.

Counterpart of metalquicha_tpu's `ops/jacobi_eigh.py` (the Pallas kernel
`_jacobi_kernel` behind `batched_jacobi_eigh`). The kernel is CUDA C++ for
sm_90a in `csrc/jacobi_eigh.cu`, compiled with nvcc at first use into
`metalquicha_tpu_torch/_build/` (keyed by a hash of the source) and bound
through its plain C interface with ctypes.

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to `jacobi_eigh_reference`, the plain torch version
of the same algorithm with the same round-robin ordering, so the two run
the same sequence of rotations. Eigenvalues come out UNSORTED, with
v[..., :, k] the eigenvector of w[..., k]; the SCC's Fermi filling does not
depend on their order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

#: largest matrix dimension the kernel takes (A and V in shared memory)
MAX_N = 64

#: kernel launches so far (a caller may reset it to 0)
launches = 0
#: the same launches per CUDA stream handle (a caller may clear it): shows
#: which streams of this process ran the kernel
launches_by_stream: dict = {}

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "jacobi_eigh.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
#: guards the build (one nvcc run and one load however many threads make
#: the first call) and the launch counts
_build_lock = threading.Lock()
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


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Jacobi kernel cannot be built")


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it; safe to call
    from several threads at once."""
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            _build_and_load()
    return _lib


def _build_and_load() -> None:
    global _lib
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = _BUILD_DIR / f"jacobi_eigh-{key[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                capture_output=True, text=True, check=False,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}"
                    f"{proc.stderr}"
                )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    for name, ptr in (("mqc_jacobi_eigh_f32", ctypes.c_void_p),
                      ("mqc_jacobi_eigh_f64", ctypes.c_void_p)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mqc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mqc_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib


def _count(stream: int) -> None:
    global launches
    with _count_lock:
        launches += 1
        launches_by_stream[stream] = launches_by_stream.get(stream, 0) + 1


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
    if err != 0:
        msg = lib.mqc_cuda_error_string(err).decode()
        raise RuntimeError(f"Jacobi kernel launch failed: {msg} ({err})")
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
