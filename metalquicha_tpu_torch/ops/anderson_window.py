"""The Anderson window step of the SCC loop, one fragment at a time.

Counterpart of the window algebra of metalquicha_tpu's Anderson step
(`methods/xtb/engine.py:808-842`, GFN2's `:614-641`): everything after
f_res = g(x) - x, which the JAX package writes in jnp for one fragment
under `vmap`. The kernel is CUDA C++ for sm_90a in
`csrc/anderson_window.cu` (a warp per fragment up to nx = 32, a block
above, the window staged in shared memory once, the solve in one warp's
registers), built with nvcc at
first use into `metalquicha_tpu_torch/_build/` and bound with ctypes
(`ops/kernel_build.py`). A fragment's bits do not depend on its batch,
where torch's batched products and `torch.linalg.solve_ex` choose their
routines by the batch count (ROADMAP C17).

`anderson_window` updates the loop's state in place: the windows, x, the
residuals and the active flags. The iteration counter is read on the
device, and its increment stays the caller's. At the first iteration
(it = 0) every fragment counts as active and the window's older slots are
read only by the step that iteration rejects, so a loop restarts from
any earlier state by setting x and the counter alone (`engine._SccLoop`).

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to `anderson_window_reference`, the torch algebra
the engine ran before the kernel. `anderson_window_rowwise` is the
kernel's arithmetic of elimination and step in elementwise batched ops,
whose bits for a fragment do not depend on the batch either (its dot
products sum in torch's order, the kernel's in its own); the tests hold the
two plain versions to each other, and the kernel to the twin bit for bit
where the windows hold small integers, whose dot products are exact in any
order.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import replay_counts
from .kernel_build import KernelLibrary

#: kernel launches so far (a caller may reset it to 0)
launches = 0
#: the largest window (broyden_memory) the kernel takes on a card: one
#: warp eliminates, a lane per row up to 16 (in registers) and rows l, l +
#: 32, ... of the system in shared memory above; the plain version a CPU
#: tensor runs takes any, as the JAX package's step does
MAX_M = 128

_ptr, _int, _dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_WINDOW = [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _dbl, _dbl, _dbl, _dbl,
           _int, _int, _int, _int, _ptr]
_LIB = KernelLibrary("anderson_window", {
    "mqc_anderson_window_f32": _WINDOW,
    "mqc_anderson_window_f64": _WINDOW,
})
_count_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it; safe to call
    from several threads at once."""
    return _LIB.load()


def _count(stream: int, n: int = 1) -> None:
    global launches
    if replay_counts.record(_count):
        return
    with _count_lock:
        launches += n


def add_launches(n: int) -> None:
    """Add launches made in another process (a mesh slot's worker)."""
    global launches
    with _count_lock:
        launches += n


def _window_sums(hist_x, hist_f, it, m):
    """The window differences against the previous slot: (dX, dF)."""
    slots = torch.arange(m, device=hist_x.device)
    prev = (it - 1) % m
    valid = ((slots <= it) & (slots != prev))[None, :, None]
    dX = torch.where(valid, hist_x - hist_x.index_select(1, prev.view(1)),
                     0.0)
    dF = torch.where(valid, hist_f - hist_f.index_select(1, prev.view(1)),
                     0.0)
    return dX, dF


def _finish(x, f_res, it_resid, c, step, resid, active, it, beta, c_lim,
            scf_tol):
    """The step taken or rejected, and the frozen-fragment update."""
    x_and = x + beta * f_res - step
    x_damped = x + beta * f_res
    # reject wild extrapolations, non-finite steps, the first step
    bad = (
        (it < 1)
        | ~torch.isfinite(x_and).all(-1)
        | (c.abs().amax(-1) > c_lim)
    )
    x_next = torch.where(bad[:, None], x_damped, x_and)
    # fragments already below scf_tol keep their state and residual; at
    # the first iteration every fragment is active
    on = active | (it < 1)
    new_resid = torch.where(on, it_resid, resid)
    x.copy_(torch.where(on[:, None], x_next, x))
    resid.copy_(new_resid)
    active.copy_(on & (new_resid > scf_tol))


def _write_slot(x, f_res, hist_x, hist_f, it, m):
    slot = (it % m).view(1)
    hist_x.index_copy_(1, slot, x[:, None])
    hist_f.index_copy_(1, slot, f_res[:, None])


def anderson_window_reference(x, f_res, hist_x, hist_f, resid, active, it,
                              beta, reg, c_lim, scf_tol):
    """Plain torch version: batched products and `torch.linalg.solve_ex`
    (the algebra of the engine's Anderson step before the kernel)."""
    m = hist_x.shape[1]
    it_resid = f_res.abs().amax(-1)
    _write_slot(x, f_res, hist_x, hist_f, it, m)
    # Anderson: minimize ||f + dF c|| over window differences
    dX, dF = _window_sums(hist_x, hist_f, it, m)
    G = dF @ dF.transpose(-1, -2)
    trace = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    eye_m = torch.eye(m, dtype=x.dtype, device=x.device)
    G = G + (reg * trace / m + 1e-30)[:, None, None] * eye_m
    rhs = (dF @ f_res[..., None])[..., 0]
    c, _ = torch.linalg.solve_ex(G, rhs)
    step = (c[:, None, :] @ (dX + beta * dF))[:, 0]
    _finish(x, f_res, it_resid, c, step, resid, active, it, beta, c_lim,
            scf_tol)


def rowwise_solve(G, rhs):
    """G c = rhs by Gaussian elimination with partial pivoting (the first
    index of the largest |.|) in elementwise batched ops: the kernel's
    order, and bits for a fragment that do not depend on the batch."""
    bsz, m = rhs.shape
    A = torch.cat([G, rhs[..., None]], -1)
    rows = torch.arange(bsz, device=G.device)
    for k in range(m):
        p = k + A[:, k:, k].abs().argmax(-1)
        row_k, row_p = A[:, k].clone(), A[rows, p].clone()
        A[rows, p] = row_k
        A[:, k] = row_p
        f = A[:, k + 1:, k] / A[:, k, k][:, None]
        A[:, k + 1:] = A[:, k + 1:] - f[..., None] * A[:, k, None, :]
    c = torch.zeros_like(rhs)
    for k in reversed(range(m)):
        acc = torch.zeros_like(rhs[:, 0])
        for j in range(k + 1, m):
            acc = acc + A[:, k, j] * c[:, j]
        c[:, k] = (A[:, k, m] - acc) / A[:, k, k]
    return c


def anderson_window_rowwise(x, f_res, hist_x, hist_f, resid, active, it,
                            beta, reg, c_lim, scf_tol):
    """Plain torch version in the kernel's order: the products as
    elementwise products and sums, the solve by `rowwise_solve`, the step
    summed in ascending j with each term rounded apart, as the kernel
    rounds it; a fragment's bits do not depend on its batch."""
    m = hist_x.shape[1]
    it_resid = f_res.abs().amax(-1)
    _write_slot(x, f_res, hist_x, hist_f, it, m)
    dX, dF = _window_sums(hist_x, hist_f, it, m)
    G = (dF[:, :, None, :] * dF[:, None, :, :]).sum(-1)
    trace = torch.zeros_like(resid)
    for j in range(m):
        trace = trace + G[:, j, j]
    shift = reg * trace / m + 1e-30
    G = G + torch.diag_embed(shift[:, None].expand(-1, m))
    rhs = (dF * f_res[:, None, :]).sum(-1)
    c = rowwise_solve(G, rhs)
    dS = dX + beta * dF
    step = torch.zeros_like(x)
    for j in range(m):
        step = step + c[:, j, None] * dS[:, j]
    _finish(x, f_res, it_resid, c, step, resid, active, it, beta, c_lim,
            scf_tol)


def _fn(name: str):
    return getattr(_LIB.lib or build(), name)


def _launch(x, f_res, hist_x, hist_f, resid, active, it, beta, reg, c_lim,
            scf_tol):
    bsz, m, nx = hist_x.shape
    if m > MAX_M:
        raise ValueError(f"broyden_memory {m} exceeds the window kernel's "
                         f"MAX_M = {MAX_M} (the card's limit; a CPU tensor "
                         f"takes any)")
    fn = _fn("mqc_anderson_window_" + (
        "f64" if x.dtype == torch.float64 else "f32"))
    f_res = f_res if f_res.is_contiguous() else f_res.contiguous()
    index = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = fn(x.data_ptr(), f_res.data_ptr(), hist_x.data_ptr(),
             hist_f.data_ptr(), resid.data_ptr(), active.data_ptr(),
             it.data_ptr(), float(beta), float(reg), float(c_lim),
             float(scf_tol), bsz, m, nx, index, stream)
    _LIB.check(err, "Anderson window kernel")
    _count(stream)


def _check(x, f_res, hist_x, hist_f, resid, active, it):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Anderson window takes float32/float64, not "
                        f"{x.dtype}")
    if x.dim() != 2 or hist_x.dim() != 3:
        raise ValueError(f"expected x (B, nx) and windows (B, m, nx), got "
                         f"{tuple(x.shape)} and {tuple(hist_x.shape)}")
    bsz, nx = x.shape
    m = hist_x.shape[1]
    if (f_res.shape != x.shape or hist_x.shape != (bsz, m, nx)
            or hist_f.shape != hist_x.shape or resid.shape != (bsz,)
            or active.shape != (bsz,) or it.shape != ()):
        raise ValueError("Anderson window: the state's shapes do not agree")
    if active.dtype != torch.bool or it.dtype != torch.int64:
        raise TypeError("Anderson window: active is bool, the counter int64")
    if any(t.dtype != x.dtype for t in (f_res, hist_x, hist_f, resid)):
        raise TypeError("Anderson window: the state has mixed dtypes")


def anderson_window(x, f_res, hist_x, hist_f, resid, active, it, *, beta,
                    reg, c_lim, scf_tol) -> None:
    """One Anderson window step of a batch, in place: x (B, nx) the
    states, f_res (B, nx) their residual vectors g(x) - x, hist_x and
    hist_f (B, m, nx) the windows, resid (B,) each fragment's last
    residual, active (B,) bool, it the 0-d int64 iteration counter (not
    incremented here); beta the mixing, reg the Tikhonov weight, c_lim the
    largest coefficient accepted, scf_tol the freezing tolerance."""
    _check(x, f_res, hist_x, hist_f, resid, active, it)
    if x.device.type == "cuda":
        for t in (x, hist_x, hist_f, resid, active):
            if not t.is_contiguous():
                raise ValueError("Anderson window kernel: the state "
                                 "tensors it updates must be contiguous")
        return _launch(x, f_res, hist_x, hist_f, resid, active, it, beta,
                       reg, c_lim, scf_tol)
    if x.device.type == "cpu":
        return anderson_window_reference(x, f_res, hist_x, hist_f, resid,
                                         active, it, beta, reg, c_lim,
                                         scf_tol)
    raise ValueError(f"no Anderson window for device {x.device}")
