"""Fermi-level fill of a fragment batch: occupations and entropy.

Counterpart of metalquicha_tpu's `_fermi_fill` and the non-fixed branch
of `occupations` (`methods/xtb/engine.py`), whose 80-step bisection on
the chemical potential XLA runs as one loop on the device. The kernel is
CUDA C++ for sm_90a in `csrc/fermi_fill.cu` (one launch per call: both
spin channels, their sum and the entropy), built with nvcc at first use
into `metalquicha_tpu_torch/_build/` and bound with ctypes
(`ops/kernel_build.py`).

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to `fermi_occupations_reference`, the plain torch
version of the same arithmetic. The kernel's outputs carry no autograd
graph; the engine detaches the plain version's where it uses them, as the
JAX package stops their gradients.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .kernel_build import KernelLibrary

#: kernel launches so far (a caller may reset it to 0)
launches = 0
#: the same launches per CUDA stream handle (a caller may clear it)
launches_by_stream: dict = {}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_LIB = KernelLibrary("fermi_fill", {
    name: [_ptr, _ptr, _ptr, _ptr, ctypes.c_double, _ptr, _ptr, _int, _int,
           _int, _ptr]
    for name in ("mqc_fermi_fill_f32", "mqc_fermi_fill_f64")
})
#: guards the launch counts
_count_lock = threading.Lock()


def _fermi_fill(eps, n_el, kt, ao_mask):
    """Fermi occupations (one spin channel, occupancy in [0,1]) + entropy,
    for a batch: eps (B, nao), n_el (B,). 80 bisection steps on mu."""
    big = 1.0e3
    e = torch.where(ao_mask > 0.5, eps, big)

    def occ(mu):
        x = torch.clamp((e - mu[:, None]) / kt, -60.0, 60.0)
        return 1.0 / (1.0 + torch.exp(x))

    lo = e.min(-1).values - 10.0
    hi = torch.where(ao_mask > 0.5, e, -big).max(-1).values + 10.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        too_many = occ(mid).sum(-1) > n_el
        lo = torch.where(too_many, lo, mid)
        hi = torch.where(too_many, mid, hi)
    f = occ(0.5 * (lo + hi))
    fc = torch.clamp(f, 1.0e-30, 1.0 - 1.0e-30)
    entropy = -(fc * torch.log(fc) + (1 - fc) * torch.log(1 - fc))
    entropy = torch.where((f > 1e-12) & (f < 1.0 - 1e-12), entropy, 0.0)
    return f, entropy.sum(-1)


def fermi_occupations_reference(eps, nelec, nuhf, kt, ao_mask):
    """Plain torch version of the kernel: the alpha and beta channels
    filled on a (2B, nao) stack (each row is independent, so this equals
    two separate fills); returns (f_total in [0,2] (B, nao), entropy
    (B,))."""
    n_ch = torch.cat([0.5 * (nelec + nuhf), 0.5 * (nelec - nuhf)])
    eps2 = torch.cat([eps, eps])
    mask2 = torch.cat([ao_mask, ao_mask])
    f2, s2 = _fermi_fill(eps2, n_ch, kt, mask2)
    bsz = eps.shape[0]
    return f2[:bsz] + f2[bsz:], s2[:bsz] + s2[bsz:]


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it; safe to call
    from several threads at once."""
    return _LIB.load()


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


def _launch(eps, nelec, nuhf, kt, ao_mask):
    if eps.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Fermi kernel takes float32/float64, not {eps.dtype}")
    # the kernel's outputs carry no graph; it reads the values only
    eps = eps.detach().contiguous()
    like = {"dtype": eps.dtype, "device": eps.device}
    mask = ao_mask.detach().to(**like).contiguous()
    nelec = nelec.detach().to(**like).contiguous()
    nuhf = nuhf.detach().to(**like).contiguous()
    lib = build()
    bsz, nao = eps.shape
    f = torch.empty((bsz, nao), **like)
    entropy = torch.empty((bsz,), **like)
    fn = (lib.mqc_fermi_fill_f64 if eps.dtype == torch.float64
          else lib.mqc_fermi_fill_f32)
    stream = torch.cuda.current_stream(eps.device).cuda_stream
    err = fn(eps.data_ptr(), mask.data_ptr(), nelec.data_ptr(),
             nuhf.data_ptr(), float(kt), f.data_ptr(), entropy.data_ptr(),
             bsz, nao, eps.device.index, stream)
    _LIB.check(err, "Fermi kernel")
    _count(stream)
    return f, entropy


def fermi_occupations(eps, nelec, nuhf, kt, ao_mask):
    """Fermi filling of both spin channels of a batch: eps (B, nao)
    orbital energies in any order, nelec and nuhf (B,), kt in Hartree,
    ao_mask (B, nao). Returns (f_total in [0,2] (B, nao), entropy (B,))."""
    if eps.dim() != 2 or ao_mask.shape != eps.shape:
        raise ValueError(f"expected eps and ao_mask of one (B, nao) shape, "
                         f"got {tuple(eps.shape)} and {tuple(ao_mask.shape)}")
    if nelec.shape != eps.shape[:1] or nuhf.shape != eps.shape[:1]:
        raise ValueError(f"expected nelec and nuhf of shape "
                         f"({eps.shape[0]},)")
    if eps.device.type == "cuda":
        return _launch(eps, nelec, nuhf, kt, ao_mask)
    if eps.device.type == "cpu":
        return fermi_occupations_reference(eps, nelec, nuhf, kt, ao_mask)
    raise ValueError(f"no Fermi fill for device {eps.device}")
