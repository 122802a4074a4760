"""Fermi-level fill of a fragment batch: occupations and entropy, and the
density built from them.

Counterpart of metalquicha_tpu's `_fermi_fill` and the non-fixed branch
of `occupations` (`methods/xtb/engine.py`), whose 80-step bisection on
the chemical potential XLA runs as one loop on the device, and of the
density product `(C * f) @ C.T` of its SCC's `make_density`. The kernels
are CUDA C++ for sm_90a in `csrc/fermi_fill.cu`, built with nvcc at first
use into `metalquicha_tpu_torch/_build/` and bound with ctypes
(`ops/kernel_build.py`):

- `fermi_occupations`: one launch per call fills both spin channels and
  returns their sum and the summed entropy;
- `fermi_density`: one launch per call fills both channels and returns
  P = C diag(f) C^T (nao <= DENSITY_MAX_N), for the SCC loop, which needs
  the density only.

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to the plain torch version beside it
(`fermi_occupations_reference`, `fermi_density_reference`). The kernels'
outputs carry no autograd graph; the engine detaches the plain version's
where it uses them, as the JAX package stops their gradients.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

from . import replay_counts
from .kernel_build import KernelLibrary

#: kernel launches so far, both entry points (a caller may reset it to 0)
launches = 0
#: the same launches per CUDA stream handle (a caller may clear it)
launches_by_stream: dict = {}
#: of `launches`, those of the fused fill and density (`fermi_density`)
density_launches = 0
#: the same by class of nao (`density_class`): 16, 32 and 64
density_by_class: collections.Counter = collections.Counter()
#: the largest nao `fermi_density` takes (its C tile in shared memory)
DENSITY_MAX_N = 64
#: bisection steps of the JAX function (the kernel stops earlier once a
#: step leaves the bracket unchanged: every later step would repeat it,
#: and takes runs of steps whose exponents are all clamped without a row
#: sum: `_bisect_skipping`)
STEPS = 80
#: a run of clamped steps starts only from a step whose bracket is at
#: least this many clamp margins wide (the kernel's kRunWidth)
RUN_WIDTH = 32

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_FILL = [_ptr, _ptr, _ptr, _ptr, ctypes.c_double, _ptr, _ptr, _ptr, _int,
         _int, _int, _ptr]
_DENSITY = [_ptr, _ptr, _ptr, _ptr, ctypes.c_double, _ptr, _ptr, _int, _int,
            _int, _ptr]
_LIB = KernelLibrary("fermi_fill", {
    "mqc_fermi_fill_f32": _FILL,
    "mqc_fermi_fill_f64": _FILL,
    "mqc_fermi_density_f32": _DENSITY,
    "mqc_fermi_density_f64": _DENSITY,
})
#: guards the launch counts
_count_lock = threading.Lock()


def _bisect(e, n_el, kt, ao_mask, trace=False):
    """The JAX function's 80 bisection steps on mu for rows e (R, nao),
    masked AOs already at 1e3: (lo, hi). With `trace`, also the state
    after the first step that left (lo, hi) unchanged (the kernel's stop;
    the 80-step state where no step did) and the steps taken up to it."""
    big = 1.0e3

    def occ(mu):
        x = torch.clamp((e - mu[:, None]) / kt, -60.0, 60.0)
        return 1.0 / (1.0 + torch.exp(x))

    lo = e.min(-1).values - 10.0
    hi = torch.where(ao_mask > 0.5, e, -big).max(-1).values + 10.0
    if trace:
        steps = torch.zeros(e.shape[0], dtype=torch.int32, device=e.device)
        done = torch.zeros(e.shape[0], dtype=torch.bool, device=e.device)
        lo_stop, hi_stop = lo, hi
    for _ in range(STEPS):
        mid = 0.5 * (lo + hi)
        too_many = occ(mid).sum(-1) > n_el
        new_lo = torch.where(too_many, lo, mid)
        new_hi = torch.where(too_many, mid, hi)
        if trace:
            # NaN never compares equal: a NaN row runs every step
            same = (new_lo == lo) & (new_hi == hi)
            steps = steps + (~done).to(torch.int32)
            lo_stop = torch.where(done, lo_stop, new_lo)
            hi_stop = torch.where(done, hi_stop, new_hi)
            done = done | same
        lo, hi = new_lo, new_hi
    if trace:
        return lo, hi, lo_stop, hi_stop, steps
    return lo, hi


def clamp_margins(kt, dtype, device="cpu"):
    """(hi, lo): the least m > 0 of `dtype` with m / kt >= 60, and with
    -m / kt <= -60, by the division `_bisect` makes on `device`, stepped
    an ulp at a time from 60 kt (the kernel's `Margins` tests 32 ulps at
    once); NaN where kt is not positive and finite or none is found
    within 64 ulps. A level d = e - mid above mid has its exponent clamped
    to 60 where d >= hi, to -60 where d <= -lo."""
    def full(value):
        return torch.full((1,), value, dtype=dtype, device=device)

    inf, zero = full(float("inf")), full(0.0)
    if not 0.0 < kt < float("inf"):
        return full(float("nan")), full(float("nan"))
    out = []
    for sign in (1.0, -1.0):
        def past(m):
            return bool(sign * ((sign * m) / kt) >= 60.0)

        m = full(60.0) * full(kt)
        n = 0
        while n < 64 and not past(m):
            m, n = torch.nextafter(m, inf), n + 1
        while n < 64 and past(torch.nextafter(m, zero)):
            m, n = torch.nextafter(m, zero), n + 1
        out.append(m if past(m) else full(float("nan")))
    return out[0], out[1]


def _bisect_skipping(e, n_el, kt, ao_mask, run_width=RUN_WIDTH):
    """`_bisect`'s steps as the kernel takes them: a step where every
    level's exponent was clamped (`clamp_margins`), taken from a bracket
    at least `run_width` margins wide, is followed by the run of steps
    whose mid leaves the lowest level clamped to 60 (eh) and the highest
    clamped to -60 (el) on their sides, each given that step's decision
    without a row sum; every other step evaluates. Returns (lo,
    hi, steps, full) at the first step that left (lo, hi) unchanged (the
    80th at most): `full` counts the steps that evaluated a row sum. Plain
    version of the kernel's control flow, for tests: bit for bit
    `_bisect(trace=True)`'s stop state and steps."""
    big = 1.0e3
    m_hi, m_lo = clamp_margins(kt, e.dtype, e.device)
    rows = e.shape[0]
    lo = e.min(-1).values - 10.0
    hi = torch.where(ao_mask > 0.5, e, -big).max(-1).values + 10.0
    steps = torch.zeros(rows, dtype=torch.int32, device=e.device)
    full = torch.zeros_like(steps)
    done = torch.zeros(rows, dtype=torch.bool, device=e.device)
    run = torch.zeros_like(done)
    run_many = torch.zeros_like(done)
    eh = torch.full_like(lo, float("inf"))
    el = torch.full_like(lo, -float("inf"))
    for _ in range(STEPS):
        mid = 0.5 * (lo + hi)
        wide = hi - lo >= run_width * m_hi
        skip = run & (eh - mid >= m_hi) & (el - mid <= -m_lo)
        d = e - mid[:, None]
        x = torch.clamp(d / kt, -60.0, 60.0)
        many_eval = (1.0 / (1.0 + torch.exp(x))).sum(-1) > n_el
        too_many = torch.where(skip, run_many, many_eval)
        new_lo = torch.where(too_many, lo, mid)
        new_hi = torch.where(too_many, mid, hi)
        active = ~done
        steps = steps + active.to(torch.int32)
        full = full + (active & ~skip).to(torch.int32)
        # NaN never compares equal: a NaN row runs every step
        stop = (new_lo == lo) & (new_hi == hi)
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
        done = done | (active & stop)
        high = d >= m_hi
        start = (active & ~skip & ~done & wide
                 & (high | (d <= -m_lo)).all(-1))
        eh = torch.where(start, torch.where(high, e, float("inf")).min(
            -1).values, eh)
        el = torch.where(start, torch.where(high, -float("inf"), e).max(
            -1).values, el)
        run_many = torch.where(start, many_eval, run_many)
        run = (skip | start) & ~done
    return lo, hi, steps, full


def _fermi_fill(eps, n_el, kt, ao_mask):
    """Fermi occupations (one spin channel, occupancy in [0,1]) + entropy,
    for a batch: eps (B, nao), n_el (B,). 80 bisection steps on mu."""
    e = torch.where(ao_mask > 0.5, eps, 1.0e3)
    lo, hi = _bisect(e, n_el, kt, ao_mask)
    mu = 0.5 * (lo + hi)
    x = torch.clamp((e - mu[:, None]) / kt, -60.0, 60.0)
    f = 1.0 / (1.0 + torch.exp(x))
    fc = torch.clamp(f, 1.0e-30, 1.0 - 1.0e-30)
    entropy = -(fc * torch.log(fc) + (1 - fc) * torch.log(1 - fc))
    entropy = torch.where((f > 1e-12) & (f < 1.0 - 1e-12), entropy, 0.0)
    return f, entropy.sum(-1)


def _channels(eps, nelec, nuhf, ao_mask):
    """The alpha and beta channels as one (2B, nao) stack: levels, electron
    counts, mask."""
    n_ch = torch.cat([0.5 * (nelec + nuhf), 0.5 * (nelec - nuhf)])
    return torch.cat([eps, eps]), n_ch, torch.cat([ao_mask, ao_mask])


def fermi_occupations_reference(eps, nelec, nuhf, kt, ao_mask):
    """Plain torch version of the kernel: the alpha and beta channels
    filled on a (2B, nao) stack (each row is independent, so this equals
    two separate fills); returns (f_total in [0,2] (B, nao), entropy
    (B,))."""
    e2, n_ch, mask2 = _channels(eps, nelec, nuhf, ao_mask)
    f2, s2 = _fermi_fill(e2, n_ch, kt, mask2)
    bsz = eps.shape[0]
    return f2[:bsz] + f2[bsz:], s2[:bsz] + s2[bsz:]


def fermi_density_reference(eps, C, nelec, nuhf, kt, ao_mask):
    """Plain torch version of the fused kernel: the fill, then
    P = (C * f) @ C^T (B, nao, nao)."""
    f, _ = fermi_occupations_reference(eps, nelec, nuhf, kt, ao_mask)
    return (C * f[:, None, :]) @ C.transpose(-1, -2)


def fermi_steps_reference(eps, nelec, nuhf, kt, ao_mask):
    """Bisection steps each channel's fill takes to its fixed point (the
    kernel's stop), counted on the plain arithmetic: int32 (B, 2), alpha
    then beta; 0 for the beta channel of a closed shell (nuhf 0), which
    the kernel does not fill (its fill would equal the alpha one)."""
    e2, n_ch, mask2 = _channels(eps, nelec, nuhf, ao_mask)
    e2 = torch.where(mask2 > 0.5, e2, 1.0e3)
    steps = _bisect(e2, n_ch, kt, mask2, trace=True)[-1]
    bsz = eps.shape[0]
    return torch.stack(
        [steps[:bsz], torch.where(nuhf == 0, 0, steps[bsz:])], -1)


def build() -> ctypes.CDLL:
    """Compile the kernels (once per source hash) and load them; safe to
    call from several threads at once."""
    return _LIB.load()


def density_class(nao: int) -> int:
    """The fused kernel's class of nao: 16 (a warp a fragment), 32 (f64
    from 16 fragments a multiprocessor a warp a fragment, else a block of
    two warps) or 64 (a block of eight warps up to 3 fragments a
    multiprocessor, else of two)."""
    return 16 if nao <= 16 else (32 if nao <= 32 else 64)


def _count(stream: int, n: int = 1, density: bool = False,
           nao_class: int = 0) -> None:
    """Count n launches on `stream`, fused ones of class `nao_class` where
    `density` (under capture, hand them to the capture's tally: each
    replay counts them)."""
    global launches, density_launches
    if replay_counts.record(_count, density, nao_class):
        return
    with _count_lock:
        launches += n
        density_launches += n * density
        if density and nao_class:
            density_by_class[nao_class] += n
        launches_by_stream[stream] = launches_by_stream.get(stream, 0) + n


def add_launches(n: int, density: int = 0, by_class=None) -> None:
    """Add launches made in another process (a mesh slot's worker) to the
    counts: n in all, `density` of them fused, `by_class` those by class
    of nao."""
    global launches, density_launches
    with _count_lock:
        launches += n
        density_launches += density
        density_by_class.update(by_class or {})


def _fn(name: str):
    """The C entry point `name`: the library is built and loaded at the
    first call only (ctypes keeps the function once looked up)."""
    return getattr(_LIB.lib or build(), name)


def _like(t, like):
    """t as a contiguous tensor of like's dtype on like's device, copied
    only where it is not one already."""
    if (t.dtype != like.dtype or t.device != like.device
            or not t.is_contiguous()):
        t = t.to(dtype=like.dtype, device=like.device).contiguous()
    return t


def _operands(eps, nelec, nuhf, ao_mask):
    if eps.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Fermi kernel takes float32/float64, not {eps.dtype}")
    # the kernels read the values only: no graph is recorded or needed
    eps = eps if eps.is_contiguous() else eps.contiguous()
    return eps, _like(nelec, eps), _like(nuhf, eps), _like(ao_mask, eps)


def _suffix(dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _stream(index: int) -> int:
    """The handle of the current CUDA stream of device `index` (the raw
    handle: a fraction of `torch.cuda.current_stream`'s host time)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(eps, nelec, nuhf, kt, ao_mask, steps=None):
    eps, nelec, nuhf, mask = _operands(eps, nelec, nuhf, ao_mask)
    fn = _fn("mqc_fermi_fill_" + _suffix(eps.dtype))
    bsz, nao = eps.shape
    # two allocations: cutting one into views costs more host time
    # (tools/fermi_probe_torch.py --host-only)
    f, entropy = eps.new_empty((bsz, nao)), eps.new_empty((bsz,))
    index = eps.device.index
    stream = _stream(index)
    err = fn(eps.data_ptr(), mask.data_ptr(), nelec.data_ptr(),
             nuhf.data_ptr(), float(kt), f.data_ptr(), entropy.data_ptr(),
             None if steps is None else steps.data_ptr(), bsz, nao, index,
             stream)
    _LIB.check(err, "Fermi kernel")
    _count(stream)
    return f, entropy


def _launch_density(eps, C, nelec, nuhf, kt, ao_mask):
    eps, nelec, nuhf, mask = _operands(eps, nelec, nuhf, ao_mask)
    C = _like(C, eps)
    fn = _fn("mqc_fermi_density_" + _suffix(eps.dtype))
    bsz, nao = eps.shape
    P = eps.new_empty((bsz, nao, nao))
    index = eps.device.index
    stream = _stream(index)
    err = fn(eps.data_ptr(), mask.data_ptr(), nelec.data_ptr(),
             nuhf.data_ptr(), float(kt), C.data_ptr(), P.data_ptr(), bsz,
             nao, index, stream)
    _LIB.check(err, "Fermi density kernel")
    _count(stream, density=True, nao_class=density_class(nao))
    return P


def _check_rows(eps, nelec, nuhf, ao_mask):
    if eps.dim() != 2 or ao_mask.shape != eps.shape:
        raise ValueError(f"expected eps and ao_mask of one (B, nao) shape, "
                         f"got {tuple(eps.shape)} and {tuple(ao_mask.shape)}")
    if nelec.shape != eps.shape[:1] or nuhf.shape != eps.shape[:1]:
        raise ValueError(f"expected nelec and nuhf of shape "
                         f"({eps.shape[0]},)")


def fermi_occupations(eps, nelec, nuhf, kt, ao_mask):
    """Fermi filling of both spin channels of a batch: eps (B, nao)
    orbital energies in any order, nelec and nuhf (B,), kt in Hartree,
    ao_mask (B, nao). Returns (f_total in [0,2] (B, nao), entropy (B,))."""
    _check_rows(eps, nelec, nuhf, ao_mask)
    if eps.device.type == "cuda":
        return _launch(eps, nelec, nuhf, kt, ao_mask)
    if eps.device.type == "cpu":
        return fermi_occupations_reference(eps, nelec, nuhf, kt, ao_mask)
    raise ValueError(f"no Fermi fill for device {eps.device}")


def fermi_occupations_steps(eps, nelec, nuhf, kt, ao_mask):
    """`fermi_occupations` and the bisection steps each channel took:
    (f_total, entropy, int32 steps (B, 2)). On a card the kernel writes
    its own counts (one launch); on the CPU they are the plain
    arithmetic's (`fermi_steps_reference`)."""
    _check_rows(eps, nelec, nuhf, ao_mask)
    if eps.device.type == "cuda":
        steps = torch.empty((eps.shape[0], 2), dtype=torch.int32,
                            device=eps.device)
        return (*_launch(eps, nelec, nuhf, kt, ao_mask, steps), steps)
    if eps.device.type == "cpu":
        return (*fermi_occupations_reference(eps, nelec, nuhf, kt, ao_mask),
                fermi_steps_reference(eps, nelec, nuhf, kt, ao_mask))
    raise ValueError(f"no Fermi fill for device {eps.device}")


def fermi_density(eps, C, nelec, nuhf, kt, ao_mask):
    """The density of the Fermi filling, P = C diag(f) C^T (B, nao, nao),
    for eps (B, nao) in any order, their eigenvectors C (B, nao, nao) in
    columns, nelec and nuhf (B,), kt in Hartree, ao_mask (B, nao);
    nao <= DENSITY_MAX_N. No graph is recorded through it: the SCC loop
    uses it, which is not differentiated."""
    _check_rows(eps, nelec, nuhf, ao_mask)
    bsz, nao = eps.shape
    if C.shape != (bsz, nao, nao):
        raise ValueError(f"expected C of shape {(bsz, nao, nao)}, got "
                         f"{tuple(C.shape)}")
    if nao > DENSITY_MAX_N:
        raise ValueError(f"nao {nao} exceeds DENSITY_MAX_N = "
                         f"{DENSITY_MAX_N}: fill with fermi_occupations and "
                         f"multiply")
    if eps.device.type == "cuda":
        return _launch_density(eps, C, nelec, nuhf, kt, ao_mask)
    if eps.device.type == "cpu":
        return fermi_density_reference(eps, C, nelec, nuhf, kt, ao_mask)
    raise ValueError(f"no Fermi fill for device {eps.device}")
