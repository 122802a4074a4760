"""Batch-invariant products of small per-fragment matrices.

The JAX package leaves the SCC's and the functional's batched products
(`methods/xtb/engine.py:443-453`, `:758-760`, `:780-781`) to XLA. On a
card torch.matmul sends them to cuBLAS, which picks its batched routine,
and with it each dot product's order of summation, by the batch count, so
a fragment's bits depended on how the executor cut the batch (ROADMAP
C17). The kernel (CUDA C++ for sm_90a in `csrc/fragment_gemm.cu`, built
with nvcc at first use into `metalquicha_tpu_torch/_build/` and bound with
ctypes, `ops/kernel_build.py`) reduces every output element in one fixed
order that depends on the sizes only: f64 on the FP64 tensor cores in
ascending blocks of 4 in k, f32 by FFMA in ascending k; where every size
is 8 or less, FMA in ascending k, a thread an element; the matvec by
FMA in ascending k, a thread an output, on a kernel of its own (a band
of a fragment's rows staged in shared memory where the batch is small;
whole fragments staged, or read in place in the transposed form and
where a row is short). Above, persistent blocks walk units of work (a
fragment, or a band of rows of one at 64), staged by 16-byte copies (f32
through a two-stage ring); above 64 (the tiled class) units of rows and
columns cut to the batch and the shape, k streamed in tiles at any length
through a ring of stages;
the kernel reads each operand's alignment itself (a view with a storage
offset, or rows of odd length in f64, are copied element by element into
the same layout, or in the tiled class in 16-byte pieces into rows shifted
by their parity, with the same bits), so the wrapper passes every
operand as it lies: a contiguous view with its offset, a transposed view
as it is stored with its flag flipped.

- `fragment_bmm(a, b, trans_a, trans_b)`: op(a) @ op(b);
- `sandwich(x, f, shift)`: x @ f @ x + shift in one launch (up to
  STAGED_N; two products and an add above);
- `fragment_matvec(m, x, trans)`: op(m) @ x;
- `pair_bilinear(w, grids)`: c[b, i, j] = w[b, i] . grids[b, i, j] .
  w[b, j], D3's C6 contraction, on a kernel of its own: one launch from
  the weights and the gathered (R, R) grids to C6.

Operands are batches with the same leading shape: a product's m and n up
to MAX_N and k of any length, the sandwich's and the matvec's sizes up to
MAX_N (above, the engine keeps torch.matmul, as the JAX package leaves
every product to XLA). Each op is a `torch.autograd.Function` on a card whose
backward calls the same kernel (so the backward is batch-invariant too,
and itself differentiable: `param_fit.py` runs a double backward);
`pair_bilinear`'s backward is built of the products, `fragment_sum`,
`broadcast` (`ops/fragment_reduce.py`) and elementwise products.

Dispatch is by the tensors' device: a CUDA tensor goes to the kernel (or
raises), a CPU tensor to the plain torch version, which is the torch
expression the engine ran before the kernel (`torch.matmul`,
`torch.einsum`), so every CPU result keeps its bits; any other device
raises. `fragment_bmm_reference` and `matvec_reference` are the
kernel's order in elementwise torch ops, for the tests;
`pair_bilinear_reference` is the pair kernel's arithmetic in elementwise
torch ops, bit for bit (its FMAs emulated exactly, `fma_reference`);
nothing on the main path calls them.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

from . import replay_counts
from .fragment_reduce import broadcast, fragment_sum
from .kernel_build import KernelLibrary

#: kernel launches so far by kind (`kind_of`), every entry; `launches` is
#: their sum (a caller may clear it)
launches_by_kind = collections.Counter()
#: the largest m and n a product takes on a card (k any length), and the
#: largest size of the sandwich and the matvec: staged whole in shared
#: memory up to STAGED_N (the range of the fused density), above in bands
#: of rows and columns with k streamed in tiles (fragments above 64 AOs:
#: the 73-atom peptide's 241, SP2's products, CPCM's points)
MAX_N = 256
STAGED_N = 64
#: the reference grids of a pair that `pair_bilinear` takes on a card
#: (D3's MAX_REFS)
PAIR_R = 5

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_BMM = [_ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _int, _ptr]
_SANDWICH = [_ptr, _ptr, _ptr, _ptr, _int, _int, _int, _ptr]
_MATVEC = [_ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _ptr]
_PAIR = [_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr]
_LIB = KernelLibrary("fragment_gemm", {
    "mqc_fragment_bmm_f32": _BMM,
    "mqc_fragment_bmm_f64": _BMM,
    "mqc_fragment_sandwich_f32": _SANDWICH,
    "mqc_fragment_sandwich_f64": _SANDWICH,
    "mqc_fragment_matvec_f32": _MATVEC,
    "mqc_fragment_matvec_f64": _MATVEC,
    "mqc_pair_bilinear_f32": _PAIR,
    "mqc_pair_bilinear_f64": _PAIR,
})
_count_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it; safe to call
    from several threads at once."""
    return _LIB.load()


def __getattr__(name):
    if name == "launches":
        # kernel launches so far, every entry
        return sum(launches_by_kind.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _count(stream: int, n: int = 1, kind: tuple = None) -> None:
    # a backward pass launches from autograd's device thread: the stream
    # tells its capture
    if replay_counts.record(_count, kind, stream=stream):
        return
    with _count_lock:
        launches_by_kind[kind] += n


def add_launches(by_kind: dict) -> None:
    """Add launches made in another process (a mesh slot's worker), by
    kind."""
    with _count_lock:
        launches_by_kind.update(by_kind)


def kind_of(entry: str, *sizes: int) -> tuple:
    """A launch's kind, (entry, class): class 0 for the direct kernel (a
    product whose sizes are all 8 or less: a thread an output) and for
    the pair kernel (`pair_bilinear`, a kind of its own), else the size
    class by the largest size (16, 32, 64; 128: the product's k in tiles,
    one band of columns; 256: past 128, the product's columns in two
    bands or a k or backward m of any length; the matvec's staged
    rows)."""
    top = max(sizes)
    if (entry == "bmm" and top <= 8) or entry == "pair_bilinear":
        return entry, 0
    return entry, (16 if top <= 16 else 32 if top <= 32 else
                   64 if top <= 64 else 128 if top <= 128 else 256)


def kind_name(kind: tuple) -> str:
    """"<entry> <size class>", "<entry> direct" or "pair_bilinear", for
    printing."""
    entry, cls = kind
    if entry == "pair_bilinear":
        return entry
    return f"{entry} {cls or 'direct'}"


def _op(t, trans):
    return t.transpose(-1, -2) if trans else t


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fragment_bmm_reference(a, b, trans_a=False, trans_b=False):
    """op(a) @ op(b) in the kernel's order: each element summed in
    ascending k from 0, in elementwise torch ops (a product and a sum
    rounded apart, where the f32 kernel fuses them and the f64 kernel sums
    blocks of 4 on the tensor cores: equal within rounding)."""
    a, b = _op(a, trans_a), _op(b, trans_b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=a.dtype,
                      device=a.device)
    for q in range(a.shape[-1]):
        acc = acc + a[..., :, q, None] * b[..., None, q, :]
    return acc


def matvec_reference(m, x, trans=False):
    """op(m) @ x in ascending k from 0."""
    m = _op(m, trans)
    acc = torch.zeros(m.shape[:-1], dtype=m.dtype, device=m.device)
    for q in range(m.shape[-1]):
        acc = acc + m[..., q] * x[..., q, None]
    return acc


#: Veltkamp's splitting constant 2^ceil(p / 2) + 1 of each dtype
_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _two_sum(a, b):
    """s = a + b rounded and e with s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p = a b rounded and e with p + e = a b exactly (Dekker, with
    Veltkamp's split)."""
    p = a * b
    ca, cb = _SPLIT[a.dtype] * a, _SPLIT[b.dtype] * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_odd(a, b):
    """a + b rounded to odd: the sum rounded toward zero, its last bit set
    where the sum is not exact."""
    s, e = _two_sum(a, b)
    even = (s.view(_BITS[s.dtype]) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.nextafter(s, torch.where(e > 0, inf, -inf))
    return torch.where((e != 0) & even, toward, s)


def fma_reference(a, b, c):
    """a b + c rounded once to the nearest (`__fma_rn`, `__fmaf_rn`), in
    elementwise torch ops of the operands' dtype: the exact product as two
    numbers, the sum of three rounded to odd and then to the nearest
    (Boldo and Melquiond's emulated FMA; exact for finite operands whose
    products do not underflow). A product of zero adds as the signed zero
    it is."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return torch.where(uh == 0, c + uh, th + _add_odd(tl, ul))


def pair_sum_reference(p):
    """The sum over the last dim (R products) in the pair kernel's
    association, torch's own for a short row on a card: lane t of H =
    2^floor(log2 R) lanes holds (+0 + p[t]) + (+0 + p[t + H]) (the second
    where t + H < R), then the lanes are halved pairwise, lane t + h into
    lane t for h = H / 2, ..., 1."""
    size = p.shape[-1]
    lanes_n = 1 << (size.bit_length() - 1)
    lanes = []
    for t in range(lanes_n):
        lane = 0.0 + p[..., t]
        if t + lanes_n < size:
            lane = lane + (0.0 + p[..., t + lanes_n])
        lanes.append(lane)
    h = lanes_n // 2
    while h:
        lanes = [lanes[t] + lanes[t + h] for t in range(h)]
        h //= 2
    return lanes[0]


def pair_bilinear_reference(w, grids):
    """`pair_bilinear` in the kernel's arithmetic: v[b, i, j, c] =
    fma(w[b, i, a], grids[b, i, j, a, c], v) for a ascending from +0, the
    products v w[b, j, c] rounded, then summed over c as
    `pair_sum_reference` does."""
    v = torch.zeros(grids.shape[:-2] + grids.shape[-1:], dtype=grids.dtype,
                    device=grids.device)
    for a in range(grids.shape[-2]):
        v = fma_reference(w[:, :, None, a, None], grids[..., a, :], v)
    return pair_sum_reference(v * w[:, None, :, :])


# ---------------------------------------------------------------------------
# The kernel's launches
# ---------------------------------------------------------------------------


def _fn(name: str, dtype):
    lib = _LIB.lib or build()
    return getattr(lib, f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


def _stream(t) -> tuple:
    index = t.device.index
    return index, torch._C._cuda_getCurrentRawStream(index)


def _operand(t, trans):
    """(a contiguous tensor, its transpose flag): a transposed view of a
    contiguous batch is passed as it is stored, with the flag flipped."""
    if t.is_contiguous():
        return t, trans
    if t.transpose(-1, -2).is_contiguous():
        return t.transpose(-1, -2), not trans
    return t.contiguous(), trans


def _flat(t):
    return t.reshape(-1, *t.shape[-2:])


def _launch_bmm(a, b, trans_a, trans_b):
    """op(a) @ op(b) on the card: one launch."""
    m, k = _op(a, trans_a).shape[-2:]
    n = _op(b, trans_b).shape[-1]
    lead = a.shape[:-2]
    a, trans_a = _operand(a, trans_a)
    b, trans_b = _operand(b, trans_b)
    c = torch.empty(*lead, m, n, dtype=a.dtype, device=a.device)
    index, stream = _stream(a)
    err = _fn("mqc_fragment_bmm", a.dtype)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), _flat(c).shape[0], m, n,
        k, int(trans_a), int(trans_b), index, stream)
    _LIB.check(err, "fragment product kernel")
    _count(stream, kind=kind_of("bmm", m, n, k))
    return c


def _launch_sandwich(x, f, shift):
    """x @ f @ x + shift on the card: one launch up to STAGED_N (X F kept
    in shared memory); above, the two products (X F rounded to memory, as
    the kernel rounds it to shared memory) and the add: the roundings of
    the one launch."""
    if x.shape[-1] > STAGED_N:
        return _launch_bmm(_launch_bmm(x, f, False, False), x, False,
                           False) + shift
    x, f, shift = x.contiguous(), f.contiguous(), shift.contiguous()
    c = torch.empty_like(x)
    index, stream = _stream(x)
    err = _fn("mqc_fragment_sandwich", x.dtype)(
        x.data_ptr(), f.data_ptr(), shift.data_ptr(), c.data_ptr(),
        _flat(c).shape[0], x.shape[-1], index, stream)
    _LIB.check(err, "fragment sandwich kernel")
    _count(stream, kind=kind_of("sandwich", x.shape[-1]))
    return c


def _launch_pair(w, grids):
    """c (B, nat, nat) from w (B, nat, R) and grids (B, nat, nat, R, R)
    on the card: one launch."""
    bsz, nat, r = w.shape
    w, grids = w.contiguous(), grids.contiguous()
    c = torch.empty(bsz, nat, nat, dtype=w.dtype, device=w.device)
    index, stream = _stream(w)
    err = _fn("mqc_pair_bilinear", w.dtype)(
        w.data_ptr(), grids.data_ptr(), c.data_ptr(), bsz, nat, r, index,
        stream)
    _LIB.check(err, "pair contraction kernel")
    _count(stream, kind=kind_of("pair_bilinear", r))
    return c


def _launch_matvec(m, x, trans):
    rows, cols = _op(m, trans).shape[-2:]
    m, trans = _operand(m, trans)
    x = x.contiguous()
    y = torch.empty(*m.shape[:-2], rows, dtype=m.dtype, device=m.device)
    index, stream = _stream(m)
    err = _fn("mqc_fragment_matvec", m.dtype)(
        m.data_ptr(), x.data_ptr(), y.data_ptr(),
        _flat(m).shape[0], rows, cols, int(trans), index, stream)
    _LIB.check(err, "fragment matvec kernel")
    _count(stream, kind=kind_of("matvec", rows, cols))
    return y


# ---------------------------------------------------------------------------
# Gradients: each backward calls the same ops, so it is batch-invariant and
# differentiable once more
# ---------------------------------------------------------------------------


class _Bmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, trans_a, trans_b):
        ctx.save_for_backward(a, b)
        ctx.trans = (trans_a, trans_b)
        return _launch_bmm(a, b, trans_a, trans_b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        ta, tb = ctx.trans
        da = db = None
        # C = op(A) op(B): d op(A) = dC op(B)^T, d op(B) = op(A)^T dC
        if ctx.needs_input_grad[0]:
            da = (_Bmm.apply(b, dc, tb, True) if ta
                  else _Bmm.apply(dc, b, False, not tb))
        if ctx.needs_input_grad[1]:
            db = (_Bmm.apply(dc, a, True, ta) if tb
                  else _Bmm.apply(a, dc, not ta, False))
        return da, db, None, None


class _Sandwich(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, shift):
        ctx.save_for_backward(x, f)
        return _launch_sandwich(x, f, shift)

    @staticmethod
    def backward(ctx, dc):
        x, f = ctx.saved_tensors
        dx = df = None
        # C = X F X + S: dX = dC (F X)^T + (X F)^T dC, dF = X^T dC X^T
        if ctx.needs_input_grad[0]:
            dx = (_Bmm.apply(dc, _Bmm.apply(f, x, False, False), False, True)
                  + _Bmm.apply(_Bmm.apply(x, f, False, False), dc, True,
                               False))
        if ctx.needs_input_grad[1]:
            df = _Bmm.apply(_Bmm.apply(x, dc, True, False), x, False, True)
        return dx, df, dc if ctx.needs_input_grad[2] else None


class _Matvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, x, trans):
        ctx.save_for_backward(m, x)
        ctx.trans = trans
        return _launch_matvec(m, x, trans)

    @staticmethod
    def backward(ctx, dy):
        m, x = ctx.saved_tensors
        trans = ctx.trans
        dm = dx = None
        # y = op(M) x: d op(M) = dy x^T (elementwise), dx = op(M)^T dy
        if ctx.needs_input_grad[0]:
            dm = (x[..., :, None] * dy[..., None, :] if trans
                  else dy[..., :, None] * x[..., None, :])
        if ctx.needs_input_grad[1]:
            dx = _Matvec.apply(m, dy, not trans)
        return dm, dx, None


def _expand(x, shape):
    """x expanded to `shape`, its backward a fragment sum on a card
    (`broadcast`)."""
    return broadcast(x, shape).expand(shape)


class _PairBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, grids):
        ctx.save_for_backward(w, grids)
        return _launch_pair(w, grids)

    @staticmethod
    def backward(ctx, dc):
        w, grids = ctx.saved_tensors
        bsz, nat, r = w.shape
        pairs = (bsz, nat, nat, r)
        dw = dgrids = None
        # c[i, j] = sum_a,c w[i, a] G[i, j, a, c] w[j, c]
        if ctx.needs_input_grad[0]:
            # dw[i, a] = sum_j dc[i, j] (G[i, j] w[j])[a]
            #          + sum_j dc[j, i] (w[j] G[j, i])[a]
            dcp = _expand(dc[..., None], pairs)
            right = fragment_bmm(grids, _expand(
                w[:, None, :, :, None], (*pairs, 1)))[..., 0]
            left = fragment_bmm(_expand(
                w[:, :, None, None, :], (bsz, nat, nat, 1, r)), grids)[
                    ..., 0, :]
            dw = fragment_sum(dcp * right, 2) + fragment_sum(dcp * left, 1)
        if ctx.needs_input_grad[1]:
            full = grids.shape
            dgrids = (_expand(dc[..., None, None], full)
                      * _expand(w[:, :, None, :, None], full)
                      * _expand(w[:, None, :, None, :], full))
        return dw, dgrids


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def _device(*tensors) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("fragment products: operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no fragment product kernel for device {dev}")
    return dev.type


def takes(m: int, n: int) -> bool:
    """Whether the op takes an (m, n) output on a card (a product's k any
    length): m and n up to MAX_N."""
    return max(m, n) <= MAX_N


def _check(*tensors) -> None:
    """What the kernel takes: float32/float64 of one dtype, the same
    leading shape."""
    dtype, lead = tensors[0].dtype, tensors[0].shape[:-2]
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fragment products take float32/float64, not "
                        f"{dtype}")
    for t in tensors:
        if t.dtype != dtype or t.dim() < 3 or t.shape[:-2] != lead:
            raise ValueError(
                f"fragment products: operands of one dtype and one leading "
                f"shape, got {[tuple(u.shape) for u in tensors]}")


def _check_sizes(m: int, n: int, shapes) -> None:
    if not takes(m, n):
        raise ValueError(f"fragment products take m and n up to MAX_N = "
                         f"{MAX_N}, got {[tuple(s) for s in shapes]}")


def fragment_bmm(a, b, trans_a: bool = False, trans_b: bool = False):
    """op(a) @ op(b) for (..., m, k) and (..., k, n) batches (op: the
    transpose where asked); on a card m and n up to MAX_N, k any
    length."""
    if _device(a, b) == "cpu":
        return torch.matmul(_op(a, trans_a), _op(b, trans_b))
    _check(a, b)
    if _op(a, trans_a).shape[-1] != _op(b, trans_b).shape[-2]:
        raise ValueError(f"fragment_bmm: {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    _check_sizes(_op(a, trans_a).shape[-2], _op(b, trans_b).shape[-1],
                 (a.shape, b.shape))
    return _Bmm.apply(a, b, trans_a, trans_b)


def sandwich(x, f, shift):
    """x @ f @ x + shift for (..., n, n) batches."""
    if _device(x, f, shift) == "cpu":
        return x @ f @ x + shift
    _check(x, f, shift)
    if not (x.shape == f.shape == shift.shape
            and x.shape[-1] == x.shape[-2]):
        raise ValueError("sandwich: x, f and shift are square, one shape")
    _check_sizes(x.shape[-1], x.shape[-1], (x.shape,))
    return _Sandwich.apply(x, f, shift)


def fragment_matvec(m, x, trans: bool = False):
    """op(m) @ x for (..., rows, cols) m and (..., cols) x."""
    if _device(m, x) == "cpu":
        return (_op(m, trans) @ x[..., None])[..., 0]
    _check(m)
    _check_sizes(*m.shape[-2:], (m.shape,))
    if (x.dtype != m.dtype or x.shape[:-1] != m.shape[:-2]
            or x.shape[-1] != _op(m, trans).shape[-1]):
        raise ValueError(f"fragment_matvec: {tuple(m.shape)} and "
                         f"{tuple(x.shape)} do not chain")
    return _Matvec.apply(m, x, trans)


def pair_bilinear(w, grids):
    """c[b, i, j] = sum over a, c of w[b, i, a] grids[b, i, j, a, c]
    w[b, j, c] for (B, nat, R) weights and (B, nat, nat, R, R) grids
    (D3's C6 from its reference grids). On a card one launch of the pair
    kernel, each pair's arithmetic fixed by R alone
    (`pair_bilinear_reference`; torch.einsum there is a batched cuBLAS
    product, whose order follows the batch count); on the CPU the two
    einsums."""
    if _device(w, grids) == "cpu":
        v = torch.einsum("bia,bijac->bijc", w, grids)
        return torch.einsum("bijc,bjc->bij", v, w)
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fragment products take float32/float64, not "
                        f"{w.dtype}")
    bsz, nat, r = w.shape if w.dim() == 3 else (0, 0, 0)
    if (grids.dtype != w.dtype or r != PAIR_R
            or grids.shape != (bsz, nat, nat, r, r)):
        raise ValueError(f"pair_bilinear: w (B, nat, R) and grids (B, nat, "
                         f"nat, R, R) of one dtype, R = PAIR_R = {PAIR_R}, "
                         f"got {tuple(w.shape)} {tuple(grids.shape)} "
                         f"{grids.dtype}")
    return _PairBilinear.apply(w, grids)
