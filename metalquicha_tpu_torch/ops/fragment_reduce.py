"""Batch-invariant sums over small per-fragment tensors.

The JAX package leaves these contractions and sums to XLA, which on the
CPU reduces each fragment the same way whatever the batch. On a card the
port's torch ops did not (ROADMAP C17): GFN2's moment contractions
(`torch.einsum`, a batched cuBLAS product whose routine follows the batch
count), torch's reductions (a row split across more threads where the
tensor has fewer rows) and `scatter_add` (atomics, whose order follows the
threads' arrival: not even repeatable). The kernel (CUDA C++ for sm_90a in
`csrc/fragment_reduce.cu`, built with nvcc at first use into
`metalquicha_tpu_torch/_build/` and bound with ctypes,
`ops/kernel_build.py`) sums every output in one order fixed by the sizes
alone, each product and sum rounded on its own:

- `moment_fock(f, v1, m1, v2, m2)`: f + (G + G^T) / 2 with G[b, k, l] =
  -sum_d v1[b, k, d] m1[b, d, k, l] - sum_d v2[b, k, d] m2[b, d, k, l]
  (GFN2's Fock matrix from the dipole and quadrupole potentials, one
  launch), d ascending;
- `moment_rows(a, m, idx, size, weights)`: c[b, k, e] = sum_l a[b, k, l]
  m[b, e, k, l], l ascending; with an index, the rows summed into
  segments in the same launch (GFN2's atomic moments, the shell
  populations);
- `segment_sum(values, idx, size, weights)`: out[b, s] = sum over k
  ascending with idx[b, k] == s of weights[b, k] values[b, k]
  (scatter_add in a fixed order);
- `fragment_sum(x, dim)`: x.sum(dim), each output by 32 lanes (a warp,
  or a group of lanes of one for rows of up to 16 elements; 256 for more
  than WARP_ROW_MAX elements, a block or a cluster of blocks), lane j
  summing elements j, j + lanes, ... ascending, then the lanes halved
  pairwise;
- `take(x, idx)` and `take2(m, idx)`: the engine's gathers, whose
  backward passes (torch's accumulate into the gathered rows) are segment
  sums here;
- `broadcast(x, shape)`: x expanded to `shape`, whose backward sums the
  broadcast dims with `fragment_sum` (torch's sum_to_size, the backward of
  a broadcasting op, is one of its reductions).

Each is a `torch.autograd.Function` on a card whose backward is built of
these ops and elementwise products, so it is batch-invariant and itself
differentiable (`param_fit.py` runs a double backward).

Dispatch is by the tensors' device: a CUDA tensor goes to the kernel (or
raises); a CPU tensor to the torch expression the engine ran before the
kernel, so every CPU result keeps its bits; any other device raises.
The `*_reference` functions are the kernel's order in elementwise torch
ops, bit for bit the kernel's, for the tests and `chip_smoke.py`; nothing
on the main path calls them.
"""

from __future__ import annotations

import collections
import ctypes
import math
import threading

import torch

from . import replay_counts
from .kernel_build import KernelLibrary

#: kernel launches so far by entry (`moment_fock`, `moment_contract`,
#: `moment_rows`, `segment_sum`, `fragment_sum`); `launches` is their sum
#: (a caller may clear it)
launches_by_kind = collections.Counter()
#: fragment_sum: rows up to this many elements are summed by WARP_LANES
#: lanes, longer ones by BLOCK_LANES
WARP_ROW_MAX = 4096
WARP_LANES = 32
BLOCK_LANES = 256

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FOCK = [_ptr, _ptr, _ptr, _int, _ptr, _ptr, _int, _ptr, _int, _int, _int,
         _int, _ptr]
_ROWS = [_ptr, _ptr, _int, _ptr, _ptr, _int, _ptr, _int, _int, _int, _ptr]
_SEGMENT = [_ptr, _ptr, _ptr, _int, _ptr, _int, _int, _int, _int, _ptr]
_SUM = [_ptr, _ptr, _ll, _ll, _int, _ptr]
_LIB = KernelLibrary("fragment_reduce", {
    "mqc_moment_fock_f32": _FOCK,
    "mqc_moment_fock_f64": _FOCK,
    "mqc_moment_rows_f32": _ROWS,
    "mqc_moment_rows_f64": _ROWS,
    "mqc_segment_sum_f32": _SEGMENT,
    "mqc_segment_sum_f64": _SEGMENT,
    "mqc_fragment_sum_f32": _SUM,
    "mqc_fragment_sum_f64": _SUM,
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


def _count(stream: int, n: int = 1, kind: str = None) -> None:
    # a backward pass launches from autograd's device thread: the stream
    # tells its capture
    if replay_counts.record(_count, kind, stream=stream):
        return
    with _count_lock:
        launches_by_kind[kind] += n


def add_launches(by_kind: dict) -> None:
    """Add launches made in another process (a mesh slot's worker), by
    entry."""
    with _count_lock:
        launches_by_kind.update(by_kind)


def lanes_of(length: int) -> int:
    """The lanes that sum a row of `length` elements in `fragment_sum`."""
    return WARP_LANES if length <= WARP_ROW_MAX else BLOCK_LANES


# ---------------------------------------------------------------------------
# Plain versions in the kernel's order
# ---------------------------------------------------------------------------


def moment_contract_reference(v, m):
    """g[b, k, l] = sum_d v[b, k, d] m[b, d, k, l], d ascending from 0,
    each product rounded apart."""
    acc = torch.zeros(m.shape[0], *m.shape[2:], dtype=m.dtype,
                      device=m.device)
    for d in range(m.shape[1]):
        acc = acc + v[..., d, None] * m[:, d]
    return acc


def moment_fock_reference(f, v1, m1, v2=None, m2=None):
    """f - (g + g^T) / 2 with g the two contractions added: the kernel's
    arithmetic of f + (G + G^T) / 2, G = -g."""
    g = moment_contract_reference(v1, m1)
    if v2 is not None:
        g = g + moment_contract_reference(v2, m2)
    return f - 0.5 * (g + g.transpose(-1, -2))


def segment_sum_reference(values, idx, size, weights=None):
    """out[b, s, ...] = sum over k ascending with idx[b, k] == s of
    weights[b, k] * values[b, k, ...] (values (B, n) or (B, n, c))."""
    v = values if values.dim() > 2 else values[..., None]
    if weights is not None:
        v = weights[..., None] * v
    out = torch.zeros(v.shape[0], size, v.shape[2], dtype=v.dtype,
                      device=v.device)
    seg = torch.arange(size, device=v.device)
    for k in range(v.shape[1]):
        hit = (idx[:, k, None] == seg)[..., None]
        out = out + torch.where(hit, v[:, k, None, :], 0.0)
    return out if values.dim() > 2 else out[..., 0]


def moment_rows_reference(a, m, idx=None, size=None, weights=None):
    """c[b, k, e] = sum_l a[b, k, l] m[b, e, k, l], l ascending from 0;
    with idx, `segment_sum_reference` of c."""
    mt = m.transpose(1, 2)                          # (B, k, e, l)
    c = torch.zeros(m.shape[0], m.shape[2], m.shape[1], dtype=m.dtype,
                    device=m.device)
    for lo in range(m.shape[-1]):
        c = c + a[:, :, lo, None] * mt[..., lo]
    if idx is None:
        return c
    return segment_sum_reference(c, idx, size, weights)


def row_sum_reference(x):
    """The sum of each row of a (rows, len) tensor in `fragment_sum`'s
    order: lane j of `lanes_of(len)` sums elements j, j + lanes, ...
    ascending from 0, then x[t] + x[t + h] for h = lanes / 2, ..., 1."""
    rows, length = x.shape
    lanes = lanes_of(length)
    acc = torch.zeros(rows, lanes, dtype=x.dtype, device=x.device)
    for start in range(0, length, lanes):
        chunk = x[:, start : start + lanes]
        if chunk.shape[1] < lanes:
            # the lanes past the row add nothing (+0 keeps every sum)
            chunk = torch.nn.functional.pad(chunk, (0, lanes - chunk.shape[1]))
        acc = acc + chunk
    h = lanes // 2
    while h:
        acc = acc[:, :h] + acc[:, h : 2 * h]
        h //= 2
    return acc[:, 0]


def _dims(x, dim) -> tuple:
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    return tuple(sorted(d % x.dim() for d in dims))


def _as_rows(x, dim):
    """x with the summed dims moved last, as (rows, len), and the output's
    shape."""
    dims = _dims(x, dim)
    keep = [d for d in range(x.dim()) if d not in dims]
    shape = tuple(x.shape[d] for d in keep)
    rows = x.permute(*keep, *dims).reshape(
        math.prod(shape), math.prod(x.shape[d] for d in dims))
    return rows, shape


def fragment_sum_reference(x, dim=-1):
    """x.sum(dim) in the kernel's order (`row_sum_reference`)."""
    rows, shape = _as_rows(x, dim)
    return row_sum_reference(rows).reshape(shape)


# ---------------------------------------------------------------------------
# The torch expressions a CPU tensor runs (the engine's before the kernel)
# ---------------------------------------------------------------------------


def _scatter(values, idx, size):
    """scatter_add of (B, n) or (B, n, c) values into (B, size[, c])."""
    out = torch.zeros(
        values.shape[0], size, *values.shape[2:],
        dtype=values.dtype, device=values.device,
    )
    if values.dim() > 2:
        idx = idx[:, :, None].expand(-1, -1, values.shape[2])
    return out.scatter_add(1, idx, values)


def _torch_moment_fock(f, v1, m1, v2=None, m2=None):
    g = -torch.einsum("bkd,bdkl->bkl", v1, m1)
    if v2 is not None:
        g = g - torch.einsum("bkd,bdkl->bkl", v2, m2)
    return f + 0.5 * (g + g.transpose(-1, -2))


def _torch_moment_rows(a, m, idx=None, size=None, weights=None):
    c = (a[:, None] * m).sum(-1).transpose(1, 2)
    if idx is None:
        return c
    if weights is not None:
        c = c * weights[..., None]
    return _scatter(c, idx, size)


def _torch_segment_sum(values, idx, size, weights=None):
    if weights is not None:
        values = values * (weights if values.dim() == 2
                           else weights[..., None])
    return _scatter(values, idx, size)


def _torch_take(x, idx):
    bidx = torch.arange(x.shape[0], device=x.device)
    return x[bidx.view(-1, *([1] * (idx.dim() - 1))), idx]


def _torch_take2(m, idx):
    bidx = torch.arange(m.shape[0], device=m.device)[:, None, None]
    return m[bidx, idx[:, :, None], idx[:, None, :]]


# ---------------------------------------------------------------------------
# The kernel's launches
# ---------------------------------------------------------------------------


def _fn(name: str, dtype):
    lib = _LIB.lib or build()
    return getattr(lib, f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


def _stream(t) -> tuple:
    index = t.device.index
    return index, torch._C._cuda_getCurrentRawStream(index)


def _c(t):
    return None if t is None else t.contiguous()


def _ptr_of(t):
    return None if t is None else t.data_ptr()


def _launch_fock(f, v1, m1, v2, m2, sym=True):
    """f - (g + g^T) / 2 (sym) or g on the card: one launch."""
    bsz, d1, n = m1.shape[0], m1.shape[1], m1.shape[-1]
    f, v1, m1, v2, m2 = (_c(t) for t in (f, v1, m1, v2, m2))
    d2 = 0 if m2 is None else m2.shape[1]
    out = torch.empty(bsz, n, n, dtype=m1.dtype, device=m1.device)
    index, stream = _stream(m1)
    err = _fn("mqc_moment_fock", m1.dtype)(
        _ptr_of(f), v1.data_ptr(), m1.data_ptr(), d1, _ptr_of(v2),
        _ptr_of(m2), d2, out.data_ptr(), bsz, n, int(sym), index, stream)
    _LIB.check(err, "moment contraction kernel")
    _count(stream, kind="moment_fock" if sym else "moment_contract")
    return out


def _launch_contract(v, m):
    return _launch_fock(None, v, m, None, None, sym=False)


def _launch_rows(a, m, idx=None, size=None, weights=None):
    bsz, d, n = m.shape[0], m.shape[1], m.shape[-1]
    a, m, idx, weights = (_c(t) for t in (a, m, idx, weights))
    rows = n if idx is None else size
    out = torch.empty(bsz, rows, d, dtype=m.dtype, device=m.device)
    index, stream = _stream(m)
    err = _fn("mqc_moment_rows", m.dtype)(
        a.data_ptr(), m.data_ptr(), d, _ptr_of(idx), _ptr_of(weights),
        0 if idx is None else size, out.data_ptr(), bsz, n, index, stream)
    _LIB.check(err, "moment row sum kernel")
    _count(stream, kind="moment_rows")
    return out


def _launch_segment(values, idx, size, weights=None):
    """out (B, size, c) from values (B, n, c) on the card: one launch."""
    bsz, n, c = values.shape
    values, idx, weights = (_c(t) for t in (values, idx, weights))
    out = torch.empty(bsz, size, c, dtype=values.dtype, device=values.device)
    index, stream = _stream(values)
    err = _fn("mqc_segment_sum", values.dtype)(
        values.data_ptr(), idx.data_ptr(), _ptr_of(weights), size,
        out.data_ptr(), bsz, n, c, index, stream)
    _LIB.check(err, "segment sum kernel")
    _count(stream, kind="segment_sum")
    return out


def _launch_sum(rows):
    """The sum of each row of a (rows, len) tensor on the card."""
    rows = rows.contiguous()
    out = torch.empty(rows.shape[0], dtype=rows.dtype, device=rows.device)
    index, stream = _stream(rows)
    err = _fn("mqc_fragment_sum", rows.dtype)(
        rows.data_ptr(), out.data_ptr(), rows.shape[0], rows.shape[1], index,
        stream)
    _LIB.check(err, "fragment sum kernel")
    _count(stream, kind="fragment_sum")
    return out


# ---------------------------------------------------------------------------
# Gradients: each backward is built of these ops and elementwise products
# ---------------------------------------------------------------------------


def _outer(v, g):
    """dm[b, d, k, l] = v[b, k, d] g[b, k, l] (elementwise)."""
    return v.transpose(1, 2)[..., None] * g[:, None]


class _MomentFock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, v1, m1, v2, m2):
        ctx.save_for_backward(v1, m1, v2, m2)
        return _launch_fock(f, v1, m1, v2, m2)

    @staticmethod
    def backward(ctx, dout):
        v1, m1, v2, m2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        # out = f - (g + g^T) / 2
        dg = -0.5 * (dout + dout.transpose(-1, -2))
        grads = [dout if need[0] else None]
        for v, m, nv, nm in ((v1, m1, need[1], need[2]),
                             (v2, m2, need[3], need[4])):
            grads.append(_MomentRows.apply(dg, m, None, None, None)
                         if nv else None)
            grads.append(_outer(v, dg) if nm else None)
        return tuple(grads)


class _Contract(torch.autograd.Function):
    """g = sum_d v m: the backward of a row sum."""

    @staticmethod
    def forward(ctx, v, m):
        ctx.save_for_backward(v, m)
        return _launch_contract(v, m)

    @staticmethod
    def backward(ctx, dg):
        v, m = ctx.saved_tensors
        dv = (_MomentRows.apply(dg, m, None, None, None)
              if ctx.needs_input_grad[0] else None)
        dm = _outer(v, dg) if ctx.needs_input_grad[1] else None
        return dv, dm


class _MomentRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, m, idx, size, weights):
        ctx.save_for_backward(a, m, idx, weights)
        return _launch_rows(a, m, idx, size, weights)

    @staticmethod
    def backward(ctx, dout):
        a, m, idx, weights = ctx.saved_tensors
        # dc[b, k, e]: the output's gradient at each row's segment
        dc = dout if idx is None else _Take.apply(dout, idx)
        if weights is not None:
            dc = dc * weights[..., None]
        da = _Contract.apply(dc, m) if ctx.needs_input_grad[0] else None
        # dm[b, e, k, l] = dc[b, k, e] a[b, k, l]
        dm = _outer(dc, a) if ctx.needs_input_grad[1] else None
        return da, dm, None, None, None


class _SegmentSum(torch.autograd.Function):
    """(B, n, c) values into (B, size, c) segments."""

    @staticmethod
    def forward(ctx, values, idx, size, weights):
        ctx.save_for_backward(idx, weights)
        return _launch_segment(values, idx, size, weights)

    @staticmethod
    def backward(ctx, dout):
        idx, weights = ctx.saved_tensors
        dv = _Take.apply(dout, idx)
        if weights is not None:
            dv = dv * weights[..., None]
        return dv, None, None, None


class _Take(torch.autograd.Function):
    """x[b, idx[b, k], ...] (a gather; its backward a segment sum)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return _torch_take(x, idx)

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        shape = ctx.shape
        flat = dy.reshape(dy.shape[0], dy.shape[1], -1)
        dx = _SegmentSum.apply(flat, idx, shape[1], None)
        return dx.reshape(shape), None


class _Take2(torch.autograd.Function):
    """m[b, idx[b, i], idx[b, j]]; its backward a segment sum over j, then
    over i."""

    @staticmethod
    def forward(ctx, m, idx):
        ctx.save_for_backward(idx)
        ctx.size = m.shape[1]
        return _torch_take2(m, idx)

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        cols = _SegmentSum.apply(dy.transpose(1, 2), idx, ctx.size, None)
        return _SegmentSum.apply(cols.transpose(1, 2), idx, ctx.size,
                                 None), None


class _Broadcast(torch.autograd.Function):
    """x expanded to a shape; its backward a fragment sum over the
    expanded dims."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        ctx.dims = tuple(d for d, (a, b) in enumerate(zip(x.shape, shape))
                         if a == 1 and b != 1)
        return x.expand(shape)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.dims:
            return dy, None
        return _FragmentSum.apply(dy, ctx.dims).reshape(ctx.shape), None


class _FragmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        rows, shape = _as_rows(x, dim)
        ctx.shape, ctx.dims = x.shape, _dims(x, dim)
        return _launch_sum(rows).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        kept = list(dy.shape)
        for d in ctx.dims:
            kept.insert(d, 1)
        return dy.reshape(kept).expand(ctx.shape), None


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def _device(*tensors) -> str:
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("fragment sums: operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no fragment sum kernel for device {dev}")
    return dev.type


def _check(*tensors) -> None:
    """What the kernel takes: float32/float64 of one dtype, the same
    number of fragments."""
    tensors = [t for t in tensors if t is not None]
    dtype, bsz = tensors[0].dtype, tensors[0].shape[0]
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fragment sums take float32/float64, not {dtype}")
    for t in tensors:
        if t.dtype != dtype or t.shape[0] != bsz:
            raise ValueError(
                f"fragment sums: operands of one dtype and batch, got "
                f"{[(tuple(u.shape), u.dtype) for u in tensors]}")


def _check_index(idx, values) -> None:
    if idx.dtype != torch.int64 or idx.shape != values.shape[:2]:
        raise ValueError(f"fragment sums: an int64 index of shape "
                         f"{tuple(values.shape[:2])}, got "
                         f"{tuple(idx.shape)} {idx.dtype}")


def moment_fock(f, v1, m1, v2=None, m2=None):
    """f + (G + G^T) / 2 with G[b, k, l] = -sum_d v1[b, k, d] m1[b, d, k, l]
    - sum_d v2[b, k, d] m2[b, d, k, l], for (B, n, n) f, (B, n, d) v and
    (B, d, n, n) m (v2, m2 optional)."""
    if _device(f, v1, m1, v2, m2) == "cpu":
        return _torch_moment_fock(f, v1, m1, v2, m2)
    _check(f, v1, m1, v2, m2)
    bsz, n = f.shape[0], f.shape[-1]
    for v, m in ((v1, m1), (v2, m2)):
        if v is None:
            continue
        if (m.dim() != 4 or m.shape[2:] != (n, n)
                or v.shape != (bsz, n, m.shape[1])):
            raise ValueError(f"moment_fock: v (B, n, d) and m (B, d, n, n) "
                             f"for f {tuple(f.shape)}, got {tuple(v.shape)} "
                             f"and {tuple(m.shape)}")
    return _MomentFock.apply(f, v1, m1, v2, m2)


def moment_rows(a, m, idx=None, size=None, weights=None):
    """c[b, k, e] = sum_l a[b, k, l] m[b, e, k, l] for (B, n, n) a and
    (B, d, n, n) m, as (B, n, d); with idx (B, n), the rows k summed into
    segments idx[b, k] of `size`, each times weights[b, k] where given, as
    (B, size, d)."""
    if _device(a, m, idx, weights) == "cpu":
        return _torch_moment_rows(a, m, idx, size, weights)
    _check(a, m, weights)
    n = a.shape[-1]
    if a.shape[1:] != (n, n) or m.dim() != 4 or m.shape[2:] != (n, n):
        raise ValueError(f"moment_rows: a (B, n, n) and m (B, d, n, n), got "
                         f"{tuple(a.shape)} and {tuple(m.shape)}")
    if idx is not None:
        _check_index(idx, a)
    return _MomentRows.apply(a, m, idx, size, weights)


def segment_sum(values, idx, size, weights=None):
    """out[b, s] = sum over k with idx[b, k] == s of weights[b, k] *
    values[b, k] for (B, n) or (B, n, c) values: scatter_add's sums, in
    ascending k on a card."""
    if _device(values, idx, weights) == "cpu":
        return _torch_segment_sum(values, idx, size, weights)
    _check(values, weights)
    _check_index(idx, values)
    flat = values if values.dim() > 2 else values[..., None]
    out = _SegmentSum.apply(flat.reshape(*flat.shape[:2], -1), idx, size,
                            weights)
    return out.reshape(values.shape[0], size, *values.shape[2:])


def fragment_sum(x, dim=-1):
    """x.sum(dim); on a card each output summed in an order fixed by the
    sizes of the summed dims alone (`row_sum_reference`)."""
    if _device(x) == "cpu":
        return x.sum(dim)
    _check(x)
    return _FragmentSum.apply(x, dim)


def broadcast(x, shape):
    """x expanded to `shape` (x has its number of dims, size 1 where
    expanded) for a broadcasting op; on a card where x takes a gradient,
    its backward sums the expanded dims in a fixed order (`fragment_sum`),
    elsewhere x itself, which the op broadcasts."""
    if _device(x) == "cuda" and x.requires_grad:
        _check(x)
        if x.dim() != len(shape):
            raise ValueError(f"broadcast: {tuple(x.shape)} to {shape}")
        return _Broadcast.apply(x, tuple(shape))
    return x


def take(x, idx):
    """x[b, idx[b, k], ...] for a (B, n, ...) x and (B, k) idx; on a card
    where x takes a gradient, its backward sums in ascending k."""
    if _device(x, idx) == "cuda" and x.requires_grad:
        _check(x)
        return _Take.apply(x, idx)
    return _torch_take(x, idx)


def take2(m, idx):
    """m[b, idx[b, i], idx[b, j]] for a (B, n, n) m; on a card where m
    takes a gradient, its backward sums in ascending j, then i."""
    if _device(m, idx) == "cuda" and m.requires_grad:
        _check(m)
        return _Take2.apply(m, idx)
    return _torch_take2(m, idx)
