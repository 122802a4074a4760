"""The plain torch expressions that stand where the program calls its
hand-written kernels: sums over a fragment's axes, gathers, segment sums
and D3's pair contraction."""

from __future__ import annotations

import torch


def fragment_sum(x, dim=-1):
    """x summed over `dim` (an int or a tuple of ints)."""
    return x.sum(dim)


def take(x, idx):
    """x[b, idx[b, k]] for a (B, n) or (B, n, ...) x."""
    bidx = torch.arange(x.shape[0], device=x.device)
    return x[bidx.view(-1, *([1] * (idx.dim() - 1))), idx]


def take2(m, idx):
    """m[b, idx[b, i], idx[b, j]] for a (B, n, n) m."""
    bidx = torch.arange(m.shape[0], device=m.device)[:, None, None]
    return m[bidx, idx[:, :, None], idx[:, None, :]]


def segment_sum(values, idx, size, weights=None):
    """out[b, s] = sum over k with idx[b, k] == s of weights[b, k] *
    values[b, k], for (B, n) or (B, n, c) values."""
    if weights is not None:
        values = values * (weights if values.dim() == 2
                           else weights[..., None])
    out = torch.zeros(values.shape[0], size, *values.shape[2:],
                      dtype=values.dtype, device=values.device)
    if values.dim() > 2:
        idx = idx[:, :, None].expand(-1, -1, values.shape[2])
    return out.scatter_add(1, idx, values)


def pair_bilinear(w, grids):
    """c[b, i, j] = sum_ac w[b, i, a] grids[b, i, j, a, c] w[b, j, c]."""
    return torch.einsum("bia,bijac,bjc->bij", w, grids, w)
