"""Device mesh utilities.

Counterpart of metalquicha_tpu's `parallel/mesh.py`. Upstream metalquicha
distributes fragments through a 3-tier MPI request/reply hierarchy (global
coordinator / group coordinators / node workers). The JAX package
collapses that into a batch axis sharded over a `jax.sharding.Mesh`; the
port does the same by hand: a `FragmentMesh` is an array of
`torch.device` (a device may fill several slots), the executor cuts a
padded chunk's fragment tuples into one piece per slot in mesh order and
each slot's worker process builds and evaluates its piece
(`parallel/slot_worker.py`), and the executor joins the per-piece
results in the same order. `shard_leading_axis` cuts a built batch the
same way (the one-slot path takes its one piece from it). Fragments are
independent, so there is nothing to reduce across devices and no
collective to write.

Upstream's topology knobs (`global_groups` / `nodes_per_group`) map to mesh
axis factors: a 2D ('group', 'frag') mesh whose outer axis has
`global_groups` slots (or n_devices / nodes_per_group). The batch axis is
cut over BOTH axes, so the results are the same; the layout only mirrors
the requested group topology.
"""

from __future__ import annotations

import numpy as np
import torch

FRAG_AXIS = "frag"
GROUP_AXIS = "group"


def _resolve_groups(n_devices, global_groups=None, nodes_per_group=None):
    """Number of groups from the reference's mutually-exclusive knobs."""
    if global_groups:
        g = int(global_groups)
    elif nodes_per_group:
        g = max(1, n_devices // max(1, int(nodes_per_group)))
    else:
        return 1
    g = max(1, min(g, n_devices))
    while n_devices % g:  # groups must tile the device count
        g -= 1
    return g


class FragmentMesh:
    """An array of devices with named axes (the part of
    `jax.sharding.Mesh` the executor uses).

    devices: object array of `torch.device`, shape (n,) or (g, n / g); a
    device may appear more than once (several slots on one card).
    """

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-d device array for axes {axis_names}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list:
        """The devices in mesh (row-major) order."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"FragmentMesh({self.shape}, {[str(d) for d in self.flat]})"


def fragment_mesh(devices=None, global_groups=None,
                  nodes_per_group=None) -> FragmentMesh:
    """Mesh over all visible CUDA devices (or the given ones).

    Without topology knobs: 1D ('frag',). With `global_groups` /
    `nodes_per_group`: 2D ('group', 'frag') with the group count tiling the
    device count (rounded down to the nearest divisor, like the reference's
    chunked round-robin assignment). `devices=None` raises when no CUDA
    device is present: there is no fallback to the CPU, which a caller
    asks for by passing `devices=["cpu"]`.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass devices=['cpu'] for a mesh on "
                "the CPU"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        devs[i] = torch.device(d)
    if devs.size == 0:
        raise ValueError("a mesh needs at least one device")
    g = _resolve_groups(devs.size, global_groups, nodes_per_group)
    if g <= 1:
        return FragmentMesh(devs, (FRAG_AXIS,))
    return FragmentMesh(devs.reshape(g, devs.size // g),
                        (GROUP_AXIS, FRAG_AXIS))


def _to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`; a tensor already there is returned as it is, and a
    view broadcast along the batch axis (the shared D3 pair table) stays
    one, so only its single row is copied."""
    if x.device == device:
        return x
    if x.dim() and x.shape[0] > 1 and x.stride(0) == 0:
        return x[:1].to(device).expand(x.shape)
    return x.to(device)


def cut_leading_axis(frag, n: int) -> list:
    """A FragmentData (any NamedTuple of batch-first tensors) cut along its
    leading axis into n pieces, views where the batch lies; the batch size
    must be a multiple of n. For n = 1 the batch itself is the piece."""
    bsz = frag[0].shape[0]
    if bsz % n:
        raise ValueError(
            f"batch of {bsz} is not a multiple of the mesh's {n} devices"
        )
    if n == 1:
        return [frag]
    per = bsz // n
    return [type(frag)(*(x[k * per : (k + 1) * per] for x in frag))
            for k in range(n)]


def place(piece, device: torch.device):
    """A NamedTuple of tensors on `device` (see `_to_device`)."""
    return type(piece)(*(_to_device(x, device) for x in piece))


def shard_leading_axis(frag, mesh: FragmentMesh) -> list:
    """Cut a FragmentData along its leading axis into one piece per mesh
    device, in mesh order, each piece on its device. The batch size must be
    a multiple of the mesh size. On a one-device mesh the batch itself is
    the piece: nothing is sliced."""
    return [place(piece, device) for piece, device in
            zip(cut_leading_axis(frag, mesh.size), mesh.flat)]


def replicate(tree, mesh: FragmentMesh) -> list:
    """A copy of a NamedTuple of tensors on every mesh device, in mesh
    order."""
    return [place(tree, device) for device in mesh.flat]
