"""Bucketed, sharded fragment execution.

Counterpart of metalquicha_tpu's `parallel/executor.py`: fragments are
grouped into atom-count buckets with common padded shapes, each bucket is
evaluated in chunks of at most 2e8 / nao^2 fragments (the engine holds
several (B, nao, nao) and the overlap matrix (B, nao, nao, nprim, nprim)
intermediates; a solvation model adds its own largest intermediate to
nao^2: CPCM's (nat nang)^2 point-point matrix, the (nat, nang, nat) SASA
integrand of ALPB/GBSA; GFN2 adds the nine raised 1D tables of its moment
integrals), and the results are scattered back per fragment,
truncated to each fragment's real size.

A chunk is padded with dummy fragments to a multiple of the mesh's slot
count, built into one batch on the calling thread, cut into one piece per
slot and every piece is evaluated at the same time, as XLA runs the JAX
package's shards: slot k has a host thread of its own (made at the first
chunk and kept) and, on a card, a CUDA stream of its own on its device
(two slots on one card get two streams). In its thread, under its device
and stream, slot k copies its piece to its device, evaluates it with the
calculator bound there (`XtbCalculator.on`), polishes it and reads the
results back to the host; the caller joins the results in mesh order. A
slot's exception is raised in the caller with the slot's index and
device; nothing is retried or moved elsewhere. On a one-slot mesh, the
default, there is no thread and no new stream: nothing is padded, cut or
copied. With a polisher (`methods/xtb/polish.py`) every piece's f32
results are re-evaluated in f64 on the same device, and fragments whose
f32 SCC missed `rescue_tol` are re-solved from scratch in f64 (on the
calling thread, after the join). The JAX package's TPU batch quantum is
not ported: it changes no result.

What the slots share: the calculator's settings and solvation model
(read only); the host tables behind `make_batch` (`batch.element_basis`,
`dispersion_d3`'s `_element_ref_arrays` and `full_pair_table`, filled for
the chunk's elements by the caller's `make_batch` before any slot starts,
so a polisher's batch in a slot only reads them; `load_overlay`, which
clears them, must not run during a `run`); the kernel's build and launch
counts (`ops/jacobi_eigh.py`, `ops/sp2.py`, under locks). Slots do not
log. Grad mode is per thread: `energies` and `gradients` set their own.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..logging_ import global_logger as logger

from ..methods.xtb.batch import _sizes_for, element_basis
from ..methods.xtb.calculator import XtbCalculator
from ..methods.xtb.multipole import work_elements as multipole_work_elements
from .mesh import cut_leading_axis, fragment_mesh, place, shard_leading_axis

#: atom-count bucket ladder; shells/AOs scale with atoms per bucket
ATOM_BUCKETS = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

#: cap on B * (nao^2 + the solvation model's work elements + the GFN2
#: moment integrals') per dispatched chunk
MAX_CHUNK_ELEMENTS = 2.0e8

_DUMMY = (np.array([1]), np.zeros((1, 3)), 0, 2)  # lone H (doublet) filler


def _bucket_of(n_atoms: int) -> int:
    for b in ATOM_BUCKETS:
        if n_atoms <= b:
            return b
    return int(np.ceil(n_atoms / 64.0) * 64)


def _frag_tuple(frag):
    if hasattr(frag, "numbers"):
        return (
            np.asarray(frag.numbers),
            np.asarray(frag.coords),
            getattr(frag, "charge", 0),
            getattr(frag, "multiplicity", 1),
        )
    return frag


def _host(x) -> np.ndarray:
    """A calculator's result on the host (the placeholder methods return
    NumPy arrays already)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _sizes(numbers, variant):
    nsh = nao = 0
    for z in numbers:
        eb = element_basis(int(z), variant)
        nsh += eb.n_shells
        nao += eb.n_ao
    return nsh, nao


class FragmentExecutor:
    """Evaluates lists of fragments on the device mesh (by default a GFN1
    `XtbCalculator` on the card and a mesh of that one device; any
    calculator of the factory).

    what='energy'  -> (energies, aux)
    what='gradient'-> (energies, gradients, aux); gradients are returned
                      per fragment, truncated to each fragment's real size.
    """

    def __init__(self, calculator: XtbCalculator = None, mesh=None,
                 polisher=None, rescue_tol=None):
        self.calc = calculator or XtbCalculator()
        #: the calculator's own device unless a mesh is given (the driver
        #: builds one over every visible card); a method that computes on
        #: the host (the placeholders) takes no device
        self.mesh = mesh if mesh is not None else fragment_mesh(
            [getattr(self.calc, "device", "cpu")])
        self.n_devices = self.mesh.size
        #: optional HostPolisher (methods/xtb/polish.py): when set, every
        #: chunk's f32 results are re-evaluated in f64 from the
        #: f32-converged charges, so assembled energies, gradients and FD
        #: Hessians match the all-f64 path.
        self.polisher = polisher
        #: residual threshold above which a fragment's f32 SCC is
        #: considered failed and re-solved from scratch in f64
        #: (polisher.rescue). None disables; the driver sets it to its own
        #: convergence gate so no fragment the rescue could save errors out.
        self.rescue_tol = rescue_tol
        #: per mesh slot, a one-thread pool and (on a card) a CUDA stream,
        #: made at the first chunk of a mesh of more than one slot
        self._slots = None

    def _buckets(self, fragments):
        groups = defaultdict(list)
        for i, frag in enumerate(fragments):
            t = _frag_tuple(frag)
            groups[_bucket_of(len(t[0]))].append((i, t))
        return groups

    def _pad_shapes_for(self, bucket_atoms, members):
        """Static (nat, nsh, nao) for a bucket: scale worst-case per atom."""
        max_nsh = max_nao = 0
        for _, (numbers, *_rest) in members:
            nsh, nao = _sizes(numbers, self.calc.variant)
            max_nsh, max_nao = max(max_nsh, nsh), max(max_nao, nao)
        # round shells/AOs up to the bucket's worst case with 2/atom slack
        nsh = max(max_nsh, 2 * bucket_atoms)
        nao = max(max_nao, int(2.5 * bucket_atoms) + 1)
        return bucket_atoms, nsh, nao

    def _multipoles(self) -> bool:
        settings = getattr(self.calc, "settings", None)
        return settings is not None and settings.multipoles

    def _max_chunk(self, pad_to, nprim: int = 0) -> int:
        """Most fragments of padded shape (nat, nsh, nao) per chunk, a
        multiple of the device count; nprim is the primitive axis of a
        GFN2 bucket (its moment tables)."""
        nat, _nsh, nao = pad_to
        per_fragment = nao * nao
        if getattr(self.calc, "solvation", None) is not None:
            per_fragment += self.calc.solvation.work_elements(nat)
        if nprim:
            per_fragment += multipole_work_elements(nao, nprim)
        max_b = int(MAX_CHUNK_ELEMENTS // per_fragment)
        return max(self.n_devices, max_b - max_b % self.n_devices)

    def run(self, fragments, what: str = "energy"):
        n = len(fragments)
        t0 = time.time()
        n_done = 0
        energies = np.zeros(n)
        gradients = [None] * n if what == "gradient" else None
        aux_out = {
            "charges": [None] * n,
            "dipole": np.zeros((n, 3)),
            "scf_residual": np.zeros(n),
        }

        for bucket_atoms, members in sorted(self._buckets(fragments).items()):
            pad_to = self._pad_shapes_for(bucket_atoms, members)
            if self._multipoles():
                nprim = _sizes_for([t[0] for _, t in members],
                                   self.calc.variant)[3]
                max_b = self._max_chunk(pad_to, nprim)
            else:
                max_b = self._max_chunk(pad_to)
            for start in range(0, len(members), max_b):
                chunk = members[start : start + max_b]
                self._run_chunk(chunk, pad_to, what, energies, gradients,
                                aux_out)
                n_done += len(chunk)
                if n > 1:
                    logger.info(
                        f"  Processed {n_done}/{n} fragments "
                        f"[{time.time() - t0:.2f} s]"
                    )

        if what == "gradient":
            return energies, gradients, aux_out
        return energies, aux_out

    def _evaluate(self, calc, frag_data, tuples, pad_to, what):
        """One piece on its device: host (e, g or None, dipole, charges,
        residual), polished when a polisher is set."""
        if what == "gradient":
            e, g, aux = calc.gradients(frag_data)
        else:
            e, aux = calc.energies(frag_data)
            g = None
        if self.polisher is not None:
            e, g, aux = self.polisher.polish(
                tuples, pad_to, aux["shell_charges"], what
            )
        return (_host(e), None if g is None else _host(g),
                _host(aux["dipole"]), _host(aux["charges"]),
                _host(aux["scf_residual"]))

    def _slot_pools(self):
        """[(one-thread pool, CUDA stream or None)] per mesh slot."""
        if self._slots is None:
            self._slots = [
                (ThreadPoolExecutor(1, thread_name_prefix=f"mqc-slot{k}"),
                 torch.cuda.Stream(device) if device.type == "cuda"
                 else None)
                for k, device in enumerate(self.mesh.flat)
            ]
        return self._slots

    def close(self) -> None:
        """Stop the slots' threads; a later run makes them again."""
        if self._slots is not None:
            for pool, _stream in self._slots:
                pool.shutdown()
            self._slots = None

    def _run_slot(self, device, stream, source, piece, tuples, pad_to, what):
        """One slot's piece, in its thread: copied to its device and
        evaluated on its stream (`source`: the stream that made the batch,
        which the slot's stream waits for), the results on the host."""
        with contextlib.ExitStack() as ctx:
            if stream is not None:
                ctx.enter_context(torch.cuda.device(device))
                ctx.enter_context(torch.cuda.stream(stream))
                if source is not None:
                    stream.wait_stream(source)
            try:
                return self._evaluate(self.calc.on(device),
                                      place(piece, device), tuples, pad_to,
                                      what)
            finally:
                if stream is not None:
                    # nothing of this slot still reads the caller's batch
                    # when the caller frees it, on success or failure
                    stream.synchronize()

    def _run_pieces(self, frag_data, tuples, pad_to, what):
        """Every slot's piece at once; the results in mesh order."""
        n = self.n_devices
        per = len(tuples) // n
        on = frag_data.coords.device
        source = (torch.cuda.current_stream(on) if on.type == "cuda"
                  else None)
        futures = [
            pool.submit(self._run_slot, device, stream, source, piece,
                        tuples[k * per : (k + 1) * per], pad_to, what)
            for k, (device, (pool, stream), piece) in enumerate(zip(
                self.mesh.flat, self._slot_pools(),
                cut_leading_axis(frag_data, n)))
        ]
        parts = []
        for k, (device, fut) in enumerate(zip(self.mesh.flat, futures)):
            try:
                parts.append(fut.result())
            except Exception as exc:
                for other in futures[k + 1:]:  # let every slot finish
                    other.exception()
                raise RuntimeError(
                    f"mesh slot {k} ({device}) failed: "
                    f"{type(exc).__name__}: {exc}") from exc
        return parts

    def _run_chunk(self, members, pad_to, what, energies, gradients, aux_out):
        idxs = [i for i, _ in members]
        tuples = [t for _, t in members]
        # pad the batch to a device-count multiple with dummy fragments
        tuples = tuples + [_DUMMY] * ((-len(tuples)) % self.n_devices)
        frag_data = self.calc.make_batch(tuples, pad_to=pad_to)
        if not hasattr(self.calc, "on"):  # a host method: one piece
            parts = [self._evaluate(self.calc, frag_data, tuples, pad_to,
                                    what)]
        elif self.n_devices == 1:
            (piece,) = shard_leading_axis(frag_data, self.mesh)
            parts = [self._evaluate(self.calc.on(self.mesh.flat[0]), piece,
                                    tuples, pad_to, what)]
        else:
            parts = self._run_pieces(frag_data, tuples, pad_to, what)
        if len(parts) == 1:
            e, g, dip, chg, res = parts[0]
        else:
            e, g, dip, chg, res = (
                None if p[0] is None else np.concatenate(p)
                for p in zip(*parts)
            )

        # f64 rescue: fragments whose f32 SCC failed to reach the driver's
        # convergence gate (slow-contracting GMBE coincident-cap terms,
        # charged clusters) are re-solved from scratch in f64 instead of
        # hard-erroring the whole run. The all-f64 path never triggers this.
        if self.polisher is not None and self.rescue_tol is not None:
            bad = [s for s in range(len(idxs)) if res[s] > self.rescue_tol]
            if bad:
                logger.info(
                    f"  f64 host rescue: {len(bad)} fragment(s) with f32 "
                    f"SCC residual > {self.rescue_tol:.1e}"
                )
                e_r, g_r, aux_r = self.polisher.rescue(
                    [tuples[s] for s in bad], pad_to, what
                )
                e, dip, chg, res = (
                    np.array(e), np.array(dip), np.array(chg), np.array(res)
                )
                if g is not None:
                    g = np.array(g)
                for j, s in enumerate(bad):
                    e[s] = e_r[j]
                    dip[s] = aux_r["dipole"][j]
                    chg[s] = aux_r["charges"][j]
                    res[s] = aux_r["scf_residual"][j]
                    if g is not None:
                        g[s] = g_r[j]

        for slot, i in enumerate(idxs):
            n_at = len(tuples[slot][0])
            energies[i] = e[slot]
            aux_out["dipole"][i] = dip[slot]
            aux_out["charges"][i] = chg[slot][:n_at]
            aux_out["scf_residual"][i] = res[slot]
            if g is not None:
                gradients[i] = g[slot][:n_at]
