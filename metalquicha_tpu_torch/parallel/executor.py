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

A chunk is padded with dummy fragments to a multiple of the mesh's device
count, built into one batch, cut into one piece per device
(`mesh.shard_leading_axis`) and each piece is evaluated on its device by
the calculator bound to it (`XtbCalculator.on`), one device after the
other from the calling thread; the results are joined in mesh order. On a
one-device mesh, the default, nothing is padded, cut or copied. With a
polisher (`methods/xtb/polish.py`) every piece's f32 results are
re-evaluated in f64 on the same device, and fragments whose f32 SCC
missed `rescue_tol` are re-solved from scratch in f64. The JAX package's
TPU batch quantum is not ported: it changes no result.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from ..logging_ import global_logger as logger

from ..methods.xtb.batch import _sizes_for, element_basis
from ..methods.xtb.calculator import XtbCalculator
from ..methods.xtb.multipole import work_elements as multipole_work_elements
from .mesh import fragment_mesh, shard_leading_axis

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

    def _run_chunk(self, members, pad_to, what, energies, gradients, aux_out):
        idxs = [i for i, _ in members]
        tuples = [t for _, t in members]
        # pad the batch to a device-count multiple with dummy fragments
        tuples = tuples + [_DUMMY] * ((-len(tuples)) % self.n_devices)
        frag_data = self.calc.make_batch(tuples, pad_to=pad_to)
        if hasattr(self.calc, "on"):
            pieces = shard_leading_axis(frag_data, self.mesh)
            per = len(tuples) // self.n_devices
            parts = [
                self._evaluate(self.calc.on(device), piece,
                               tuples[k * per : (k + 1) * per], pad_to, what)
                for k, (device, piece) in enumerate(zip(self.mesh.flat,
                                                        pieces))
            ]
        else:  # a host method: the whole chunk in one piece
            parts = [self._evaluate(self.calc, frag_data, tuples, pad_to,
                                    what)]
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
