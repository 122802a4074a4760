"""Bucketed fragment execution on one device.

Counterpart of metalquicha_tpu's `parallel/executor.py`: fragments are
grouped into atom-count buckets with common padded shapes, each bucket is
evaluated in chunks of at most 2e8 / nao^2 fragments (the engine holds
several (B, nao, nao) and the overlap matrix (B, nao, nao, nprim, nprim)
intermediates; a solvation model adds its own largest intermediate to
nao^2: CPCM's (nat nang)^2 point-point matrix, the (nat, nang, nat) SASA
integrand of ALPB/GBSA; GFN2 adds the nine raised 1D tables of its moment
integrals), and the results are scattered back per fragment,
truncated to each fragment's real size. The mesh, the f64 host polisher and
rescue, and the TPU batch quantum are not ported.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from ..logging_ import global_logger as logger

from ..methods.xtb.batch import _sizes_for, element_basis
from ..methods.xtb.calculator import XtbCalculator
from ..methods.xtb.multipole import work_elements as multipole_work_elements

#: atom-count bucket ladder; shells/AOs scale with atoms per bucket
ATOM_BUCKETS = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

#: cap on B * (nao^2 + the solvation model's work elements + the GFN2
#: moment integrals') per dispatched chunk
MAX_CHUNK_ELEMENTS = 2.0e8


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
    """Evaluates lists of fragments on the calculator's device (by default
    a GFN1 `XtbCalculator` on the card; any calculator of the factory).

    what='energy'  -> (energies, aux)
    what='gradient'-> (energies, gradients, aux); gradients are returned
                      per fragment, truncated to each fragment's real size.
    """

    def __init__(self, calculator: XtbCalculator = None):
        self.calc = calculator or XtbCalculator()

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
        """Most fragments of padded shape (nat, nsh, nao) per chunk; nprim
        is the primitive axis of a GFN2 bucket (its moment tables)."""
        nat, _nsh, nao = pad_to
        per_fragment = nao * nao
        if getattr(self.calc, "solvation", None) is not None:
            per_fragment += self.calc.solvation.work_elements(nat)
        if nprim:
            per_fragment += multipole_work_elements(nao, nprim)
        return max(1, int(MAX_CHUNK_ELEMENTS // per_fragment))

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

    def _run_chunk(self, members, pad_to, what, energies, gradients, aux_out):
        idxs = [i for i, _ in members]
        tuples = [t for _, t in members]
        frag_data = self.calc.make_batch(tuples, pad_to=pad_to)
        if what == "gradient":
            e, g, aux = self.calc.gradients(frag_data)
            g = _host(g)
        else:
            e, aux = self.calc.energies(frag_data)
            g = None
        e = _host(e)
        dip = _host(aux["dipole"])
        chg = _host(aux["charges"])
        res = _host(aux["scf_residual"])

        for slot, i in enumerate(idxs):
            n_at = len(tuples[slot][0])
            energies[i] = e[slot]
            aux_out["dipole"][i] = dip[slot]
            aux_out["charges"][i] = chg[slot][:n_at]
            aux_out["scf_residual"][i] = res[slot]
            if g is not None:
                gradients[i] = g[slot][:n_at]
