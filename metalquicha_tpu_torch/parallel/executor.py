"""Bucketed, sharded fragment execution.

Counterpart of metalquicha_tpu's `parallel/executor.py`: fragments are
grouped into atom-count buckets with common padded shapes, each bucket is
evaluated in chunks of at most 2e8 / nao^2 fragments per mesh slot (the
engine holds
several (B, nao, nao) and the overlap matrix (B, nao, nao, nprim, nprim)
intermediates; a solvation model adds its own largest intermediate to
nao^2: CPCM's (nat nang)^2 point-point matrix, the (nat, nang, nat) SASA
integrand of ALPB/GBSA; GFN2 adds the nine raised 1D tables of its moment
integrals), and the results are scattered back per fragment,
truncated to each fragment's real size.

A chunk is padded with dummy fragments to a multiple of the mesh's slot
count and cut, in mesh order, into one piece of fragment tuples per slot
(slot k takes tuples[k * per : (k + 1) * per]); every piece is evaluated
at the same time, as XLA runs the JAX package's shards: on a mesh of more
than one slot each slot has a worker process of its own
(`parallel/slot_worker.py`: its own interpreter, and on a card its own
CUDA context on the slot's device), which builds its piece's batch with
`make_batch`, evaluates it with its own copy of the calculator, polishes
it and sends the results back as host arrays; the caller joins them in
mesh order. The workers start at the first chunk of such a mesh, after
the caller has built the kernels they will launch (each loads that
build), live as long as the executor, across chunks and `run` calls, and
stop in `close()` (or when the executor is collected, or the process
exits). Their Jacobi and Fermi launches and SP2 calls are added to the
caller's counts (`ops/jacobi_eigh.launches`, `ops/fermi_fill.launches`,
`ops/sp2.calls`).

What a worker computes with is sent, not shared: the calculator's
variant, settings, dtype and solvation model, the polisher's k, the
kernel's build directory and the host parameter tables (the GFN1/GFN2
and solvation overlays, one loaded at run time with `load_overlay`, a
fit's tables, the D3 pair overrides). They are sent at the start, and
the executor compares them with the caller's before every chunk and
sends them again where they differ, so a worker never computes with
tables other than the caller's.

A slot that fails (an exception in its worker, a worker that dies or
does not start) raises in the caller with the slot's index and device,
once the other slots have answered, died, or had `slot_worker.GRACE`
seconds more; every worker is then stopped, and the next chunk starts
new ones. Nothing is retried or moved elsewhere. `timeout` (seconds, None
by default) bounds the wait for a chunk's answers too. On a one-slot mesh,
the default, there is no process: the batch is built on the calling
thread and nothing is padded, cut or copied. With a polisher
(`methods/xtb/polish.py`) every piece's f32 results are re-evaluated in
f64 on the same device, and fragments whose f32 SCC missed `rescue_tol`
are re-solved from scratch in f64 (in the caller, after the join). The
JAX package's TPU batch quantum is not ported: it changes no result.

Device memory. The element cap above is the JAX package's guard; the
port's eager tensors hold far more bytes per counted element than XLA's
fused programs, so on a card a chunk is also held to the device's bytes:
`fragment_bytes` models the peak device memory one fragment of a padded
shape takes in an energy or a gradient evaluation (the overlap's
(nao, nao, nprim, nprim) tables, (nao, nao) matrices, ATM's
(nat, nat, nat) triples, the solvation model's and GFN2's moment
intermediates), and `device_budget` is what a slot may plan for:
BUDGET_SHARE of the device's free bytes, the SCC graph cache's held
out but for the calling thread's own pool (`methods/xtb/scc_graph.py`),
taken once per `run`, split
evenly between the mesh slots that share the device. A one-slot mesh cuts
its chunks to min(element cap, budget / model bytes); on a mesh of
several slots every worker applies the same rule on its own device and
evaluates its piece in parts of at most that many fragments. The model
holds one chunk's own SCC graph cache entries, its call's stages among
them (`scc_entry_bytes`); the
entries a run made for its earlier chunks are held in the plan too: they
stay only while they fit beside the next chunk in the budget, and the
calling thread's graph pool only while a new shape's eager warm-up fits
beside its idle blocks (`make_room`); chunks of one shape replay the
graphs the first captured (`scc_graph.planned`), and a run whose chunks
the budget cut gives the pool back at its end. A fragment the budget
cannot hold raises `DeviceMemoryError`, naming its shape;
nothing moves to the CPU. On the CPU no budget is taken and chunks are
cut as the JAX package cuts them.
"""

from __future__ import annotations

import time
import weakref
from collections import defaultdict

import numpy as np
import torch

from ..logging_ import global_logger as logger

from ..methods.xtb import scc_graph
from ..methods.xtb.batch import _sizes_for, element_basis
from ..methods.xtb.calculator import XtbCalculator
from ..methods.xtb.multipole import work_elements as multipole_work_elements
from ..ops import anderson_window, batched_eigh, fermi_fill, fragment_gemm
from ..ops import fragment_reduce
from ..ops import jacobi_eigh
from . import slot_worker
from .mesh import fragment_mesh, shard_leading_axis
from .slot_worker import evaluate_piece

#: atom-count bucket ladder; shells/AOs scale with atoms per bucket
ATOM_BUCKETS = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

#: cap on B * (nao^2 + the solvation model's work elements + the GFN2
#: moment integrals') per slot's piece of a chunk
MAX_CHUNK_ELEMENTS = 2.0e8

_DUMMY = (np.array([1]), np.zeros((1, 3)), 0, 2)  # lone H (doublet) filler

#: share of a device's free bytes that one `run` plans for
BUDGET_SHARE = 0.85

#: `fragment_bytes`' coefficients: the peak elements one fragment holds
#: per element of the overlap's (nao, nao, nprim, nprim) table ("table"),
#: an (nao, nao) matrix ("matrix"), ATM's (nat, nat, nat) triple tensor
#: ("triple", where disp_s9 != 0), the solvation model's `work_elements`
#: and GFN2's moment `work_elements`. Fit to
#: `torch.cuda.max_memory_allocated` on an NVIDIA H100 80GB HBM3 (700 W)
#: by tools/memory_probe_torch.py --calibrate; the model lies between 1x
#: and 2x the measured peak at every calibrated shape.
BYTE_MODEL = {
    "energy": {"table": 18.0, "matrix": 32.0, "triple": 10.5,
               "solvation": 7.0, "moments": 3.8},
    "gradient": {"table": 66.0, "matrix": 96.0, "triple": 24.0,
                 "solvation": 12.5, "moments": 16.5},
}


class DeviceMemoryError(RuntimeError):
    """One fragment of a bucket needs more device memory than the slot's
    budget holds."""


def fragment_bytes(calc, pad_to, nprim: int, what: str,
                   polished: bool = False) -> float:
    """Modelled peak device bytes of one fragment of padded shape
    (nat, nsh, nao) with nprim primitives per AO, in `calc.energies`
    (what="energy") or `calc.gradients` (what="gradient"). The energy
    holds one phase's intermediates at a time (the overlap, GFN2's moment
    tables, ATM or the solvation model, whichever is largest); a gradient
    keeps every phase's graph until its backward pass. Elements are of
    the calculator's dtype, or float64 where a polisher re-evaluates
    (`polished`). Both hold the SCC graph cache's entry for the shape
    (`scc_entry_bytes`) beside them."""
    nat, _nsh, nao = pad_to
    c = BYTE_MODEL[what]
    settings = calc.settings
    parts = [c["table"] * nao * nao * nprim * nprim]
    if settings.multipoles:
        parts.append(c["moments"] * multipole_work_elements(nao, nprim))
    if settings.disp_s9:
        parts.append(c["triple"] * nat ** 3)
    if getattr(calc, "solvation", None) is not None:
        parts.append(c["solvation"] * calc.solvation.work_elements(nat))
    held = max(parts) if what == "energy" else sum(parts)
    size = 8 if polished else torch.finfo(calc.dtype).bits // 8
    return (size * (held + c["matrix"] * nao * nao)
            + scc_entry_bytes(calc, pad_to, nprim, polished))


def scc_entry_bytes(calc, pad_to, nprim: int,
                    polished: bool = False) -> float:
    """Bytes one fragment's share of a call's SCC graph cache entries keeps
    from its call to the end of the run and beyond (`scc_graph`): the
    loop's entry (copies of its inputs: H0, S, the orthogonalizer's two
    matrices, gamma, the solvation kernel, GFN2's moment integrals; its
    state, the two Anderson windows), the stage entries of the operand
    build (the batch's fields and coordinates in, the loop's inputs out)
    and of the functional (the batch, coordinates and converged state in;
    energies, gradients and aux out), and on a card cuSOLVER's workspace
    for the (nao, nao) eighs, which the loop's, the orthogonalizer's and
    the functional's statuses share (`batched_eigh._shared_workspace`), and
    with ALPB the one for its (3, 3) covariances (its query's bytes). The
    graphs' pool is the functional's peak, which the byte model's
    coefficients hold; D3's pair table, one broadcast copy per stage entry
    (116 KB), is left out. A polished calculator also keeps the float64
    polish's entries. nprim: primitives per AO."""
    nat, nsh, nao = pad_to
    settings = calc.settings
    nx = nsh + 9 * nat if settings.multipoles else nsh
    loop_inputs = 4 * nao * nao + nsh * nsh
    if getattr(calc, "solvation", None) is not None:
        loop_inputs += nat * nat
    if settings.multipoles:
        loop_inputs += 9 * nao * nao
    # a stage's copy of the batch's fields: the primitive tables (five
    # values per primitive), the AO, shell and atom tables (D3's reference
    # tables, GFN2's AES table) and the outputs' rows
    fields = nao * (5 * nprim + 8) + nsh * 12 + nat * 48
    # the operand build's outputs and the loop's copies of them, the loop's
    # state and fields, the two stages' fields
    elements = (2 * loop_inputs + (2 * settings.broyden_memory + 4) * nx
                + 2 * nao + 4 * nsh + nat + 2 * fields)
    dtypes = [calc.dtype] + ([torch.float64] if polished else [])
    out = 0.0
    alpb = getattr(getattr(calc, "solvation", None), "alpb", False)
    for dtype in dtypes:
        out += elements * (torch.finfo(dtype).bits // 8)
        if calc.device.type == "cuda":
            out += batched_eigh.workspace_bytes(dtype, nao, calc.device)
            if alpb:  # the eigenvalues of ALPB's 3x3 covariances
                out += batched_eigh.workspace_bytes(dtype, 3, calc.device)
    return out


def device_budget(device, sharing: int = 1):
    """Bytes one mesh slot may plan for on `device`: BUDGET_SHARE of the
    device's free bytes and of the blocks this process's allocator holds
    unused, split between the `sharing` slots on the device; None on a
    device that is not a card (no byte cap there).

    The SCC graph cache's bytes other than the calling thread's pool are
    held out: the unused blocks of other threads' graph pools serve only
    their graphs (`scc_graph.idle_pool_bytes`), and its buffers and
    workspaces are allocated, so neither free nor unused. The calling
    thread's own pool is the run's: its captures and replays reuse its
    blocks, and `make_room` gives them back before an eager warm-up that
    would not fit beside them."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device)
              - scc_graph.idle_pool_bytes(device, own=False))
    return int(BUDGET_SHARE * (free + max(cached, 0)) / sharing)


def make_room(budget: int, mark: int, shape, planned: float, last,
              device=None):
    """Before a piece of `shape` (its padded shape and its size) modelled
    at `planned` bytes, in a run whose budget was taken after SCC graph
    cache serial `mark`: the graphs the run cached since stay if their
    bytes fit beside the piece in the budget, else they are evicted. A
    piece of the last piece's shape replays the graphs that piece made and
    allocates none, so it peaks where that piece did. A piece of a new
    shape runs its stages once eagerly, outside the graph pool: where the
    calling thread's pool on `device` holds more idle blocks than fit
    beside it, every entry on that pool is evicted and its blocks given
    back (`scc_graph.evict_own_pool`). Returns `shape`, the next call's
    `last`."""
    if shape == last:
        return shape
    if scc_graph.held_since(mark) + planned > budget:
        scc_graph.evict_since(mark)
    if device is not None and torch.device(device).type == "cuda" and (
            scc_graph.held_since(mark) + planned
            + scc_graph.own_idle_bytes(device) > budget):
        scc_graph.evict_own_pool(device)
    return shape


def byte_cap(budget: int, per_fragment: float, pad_to, nprim: int,
             what: str) -> int:
    """Most fragments of one piece that `budget` bytes hold; raises
    DeviceMemoryError where not even one does."""
    fit = int(budget // per_fragment)
    if fit < 1:
        nat, nsh, nao = pad_to
        raise DeviceMemoryError(
            f"one fragment of padded shape (nat, nsh, nao, nprim) = "
            f"({nat}, {nsh}, {nao}, {nprim}) needs {per_fragment:.4g} "
            f"bytes of device memory for its {what}, more than the "
            f"slot's budget of {budget} bytes")
    return fit


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
                 polisher=None, rescue_tol=None, timeout=None):
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
        #: seconds to wait for the slots' answers to a chunk (or to their
        #: start); None waits as long as the workers live
        self.timeout = timeout
        #: the `slot_worker.SlotWorker` of every mesh slot, started at the
        #: first chunk of a mesh of more than one slot
        self.workers = []
        #: the configuration the workers hold (`slot_worker.configuration`)
        self._config = None
        #: `run` calls so far; a worker takes its budget once per run
        self.runs = 0
        #: the byte budget of the last run on a one-slot card mesh (None
        #: elsewhere; each worker reports its own in `stats`)
        self.last_budget = None
        weakref.finalize(self, slot_worker.stop_all, self.workers)

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
        """Most fragments of padded shape (nat, nsh, nao) per chunk: the
        cap holds for each slot's piece, so a chunk is the slot count
        times the most fragments one piece may hold; nprim is the
        primitive axis of a GFN2 bucket (its moment tables)."""
        nat, _nsh, nao = pad_to
        per_fragment = nao * nao
        if getattr(self.calc, "solvation", None) is not None:
            per_fragment += self.calc.solvation.work_elements(nat)
        if nprim:
            per_fragment += multipole_work_elements(nao, nprim)
        return self.n_devices * max(1, int(MAX_CHUNK_ELEMENTS
                                           // per_fragment))

    def fragment_bytes(self, pad_to, members, what: str) -> float:
        """`fragment_bytes` for a bucket's members ((index, tuple) pairs)
        with this executor's calculator."""
        nprim = _sizes_for([t[0] for _, t in members], self.calc.variant)[3]
        return fragment_bytes(self.calc, pad_to, nprim, what,
                              self.polisher is not None)

    def _budget(self):
        """The byte budget of this run's one piece per chunk, or None:
        a mesh of several slots leaves it to each worker, a host method
        and a CPU slot have none."""
        if self.n_devices != 1 or not hasattr(self.calc, "on"):
            return None
        return device_budget(self.mesh.flat[0])

    def run(self, fragments, what: str = "energy"):
        n = len(fragments)
        t0 = time.time()
        self.runs += 1
        budget = self.last_budget = self._budget()
        mark, last = scc_graph.mark(), None
        n_done = 0
        energies = np.zeros(n)
        gradients = [None] * n if what == "gradient" else None
        aux_out = {
            "charges": [None] * n,
            "dipole": np.zeros((n, 3)),
            "scf_residual": np.zeros(n),
        }

        # the chunks' graph pools are the run's to plan (`make_room`)
        cut = False
        with scc_graph.planned():
            for bucket_atoms, members in sorted(
                    self._buckets(fragments).items()):
                pad_to = self._pad_shapes_for(bucket_atoms, members)
                if self._multipoles() or budget is not None:
                    nprim = _sizes_for([t[0] for _, t in members],
                                       self.calc.variant)[3]
                if self._multipoles():
                    max_b = self._max_chunk(pad_to, nprim)
                else:
                    max_b = self._max_chunk(pad_to)
                if budget is not None:
                    per = fragment_bytes(self.calc, pad_to, nprim, what,
                                         self.polisher is not None)
                    fit = byte_cap(budget, per, pad_to, nprim, what)
                    cut = cut or fit < min(max_b, len(members))
                    max_b = min(max_b, fit)
                for start in range(0, len(members), max_b):
                    chunk = members[start : start + max_b]
                    if budget is not None:
                        last = make_room(budget, mark, (pad_to, len(chunk)),
                                         len(chunk) * per, last,
                                         self.mesh.flat[0])
                    self._run_chunk(chunk, pad_to, what, energies,
                                    gradients, aux_out)
                    n_done += len(chunk)
                    if n > 1:
                        logger.info(
                            f"  Processed {n_done}/{n} fragments "
                            f"[{time.time() - t0:.2f} s]"
                        )
        if cut:
            # chunks cut to the budget captured graphs sized to the card;
            # their pool goes back with the run, for other work and other
            # processes on the card
            scc_graph.evict_own_pool(self.mesh.flat[0])

        if what == "gradient":
            return energies, gradients, aux_out
        return energies, aux_out

    def close(self) -> None:
        """Stop the slots' workers; a later run starts them again."""
        slot_worker.stop_all(self.workers)
        self._config = None

    def _fail(self, k, exc):
        """Stop every worker and raise slot k's failure."""
        slot_worker.stop_all(self.workers, kill=True)
        self._config = None
        raise RuntimeError(
            f"mesh slot {k} ({self.mesh.flat[k]}) failed: "
            f"{type(exc).__name__}: {exc}") from exc

    def _answers(self, messages):
        """Every worker's answer to its message, in mesh order; the first
        slot's failure raised."""
        results = slot_worker.exchange(self.workers, messages, self.timeout)
        for k, (_answer, exc) in enumerate(results):
            if exc is not None:
                self._fail(k, exc)
        return [answer for answer, _exc in results]

    def _start_workers(self, config: bytes) -> None:
        """One worker per mesh slot, started together."""
        self.workers.extend(slot_worker.SlotWorker(k, device)
                            for k, device in enumerate(self.mesh.flat))
        messages = []
        for k, worker in enumerate(self.workers):
            try:
                messages.append(worker.start(config))
            except Exception as exc:
                self._fail(k, exc)
        for worker, answer in zip(self.workers, self._answers(messages)):
            worker.started(answer)
        self._config = config

    def _run_pieces(self, tuples, pad_to, what):
        """Every slot's piece at once, each in its worker; the results in
        mesh order."""
        config = slot_worker.configuration(self.calc, self.polisher)
        # here, before any worker loads them
        if any(d.type == "cuda" for d in self.mesh.flat):
            fermi_fill.build()
            anderson_window.build()
            fragment_gemm.build()
            fragment_reduce.build()
            batched_eigh.build()
            if self.calc.settings.use_pallas_eigh:
                jacobi_eigh.build()
        if [w.device for w in self.workers] != self.mesh.flat:
            self.close()
            self._start_workers(config)
        send = None if config == self._config else config
        per = len(tuples) // self.n_devices
        flat = self.mesh.flat
        answers = self._answers([
            ("piece", send, tuples[k * per : (k + 1) * per], pad_to, what,
             self.runs, flat.count(flat[k]))
            for k in range(self.n_devices)])
        self._config = config
        parts = []
        for worker, (part, stats) in zip(self.workers, answers):
            worker.record(stats)
            parts.append(part)
        return parts

    def _run_chunk(self, members, pad_to, what, energies, gradients, aux_out):
        idxs = [i for i, _ in members]
        tuples = [t for _, t in members]
        # pad the batch to a device-count multiple with dummy fragments
        tuples = tuples + [_DUMMY] * ((-len(tuples)) % self.n_devices)
        if not hasattr(self.calc, "on"):  # a host method: one piece
            frag_data = self.calc.make_batch(tuples, pad_to=pad_to)
            parts = [evaluate_piece(self.calc, self.polisher, frag_data,
                                    tuples, pad_to, what)]
        elif self.n_devices == 1:
            frag_data = self.calc.make_batch(tuples, pad_to=pad_to)
            (piece,) = shard_leading_axis(frag_data, self.mesh)
            parts = [evaluate_piece(self.calc.on(self.mesh.flat[0]),
                                    self.polisher, piece, tuples, pad_to,
                                    what)]
        else:
            parts = self._run_pieces(tuples, pad_to, what)
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
