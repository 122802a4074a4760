"""One mesh slot's worker process.

On a mesh of more than one slot the executor evaluates each slot's piece
of a chunk in a process of its own, as XLA runs each shard of the JAX
package's sharded batch on its own device: every worker has its own
interpreter (the slots' kernel launches do not take turns under one
interpreter lock), its own CUDA context on its slot's device and the
kernel its parent built.

A worker is `python -m metalquicha_tpu_torch.parallel.slot_worker FD`,
started by `SlotWorker.start` (a new interpreter, never a `fork` of a
parent that may hold a CUDA context; nothing of the parent's `__main__`
is imported again), with FD its end of a socket pair over which the two
exchange pickled messages (`multiprocessing.connection.Connection`), one
answer per message:

- ("start", device, threads, config): the worker sets its torch thread
  count, installs the configuration (`configuration`: the calculator's
  variant, settings, dtype and solvation model's class and fields, the
  polisher's k or None, the kernels' build directory and the host
  parameter tables of `parameter_state`), builds its own `XtbCalculator`
  on its device and its own `HostPolisher` from them and, on a card,
  loads the kernels the parent built (the Fermi fill; the Jacobi kernel
  on its route). No tensor or object of the parent crosses. Answers with
  its statistics (peak device memory, loaded packages, build
  directory).
- ("piece", config or None, tuples, pad_to, what, run, sharing):
  installs the configuration if the parent sent a new one (a run-time
  `load_overlay`, a fit that moved a table, new settings), builds the
  piece's batch from the fragment tuples with `make_batch` on its device,
  evaluates and polishes it (`evaluate_piece`) and answers with host
  arrays (e, g or None, dipole, charges, residual), its statistics and
  the Jacobi and Fermi launches and SP2 calls the piece made. On a card
  the piece is evaluated in parts of at most as many fragments as the
  device's byte budget holds (`executor.device_budget`, taken once per
  parent's `run` number, after the SCC graphs earlier runs cached are
  dropped, and split between the `sharing` slots on the device;
  `executor.fragment_bytes`, `executor.byte_cap`), the graphs its earlier
  parts cached kept only while they fit beside the next part
  (`executor.make_room`).
- None, or the parent's end closing: the worker exits.

An exception in the worker answers with the exception, its traceback
added as a note, and the worker lives on. Only host arrays cross a process
boundary, never device memory.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection, wait
from pathlib import Path

import numpy as np
import torch

_MODULE = "metalquicha_tpu_torch.parallel.slot_worker"
#: the directory that holds the package: the worker imports the same copy
_ROOT = str(Path(__file__).resolve().parents[2])
#: seconds the other slots get to answer once one has failed
GRACE = 10.0
#: seconds a stopped worker gets to exit before it is killed
_STOP_WAIT = 10.0


def _host(x) -> np.ndarray:
    """A calculator's result on the host (the placeholder methods return
    NumPy arrays already)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def evaluate_piece(calc, polisher, frag_data, tuples, pad_to, what):
    """One piece on its device: host (e, g or None, dipole, charges,
    residual), polished when a polisher is given."""
    if what == "gradient":
        e, g, aux = calc.gradients(frag_data)
    else:
        e, aux = calc.energies(frag_data)
        g = None
    if polisher is not None:
        e, g, aux = polisher.polish(tuples, pad_to, aux["shell_charges"],
                                    what)
    return (_host(e), None if g is None else _host(g),
            _host(aux["dipole"]), _host(aux["charges"]),
            _host(aux["scf_residual"]))


# ---------------------------------------------------------------------------
# What a worker must share with its parent
# ---------------------------------------------------------------------------

def _state_tables():
    """(module, attribute names) of every host table a parameter overlay,
    a fit or the solvation overlay changes."""
    from ..methods.xtb import dispersion_d3, params_gfn1, params_gfn2
    from ..methods.xtb.solvation import born, cpcm

    params = ("ELEMENTS", "GLOBALS", "KPAIR", "ATOMIC_RADII_A",
              "COVALENT_RADII_A")
    return (
        (params_gfn1, params),
        (params_gfn2, params),
        (dispersion_d3, ("REF_CN", "REF_C6_DIAG", "R4R2",
                         "_PAIR_OVERRIDES")),
        (born, ("PARAM_SETS",)),
        (cpcm, ("COSMO_X", "SELF_INTERACTION")),
    )


def parameter_state() -> dict:
    """The host parameter tables as they stand in this process:
    {module name: {attribute: value}} (values, not copies; pickle them)."""
    return {mod.__name__: {name: getattr(mod, name) for name in names}
            for mod, names in _state_tables()}


def install_parameter_state(state: dict) -> None:
    """Make this process's tables equal to `state` (of `parameter_state`),
    in place, so every module that holds a table sees the new values, and
    clear the caches built from them."""
    from ..methods.xtb import batch, dispersion_d3

    for mod, names in _state_tables():
        for name in names:
            value, current = state[mod.__name__][name], getattr(mod, name)
            if isinstance(current, dict):
                current.clear()
                current.update(value)
            elif isinstance(current, np.ndarray):
                current[...] = value
            elif hasattr(current, "__dict__"):
                vars(current).clear()
                vars(current).update(vars(value))
            else:
                setattr(mod, name, value)
    dispersion_d3.invalidate_caches()
    batch.element_basis.cache_clear()


def _solvation_spec(solvation):
    """A solvation model (a dataclass) as its class and fields."""
    if solvation is None:
        return None
    return type(solvation), {f.name: getattr(solvation, f.name)
                             for f in dataclasses.fields(solvation)
                             if f.init}


def configuration(calc, polisher) -> bytes:
    """Everything a worker builds its calculator and polisher from,
    pickled: equal bytes mean an equal configuration."""
    from ..ops import kernel_build

    return pickle.dumps({
        "variant": calc.variant,
        "settings": calc.settings,
        "dtype": calc.dtype,
        "solvation": _solvation_spec(calc.solvation),
        "polish_k": None if polisher is None else polisher.k,
        "build_dir": str(kernel_build.BUILD_DIR),
        "state": parameter_state(),
    })


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

class WorkerExited(RuntimeError):
    """A slot's worker process ended without answering."""


class SlotWorker:
    """The parent's handle on one slot's worker process.

    `launches`, `fermi_launches` and `sp2_calls` count the Jacobi and
    Fermi launches and SP2 calls the worker has made (its SCC graphs'
    replays included), `window_launches` its Anderson window kernel's,
    `gemm_launches` its fragment product kernel's, `reduce_launches` its
    fragment sum kernel's,
    `scc_captures`, `scc_hits` and `scc_eager` its SCC solves on a card
    that captured a graph, replayed a cached one and ran launch by launch,
    `stage_captures`, `stage_hits` and `stage_eager` the same of its
    calls' other stages (`scc_graph.Call`), `scc_held_bytes` what its
    graph cache holds,
    `peak_bytes` is its peak device memory (0 on the CPU), `run_memory`
    each run's budget and peak, `modules` the
    top-level packages loaded in it, `build_dir` the directory it loads
    the kernels from, `startup_s` the seconds from its start to its first
    answer."""

    def __init__(self, index: int, device):
        self.index = index
        self.device = torch.device(device)
        self.proc = None
        self.conn = None
        #: whether it was asked to exit
        self.asked = False
        self._t0 = None
        self.startup_s = None
        self.answered_at = None
        self.launches = 0
        self.fermi_launches = 0
        self.sp2_calls = 0
        self.window_launches = 0
        self.gemm_launches = 0
        self.reduce_launches = 0
        self.scc_captures = 0
        self.scc_hits = 0
        self.scc_eager = 0
        self.stage_captures = 0
        self.stage_hits = 0
        self.stage_eager = 0
        self.scc_held_bytes = 0
        self.peak_bytes = 0
        #: parent's run number -> (its byte budget, the worker's peak
        #: device memory in that run); None and 0 off a card
        self.run_memory = {}
        #: the byte budget of its last piece (None off a card) and the
        #: parts that piece was evaluated in
        self.budget_bytes = None
        self.parts = 0
        self.modules = ()
        self.build_dir = None

    @property
    def pid(self):
        return None if self.proc is None else self.proc.pid

    def start(self, config: bytes) -> tuple:
        """Start the process; returns its start message, for `exchange`
        to send and read the answer to."""
        self._t0 = time.perf_counter()
        parent, child = socket.socketpair()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", _MODULE, str(child.fileno())],
                pass_fds=(child.fileno(),), cwd=_ROOT, env=env,
            )
        except BaseException:
            parent.close()
            raise
        finally:
            child.close()
        self.conn = Connection(parent.detach())
        return ("start", str(self.device), torch.get_num_threads(), config)

    def started(self, answer: dict) -> None:
        """Take the answer to the start message."""
        self.startup_s = self.answered_at - self._t0
        self.modules, self.build_dir = answer["modules"], answer["build_dir"]

    def record(self, stats: dict) -> None:
        """Take a piece's statistics: its counts into this handle's and
        this process's counters."""
        from ..ops import anderson_window, fermi_fill, fragment_gemm
        from ..ops import fragment_reduce, jacobi_eigh, sp2

        self.launches += stats["launches"]
        self.window_launches += stats["window_launches"]
        self.gemm_launches += sum(stats["gemm_by_kind"].values())
        self.reduce_launches += sum(stats.get("reduce_by_kind", {}).values())
        self.fermi_launches += stats["fermi_launches"]
        self.sp2_calls += stats["sp2_calls"]
        self.scc_captures += stats["scc_captures"]
        self.scc_hits += stats["scc_hits"]
        self.scc_eager += stats["scc_eager"]
        self.stage_captures += stats["stage_captures"]
        self.stage_hits += stats["stage_hits"]
        self.stage_eager += stats["stage_eager"]
        self.scc_held_bytes = stats["scc_held_bytes"]
        self.peak_bytes = max(self.peak_bytes, stats["peak_bytes"])
        self.budget_bytes = stats["budget_bytes"]
        self.run_memory[stats["run"]] = (stats["budget_bytes"],
                                         stats["peak_bytes"])
        self.parts = stats["parts"]
        self.modules, self.build_dir = stats["modules"], stats["build_dir"]
        jacobi_eigh.add_launches(stats["launches"])
        fermi_fill.add_launches(stats["fermi_launches"],
                                stats["density_launches"],
                                stats.get("density_by_class"))
        sp2.add_calls(stats["sp2_calls"])
        anderson_window.add_launches(stats["window_launches"])
        fragment_gemm.add_launches(stats["gemm_by_kind"])
        fragment_reduce.add_launches(stats.get("reduce_by_kind", {}))

    def exited(self) -> WorkerExited:
        """The exception for a worker whose end of the pipe closed."""
        try:
            code = self.proc.wait(timeout=_STOP_WAIT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            code = self.proc.wait()
        return WorkerExited(f"the worker (pid {self.proc.pid}) exited with "
                            f"code {code}")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def ask_to_exit(self) -> None:
        if self.proc is not None and not self.conn.closed and not self.asked:
            self.asked = True
            try:
                self.conn.send(None)
            except OSError:
                pass

    def stop(self, kill: bool = False) -> None:
        """End the process (asked to exit, killed if it has not after
        `_STOP_WAIT` s, or at once with `kill`) and close the pipe."""
        if self.proc is None or self.conn.closed:
            return
        if not kill:
            self.ask_to_exit()
        try:
            self.proc.wait(timeout=0 if kill else _STOP_WAIT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.conn.close()


def stop_all(workers: list, kill: bool = False) -> None:
    """Stop every worker of the list (all asked at once) and empty it."""
    if not kill:
        for worker in workers:
            worker.ask_to_exit()
    for worker in workers:
        worker.stop(kill)
    workers.clear()


def _remote_error(exc_bytes, name, message, trace):
    """The exception a worker answered with (a stand-in if it does not
    unpickle), its traceback in the worker as a note."""
    try:
        exc = pickle.loads(exc_bytes)
    except Exception:
        exc = RuntimeError(f"{name}: {message}")
    exc.add_note(f"in the slot's worker:\n{trace}")
    return exc


def exchange(workers: list, messages: list, timeout=None) -> list:
    """Send each worker its message, then wait for every answer:
    [(answer, None) or (None, exception)] in worker order.

    A worker that dies answers `WorkerExited`; one that has not answered
    `timeout` seconds after the sends (None: as long as it lives), or
    `GRACE` seconds after another slot failed, `TimeoutError`. So this
    returns however the workers fail."""
    results = [None] * len(workers)
    pending = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    for k, (worker, msg) in enumerate(zip(workers, messages)):
        try:
            worker.conn.send(msg)
            pending[worker.conn] = k
        except OSError:
            results[k] = (None, worker.exited())
    graced = False
    while pending:
        if not graced and any(r and r[1] is not None for r in results):
            graced = True
            grace = time.monotonic() + GRACE
            deadline = grace if deadline is None else min(deadline, grace)
        left = (None if deadline is None
                else max(0.0, deadline - time.monotonic()))
        ready = wait(list(pending), left)
        if not ready:
            for k in pending.values():
                results[k] = (None, TimeoutError(
                    f"no answer from the worker (pid {workers[k].pid}) in "
                    f"time"))
            break
        for conn in ready:
            k = pending.pop(conn)
            workers[k].answered_at = time.perf_counter()
            try:
                kind, *body = conn.recv()
            except (EOFError, OSError):
                results[k] = (None, workers[k].exited())
                continue
            results[k] = ((body[0], None) if kind == "ok"
                          else (None, _remote_error(*body)))
    return results


# ---------------------------------------------------------------------------
# The worker's side
# ---------------------------------------------------------------------------

class _Slot:
    """A worker's calculator and polisher on its device."""

    def __init__(self, device: str, threads: int):
        from ..methods.xtb.calculator import check_device

        self.device = check_device(device)
        torch.set_num_threads(threads)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        self.calc = self.polisher = None
        #: the parent's run number the byte budget was taken for
        self.run = self.budget = None
        #: the run's SCC graph cache mark and its last part's shape
        #: (`executor.make_room`)
        self.mark, self.last = 0, None

    def configure(self, config: bytes) -> None:
        from ..methods.xtb.calculator import XtbCalculator
        from ..methods.xtb.polish import HostPolisher
        from ..ops import anderson_window, batched_eigh, fermi_fill
        from ..ops import fragment_gemm, fragment_reduce, jacobi_eigh
        from ..ops import kernel_build

        cfg = pickle.loads(config)
        install_parameter_state(cfg["state"])
        kernel_build.BUILD_DIR = Path(cfg["build_dir"])
        solvation = cfg["solvation"]
        if solvation is not None:
            cls, fields = solvation
            solvation = cls(**fields)
        self.calc = XtbCalculator(cfg["settings"], cfg["variant"],
                                  cfg["dtype"], self.device, solvation)
        self.polisher = (None if cfg["polish_k"] is None
                         else HostPolisher(self.calc, cfg["polish_k"]))
        # the parent's builds: loaded, not compiled
        if self.device.type == "cuda":
            fermi_fill.build()
            anderson_window.build()
            fragment_gemm.build()
            fragment_reduce.build()
            batched_eigh.build()
            if cfg["settings"].use_pallas_eigh:
                jacobi_eigh.build()

    def _cap(self, tuples, pad_to, what, run, sharing):
        """(most fragments of this piece evaluated at once: all of them,
        or on a card as many as the run's byte budget holds; the modelled
        bytes of one, None off a card)."""
        from ..methods.xtb import scc_graph
        from ..methods.xtb.batch import _sizes_for
        from .executor import byte_cap, device_budget, fragment_bytes

        if run != self.run:
            # each run plans for its share of the card anew: the graphs
            # earlier runs cached go first, as their bytes would count in
            # this worker's peak and not in its budget
            scc_graph.clear()
            if self.device.type == "cuda":
                # the run's peak, held to the run's budget
                torch.cuda.reset_peak_memory_stats(self.device)
            self.run, self.budget = run, device_budget(self.device, sharing)
            self.mark, self.last = scc_graph.mark(), None
        if self.budget is None:
            return len(tuples), None
        nprim = _sizes_for([t[0] for t in tuples], self.calc.variant)[3]
        per = fragment_bytes(self.calc, pad_to, nprim, what,
                             self.polisher is not None)
        return byte_cap(self.budget, per, pad_to, nprim, what), per

    def evaluate(self, config, tuples, pad_to, what, run, sharing):
        from ..methods.xtb import scc_graph
        from ..ops import anderson_window, fermi_fill, fragment_gemm
        from ..ops import fragment_reduce, jacobi_eigh, sp2
        from .executor import make_room

        if config is not None:
            self.configure(config)
        n0, s0 = jacobi_eigh.launches, sp2.calls
        m0, d0 = fermi_fill.launches, fermi_fill.density_launches
        c0 = collections.Counter(fermi_fill.density_by_class)
        w0 = anderson_window.launches
        k0 = collections.Counter(fragment_gemm.launches_by_kind)
        r0 = collections.Counter(fragment_reduce.launches_by_kind)
        g0, e0 = scc_graph.stats["captures"], scc_graph.stats["eager"]
        h0 = scc_graph.stats["hits"]
        sg0, sh0, se0 = (scc_graph.stats[k] for k in (
            "stage_captures", "stage_hits", "stage_eager"))
        cap, per = self._cap(tuples, pad_to, what, run, sharing)
        outs = []
        # the parts' graph pools are the run's to plan (`make_room`); the
        # next run clears them
        with scc_graph.planned():
            for start in range(0, len(tuples), cap):
                part = tuples[start : start + cap]
                if per is not None:
                    self.last = make_room(self.budget, self.mark,
                                          (pad_to, len(part)),
                                          len(part) * per, self.last,
                                          self.device)
                frag = self.calc.make_batch(part, pad_to=pad_to)
                outs.append(evaluate_piece(self.calc, self.polisher, frag,
                                           part, pad_to, what))
                del frag
        parts = outs[0] if len(outs) == 1 else tuple(
            None if p[0] is None else np.concatenate(p) for p in zip(*outs))
        return parts, dict(self.stats(), launches=jacobi_eigh.launches - n0,
                           fermi_launches=fermi_fill.launches - m0,
                           density_launches=fermi_fill.density_launches - d0,
                           density_by_class=dict(
                               fermi_fill.density_by_class - c0),
                           window_launches=anderson_window.launches - w0,
                           gemm_by_kind=dict(
                               fragment_gemm.launches_by_kind - k0),
                           reduce_by_kind=dict(
                               fragment_reduce.launches_by_kind - r0),
                           sp2_calls=sp2.calls - s0,
                           scc_captures=scc_graph.stats["captures"] - g0,
                           scc_hits=scc_graph.stats["hits"] - h0,
                           scc_eager=scc_graph.stats["eager"] - e0,
                           stage_captures=(scc_graph.stats["stage_captures"]
                                           - sg0),
                           stage_hits=scc_graph.stats["stage_hits"] - sh0,
                           stage_eager=scc_graph.stats["stage_eager"] - se0,
                           scc_held_bytes=scc_graph.stats["held_bytes"],
                           parts=len(outs), run=self.run)

    def stats(self) -> dict:
        from ..ops import kernel_build

        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        return {"peak_bytes": int(peak), "budget_bytes": self.budget,
                "modules": sorted({m.split(".")[0] for m in sys.modules}),
                "build_dir": str(kernel_build.BUILD_DIR)}


def _answer(slot, msg):
    """(the slot, the answer) for a "start" or a "piece" message."""
    if msg[0] == "start":
        _kind, device, threads, config = msg
        slot = _Slot(device, threads)
        slot.configure(config)
        return slot, slot.stats()
    return slot, slot.evaluate(*msg[1:])


def _pickled(exc):
    try:
        return pickle.dumps(exc)
    except Exception:
        return None


def main(argv=None) -> int:
    fd = int((sys.argv[1:] if argv is None else argv)[0])
    conn = Connection(fd)
    slot = None
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return 0
        if msg is None:
            return 0
        try:
            slot, answer = _answer(slot, msg)
            reply = ("ok", answer)
        except Exception as exc:
            reply = ("error", _pickled(exc), type(exc).__name__, str(exc),
                     traceback.format_exc())
        try:
            conn.send(reply)
        except OSError:
            return 0


if __name__ == "__main__":
    sys.exit(main())
