#!/usr/bin/env python3
"""Where the time of a mesh of several slots goes: worker processes
against serial dispatch, on one CUDA card.

Times bench.py's w20 MBE(2) list with gradients (the Jacobi route, 32 SCC
iterations, float64) through `FragmentExecutor` on
- one slot;
- two slots on the card, each piece in a worker process of its own (the
  executor's dispatch; the warm-up pass starts the workers);
- two slots whose pieces run one after the other from the calling
  process;
- two slot threads of the calling process that take one lock around each
  piece (threads, but no overlap at all);
and, as a probe of the host side, `OPS` tiny in-place additions on the
card from one thread (2 x OPS) and from two threads (OPS each), with and
without a host sync every 64 additions. Each configuration is timed
`--reps` times after a warm-up, in turns; the totals are held equal to the
one-slot run (1e-10 Ha). Prints one line per configuration, each worker's
pid, start-up seconds and Jacobi launches, and the card's name and power
limit.

Usage: python3 tools/mesh_dispatch_probe.py [--reps 3] [--ops 20000]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from metalquicha_tpu_torch.logging_ import global_logger  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.calculator import (  # noqa: E402
    XtbCalculator,
    check_device,
)
from metalquicha_tpu_torch.methods.xtb.engine import (  # noqa: E402
    settings_from_params,
)
from metalquicha_tpu_torch.parallel.executor import (  # noqa: E402
    FragmentExecutor,
)
from metalquicha_tpu_torch.parallel.mesh import fragment_mesh  # noqa: E402
from metalquicha_tpu_torch.parallel.slot_worker import (  # noqa: E402
    evaluate_piece,
)
from metalquicha_tpu_torch.workloads import (  # noqa: E402
    w20_mbe2_assemble,
    w20_mbe2_fragments,
)


class SerialExecutor(FragmentExecutor):
    """The pieces one after the other from the calling process."""

    def _run_pieces(self, tuples, pad_to, what):
        per = len(tuples) // self.n_devices
        return [_piece(self.calc.on(device), tuples[k * per : (k + 1) * per],
                       pad_to, what)
                for k, device in enumerate(self.mesh.flat)]


class LockedExecutor(FragmentExecutor):
    """A thread of the calling process per slot, each on a CUDA stream of
    its own, that takes one lock around its piece."""

    def _run_pieces(self, tuples, pad_to, what):
        per = len(tuples) // self.n_devices
        lock = threading.Lock()
        parts = [None] * self.n_devices

        def slot(k, device):
            with lock, torch.cuda.stream(torch.cuda.Stream(device)):
                parts[k] = _piece(self.calc.on(device),
                                  tuples[k * per : (k + 1) * per], pad_to,
                                  what)
                torch.cuda.current_stream(device).synchronize()

        threads = [threading.Thread(target=slot, args=(k, device))
                   for k, device in enumerate(self.mesh.flat)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return parts


def _piece(calc, piece, pad_to, what):
    return evaluate_piece(calc, None, calc.make_batch(piece, pad_to=pad_to),
                          piece, pad_to, what)


def _timed(fn, device, reps):
    fn()  # warm-up
    out = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize(device)
        out.append(time.perf_counter() - t0)
    return result, out


def _additions(device, n_threads, ops, sync_every):
    streams = [torch.cuda.Stream(device) for _ in range(n_threads)]

    def work(stream):
        with torch.cuda.stream(stream):
            x = torch.zeros(4, device=device)
            for i in range(ops):
                x.add_(1.0)
                if sync_every and i % sync_every == sync_every - 1:
                    stream.synchronize()
            stream.synchronize()

    threads = [threading.Thread(target=work, args=(s,)) for s in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ops", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("the probe times a CUDA card")
    global_logger.set_level("warning")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    calc = XtbCalculator(settings_from_params("gfn1", max_scf_iter=32,
                                              use_pallas_eigh=True),
                         dtype=torch.float64, device=device)
    frags = w20_mbe2_fragments()
    two = fragment_mesh([device, device])
    configs = {
        "one slot": FragmentExecutor(calc),
        "two slots, worker processes": FragmentExecutor(calc, mesh=two),
        "two slots, serial": SerialExecutor(calc, mesh=two),
        "two slots, threads under one lock": LockedExecutor(calc, mesh=two),
    }
    totals = {}
    for name, ex in configs.items():
        (e, g, _aux), secs = _timed(lambda: ex.run(frags, "gradient"),
                                    device, args.reps)
        totals[name] = w20_mbe2_assemble(e, g)[0]
        print(f"w20 MBE(2) gradient, {name}: "
              f"{' '.join(f'{t:.3f}' for t in secs)} s "
              f"total={totals[name]:.10f}", flush=True)
        for w in ex.workers:
            print(f"  worker slot {w.index}: pid {w.pid} on {w.device}, "
                  f"start-up {w.startup_s:.2f} s, {w.launches} Jacobi "
                  f"launches", flush=True)
        ex.close()
    for name, total in totals.items():
        if abs(total - totals["one slot"]) > 1e-10:
            raise RuntimeError(f"{name}: total off by "
                               f"{abs(total - totals['one slot']):.3e}")

    for sync_every in (0, 64):
        for n_threads in (1, 2):
            ops = args.ops * 2 // n_threads
            _, secs = _timed(
                lambda: _additions(device, n_threads, ops, sync_every),
                device, args.reps)
            print(f"{2 * args.ops} additions, {n_threads} thread(s), sync "
                  f"every {sync_every or 'never'}: "
                  f"{' '.join(f'{t:.3f}' for t in secs)} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
