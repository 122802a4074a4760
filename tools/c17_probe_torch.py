#!/usr/bin/env python3
"""How far a fragment's gradient depends on the batch it is cut into
(ROADMAP C17): the cut deltas.

One executor batch against the pieces of a two-slot cut, evaluated one
after the other in this process (`SerialCut`), for the rigid water trimer
MBE(2) gradient (`workloads.trimer_mbe2_fragments`, whose dimers have
exactly degenerate cross-monomer spectra) and the w20 MBE(2) |g| in
float64 and in float32 + the f64 polish. The deltas are measured once per
route of the Anderson step's window algebra (`--solves`): the window
kernel, one block per fragment (kernel, what the engine runs on a card,
`ops/anderson_window.py`); its plain torch version, batched products and
`torch.linalg.solve_ex` (library, what the engine ran before the kernel);
the same with the solve one fragment at a time (looped); or the kernel's
order in elementwise batched ops (rowwise). Where a delta stays with the
kernel, it comes from outside the window (the Fock build's batched
products, ROADMAP C17).

Usage: python3 tools/c17_probe_torch.py [--device cuda]
           [--solves kernel,library,looped,rowwise] [--json-out F]
It prints a line per solve and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)


class SerialCut:
    """A FragmentExecutor whose chunks are cut as a mesh of two slots cuts
    them, the pieces evaluated one after the other in this process."""

    @staticmethod
    def make(calc, polisher=None):
        from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
        from metalquicha_tpu_torch.parallel.mesh import fragment_mesh
        from metalquicha_tpu_torch.parallel.slot_worker import evaluate_piece

        class _Serial(FragmentExecutor):
            def _run_pieces(self, tuples, pad_to, what):
                per = len(tuples) // self.n_devices
                parts = []
                for j, device in enumerate(self.mesh.flat):
                    c = self.calc.on(device)
                    piece = tuples[j * per : (j + 1) * per]
                    parts.append(evaluate_piece(
                        c, self.polisher, c.make_batch(piece, pad_to=pad_to),
                        piece, pad_to, what))
                return parts

        two = fragment_mesh([calc.device, calc.device], nodes_per_group=1)
        return _Serial(calc, mesh=two, polisher=polisher)


def cut_deltas(device):
    """The C17 deltas: one batch against a two-slot cut."""
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.methods.xtb.polish import HostPolisher
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.workloads import (
        trimer_mbe2_assemble,
        trimer_mbe2_fragments,
        w20_mbe2_assemble,
        w20_mbe2_fragments,
    )

    out = {}
    calc = XtbCalculator(dtype=torch.float64, device=device)
    frags = trimer_mbe2_fragments()
    e1, g1, _ = FragmentExecutor(calc).run(frags, what="gradient")
    e2, g2, _ = SerialCut.make(calc).run(frags, what="gradient")
    t1, gs1 = trimer_mbe2_assemble(e1, g1)
    t2, gs2 = trimer_mbe2_assemble(e2, g2)
    out["trimer_max_dG"] = float(np.abs(gs1 - gs2).max())
    out["trimer_d_total"] = abs(t1 - t2)
    base = settings_from_params("gfn1", max_scf_iter=32)
    frags = w20_mbe2_fragments()
    for name, dtype, polish in (("w20_f64", torch.float64, False),
                                ("w20_f32_polish", torch.float32, True)):
        calc = XtbCalculator(base, dtype=dtype, device=device)
        pol = HostPolisher(calc) if polish else None
        e1, g1, _ = FragmentExecutor(calc, polisher=pol).run(
            frags, what="gradient")
        e2, g2, _ = SerialCut.make(calc, pol).run(frags, what="gradient")
        t1, n1 = w20_mbe2_assemble(e1, g1)
        t2, n2 = w20_mbe2_assemble(e2, g2)
        out[f"{name}_d_gnorm"] = abs(n1 - n2)
        out[f"{name}_d_total"] = abs(t1 - t2)
        out[f"{name}_max_dg"] = max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(g1, g2))
    return out


def looped_solve(G, rhs):
    """torch.linalg.solve_ex one fragment at a time: each fragment's solve
    takes the one-matrix routine, whatever the batch."""
    outs = [_LIBRARY_SOLVE(G[i : i + 1], rhs[i : i + 1]) for i in
            range(G.shape[0])]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _plain(fn, solve=None):
    """The engine's window op replaced by plain version `fn` (its
    keywords as the wrapper's), its solve by `solve` where given."""
    def window(*args, beta, reg, c_lim, scf_tol):
        if solve is not None:
            torch.linalg.solve_ex = solve
        try:
            return fn(*args, beta, reg, c_lim, scf_tol)
        finally:
            torch.linalg.solve_ex = _LIBRARY_SOLVE
    return window


_LIBRARY_SOLVE = torch.linalg.solve_ex


def _windows():
    from metalquicha_tpu_torch.ops import anderson_window as aw

    return {"kernel": aw.anderson_window,
            "library": _plain(aw.anderson_window_reference),
            "looped": _plain(aw.anderson_window_reference, looped_solve),
            "rowwise": _plain(aw.anderson_window_rowwise)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--solves", default="kernel",
                    help="comma-separated: the Anderson step's window "
                         "algebra for the deltas (kernel, library, looped, "
                         "rowwise)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    from metalquicha_tpu_torch.logging_ import global_logger
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import engine, scc_graph

    global_logger.set_level("warning")
    device = tcalc.check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": str(device)}
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
    windows, real = _windows(), engine.anderson_window
    for name in args.solves.split(","):
        engine.anderson_window = windows[name]
        # the graphs captured with another route's window are not replayed
        scc_graph.clear()
        try:
            result[f"deltas_{name}"] = cut_deltas(device)
        finally:
            engine.anderson_window = real
            scc_graph.clear()
        print(f"c17 cut deltas, solve {name}: {result[f'deltas_{name}']}",
              flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
