#!/usr/bin/env python3
"""How far a fragment's gradient depends on the batch it is cut into
(ROADMAP C17): the cut deltas.

One executor batch against the pieces of a two-slot cut, evaluated one
after the other in this process (`SerialCut`), for the rigid water trimer
MBE(2) gradient (`workloads.trimer_mbe2_fragments`, whose dimers have
exactly degenerate cross-monomer spectra) and the w20 MBE(2) |g| in
float64 and in float32 + the f64 polish. The deltas are measured once per
solve of the Anderson step's window (`--solves`): torch's
`torch.linalg.solve_ex` (library, what the engine calls), the same one
fragment at a time (looped), or Gaussian elimination in elementwise
batched ops, whose bits for a fragment do not depend on the batch
(rowwise). A change that makes the port's results independent of the cut
should bring every delta to 0 with the library solve.

Usage: python3 tools/c17_probe_torch.py [--device cuda]
           [--solves library,looped,rowwise] [--json-out F]
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


def rowwise_solve(G, rhs):
    """Gaussian elimination with partial pivoting in elementwise batched
    ops, whose bits for a fragment do not depend on the batch."""
    bsz, m = rhs.shape
    A = torch.cat([G, rhs[..., None]], -1).clone()
    rows = torch.arange(bsz, device=G.device)
    for k in range(m):
        p = k + A[:, k:, k].abs().argmax(-1)
        row_k, row_p = A[:, k].clone(), A[rows, p].clone()
        A[rows, p] = row_k
        A[:, k] = row_p
        f = A[:, k + 1 :, k] / A[:, k, k][:, None]
        A[:, k + 1 :] = A[:, k + 1 :] - f[..., None] * A[:, k, None, :]
    x = torch.zeros_like(rhs)
    for k in reversed(range(m)):
        acc = A[:, k, m] - (A[:, k, k + 1 : m] * x[:, k + 1 :]).sum(-1)
        x[:, k] = acc / A[:, k, k]
    return x, torch.zeros(bsz, dtype=torch.int32, device=G.device)


_LIBRARY_SOLVE = torch.linalg.solve_ex
SOLVES = {"library": _LIBRARY_SOLVE, "looped": looped_solve,
          "rowwise": rowwise_solve}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--solves", default="library",
                    help="comma-separated: the Anderson step's window "
                         "solve for the deltas (library, looped, rowwise)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    from metalquicha_tpu_torch.logging_ import global_logger
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc

    global_logger.set_level("warning")
    device = tcalc.check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": str(device)}
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
    for name in args.solves.split(","):
        torch.linalg.solve_ex = SOLVES[name]
        try:
            result[f"deltas_{name}"] = cut_deltas(device)
        finally:
            torch.linalg.solve_ex = _LIBRARY_SOLVE
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
