#!/usr/bin/env python3
"""How far a fragment's gradient depends on the batch it is cut into
(ROADMAP C17): the cut deltas.

One executor batch against the pieces of a two-slot cut, evaluated one
after the other in this process (`SerialCut`), for the rigid water trimer
MBE(2) gradient (`workloads.trimer_mbe2_fragments`, whose dimers have
exactly degenerate cross-monomer spectra) and the w20 MBE(2) |g| in
float64 and in float32 + the f64 polish. The deltas are measured once per
route of the Anderson step's window algebra (`--solves`): the window
kernel (kernel, what the engine runs on a card,
`ops/anderson_window.py`); its plain torch version, batched products and
`torch.linalg.solve_ex` (library, what the engine ran before the
kernel); the same with the solve one fragment at a time (looped); or the
kernel's order in elementwise batched ops (rowwise); and once per route of
the engine's products (`--products`): the batch-invariant kernel
(kernel, `ops/fragment_gemm.py`: the products, the Coulomb matvec and
D3's C6 contraction), or torch.matmul and torch.einsum in their place
(library, what the port ran before it).

Beyond GFN1 up to 64 AOs (`beyond_deltas`, float64, the kernel routes):
the w20 MBE(2) gradient in GFN2 and in GFN1 with ALPB (one batch against
the two-slot cut), and a bucket above 64 AOs, `chip_smoke.py`'s 16 water
dodecamers (nao 72, padded to 96; seed 40), as one batch against two of 8.

`--locate` names, per products route, the first value that depends on
the batch, for each of LOCATE_CASES: the w20 MBE(2) dimers' float64
gradients (GFN1, GFN2, GFN1 with ALPB) as one batch of 190 and as its
first 95, and the 16 dodecamers and their first 8, launch by launch,
every call of the traced functions (`TRACED`) and the kernels' backward
passes compared on the shared fragments in call order.

Usage: python3 tools/c17_probe_torch.py [--device cuda]
           [--solves kernel,library,looped,rowwise]
           [--products kernel,library] [--beyond] [--locate]
           [--json-out F]
It prints a line per route and one JSON line.
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


def dodecamers():
    """chip_smoke.py's 16 seeded water dodecamers (its call_graph phase's
    bucket above 64 AOs: nao 72, padded to 96)."""
    from chip_smoke import water_clusters

    return water_clusters(np.random.default_rng(40), 16, 12)


def _calculator(case, device):
    """The float64 calculator of a case: w20_gfn1, w20_gfn2, w20_alpb
    (GFN1, water) or dodecamers (GFN1, scf_tol 1e-9 as the call_graph
    phase's)."""
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )

    variant = "gfn2" if case == "w20_gfn2" else "gfn1"
    if case == "dodecamers":
        base = settings_from_params(variant, scf_tol=1e-9, max_scf_iter=64)
    else:
        base = settings_from_params(variant, max_scf_iter=32)
    solvation = BornSolvation(78.4, alpb=True) if case == "w20_alpb" else None
    return XtbCalculator(base, variant=variant, dtype=torch.float64,
                         device=device, solvation=solvation)


def beyond_deltas(device):
    """C17's deltas beyond GFN1 up to 64 AOs, float64: the w20 MBE(2)
    gradient in GFN2 and with ALPB (one batch against the two-slot cut:
    |g|, max |dg|, total), and the 16 dodecamers as one batch against two
    of 8 (max |dE|, max |dg|)."""
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.workloads import (
        w20_mbe2_assemble,
        w20_mbe2_fragments,
    )

    out = {}
    frags = w20_mbe2_fragments()
    for case in ("w20_gfn2", "w20_alpb"):
        calc = _calculator(case, device)
        e1, g1, _ = FragmentExecutor(calc).run(frags, what="gradient")
        e2, g2, _ = SerialCut.make(calc).run(frags, what="gradient")
        t1, n1 = w20_mbe2_assemble(e1, g1)
        t2, n2 = w20_mbe2_assemble(e2, g2)
        out[f"{case}_d_gnorm"] = abs(n1 - n2)
        out[f"{case}_d_total"] = abs(t1 - t2)
        out[f"{case}_max_dg"] = max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(g1, g2))
    calc = _calculator("dodecamers", device)
    clusters = dodecamers()
    half = len(clusters) // 2
    e1, g1, _ = calc.gradients(calc.make_batch(clusters))
    parts = [calc.gradients(calc.make_batch(p))
             for p in (clusters[:half], clusters[half:])]
    e2 = torch.cat([p[0] for p in parts])
    g2 = torch.cat([p[1] for p in parts])
    out["dodecamers_d_energy"] = float((e1 - e2).abs().max())
    out["dodecamers_max_dg"] = float((g1 - g2).abs().max())
    return out


#: where --locate looks: (case, whole batch, the first part of it)
LOCATE_CASES = ("w20_gfn1", "w20_gfn2", "w20_alpb", "dodecamers")


#: (module, function) pairs whose outputs `first_difference` compares; an
#: in-place op (the window) is read after the call from its first argument
TRACED = (
    ("engine", "overlap_matrix"), ("engine", "coordination_numbers"),
    ("engine", "h0_matrix"), ("engine", "gamma_matrix"),
    ("engine", "eigh_folded"), ("engine", "batched_eigh"),
    ("engine", "eigh_safe"), ("engine", "fragment_bmm"),
    ("engine", "sandwich"), ("engine", "fragment_matvec"),
    ("engine", "fermi_density"),
    ("engine", "fermi_occupations"), ("engine", "anderson_window"),
    ("engine", "_fock"), ("engine", "_shell_populations"),
    ("engine", "_ortho_factors"), ("engine", "_general_eigh"),
    ("engine", "_scc_density"), ("engine", "_coulomb_potential"),
    ("engine", "moment_matrices"), ("engine", "_aes_potentials"),
    ("engine", "_aes_fock"), ("engine", "_aes_moments_of_P"),
    ("calculator", "_scc_operands"), ("calculator", "_solv_gamma"),
    ("dispersion_d3", "c6_coefficients"), ("dispersion_d3", "d3_energy"),
    ("dispersion_d3", "atm_energy"),
)
#: autograd Functions whose backward passes are compared too
TRACED_BACKWARD = (("engine", "_EighSafe"), ("fragment_gemm", "_Bmm"),
                   ("fragment_gemm", "_Sandwich"),
                   ("fragment_gemm", "_Matvec"))


class _Found(Exception):
    pass


class _Trace:
    """The traced calls of one run (`ref` None) or their comparison with a
    recorded run's on its first `rows` fragments."""

    def __init__(self, bsz, ref=None, rows=None):
        self.bsz, self.ref, self.rows = bsz, ref, rows
        self.calls = []

    def add(self, name, out):
        flat = [t.detach() for t in _tensors(out)
                if t.dim() and t.shape[0] == self.bsz]
        k = len(self.calls)
        self.calls.append(name)
        if self.ref is None:
            self.calls[-1] = (name, [t.cpu().clone() for t in flat])
            return
        ref_name, ref_out = self.ref[k]
        if ref_name != name:
            raise _Found({"op": name, "call": k,
                          "diverged": f"call order ({ref_name})"})
        for t, r in zip(flat, ref_out):
            mine = t[: self.rows].cpu()
            same = torch.equal(torch.nan_to_num(mine), torch.nan_to_num(r))
            if not same:
                raise _Found({"op": name, "call": k, "max_abs_diff": float(
                    (mine - r).abs().max())})


def _tensors(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def first_difference(device, case="w20_gfn1"):
    """The first traced value (in call order) of a case's float64
    gradients that differs between its fragments as one batch (the w20
    MBE(2) dimers: 190; the dodecamers: 16) and the first half alone, or
    None where the gradients agree bit for bit."""
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import dispersion_d3, engine
    from metalquicha_tpu_torch.ops import fragment_gemm
    from metalquicha_tpu_torch.workloads import w20_mbe2_fragments

    mods = {"engine": engine, "dispersion_d3": dispersion_d3,
            "fragment_gemm": fragment_gemm, "calculator": tcalc}
    calc = _calculator(case, device)
    dimers = (dodecamers() if case == "dodecamers"
              else w20_mbe2_fragments()[20:])
    half = len(dimers) // 2
    runs = {}

    def run(frags, trace):
        saved = []
        for mod, name in TRACED:
            fn = getattr(mods[mod], name, None)
            if fn is None:
                continue
            saved.append((mods[mod], name, fn))

            def traced(*args, _fn=fn, _name=name, **kw):
                out = _fn(*args, **kw)
                trace.add(_name, args[0] if _name == "anderson_window"
                          else out)
                return out
            setattr(mods[mod], name, traced)
        for mod, name in TRACED_BACKWARD:
            cls = getattr(mods[mod], name)
            fn = cls.__dict__["backward"]
            saved.append((cls, "backward", fn))

            def backward(ctx, *grads, _fn=fn.__func__, _name=name):
                out = _fn(ctx, *grads)
                trace.add(f"{_name}.backward", out)
                return out
            cls.backward = staticmethod(backward)
        try:
            frag = calc.make_batch(frags)
            e, g, _ = calc.gradients(frag, graph=False)
            trace.add("gradients", (e, g))
        finally:
            for owner, name, fn in reversed(saved):
                setattr(owner, name, fn)
        return trace

    runs["half"] = run(dimers[:half], _Trace(half))
    try:
        run(dimers, _Trace(len(dimers), runs["half"].calls, half))
    except _Found as found:
        return found.args[0]
    return None


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


def _library_products():
    """The kernel ops replaced by the torch calls they replaced (cuBLAS's
    batched products on a card), by (module, name)."""
    def bmm(a, b, trans_a=False, trans_b=False):
        return torch.matmul(a.transpose(-1, -2) if trans_a else a,
                            b.transpose(-1, -2) if trans_b else b)

    def pair_bilinear(w, grids):
        v = torch.einsum("bia,bijac->bijc", w, grids)
        return torch.einsum("bijc,bjc->bij", v, w)

    return {("engine", "fragment_bmm"): bmm,
            ("engine", "sandwich"): lambda x, f, shift: x @ f @ x + shift,
            ("engine", "fragment_matvec"):
                lambda m, x: (m @ x[..., None])[..., 0],
            ("dispersion_d3", "pair_bilinear"): pair_bilinear}


def _products(name):
    """Route `name` of the kernel ops, by (module, name)."""
    from metalquicha_tpu_torch.ops import fragment_gemm as fm

    if name == "library":
        return _library_products()
    return {("engine", "fragment_bmm"): fm.fragment_bmm,
            ("engine", "sandwich"): fm.sandwich,
            ("engine", "fragment_matvec"): fm.fragment_matvec,
            ("dispersion_d3", "pair_bilinear"): fm.pair_bilinear}


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
    ap.add_argument("--products", default="kernel",
                    help="comma-separated: the engine's products for the "
                         "deltas (kernel, library)")
    ap.add_argument("--beyond", action="store_true",
                    help="also the deltas beyond GFN1 up to 64 AOs (GFN2, "
                         "ALPB, the dodecamers above 64 AOs), per products "
                         "route")
    ap.add_argument("--locate", action="store_true",
                    help="name the first value that depends on the batch, "
                         "per products route and case")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    from metalquicha_tpu_torch.logging_ import global_logger
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import dispersion_d3, engine
    from metalquicha_tpu_torch.methods.xtb import scc_graph

    global_logger.set_level("warning")
    device = tcalc.check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": str(device)}
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
    windows, real = _windows(), engine.anderson_window
    mods = {"engine": engine, "dispersion_d3": dispersion_d3}
    real_products = _products("kernel")
    for products in args.products.split(","):
        for (mod, name), fn in _products(products).items():
            setattr(mods[mod], name, fn)
        try:
            for name in args.solves.split(","):
                engine.anderson_window = windows[name]
                # the graphs captured on another route are not replayed
                scc_graph.clear()
                try:
                    key = f"deltas_{name}_{products}"
                    result[key] = cut_deltas(device)
                finally:
                    engine.anderson_window = real
                    scc_graph.clear()
                print(f"c17 cut deltas, solve {name}, products {products}: "
                      f"{result[key]}", flush=True)
            if args.beyond:
                scc_graph.clear()
                key = f"beyond_{products}"
                result[key] = beyond_deltas(device)
                print(f"c17 cut deltas beyond GFN1 up to 64 AOs, products "
                      f"{products}: {result[key]}", flush=True)
            if args.locate:
                for case in LOCATE_CASES:
                    key = (f"first_{products}" if case == "w20_gfn1"
                           else f"first_{products}_{case}")
                    result[key] = first_difference(device, case)
                    print(f"c17 first value that depends on the batch, "
                          f"products {products}, {case}: {result[key]}",
                          flush=True)
        finally:
            for (mod, name), fn in real_products.items():
                setattr(mods[mod], name, fn)
            scc_graph.clear()
    line = json.dumps(result)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
