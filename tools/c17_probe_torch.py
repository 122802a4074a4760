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

Beyond GFN1 (`beyond_deltas`, the kernel routes): the w20 MBE(2)
gradient in GFN2 and in GFN1 with ALPB (float64, one batch against the
two-slot cut); as one batch against its two halves `chip_smoke.py`'s 16
water dodecamers (nao 72, padded to 96; seed 40) in float64 and in
float32 on SP2's route, 8 jittered copies of the 73-atom peptide of
validation/inputs/no_frag.json (228 AOs: products, the matvec and the
eigh above 128) and the w20 MBE(2) dimers in GFN2 through the refine
route (diff_scf_iters = 2); and the w20 MBE(2) energies with CPCM (one
batch against the two-slot cut). Nothing is left open up to 256 AOs
(ROADMAP C17). `--eigh` measures the in-loop
eigh's batched call against a batch of 41 and a matrix alone, per size,
and times the batched and the one-a-matrix calls (`eigh_deltas`).

`--reductions` runs these per route of the sums of `ops/fragment_reduce.py`
(ROADMAP C17 beyond GFN1), each step putting one more of its entries on
the kernel, the others on the torch expressions they replaced (a CPU
tensor's): none (torch's einsums, reductions, scatter_add and indexing
backward), fock (GFN2's moment contraction `moment_fock`), rows (and the
row sums `moment_rows`), all (and `segment_sum`, `fragment_sum`, the
gathers' backward, the broadcasts' backward: what the engine runs on a
card).

`--locate` names, per products and reductions route, the first value that
depends on the batch, for each of LOCATE_CASES: the w20 MBE(2) dimers'
float64 gradients (GFN1, GFN2) as one batch of 190 and as its first 95,
its 20 monomers with ALPB and their first 10, the 16 dodecamers and
their first 8 (float64, and float32 on SP2's route), the 8 peptides and
their first 4, and the dimers' CPCM energies, launch by launch, every
call of the traced functions (`TRACED`), the kernels' backward passes
and the gradient the gathers `_take` / `_take2` pass back to their
input, compared on the shared fragments in call order.

Usage: python3 tools/c17_probe_torch.py [--device cuda]
           [--solves kernel,library,looped,rowwise]
           [--products kernel,library] [--reductions none,fock,rows,all]
           [--beyond] [--locate] [--eigh] [--json-out F]
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
    """The calculator of a case: w20_gfn1, w20_gfn2, w20_gfn2_refine (its
    gradients through diff_scf_iters = 2, `refined_gradients`), w20_alpb
    (GFN1, water), cpcm (GFN1, water; energies), dodecamers (GFN1,
    scf_tol 1e-9 as the call_graph phase's), peptide (GFN1's defaults), in
    float64; sp2_f32 (the dodecamers in float32 on the fast in-loop route,
    SP2 above 64 AOs, scf_tol 2e-5)."""
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )
    from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import (
        CpcmSolvation,
    )

    variant = "gfn2" if case.startswith("w20_gfn2") else "gfn1"
    dtype = torch.float64
    if case == "dodecamers":
        base = settings_from_params(variant, scf_tol=1e-9, max_scf_iter=64)
    elif case == "sp2_f32":
        base = settings_from_params(variant, use_pallas_eigh=True,
                                    scf_tol=2e-5, max_scf_iter=64)
        dtype = torch.float32
    elif case == "peptide":
        base = settings_from_params(variant)
    else:
        base = settings_from_params(variant, max_scf_iter=32)
    solvation = {"w20_alpb": lambda: BornSolvation(78.4, alpb=True),
                 "cpcm": lambda: CpcmSolvation(78.4)}.get(case)
    return XtbCalculator(base, variant=variant, dtype=dtype, device=device,
                         solvation=solvation and solvation())


def _case_fragments(case):
    """The fragments of a case (`_calculator`)."""
    from metalquicha_tpu_torch.workloads import w20_mbe2_fragments

    if case in ("dodecamers", "sp2_f32"):
        return dodecamers()
    if case == "peptide":
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import memory_probe_torch

        return memory_probe_torch.fragments("peptide", 8)
    if case in ("w20_alpb",):
        return w20_mbe2_fragments()[:20]
    return w20_mbe2_fragments()[20:]


def refined_gradients(calc, frag):
    """(energies, gradients) of a batch through `single_point_energy` with
    diff_scf_iters = 2: the refine route (GFN2's `_aes_fixed_point`
    recorded by autograd, its density the product op's)."""
    from metalquicha_tpu_torch.methods.xtb.calculator import (
        single_point_energy,
    )

    coords = frag.coords.detach().clone().requires_grad_()
    e, _ = single_point_energy(coords, frag, calc.settings,
                               calc.solvation, diff_scf_iters=2)
    (g,) = torch.autograd.grad(e.sum(), coords)
    return e.detach(), g


def _sums(out, case, e, g=None):
    """What the one batch gave, to hold repeats of one process to each
    other: the energies' sum and the gradients' absolute sum."""
    out[f"{case}_energy_sum"] = float(e.sum())
    if g is not None:
        out[f"{case}_gradient_sum"] = float(g.abs().sum())


def beyond_deltas(device, values=False):
    """C17's deltas beyond GFN1: the w20 MBE(2) gradient in GFN2 and with
    ALPB (float64, one batch against the two-slot cut: |g|, max |dg|,
    total); and each as one batch against two halves (max |dE|, max |dg|):
    the 16 dodecamers in float64 and in float32 on SP2's route (`sp2_f32`),
    8 jittered 73-atom peptides (228 AOs, padded to 241), the w20 MBE(2)
    dimers in GFN2 through the refine route (diff_scf_iters = 2,
    `w20_gfn2_refine`, 190 against two of 95); and the w20 MBE(2)
    energies with CPCM (one batch against the two-slot cut: max |dE|,
    total). With `values`, also what the one batch gave (the totals and
    |g|, the energies' and gradients' sums), to hold repeats of one
    process to each other."""
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
        if values:
            out[f"{case}_total"], out[f"{case}_gnorm"] = t1, n1
    for case in ("dodecamers", "sp2_f32", "peptide", "w20_gfn2_refine"):
        calc = _calculator(case, device)
        run = refined_gradients if case == "w20_gfn2_refine" else None
        (e1, g1), (e2, g2) = _halves(calc, _case_fragments(case), True, run)
        tag = "dodecamers_d_energy" if case == "dodecamers" else (
            f"{case}_max_de")
        out[tag] = float((e1 - e2).abs().max())
        out[f"{case}_max_dg"] = float((g1 - g2).abs().max())
        if values:
            _sums(out, case, e1, g1)
    calc = _calculator("cpcm", device)
    e1 = FragmentExecutor(calc).run(frags, what="energy")[0]
    e2 = SerialCut.make(calc).run(frags, what="energy")[0]
    e1, e2 = np.asarray(e1), np.asarray(e2)
    out["cpcm_max_de"] = float(np.abs(e1 - e2).max())
    out["cpcm_d_energy_sum"] = abs(float(e1.sum()) - float(e2.sum()))
    if values:
        out["cpcm_energy_sum"] = float(e1.sum())
    return out


def _halves(calc, frags, grad, run=None):
    """(energies, gradients or None) of `frags` as one batch and as its
    two halves; `run(calc, batch)` in place of `calc.gradients` where
    given."""
    half = len(frags) // 2
    runs = []
    for parts in ([frags], [frags[:half], frags[half:]]):
        outs = []
        for p in parts:
            batch = calc.make_batch(p)
            outs.append(run(calc, batch) if run is not None
                        else calc.gradients(batch) if grad
                        else calc.energies(batch))
        runs.append((torch.cat([o[0] for o in outs]),
                     torch.cat([o[1] for o in outs]) if grad else None))
    return runs


#: where --locate looks (`_calculator`, `_case_fragments`): the whole
#: batch against each half
LOCATE_CASES = ("w20_gfn1", "w20_gfn2", "w20_alpb", "dodecamers", "peptide",
                "sp2_f32", "cpcm")
#: the modules that call the ops of `ops/fragment_reduce.py`
REDUCE_USERS = ("engine", "gfn2", "calculator", "dispersion_d3", "xbond",
                "born", "sp2")


#: (module, function) pairs whose outputs `first_difference` compares; an
#: in-place op (the window) is read after the call from its first argument
TRACED = (
    ("engine", "overlap_matrix"), ("engine", "coordination_numbers"),
    ("engine", "h0_matrix"), ("engine", "gamma_matrix"),
    ("engine", "eigh_folded"), ("engine", "batched_eigh"),
    ("engine", "eigh_safe"), ("engine", "fragment_bmm"),
    ("engine", "sandwich"), ("engine", "fragment_matvec"),
    ("engine", "fermi_density"), ("engine", "sp2_density"),
    ("sp2", "fragment_bmm"), ("cpcm", "batched_solve"), ("cpcm", "_mm"),
    ("engine", "fermi_occupations"), ("engine", "anderson_window"),
    ("engine", "_fock"), ("engine", "_shell_populations"),
    ("engine", "_ortho_factors"), ("engine", "_general_eigh"),
    ("engine", "_scc_density"), ("engine", "_coulomb_potential"),
    ("engine", "moment_matrices"), ("engine", "_aes_potentials"),
    ("engine", "_aes_fock"), ("engine", "_aes_moments_of_P"),
    ("calculator", "_scc_operands"), ("calculator", "_solv_gamma"),
    ("dispersion_d3", "c6_coefficients"), ("dispersion_d3", "d3_energy"),
    ("dispersion_d3", "atm_energy"),
    # the energy's sums (ROADMAP C17 beyond GFN1)
    ("gfn2", "camm_moments"), ("gfn2", "aes_energy"),
    ("engine", "repulsion_energy"), ("engine", "_coulomb_energy"),
    ("engine", "_atom_charges"), ("engine", "electronic_energy"),
    ("engine", "electronic_energy_multipole"),
    ("calculator", "halogen_bond_energy"), ("engine", "eigvalsh"),
    ("Born", "surface_energy"), ("Born", "born_radii"),
    ("Born", "electrostatic_size"), ("Born", "gamma_atoms"),
    # the ops of ops/fragment_reduce.py, where the tree has them
    *((mod, name) for mod in REDUCE_USERS
      for name in ("moment_fock", "moment_rows", "segment_sum",
                   "fragment_sum")),
)
#: autograd Functions whose backward passes are compared too
TRACED_BACKWARD = (("engine", "_EighSafe"), ("engine", "_EighValues"),
                   ("fragment_gemm", "_Bmm"),
                   ("fragment_gemm", "_Sandwich"),
                   ("fragment_gemm", "_Matvec"), ("born", "_ProdLast"),
                   ("fragment_reduce", "_MomentFock"),
                   ("fragment_reduce", "_MomentRows"),
                   ("fragment_reduce", "_SegmentSum"),
                   ("fragment_reduce", "_FragmentSum"),
                   ("fragment_reduce", "_Broadcast"))
#: gathers whose input's gradient (their backward's accumulated rows) is
#: compared
TRACED_GATHERS = (("engine", "_take"), ("engine", "_take2"))


class _Found(Exception):
    pass


class _Trace:
    """The traced calls of one run (`ref` None) or their comparison with a
    recorded run's on its fragments `rows` (a slice)."""

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
            mine = t[self.rows].cpu()
            same = torch.equal(torch.nan_to_num(mine), torch.nan_to_num(r))
            if not same:
                raise _Found({"op": name, "call": k, "max_abs_diff": float(
                    (mine - r).abs().max()), "shape": list(t.shape),
                    "after": [c if isinstance(c, str) else c[0]
                              for c in self.ref[max(0, k - 6):k]]})


def _tensors(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _modules() -> dict:
    """The modules (and the Born model's class) the probe patches, by the
    names TRACED uses; `fragment_reduce` only where the tree has it."""
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import dispersion_d3, engine, gfn2
    from metalquicha_tpu_torch.methods.xtb import xbond
    from metalquicha_tpu_torch.methods.xtb.solvation import born, cpcm
    from metalquicha_tpu_torch.ops import fragment_gemm, sp2

    mods = {"engine": engine, "dispersion_d3": dispersion_d3,
            "fragment_gemm": fragment_gemm, "calculator": tcalc,
            "gfn2": gfn2, "xbond": xbond, "born": born,
            "Born": born.BornSolvation, "sp2": sp2, "cpcm": cpcm}
    try:
        from metalquicha_tpu_torch.ops import fragment_reduce
    except ImportError:
        pass
    else:
        mods["fragment_reduce"] = fragment_reduce
    return mods


def _grad_probe(trace, name):
    """An identity whose backward adds the gradient passing back through
    it to `trace`."""
    class _Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            trace.add(name, g)
            return g
    return _Probe


def _hook_nodes(roots, trace) -> list:
    """A hook on every node of the autograd graph behind `roots` (but the
    leaves' accumulators) that adds the gradients the node passes back to
    `trace`, named by the node; the hooks' handles."""
    stack = [t.grad_fn for t in roots if t.grad_fn is not None]
    seen, handles = set(), []
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        name = node.name()
        if "AccumulateGrad" not in name:
            handles.append(node.register_hook(
                lambda grads, _outs, _n=name: trace.add(f"node {_n}",
                                                        grads)))
        stack.extend(f for f, _ in node.next_functions if f is not None)
    return handles


def first_difference(device, case="w20_gfn1", nodes=False):
    """The first traced value (in call order) of a case's gradients (CPCM:
    energies) that differs between its fragments as one batch (the w20
    MBE(2) dimers: 190; with ALPB its 20 monomers; the dodecamers: 16; the
    peptides: 8) and the first half alone, then the second half alone
    (`half`: which), or None where the results agree bit for bit. With
    `nodes`, the gradient every node of the functional's autograd graph
    passes back is compared too, in the order the backward pass runs them
    (where no traced function differs before the gradient itself)."""
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor

    mods = _modules()
    calc = _calculator(case, device)
    frags = _case_fragments(case)
    half = len(frags) // 2
    # padded as the executor pads the bucket (the dodecamers and peptides
    # as one make_batch builds them)
    pad_to = None
    if case not in ("dodecamers", "sp2_f32", "peptide"):
        ex = FragmentExecutor(calc)
        ((atoms, members),) = ex._buckets(frags).items()
        pad_to = ex._pad_shapes_for(atoms, members)
    runs = {}

    def run(batch, trace):
        saved = []
        for mod, name in TRACED:
            owner = mods.get(mod)
            fn = None if owner is None else owner.__dict__.get(name)
            if fn is None:
                continue
            saved.append((owner, name, fn))

            def traced(*args, _fn=fn, _name=f"{mod}.{name}",
                       _window=name == "anderson_window", **kw):
                out = _fn(*args, **kw)
                trace.add(_name, args[0] if _window else out)
                return out
            setattr(owner, name, traced)
        for mod, name in TRACED_BACKWARD:
            cls = getattr(mods.get(mod), name, None)
            if cls is None:
                continue
            fn = cls.__dict__["backward"]
            saved.append((cls, "backward", fn))

            def backward(ctx, *grads, _fn=fn.__func__, _name=name):
                out = _fn(ctx, *grads)
                trace.add(f"{_name}.backward", out)
                return out
            cls.backward = staticmethod(backward)
        for mod, name in TRACED_GATHERS:
            fn = getattr(mods[mod], name)
            saved.append((mods[mod], name, fn))
            probe = _grad_probe(trace, f"{name}.input_grad")

            def gather(x, idx, _fn=fn, _probe=probe):
                if (torch.is_tensor(x) and x.requires_grad
                        and torch.is_grad_enabled()):
                    x = _probe.apply(x)
                return _fn(x, idx)
            setattr(mods[mod], name, gather)
        real_grad = torch.autograd.grad
        handles = []

        def grad(outputs, inputs, *args, **kw):
            if nodes:
                handles.extend(_hook_nodes(_tensors(outputs), trace))
            return real_grad(outputs, inputs, *args, **kw)
        torch.autograd.grad = grad
        try:
            frag = calc.make_batch(batch, pad_to=pad_to)
            if case == "cpcm":
                trace.add("energies", calc.energies(frag, graph=False)[0])
            else:
                e, g, _ = calc.gradients(frag, graph=False)
                trace.add("gradients", (e, g))
        finally:
            torch.autograd.grad = real_grad
            for h in handles:
                h.remove()
            for owner, name, fn in reversed(saved):
                setattr(owner, name, fn)
        return trace

    for which, rows in (("first", slice(0, half)),
                        ("second", slice(half, 2 * half))):
        runs[which] = run(frags[rows], _Trace(half))
        try:
            run(frags, _Trace(len(frags), runs[which].calls, rows))
        except _Found as found:
            return dict(found.args[0], half=which)
    return None


#: (n) of the in-loop eigh's batch check (`eigh_deltas`), and the batch
#: counts each is cut into
EIGH_SIZES = (16, 32, 33, 48, 64, 72, 96, 128, 160, 192, 228, 241, 256)
EIGH_BATCHES = (2, 3, 4, 8, 16, 41)
#: (B, n) at which the batched call and the one-a-matrix calls are timed:
#: the dodecamers' bucket, the 8 peptides' halves and the FD Hessian's
#: chunk of 41, bench.py's SP2 shape
EIGH_TIMED = ((16, 96), (4, 228), (8, 228), (41, 241), (64, 256))


def eigh_deltas(device):
    """How far the binding's XsyevBatched gives a matrix eigenpairs that
    depend on its batch, per n of EIGH_SIZES, float64 and float32, on
    seeded symmetric matrices (the largest |dw| and |dV|; 0: the same
    bits): the first B of a batch of 41 solved as a batch of B
    (EIGH_BATCHES) against the batch of 41 (`batched`), and each matrix
    alone, a (1, n, n) call, against it (`single`); and the graph-replayed
    ms of the batched call and of B one-a-matrix calls at EIGH_TIMED."""
    from chip_smoke import graph_ms

    from metalquicha_tpu_torch.ops import batched_eigh as be

    out = {"sizes": {}, "times": {}}
    top = max(EIGH_BATCHES)

    def solve(m, single):
        status = be.EighStatus(m)
        got = be._launch(m, status, single)
        status.check()
        return got

    def delta(got, ref):
        return (float((got[0] - ref[0]).abs().max()),
                float((got[1] - ref[1]).abs().max()))

    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        rng = np.random.default_rng(23)
        for n in EIGH_SIZES:
            x = rng.standard_normal((top, n, n))
            a = torch.tensor(x + x.transpose(0, 2, 1), dtype=dtype,
                             device=device)
            w0, v0 = solve(a, False)
            rec = {}
            for name, got in (
                    ("batched", [solve(a[:b].contiguous(), False) + (b,)
                                 for b in EIGH_BATCHES]),
                    ("single", [solve(a[:4], True) + (4,)])):
                dw, dv = zip(*(delta((w, v), (w0[:b], v0[:b]))
                               for w, v, b in got))
                rec[name] = {"max_dw": max(dw), "max_dv": max(dv)}
            out["sizes"][f"{tag}/{n}"] = rec
            print(f"c17 eigh {tag} n={n}: against the batch of {top}: "
                  f"{rec}", flush=True)
        for bsz, n in EIGH_TIMED:
            x = rng.standard_normal((bsz, n, n))
            a = torch.tensor(x + x.transpose(0, 2, 1), dtype=dtype,
                             device=device)
            status = be.EighStatus(a)
            rec = {f"{name}_ms": graph_ms(
                lambda single=single: be._launch(a, status, single), 5)
                for name, single in (("batched", False), ("single", True))}
            status.check()
            out["times"][f"{tag}/{bsz}x{n}"] = rec
            print(f"c17 eigh {tag} ({bsz}, {n}): {rec}", flush=True)
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


def _library_products():
    """The kernel ops replaced by the torch calls they replaced (cuBLAS's
    batched products on a card), by (module, name)."""
    def bmm(a, b, trans_a=False, trans_b=False):
        return torch.matmul(a.transpose(-1, -2) if trans_a else a,
                            b.transpose(-1, -2) if trans_b else b)

    def pair_bilinear(w, grids):
        v = torch.einsum("bia,bijac->bijc", w, grids)
        return torch.einsum("bijc,bjc->bij", v, w)

    return {("engine", "fragment_bmm"): bmm, ("sp2", "fragment_bmm"): bmm,
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
            ("sp2", "fragment_bmm"): fm.fragment_bmm,
            ("engine", "sandwich"): fm.sandwich,
            ("engine", "fragment_matvec"): fm.fragment_matvec,
            ("dispersion_d3", "pair_bilinear"): fm.pair_bilinear}


def _windows():
    from metalquicha_tpu_torch.ops import anderson_window as aw

    return {"kernel": aw.anderson_window,
            "library": _plain(aw.anderson_window_reference),
            "looped": _plain(aw.anderson_window_reference, looped_solve),
            "rowwise": _plain(aw.anderson_window_rowwise)}


#: the entries each --reductions step puts on the kernel
REDUCTION_STEPS = {
    "none": (),
    "fock": ("moment_fock",),
    "rows": ("moment_fock", "moment_rows"),
    "all": ("moment_fock", "moment_rows", "segment_sum", "fragment_sum",
            "take", "take2", "broadcast"),
}


def _torch_reductions() -> dict:
    """The torch expressions the ops of `ops/fragment_reduce.py` replaced
    (a CPU tensor's route), by name."""
    from metalquicha_tpu_torch.ops import fragment_reduce as fr

    return {"moment_fock": fr._torch_moment_fock,
            "moment_rows": fr._torch_moment_rows,
            "segment_sum": fr._torch_segment_sum,
            "fragment_sum": lambda x, dim=-1: x.sum(dim),
            "take": fr._torch_take, "take2": fr._torch_take2,
            "broadcast": lambda x, shape: x}


def _route_reductions(step) -> list:
    """Put the entries of `step` on the kernel and the others on torch's
    expressions in every module that calls them; returns what to
    restore."""
    mods = _modules()
    saved = []
    for name, fn in _torch_reductions().items():
        if name in REDUCTION_STEPS[step]:
            continue
        for mod in REDUCE_USERS:
            if name in mods[mod].__dict__:
                saved.append((mods[mod], name, mods[mod].__dict__[name]))
                setattr(mods[mod], name, fn)
    return saved


def _beyond_and_locate(args, device, tag, result) -> None:
    """--beyond and --locate on the routes in place, into
    `result` under keys tagged `tag`."""
    from metalquicha_tpu_torch.methods.xtb import scc_graph

    if args.beyond:
        scc_graph.clear()
        result[f"beyond_{tag}"] = beyond_deltas(device)
        print(f"c17 cut deltas beyond GFN1, route {tag}: "
              f"{result[f'beyond_{tag}']}", flush=True)
    if args.locate:
        for case in LOCATE_CASES:
            key = (f"first_{tag}" if case == "w20_gfn1"
                   else f"first_{tag}_{case}")
            result[key] = first_difference(device, case)
            print(f"c17 first value that depends on the batch, route "
                  f"{tag}, {case}: {result[key]}", flush=True)
            if (result[key] or {}).get("op") == "gradients":
                # no traced value before the gradient: the backward's nodes
                result[key + "_node"] = first_difference(device, case,
                                                         nodes=True)
                print(f"c17 first backward node that depends on the "
                      f"batch, route {tag}, {case}: "
                      f"{result[key + '_node']}", flush=True)
    scc_graph.clear()


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
    ap.add_argument("--reductions", default="all",
                    help="comma-separated steps of the sums of "
                         "ops/fragment_reduce.py on the kernel (none, fock, "
                         "rows, all) for --beyond and --locate")
    ap.add_argument("--beyond", action="store_true",
                    help="also the deltas beyond GFN1 (GFN2, ALPB, the "
                         "dodecamers above 64 AOs in float64 and on SP2, "
                         "the 73-atom peptides, GFN2's refine route, "
                         "CPCM), per products and reductions route")
    ap.add_argument("--locate", action="store_true",
                    help="name the first value that depends on the batch, "
                         "per products and reductions route and case")
    ap.add_argument("--eigh", action="store_true",
                    help="also whether the in-loop eigh's batched call "
                         "gives a matrix its one-a-matrix eigenpairs, per "
                         "size, and both calls' times")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    from metalquicha_tpu_torch.logging_ import global_logger
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import dispersion_d3, engine
    from metalquicha_tpu_torch.methods.xtb import scc_graph
    from metalquicha_tpu_torch.ops import sp2

    global_logger.set_level("warning")
    device = tcalc.check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": str(device)}
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
    if args.eigh:
        result["eigh"] = eigh_deltas(device)
    windows, real = _windows(), engine.anderson_window
    mods = {"engine": engine, "dispersion_d3": dispersion_d3, "sp2": sp2}
    real_products = _products("kernel")
    for products in args.products.split(","):
        for (mod, name), fn in _products(products).items():
            setattr(mods[mod], name, fn)
        try:
            for name in filter(None, args.solves.split(",")):
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
            for step in filter(None, args.reductions.split(",")):
                tag = products + ("" if step == "all" else f"_{step}")
                saved = _route_reductions(step)
                try:
                    _beyond_and_locate(args, device, tag, result)
                finally:
                    for owner, name, fn in reversed(saved):
                        setattr(owner, name, fn)
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
