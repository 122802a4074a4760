#!/usr/bin/env python3
"""Device times of the Anderson window kernel, the fragment product
kernel and the fragment sum kernel at the main path's shapes, on a card.

Each kernel is timed two ways: its launches replayed from one CUDA graph
(`graph_ms`: the kernel's own time, no host time between launches) and
launched one by one from Python with CUDA events around the calls
(`eager_ms`, as `chip_smoke.py`'s window phase timed it before: where the
wrapper's host time is longer than the kernel, that is what it reads).
The product kernel is timed beside torch.matmul (cuBLAS's batched
product), graph-replayed too, with its bound (`chip_smoke.gemm_bound`,
here `gemm_bound`): the product, the sandwich x f x + s against torch's
`x @ f @ x + s`, and the matvec (B, n, n) by (B, n) and its transposed
form against torch.matmul's, at those shapes and at
`chip_smoke.MATVEC_SHAPES` (the Coulomb matvec's shell counts, and the
sizes its kernel cuts into bands), beside `chip_smoke.matvec_bound`. The
fragment sums (`csrc/fragment_reduce.cu`, section
"reduce") are timed graph-replayed in every form of
`chip_smoke.reduce_forms` at `chip_smoke.REDUCE_SHAPES`, on
`chip_smoke._reduce_case`'s operands, beside the torch expression each
replaced and `chip_smoke.reduce_bound`; section "rows" times
`fragment_sum` alone over (rows, length) tensors at
`chip_smoke.ROW_SUM_CASES` (lane groups, four rows a group, clusters of
2 to 16 blocks a row, a block a row) beside torch's sum. Section "fock"
times moment_fock alone, in its three forms of `chip_smoke.reduce_forms`
(the dipoles and quadrupoles, the dipoles alone, the contraction without
the symmetrisation at d = 6: `moment_contract`) at
`chip_smoke.REDUCE_SHAPES`; section "pair" D3's pair contraction
(`pair_bilinear`) at `chip_smoke.PAIR_SHAPES` beside the two einsums it
replaced and `chip_smoke.pair_bound`. Section "wide" times the shapes
above 64 (`WIDE`: the products and the sandwich at the peptide's 241 and
SP2's 256, the matvec at the peptide's 192 shells, CPCM's (nat, points)
by (points, nat) and its backward's form (launched as the op's backward
launches it), the small batches (16, 96) and (3, 128)) through
the engine's dispatch (`_mm`, `_sandwich`, `_matvec`: the kernel in a tree
whose op takes the sizes, torch.matmul in one whose op does not) beside
torch.matmul and the bound; section "sp2" SP2's density (`sp2_density`,
48 iterations, closed shell) at `SP2` in float32 on the ops of the tree
(or on its torch.matmul), beside its FLOP bound. Section "fermi" times
the Fermi kernels on `chip_smoke.fermi_inputs`' batches at 300 K, f64
and f32: the fill (`fermi_occupations`) at `chip_smoke.FERMI_TIMED`, and
the fused fill and density (`fermi_density`) at `FERMI_DENSITY` (the
main path's shapes and other batch sizes of each class) beside the fill
and torch's product it replaced and, in a tree
with the plain skipping bisection, the bounds (`chip_smoke.fermi_bound`,
`fermi_density_bound` on its steps) and the steps taken with and without
a row sum.

With an older checkout first on PYTHONPATH (unpacked with `git archive`
into the gitignored `_archive/`), it times that checkout's kernels; the
product kernel where the checkout has one.

Usage: python3 tools/kernel_times_torch.py [--reps N] [--sections
window,gemm,reduce,rows,fock,pair,wide,sp2,fermi] [--json-out F]
It prints a line per shape (per form in "reduce") and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

#: (B, nx) of the window on the main path (chip_smoke.WINDOW_SHAPES)
WINDOW_SHAPES = ((512, 12), (512, 62), (5985, 24), (64, 36), (64, 186))
WINDOW_M = 12
#: (reg, c_lim) the engine passes per dtype
WINDOW_LIMITS = {torch.float64: (1e-12, 1e3), torch.float32: (1e-4, 2.0)}
#: (B, n) of the products on the main path (chip_smoke.GEMM_SHAPES)
GEMM_SHAPES = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
               (128, 64))
#: (B, m, k, n) above 64, each with the engine's entry that runs it: the
#: peptide's 241 AOs (8 jittered copies' half batch of 4, and the FD
#: Hessian's chunk of 41), SP2's (64, 256), the peptide's 192 shells, CPCM's
#: (nat, points) by (points, nat) at the w20 dimers (trans_a) and its
#: backward's (points, nat) by (nat, nat) (`mm_bwd`: the op's backward
#: launches it, past MAX_N in m), the small batches of the tiled class (the
#: dodecamers' (16, 96), (3, 128)) and the sandwich at (16, 96)
WIDE = (("mm", 41, 241, 241, 241), ("mm", 64, 256, 256, 256),
        ("sandwich", 41, 241, 241, 241), ("sandwich", 64, 256, 256, 256),
        ("matvec", 41, 192, 192, 1), ("mm_ta", 190, 6, 660, 6),
        ("mm_bwd", 190, 660, 6, 6), ("mm", 3, 128, 128, 128),
        ("mm", 16, 96, 96, 96), ("sandwich", 16, 96, 96, 96))
#: (B, n, real states) of SP2's density: the dodecamers' bucket and
#: bench.py's (64, 256)
SP2 = ((16, 96, 72), (64, 256, 240))
#: (B, nao) of the fused fill and density: chip_smoke.DENSITY_SHAPES, then
#: GFN2's chunk of 1767 dimers and a batch past it at 16, batches on both
#: sides of the rows of 32 a half-warp (1024, 1584) and the hexamers'
#: (64, 48)
FERMI_DENSITY = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
                 (128, 64), (1767, 16), (4096, 16), (1024, 32), (1584, 32),
                 (64, 48))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# after an older checkout on PYTHONPATH, so that its package comes first
if ROOT not in sys.path:
    sys.path.append(ROOT)
#: the card's peak rates (chip_smoke.PEAK_FLOPS, PEAK_BYTES)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def gemm_bound(bsz: int, n: int, bits: int, sandwich: bool = False):
    """(bound_ms, bound_by) of a batch of (n, n) products, as
    chip_smoke.gemm_bound: 2 n^3 operations a product (the sandwich two
    and an add) at the peak rate, or the operands read and the result
    written once at the memory rate."""
    k = 2 if sandwich else 1
    flop = bsz * (k * 2 * n**3 + (n * n if sandwich else 0))
    nbytes = bsz * (k + 2) * n * n * bits // 8
    times = {"operations": flop / PEAK_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def eager_ms(fn, reps: int) -> float:
    """Mean time per call of reps calls launched from Python, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time per call of reps calls captured in one CUDA graph
    and replayed (after a warm-up replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def window_state(rng, bsz: int, nx: int, dtype, it: int = 11):
    """A seeded Anderson state at iteration `it` on the card (as
    chip_smoke.window_state)."""
    m = WINDOW_M
    target = rng.standard_normal((bsz, nx))
    hist_x = np.zeros((bsz, m, nx))
    hist_f = np.zeros((bsz, m, nx))
    for k in range(it):
        xk = target + 0.5 ** k * rng.standard_normal((bsz, nx))
        hist_x[:, k % m] = xk
        hist_f[:, k % m] = (target - xk) * 0.7 + 1e-3 * 0.5 ** k * (
            rng.standard_normal((bsz, nx)))
    x = target + 0.5 ** it * rng.standard_normal((bsz, nx))
    active = np.ones(bsz, dtype=bool)
    active[-1] = False
    out = [torch.tensor(a, dtype=dtype, device="cuda") for a in
           (x, (target - x) * 0.7, hist_x, hist_f, rng.uniform(0, 1, bsz))]
    return (*out, torch.tensor(active, device="cuda"),
            torch.tensor(it, dtype=torch.int64, device="cuda"))


def chip_smoke():
    """This tree's chip_smoke.py as a module (an older checkout first on
    PYTHONPATH holds a chip_smoke.py of its own)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["chip_smoke"] = module
    return sys.modules["chip_smoke"]


def reduce_times(reps: int, entries=None) -> list:
    """Every form of chip_smoke.reduce_forms at chip_smoke.REDUCE_SHAPES
    (of `entries` only, where given), float64 and float32: the kernel's
    and torch's graph-replayed ms and the bound."""
    cs = chip_smoke()
    fr = importlib.import_module("metalquicha_tpu_torch.ops.fragment_reduce")
    out = []
    rng = np.random.default_rng(17)
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for bsz, n in cs.REDUCE_SHAPES:
            c = cs._reduce_case(rng, bsz, n, dtype)
            c["f1"] = c["f"][:, None]
            for entry, forms in cs.reduce_forms(fr, n).items():
                if entries is not None and entry not in entries:
                    continue
                for label, kernel, _plain, library, kw in forms:
                    rec = {"dtype": tag, "shape": [bsz, n], "entry": entry,
                           "form": label,
                           "ms": graph_ms(lambda: kernel(c), reps),
                           "torch_ms": graph_ms(lambda: library(c), reps),
                           "bound_ms": cs.reduce_bound(entry, bsz, n, dtype,
                                                       **kw)[0]}
                    out.append(rec)
                    print(f"sums {tag} {bsz}x{n} {entry} {label}: "
                          f"ms={rec['ms']:.4f} torch ms="
                          f"{rec['torch_ms']:.4f} bound ms="
                          f"{rec['bound_ms']:.6f}", flush=True)
    return out


def pair_times(fm, reps: int) -> list:
    """`pair_bilinear` at chip_smoke.PAIR_SHAPES, float64 and float32 (its
    weights and grids drawn as chip_smoke's rect phase draws them): its
    and the two einsums' graph-replayed ms and the bound."""
    cs = chip_smoke()
    rng = np.random.default_rng(20)
    out = []
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for bsz, nat in cs.PAIR_SHAPES:
            w = torch.tensor(rng.random((bsz, nat, 5)), dtype=dtype,
                             device="cuda")
            w = w / w.sum(-1, keepdim=True)
            grids = torch.tensor(rng.random((bsz, nat, nat, 5, 5)) * 40.0,
                                 dtype=dtype, device="cuda")

            def einsums():
                v = torch.einsum("bia,bijac->bijc", w, grids)
                return torch.einsum("bijc,bjc->bij", v, w)

            rec = {"dtype": tag, "shape": [bsz, nat],
                   "ms": graph_ms(lambda: fm.pair_bilinear(w, grids), reps),
                   "torch_ms": graph_ms(einsums, reps),
                   "bound_ms": cs.pair_bound(bsz, nat, dtype)[0]}
            out.append(rec)
            print(f"pair {tag} {bsz}x{nat}: ms={rec['ms']:.4f} torch ms="
                  f"{rec['torch_ms']:.4f} bound ms={rec['bound_ms']:.6f}",
                  flush=True)
    return out


def matvec_times(fm, rng, dtype, reps: int) -> list:
    """The matvec in both forms at chip_smoke.MATVEC_SHAPES: the kernel's
    and torch.matmul's graph-replayed ms and the bound."""
    cs = chip_smoke()
    tag = "f64" if dtype == torch.float64 else "f32"
    out = []
    for bsz, n in cs.MATVEC_SHAPES:
        m = torch.tensor(rng.standard_normal((bsz, n, n)), dtype=dtype,
                         device="cuda")
        x = torch.tensor(rng.standard_normal((bsz, n)), dtype=dtype,
                         device="cuda")
        rec = {"dtype": tag, "shape": [bsz, n],
               "bound_ms": cs.matvec_bound(bsz, n, dtype)[0]}
        for form, trans in (("plain", False), ("transposed", True)):
            mt = m.mT if trans else m
            rec[f"{form}_ms"] = graph_ms(
                lambda: fm.fragment_matvec(m, x, trans), reps)
            rec[f"{form}_torch_ms"] = graph_ms(
                lambda: torch.matmul(mt, x[..., None]), reps)
        out.append(rec)
        print(f"matvec {tag} {bsz}x{n}: {rec}", flush=True)
    return out


def _flop_bound(flop: float, nbytes: float, dtype) -> float:
    """The larger of the operations at the peak rate and the bytes at the
    memory rate, in ms."""
    return max(flop / PEAK_FLOPS, nbytes * torch.finfo(dtype).bits / 8
               / PEAK_BYTES) * 1e3


def wide_times(reps: int) -> list:
    """The cases of WIDE, float64 and float32, through the engine's
    dispatch of the tree first on the path, beside torch.matmul: graph-
    replayed ms and the bound (the operands read and the result written
    once, or 2 m k n operations a product, at the peak rates)."""
    te = importlib.import_module("metalquicha_tpu_torch.methods.xtb.engine")
    rng = np.random.default_rng(21)
    out = []
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for entry, bsz, m, k, n in WIDE:
            def draw(*shape):
                return torch.tensor(rng.standard_normal((bsz, *shape)),
                                    dtype=dtype, device="cuda")

            if entry == "matvec":
                a, x = draw(m, k), draw(k)
                route = (lambda: te._matvec(a, x))
                library = (lambda: torch.matmul(a, x[..., None]))
                flop, nbytes = 2 * bsz * m * k, bsz * (m * k + m + k)
            elif entry == "sandwich":
                a, f, sh = draw(m, m), draw(m, m), draw(m, m)
                route = (lambda: te._sandwich(a, f, sh))
                library = (lambda: a @ f @ a + sh)
                flop, nbytes = 4 * bsz * m ** 3, 4 * bsz * m * m
            else:
                ta = entry == "mm_ta"
                a, b = draw(*((k, m) if ta else (m, k))), draw(k, n)
                route = (lambda: te._mm(a, b, trans_a=ta))
                if entry == "mm_bwd":
                    fm = importlib.import_module(
                        "metalquicha_tpu_torch.ops.fragment_gemm")
                    route = (lambda: fm._launch_bmm(a, b, False, False))
                library = (lambda: torch.matmul(a.mT if ta else a, b))
                flop = 2 * bsz * m * k * n
                nbytes = bsz * (m * k + k * n + m * n)
            rec = {"dtype": tag, "entry": entry, "shape": [bsz, m, k, n],
                   "route_ms": graph_ms(route, reps),
                   "torch_ms": graph_ms(library, reps),
                   "bound_ms": _flop_bound(flop, nbytes, dtype)}
            out.append(rec)
            print(f"wide {tag} {entry} {bsz}x{m}x{k}x{n}: route ms="
                  f"{rec['route_ms']:.4f} torch ms={rec['torch_ms']:.4f} "
                  f"bound ms={rec['bound_ms']:.6f}", flush=True)
    return out


def sp2_times(reps: int) -> list:
    """SP2's density at SP2, float32, closed shell, 48 iterations
    (`chip_smoke.sp2_inputs`' matrices): graph-replayed ms beside the
    bound of its products (2 n^3 operations an iteration)."""
    cs = chip_smoke()
    sp2 = importlib.import_module("metalquicha_tpu_torch.ops.sp2")
    rng = np.random.default_rng(22)
    out = []
    for bsz, n, n_real in SP2:
        a_np, mask_np, nocc = cs.sp2_inputs(rng, bsz, n, n_real)
        a = torch.tensor(a_np, dtype=torch.float32, device="cuda")
        mask = torch.tensor(mask_np, dtype=torch.float32, device="cuda")
        nelec = torch.full((bsz,), 2.0 * nocc, device="cuda")
        nuhf = torch.zeros(bsz, device="cuda")
        rec = {"dtype": "f32", "shape": [bsz, n],
               "ms": graph_ms(lambda: sp2.sp2_density(
                   a, nelec, nuhf, mask, closed_shell=True), max(reps // 10,
                                                                 2)),
               "bound_ms": _flop_bound(48 * 2 * bsz * n ** 3,
                                       2 * bsz * n * n, torch.float32)}
        out.append(rec)
        print(f"sp2 f32 {bsz}x{n}: ms={rec['ms']:.4f} bound ms="
              f"{rec['bound_ms']:.6f}", flush=True)
    return out


def fermi_times(reps: int) -> list:
    """The Fermi kernels of the tree first on the path at 300 K, float64
    and float32, graph-replayed ms: the fill at chip_smoke.FERMI_TIMED,
    the fused fill and density at FERMI_DENSITY beside the fill and
    torch's product (`fill_matmul_ms`);
    bounds and steps where the tree has the plain skipping bisection."""
    cs = chip_smoke()
    ff = importlib.import_module("metalquicha_tpu_torch.ops.fermi_fill")
    ff.build()
    from metalquicha_tpu_torch.constants import KB_HARTREE

    kt = 300.0 * KB_HARTREE
    rng = np.random.default_rng(23)
    traced = hasattr(ff, "_bisect_skipping")
    out = []
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for bsz, nao in cs.FERMI_TIMED:
            eps, nelec, nuhf, mask = cs.fermi_inputs(rng, bsz, nao, dtype)
            rec = {"entry": "fill", "dtype": tag, "shape": [bsz, nao],
                   "ms": graph_ms(lambda: ff.fermi_occupations(
                       eps, nelec, nuhf, kt, mask), reps)}
            if traced:
                steps, full = cs.fermi_trace(ff, eps, nelec, nuhf, kt, mask)
                rec.update(steps=int(steps.sum()), full=int(full.sum()),
                           bound_ms=cs.fermi_bound(bsz, nao, dtype, steps,
                                                   full)[0])
            out.append(rec)
            print(f"fermi fill {tag} {bsz}x{nao}: {rec}", flush=True)
        for bsz, nao in FERMI_DENSITY:
            eps, nelec, nuhf, mask = cs.fermi_inputs(rng, bsz, nao, dtype)
            c = torch.tensor(rng.standard_normal((bsz, nao, nao))
                             / np.sqrt(nao), dtype=dtype, device="cuda")

            def fill_matmul():
                f, _ = ff.fermi_occupations(eps, nelec, nuhf, kt, mask)
                return (c * f[:, None, :]) @ c.transpose(-1, -2)

            def fused():
                return ff.fermi_density(eps, c, nelec, nuhf, kt, mask)

            rec = {"entry": "density", "dtype": tag, "shape": [bsz, nao],
                   "fill_matmul_ms": graph_ms(fill_matmul, reps),
                   "ms": graph_ms(fused, reps)}
            if traced:
                steps, full = cs.fermi_trace(ff, eps, nelec, nuhf, kt, mask)
                rec.update(steps=int(steps.sum()), full=int(full.sum()),
                           bound_ms=cs.fermi_density_bound(
                               bsz, nao, dtype, steps, full)[0],
                           bytes_ms=cs.fermi_density_bytes_ms(bsz, nao,
                                                              dtype))
            out.append(rec)
            print(f"fermi density {tag} {bsz}x{nao}: {rec}", flush=True)
    return out


def row_times(reps: int) -> list:
    """fragment_sum over (rows, length) tensors at
    chip_smoke.ROW_SUM_CASES, float64 and float32: the kernel's and torch's
    sum's graph-replayed ms and the bound (every element read once)."""
    cs = chip_smoke()
    fr = importlib.import_module("metalquicha_tpu_torch.ops.fragment_reduce")
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = []
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for rows, length in cs.ROW_SUM_CASES:
            x = torch.randn((rows, length), generator=gen, dtype=dtype,
                            device="cuda")
            rec = {"dtype": tag, "shape": [rows, length],
                   "ms": graph_ms(lambda: fr.fragment_sum(x), reps),
                   "torch_ms": graph_ms(lambda: x.sum(-1), reps),
                   "bound_ms": cs.reduce_bound("fragment_sum", 1, 0, dtype,
                                               length=length,
                                               rows=rows)[0]}
            out.append(rec)
            print(f"rows {tag} {rows}x{length}: ms={rec['ms']:.4f} torch "
                  f"ms={rec['torch_ms']:.4f} bound ms={rec['bound_ms']:.6f}",
                  flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sections", default="window,gemm,reduce")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    sections = set(args.sections.split(","))
    from metalquicha_tpu_torch.ops import anderson_window as aw

    aw.build()
    try:
        fm = importlib.import_module(
            "metalquicha_tpu_torch.ops.fragment_gemm")
        fm.build()
    except ModuleNotFoundError:
        fm = None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    result = {"card": card, "source": aw.__file__, "window": [],
              "gemm": [], "matvec": [], "reduce": []}
    rng = np.random.default_rng(14)
    for dtype in (torch.float64, torch.float32):
        if "window" not in sections:
            break
        tag = "f64" if dtype == torch.float64 else "f32"
        reg, c_lim = WINDOW_LIMITS[dtype]
        kw = dict(beta=0.4, reg=reg, c_lim=c_lim, scf_tol=1e-6)
        for bsz, nx in WINDOW_SHAPES:
            state = window_state(rng, bsz, nx, dtype)

            def step(st=state):
                aw.anderson_window(*st, **kw)

            rec = {"dtype": tag, "shape": [bsz, nx],
                   "eager_ms": eager_ms(step, args.reps),
                   "graph_ms": graph_ms(step, args.reps)}
            result["window"].append(rec)
            print(f"window {tag} {bsz}x{nx}: {rec}", flush=True)
    for dtype in (torch.float64, torch.float32):
        if fm is None or "gemm" not in sections:
            break
        tag = "f64" if dtype == torch.float64 else "f32"
        for bsz, n in GEMM_SHAPES:
            a, b, s = (torch.tensor(rng.standard_normal((bsz, n, n)),
                                    dtype=dtype, device="cuda")
                       for _ in range(3))
            v = b[:, 0].contiguous()  # as the engine's charges: no copy
            bits = torch.finfo(dtype).bits
            rec = {"dtype": tag, "shape": [bsz, n],
                   "bound_ms": gemm_bound(bsz, n, bits)[0],
                   "sandwich_bound_ms": gemm_bound(bsz, n, bits, True)[0]}
            for name, fn in (
                    ("bmm", lambda: fm.fragment_bmm(a, b, False, True)),
                    ("matmul", lambda: torch.matmul(a, b.mT)),
                    ("sandwich", lambda: fm.sandwich(a, b, s)),
                    ("torch_sandwich", lambda: a @ b @ a + s),
                    ("matvec", lambda: fm.fragment_matvec(a, v)),
                    ("torch_matvec", lambda: torch.matmul(a, v[..., None])),
                    ("matvec_t", lambda: fm.fragment_matvec(a, v, True)),
                    ("torch_matvec_t",
                     lambda: torch.matmul(a.mT, v[..., None]))):
                rec[f"{name}_graph_ms"] = graph_ms(fn, args.reps)
                rec[f"{name}_eager_ms"] = eager_ms(fn, args.reps)
            result["gemm"].append(rec)
            print(f"products {tag} {bsz}x{n}: {rec}", flush=True)
        result["matvec"] += matvec_times(fm, rng, dtype, args.reps)
    if sections & {"reduce", "rows", "fock"}:
        importlib.import_module(
            "metalquicha_tpu_torch.ops.fragment_reduce").build()
    if "reduce" in sections:
        result["reduce"] = reduce_times(args.reps)
    if "fock" in sections:
        result["fock"] = reduce_times(args.reps, ("moment_fock",))
    if "pair" in sections and fm is not None:
        result["pair"] = pair_times(fm, args.reps)
    if "rows" in sections:
        result["rows"] = row_times(args.reps)
    if "wide" in sections:
        result["wide"] = wide_times(args.reps)
    if "sp2" in sections:
        result["sp2"] = sp2_times(args.reps)
    if "fermi" in sections:
        result["fermi"] = fermi_times(args.reps)
    line = json.dumps(result)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
