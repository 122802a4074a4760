#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: `python3 chip_smoke.py`.

Phases (each raises on failure; nothing is caught):
1. kernel:   builds the Jacobi eigensolver kernel from csrc/, compares it
             with its plain torch version and with torch.linalg.eigh at
             the main path's shapes (B, N) = (20, 11), (190, 16), (512, 16),
             (5985, 32), at (128, 64), at an odd N (7, 13) and at (6000, 16)
             (more matrices than the card holds at once), in float32 and
             float64, and times all three at all but the last two, beside
             the kernel's bound (FLOP or bytes, whichever is larger) and its
             share of it;
1b. fermi:   the Fermi kernels (csrc/fermi_fill.cu, built beside the
             Jacobi kernel before phase 1, one nvcc each, started
             together), first bit for bit their fingerprint
             (tests/data/fermi_bits.json, tools/fermi_bits_torch.py
             --check: f, entropy, steps and P of the kernels at commit
             bb294ac, at batches on both sides of each of the fused
             kernel's launch thresholds). The
             fill (`fermi_occupations`) against its plain
             torch version at the main path's row shapes, (B, nao) =
             (512, 16) (the dimer slice), (190, 16) and (20, 11) (the w20
             MBE(2) buckets), (2581, 32) and (5985, 32) (the w20 MBE(4)
             gradient and energy chunks) and (41, 241) (a chunk of the
             73-atom FD Hessian), each fragment's two spin channels (a
             closed shell filled once), and at (3, 300) (a row longer than
             the kernel keeps in registers) and (64, 8) (quarter-warp
             rows), in float64 (max |df| and max |d entropy| <= 1e-12) and
             float32 (1e-5 and 1e-4); seeded unsorted levels with padded
             AOs, nuhf 0, 1 and 2 mixed and near-degenerate pairs at 300 K;
             the bisection steps the kernel took and the plain version
             needs, and on the plain trace (`fermi_trace`) those that
             evaluated a row sum and those of runs of clamped steps; times
             both at all but the last two, in turns, beside the kernel's
             bound (`fermi_bound` on the plain trace, a skipped step
             charged as the scalar step it is, and the 80-step count). The
             fused fill and density (`fermi_density`) against
             `fermi_density_reference` at (512, 16), (190, 16), (20, 11),
             (2581, 32), (5985, 32) and (128, 64) (max |dP| <= 1e-12 in
             float64, 1e-5 in float32), graph-replayed beside the fill and
             the product it replaces, the plain version and its bounds
             (`fermi_density_bound`, and the bytes alone); the main path's
             fused launches counted by class of nao (16, 32, 64);
1c. window:  the Anderson window kernel (csrc/anderson_window.cu, built
             with the others; a warp per fragment up to nx = 32, a block
             above) against its plain versions, the torch
             algebra it replaces (`anderson_window_reference`: batched
             products and torch.linalg.solve_ex) and the kernel's order in
             elementwise ops (`anderson_window_rowwise`), at (B, nx) =
             (512, 12) and (512, 62) (the dimer slice in GFN1 and GFN2),
             (5985, 24) (the w20 MBE(4) chunk), (64, 36) and (64, 186)
             (GFN1 and GFN2 water hexamers), m = 12, float64 (1e-12) and
             float32 (1e-5), the active flags equal; a fragment alone and
             in its batch bit for bit equal; the kernel (graph-replayed:
             its device time; and launched one by one from Python, as
             the phase timed it before), the rowwise twin (plain_ms) and the reference
             (library_ms) timed beside the bound (`window_bound`);
             windows above 32 (ROADMAP C21): m = 40 and 64 partly
             filled at (512, 12) and wrapped at (64, 186), against both
             plain versions;
1d. gemm:    the batch-invariant product kernel (csrc/fragment_gemm.cu,
             built with the others) bit for bit its first version's
             (commit df9980a) at
             every case of the fingerprint fixture
             (tests/data/fragment_gemm_bits.json, tools/gemm_bits_torch.py);
             operands with a storage offset and of odd n bit for bit the
             same products on aligned operands; against its plain versions (the
             kernel's order in elementwise ops) and torch.matmul at (B, n)
             = (512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
             (128, 64), above 64 (the tiled class, units cut to the
             batch and the shape) at (16, 96) and (3, 128) (small
             batches), (41, 241) and (64, 256) (wide squares), each
             fingerprinted: the product with every transpose, the sandwich
             x f x + s and the matvec with and without its transpose;
             the rectangular products of D3's C6 contraction ((1, 5) by
             (5, 5) per atom pair of a 73-atom Hessian chunk and of the
             w20 dimers, and its backward's (5, 1) by (1, 5)) and of
             CPCM's (nat, points) by (points, nat) at the w20 dimers and
             monomers and its backward's (points, nat) by (nat, nat) with
             every transpose (CPCM's forward and backward timed beside
             torch.matmul and `rect_bound`), and the contraction itself
             (`pair_bilinear`, one
             launch of its own kernel) bit for bit its plain version
             (`pair_bilinear_reference`) and against the einsums it
             replaced, its backward (dw, dgrids) bit for bit alone and
             in its batch, timed beside the einsums and `pair_bound`;
             float64 (1e-13 of the largest entry) and float32 (1e-5); a
             fragment alone and in its batch bit for bit equal; the
             product and the sandwich,
             the plain version and torch.matmul (library_ms) timed
             graph-replayed beside the bound (`gemm_bound`), the matvec
             beside torch.matmul's; the Coulomb matvec on its own kernel
             (`matvec_phase`) at the shell counts (512, 12), (5985, 24),
             (64, 36) and at (16, 96), (3, 128), (41, 192), plain and
             transposed,
             against its plain version and torch.matmul, alone and in
             its batch and on an offset operand bit for bit, timed
             beside torch.matmul and `matvec_bound`;
1e. sums:   the batch-invariant fragment sums (csrc/fragment_reduce.cu,
             built with the others): GFN2's moment contraction into the
             Fock matrix (`moment_fock`, d = 3 and 6 at once, d = 3
             alone, and its contraction without the symmetrisation,
             `moment_contract`, at d = 6 as moment_rows' backward runs
             it), the moment
             row sums (`moment_rows`: d = 3 and 6 into atoms, unsegmented
             as its backward runs it, d = 1 with a mask as the shell
             populations, an index in no sorted order), the segment sums
             (`segment_sum`: c = 3, 6, 1 with a mask, n as the gathers'
             backward over an (n, n) table, an unsorted index) and the
             sums over trailing dims (`fragment_sum`: a row, an (n, n)
             pair table, a (6, n, n) table past the warp's rows), every
             form of `reduce_forms`, against their plain versions in the
             kernel's order and the torch expressions they replaced at
             (B, n) = (512, 16), (5985, 32), (64, 48), (16, 96) and the
             73-atom Hessian's (1, 241), float64 (1e-13 of the largest
             entry) and float32 (1e-5), the bits the plain version's
             (checked); a fragment alone and in its batch bit for bit
             equal; every form's kernel, plain version and torch timed
             graph-replayed beside the bound (`reduce_bound`); then
             `fragment_sum` alone at ROW_SUM_CASES (rows of 3 to 348486
             elements, a lane group to a cluster of 8 blocks a row) bit
             for bit its plain version, alone and in the batch, a row of
             -0.0 summed to +0.0;
2. sp2:      `sp2_density` (ops/sp2.py: batched matrix products, not a
             hand-written kernel, as in the JAX package) against the T = 0
             density built from torch.linalg.eigh on seeded, gapped
             symmetric matrices with padded states, closed and open shell,
             at (B, N) = (64, 256) and (128, 96) in float64 (1e-8) and
             float32 (1e-3); times both routes beside SP2's FLOP bound
             (48 products of 2 N^3 FLOP per matrix and spin channel);
2b. scc_graph: the SCC loop as a replayed CUDA graph
             (methods/xtb/scc_graph.py). The in-loop eigh binding
             (ops/batched_eigh.py, csrc/batched_eigh.cu, built with the
             kernels and linked with -lcusolver) against
             torch.linalg.eigh at (B, n) = (512, 16), (2581, 32), (5985,
             32), (128, 64), (41, 241) and (1, 16) in float64 and float32:
             bit for bit where torch calls the same routine (a batch of
             matrices up to 32), else within 1e-12 in float64, and a
             residual |A V - V diag(w)| / max|A| below 1e-12 (f64) / 1e-4
             (f32); both timed, the workspace printed. Then every route,
             GFN1 exact (f64), Jacobi (f32), SP2 (f32, 16 water
             dodecamers at 72 AOs), GFN1 + ALPB and GFN2, on the dimer
             slice and on 64 seeded water hexamers (36 AOs): a miss of
             the graph cache, then hits on two fresh sets of the same
             shapes (the dimers drawn anew; above 32 AOs seeded sets of
             the w20 isomer's waters), each against `graph=False` on the
             same operands (charges and residuals bit for bit, the same
             stop iteration, the same launches of every counter, the
             in-loop solver's once per iteration) and each hit against a
             capture
             made after the cache is cleared; a hit's setup (host ms)
             under 10% of the miss's warm-up, recording and
             instantiation; the loop body under
             torch.cuda.set_sync_debug_mode("error"); on the slice both
             timed at 32 iterations (a miss and a hit), with the
             capture's ms and the cache's bytes. One line
             `{"scc_graph": ...}`. Every later phase must run its SCCs
             through captured or cached graphs, none launch by launch;
             slice, validation, polish, fit_tools and bench, which repeat
             shapes, must hit the cache. Each phase's SCC solves are
             printed by reuse distance (`scc_graph.reuse`) with the hits
             a cache of each cap would have had, in one line
             `{"scc_reuse": ...}` after the main path;
2c. call_graph: every route's `XtbCalculator.energies` and `.gradients`
             as replayed device programs (`scc_graph.Call`: the operand
             build, the loop and the functional, the gradient's backward
             pass inside its capture): GFN1 exact, Jacobi, SP2 (16 water
             dodecamers, 72 AOs), ALPB and GFN2 on the dimer slice (B =
             512), CPCM's energies on 64 dimers; a miss and two hits on
             fresh inputs, each bit for bit `graph=False`'s (energies,
             gradients, every aux field), every stage's run once more under
             torch.cuda.set_sync_debug_mode("error") (a miss and launch by
             launch), a hit's setup ms beside the miss's warm-up; one line
             `{"call_graph": ...}`;
2d. c17:     ROADMAP C17 (`tools/c17_probe_torch.py`'s cut deltas): the
             rigid trimer MBE(2) gradient and total, and the w20 MBE(2)
             |g|, max |dg| and total in float64 and in float32 + polish,
             from one batch and from a two-slot cut must be equal bit for
             bit; so must, three times in this process, the w20 MBE(2)
             gradient in GFN2 and with ALPB (|g|, max |dg|, total), the
             16 dodecamers (96 AOs, one batch against two of 8: energies
             and gradients) in float64 and in float32 on SP2's route, 8
             jittered 73-atom peptides (241 AOs, one batch against two of
             4), the w20 MBE(2) dimers in GFN2 through the refine route
             (190 against two of 95) and CPCM's w20 MBE(2) energies, each
             repeat's totals, |g| and sums bit for bit the first's; one
             line `{"c17": ...}`;
3. slice:    the bench dimer batch (B = 512, seed 0) through
             XtbCalculator.energies/gradients with use_pallas_eigh in
             float64 (the exact route, as the JAX package's: no Jacobi
             launch, the flag-off results to 1e-10 / 1e-9) against the JAX
             package's float64 goldens (first 8 dimers); energies/s and
             gradients/s; the same batch in float32 on the Jacobi route,
             which must launch the kernel;
4. executor: FragmentExecutor.run(what="gradient") on bench's w20 MBE(2)
             fragment list against the golden weighted total in float64
             (no Jacobi launch), and in float32 on the Jacobi route (its
             distance printed, the kernel launched);
5. driver:   run_calculation on tests/data/port_prism.mqc and
             port_w20_mbe4.mqc (MBE(4), 6195 fragments) with use_pallas_eigh
             in float64, prism also in float32 + f64 polish on the Jacobi
             route (1e-7 of the golden, the kernel launched), and prism
             through `python -m metalquicha_tpu_torch`;
5b. memory: the executor's byte guard (parallel/executor.py
             `fragment_bytes`, `device_budget`). The byte model against
             the measured peak per fragment at the shapes of
             tools/memory_probe_torch.py --calibrate (GFN1 nao 16 and 32
             on both in-loop routes, nao 241, ALPB, CPCM, GFN2; energy and
             gradient; the table printed, every ratio within [1, 2]); the
             FD Hessian of validation/inputs/no_frag.json (73 atoms, 438
             displaced gradients at nao 241 on the exact route) through
             run_calculation: its unsymmetrized rows of atoms 0 and 40
             within 1e-6 of tests/data/port_golden_memory.json's central
             differences, the Hessian symmetric (1e-6) and every row's sum
             over the atoms per direction below 1e-5; then the w20 MBE(4)
             gradient through run_calculation with the factory's executor
             (float64): 48 tetramers' energies and gradients within
             1e-8 of the golden, the total within 1e-8 of the MBE(4)
             golden, the net force below 1e-7. Each run's chunks, wall,
             peak and budget printed; the peak must stay under the budget;
6. solvation: the w20 MBE(2) list through FragmentExecutor with ALPB
             water (gradients) and CPCM water (energies), use_pallas_eigh
             in float64, against the JAX package's goldens (totals 1e-8
             Ha, ALPB |g| 1e-6), and ALPB energies in float32 on the Jacobi
             route (printed, the kernel launched); wall time and peak
             device memory;
7. validation: run_calculation with the factory's settings on every .mqc
             of tests/data/port_golden_gfn1_full.json (the GFN1 cases of
             validation/expected.json: unfragmented, MBE, GMBE, charged,
             multi-molecule, Hessian, solvated) within
             `validation.GOLDEN_TOLERANCES` of the JAX package's results;
             unfrag_gly3 (228 AOs in one fragment) and gly10_mbe again with
             use_pallas_eigh, in float64 (the exact route: neither SP2 nor
             the Jacobi kernel) and in float32 + f64 polish, where the
             first must go through SP2 and the second through the Jacobi
             kernel, both held to the same tolerances; one solvated case
             from its
             JSON through `python -m metalquicha_tpu_torch.io.prep` and
             `python -m metalquicha_tpu_torch`;
8. gfn2:     GFN2 (multipole SCC, charge-scaled dispersion; it runs no
             Jacobi kernel, as in the JAX package, whose multipole SCC
             always diagonalizes with the library's eigh, but the Fermi
             kernel in every filling) in float64
             against tests/data/port_golden_gfn2.json: the bench dimer batch
             (B = 512; the first 8 against the goldens; energies/s and
             gradients/s); the w20 MBE(2) list through FragmentExecutor with
             gradients and with ALPB water (totals 1e-8 Ha; wall, peak
             memory); the five molecules of tests/data/gfn2_fixtures.json,
             cold and warm-started from the JAX package's converged state;
             the largest dimer chunk the executor's cap allows,
             with gradients (its peak must stay under 80% of the card's
             memory); run_calculation on `w1_vib_therm` (Hessian,
             frequencies, thermochemistry), prism MBE(2) and w20 MBE(3)
             with the method switched to GFN2, and on w20 MBE(4) for its
             wall and peak memory (the SCC of one tetramer does not
             converge in either package: the driver raises ConvergenceError
             after every fragment has been evaluated); the device
             time and the device kernels of one SCC iteration at (512,
             16) on GFN1's exact route (float64) and Jacobi route
             (float32) and GFN2's multipole route (float64), and the Fermi
             launches per iteration, one fused fill and density each
             (`tools/scc_probe_torch.py`);
9. polish:   the mixed-precision route (methods/xtb/polish.py). The w20
             MBE(2) list with gradients through (a) the float64 executor,
             (b) raw float32, (c) float32 + f64 polish with the exact
             in-loop solve, (d) float32 on the Jacobi route + polish: (c)
             and (d) within 1e-9 of (a) in total (|g| 1e-6: the list's
             waters are exact translates), (b)'s distance printed; wall
             time and peak memory of all four; the water-trimer MBE(2) set
             polished within 1e-9 of float64 in total and |g|; the 512-dimer
             slice in float32 + polish beside float64 (energies 1e-9,
             gradients 1e-8); the rescue path
             (rescue_tol = 1e-30) on three waters equal to float64 (1e-12);
             run_calculation with force_dtype="f32" on prism MBE(2) and on
             `w1_vib_therm` (GFN2 Hessian) within `GOLDEN_TOLERANCES` of
             the JAX package's float64 goldens, beside their float64 times;
10. mesh:    the water-trimer MBE(2) set through a mesh of every visible
             card and through a two-slot 2D mesh (the one card listed
             twice where only one is present: pad, cut and join all run,
             and each slot's piece is evaluated in a worker process of its
             own): float64 totals equal the one-device run's (1e-12),
             gradients too once every atom is moved by a seeded jitter
             (the rigid set's degenerate dimers hold theirs to 1e-8); the
             w20 MBE(2) gradient on one slot, on two worker processes and
             on two slots dispatched one after the other from this process
             (a warm-up pass each, the workers' start in theirs, then two
             timed passes each in turns; the walls, their ratios and each
             worker's pid, device, start-up seconds and Fermi launches
             printed): the two-process total within 1e-10 of one slot's
             and 1e-8 of the golden, each worker launched the Fermi kernel
             and loaded nothing of jax or the JAX package, and in one more
             pass in float32 on the Jacobi route each worker launched the
             Jacobi kernel; then run_calculation
             on port_w20_mbe4.mqc through the same two workers within 1e-7
             of the golden, its wall beside the driver phase's one-slot
             wall and each process's peak device memory printed; its
             gradient (port_memory_w20_mbe4_grad.mqc) through the same
             workers, each planning for half the card and cutting its
             piece into parts (total 1e-7, net force 1e-7, every worker's
             peak in every run under that run's budget, each printed); no
             worker alive after `close()`;
11. fit:     the differentiable parameterization (methods/xtb/param_fit.py):
             rebuild(theta_init) equal to the host batch (1e-12) in GFN1
             and GFN2; dE/dtheta of a water against a central difference on
             one level (rel 1e-4); the time of one value-and-gradient over
             theta of the summed energy and of the force-matching loss
             sum |grad_R E|^2 for 64 bench dimers;
12. fit_tools: the training programs (tools/fit_gfn1_torch.py,
             fit_gfn2_w1_torch.py, fit_solvation_torch.py), each from the
             shipped overlay. `fit_gfn1_torch.main --iters 1` over every
             default target in GFN1 (16: energies, w20 MBE(4) among them,
             assembled gradient norms, FD-Hessian norms) and in GFN2 (2);
             its evaluation at theta_0 timed per target, with the peak
             memory, and checked: the value against the JAX driver's result of
             the same observable (tests/data/port_golden_gfn1*.json,
             port_golden_gfn2.json: energies 1e-7 Ha, |g| 1e-6, |H|_F
             1e-5) and, where tests/data/port_golden_fit_tools.json holds
             the target, value (1e-9) and gradient (relative 1e-6) against
             the JAX script's; each energy target's gradient against a
             central difference along a seeded random direction in theta
             (relative 1e-5); its GFN1 output read back through
             `theta_from_overlay`. The w1 observables and the solvation
             energies at two parameter vectors against the JAX scripts'
             frozen values, then `main --iters 1` of fit_gfn2_w1_torch and
             of fit_solvation_torch (warm-started from the shipped
             solvation overlay). The fits launch no Jacobi kernel, as
             the JAX fits run none (`use_pallas_eigh=False`);
             then no module of jax or of the JAX package may be loaded;
13. bench:   `bench_torch.py` (the port's counterpart of bench.py) at its
             defaults, in this process: its JSON line has bench.py's keys
             and `platform` "cuda", both SCC residuals are below 1e-5, the
             Jacobi kernel launched, and `mbe2_w20_total_ha` is within 1e-6
             of the golden w20 MBE(2) total (its printed rounding; the
             timed passes' 1e-5 Bohr jitter is a rigid shift); the line is
             printed on a line of its own.

`--baseline SRC` builds a second version of the kernel source (an
earlier commit's `csrc/jacobi_eigh.cu`, same C interface) with the same
nvcc flags into a temporary directory and times it beside this one in
phase 1, in the order baseline, this, this, baseline.

The kernels' launch counters (their replays' launches included), SP2's
and the in-loop eigh's call counters and the SCC graph counts are reset
before phases 3-13; every one of phases 3-13 but the mesh must capture an
SCC graph and none may run an SCC on the card launch by launch, nor any
stage of a calculator's call (the mesh's workers report theirs, each must
have captured, and run no stage launch by launch); every one of phases
3-13 must launch the Anderson window kernel, the fragment product kernel
and the fragment sum kernel (the workers' launches added), and the main
path every entry of the last; the Jacobi
kernel's must grow in phases 3-6 (5b too), 9, 10
and 13, each from its float32 pass (a float64 SCC takes the exact route,
as the JAX package's) or, in 13, its timing of the kernel alone, and
both in phase 7; phase 8 must leave both as they are, and phase 12 the
first; the Fermi kernels' must grow in every one of phases 3-13, since
each runs an SCC on the card (phase 10's worker processes' launches
added), the fused fill and density's over the main path, and the SCC
probe (phase 8) must see one Fermi launch per iteration on every route.
Diagnostics go to stdout; the line before the last but one is the
kernels' JSON line, the line before the last the card's name and power
limit, and the last line `{"ok": true, "device": {...}}`.
Exits non-zero, with no result, when CUDA is absent.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_gfn1.json")
GOLDEN_FULL = os.path.join(ROOT, "tests", "data", "port_golden_gfn1_full.json")
GOLDEN_GFN2 = os.path.join(ROOT, "tests", "data", "port_golden_gfn2.json")
GOLDEN_MEMORY = os.path.join(ROOT, "tests", "data", "port_golden_memory.json")
GFN2_MBE4 = os.path.join(ROOT, "tests", "data", "port_gfn2_w20_mbe4.mqc")
GFN2_FIXTURES = os.path.join(ROOT, "tests", "data", "gfn2_fixtures.json")
GOLDEN_FIT_TOOLS = os.path.join(ROOT, "tests", "data",
                                "port_golden_fit_tools.json")
SOLV_OVERLAY = os.path.join(ROOT, "metalquicha_tpu_torch", "methods", "xtb",
                            "data", "solv_fitted.json")
TOL_F32 = 5e-5          # tests/test_pallas_eigh.py's tolerance
TOL_F64_REL = 1e-10     # times ||A||
DEVICE = "cuda"
# (B, N) the main path launches: w20 monomers and dimers (executor), the
# bench dimer slice, the w20 MBE(4) chunk; then the N > 32 path
TIMED_SHAPES = ((20, 11), (190, 16), (512, 16), (5985, 32), (128, 64))
# checked only: an odd N, and more N <= 16 matrices than the card holds
# at once
KERNEL_SHAPES = TIMED_SHAPES + ((7, 13), (6000, 16))
SWEEPS = 10             # jacobi_eigh's fixed sweep count
# H100 SXM peaks (NVIDIA data sheet): FP64 through the tensor cores (34
# TFLOP/s outside them), FP32 outside the tensor cores, and HBM3
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# outside the tensor cores (NVIDIA data sheet): the Fermi fill's rates
PEAK_VECTOR = {torch.float64: 34e12, torch.float32: 67e12}
# (B fragments, nao) of the main path's Fermi fills, two rows each: the
# dimer slice, the w20 MBE(2) buckets, the w20 MBE(4) gradient and energy
# chunks, a chunk of the 73-atom FD Hessian; then checked only: a row
# longer than the kernel keeps in registers
FERMI_TIMED = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
               (41, 241))
# checked only: a row longer than the kernel keeps in registers, and rows
# of 8 (a quarter-warp each)
FERMI_SHAPES = FERMI_TIMED + ((3, 300), (64, 8))
FERMI_TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-4)}
# (B fragments, nao) of the fused fill and density (ops/fermi_fill.py
# `fermi_density`, nao <= 64): the dimer slice, the w20 MBE(2) buckets, the
# w20 MBE(4) chunks, and its largest nao; all timed
DENSITY_SHAPES = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
                  (128, 64))
DENSITY_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# operations per evaluation of CUDA's exp and log (a range reduction and a
# polynomial): an estimate, not a count of the compiled code
EXP_OPS = {torch.float64: 20, torch.float32: 8}
# operations of a bisection step taken without a row sum (a run of clamped
# steps): the mid's add and product, two subtractions and two tests on the
# nearest levels, the decision's select and the stop's test
SCALAR_STEP_OPS = 8
# SP2: (B, N, real states), the first the shape bench.py times, and the
# tolerance of tests/test_sp2.py's class per dtype
SP2_SHAPES = ((64, 256, 240), (128, 96, 81))
SP2_ITERS = 48
SP2_TOL = {torch.float64: 1e-8, torch.float32: 1e-3}
#: walls an earlier phase took, for a later one to print beside its own
WALLS = {}
#: the main path's phases that solve one shape more than once, and so
#: must replay cached SCC graphs
REPEATING = ("slice", "validation", "polish", "fit_tools", "bench")


def jacobi_bound(bsz: int, n: int, dtype):
    """(bound_ms, bound_by) of SWEEPS sweeps on (bsz, n, n): per rotation
    12N FLOP (6 per updated pair of elements: the N-2 off-diagonal pairs
    of rows p, q of A, whose mirrors are copies, and the N pairs of V's
    columns p, q) plus 20 for (c, s) and the 2x2 diagonal block, N(N-1)/2
    rotations per sweep; A read once, w and V written once."""
    flop = bsz * SWEEPS * (n * (n - 1) // 2) * (12 * n + 20)
    nbytes = bsz * (2 * n * n + n) * torch.finfo(dtype).bits // 8
    t_flop, t_bytes = flop / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_flop, t_bytes), ("operations" if t_flop >= t_bytes
                                        else "bytes")


def _fill_ops(nao: int, dtype, steps=None, bsz=None, entropy=True,
              full=None):
    """Operations of the Fermi fill at the vector rate: per filled row,
    one fill of nao values per bisection step that evaluates a row sum and
    one more for f, each a subtraction, a division, a two-sided clamp, an
    exp, an add, a reciprocal and the sum's add (7 operations and
    EXP_OPS), SCALAR_STEP_OPS per step taken without one (a run of clamped
    steps), the min and the max, and the entropy of the last fill (a
    clamp, two logs, 1 - f, two products, an add, a sign, the window's two
    tests and the sum's add: 10 operations and two EXP_OPS). steps: int
    (B, 2) steps each channel's bisection takes to its fixed point, 0 for
    a channel not filled (a closed shell's beta), and full those of them
    that evaluate a row sum (`fermi_trace`; None: every one); steps None
    for the 80-step count, both channels of bsz fragments at 80 steps."""
    e = EXP_OPS[dtype]
    tail = 2 + ((10 + 2 * e) if entropy else 0)
    if steps is None:
        rows, fills, scalar = 2 * bsz, 2 * bsz * 81, 0
    else:
        evaluated = steps if full is None else full
        rows = int((steps > 0).sum())
        fills = int(evaluated.sum()) + rows
        scalar = int((steps - evaluated).sum())
    return nao * (fills * (7 + e) + rows * tail) + scalar * SCALAR_STEP_OPS


def _bound(times: dict):
    """(bound_ms, bound_by) from {reason: seconds}: the largest."""
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def fermi_bound(bsz: int, nao: int, dtype, steps=None, full=None):
    """(bound_ms, bound_by) of the Fermi fill of bsz fragments: the fill's
    operations (`_fill_ops`: the rows filled and the steps these inputs
    need, with and without a row sum, counted on the plain version;
    steps=None gives the 80-step count) at the vector rate, or eps, the
    mask, nelec and nuhf read once and f and the entropy written once at
    the memory rate, whichever is larger."""
    ops = _fill_ops(nao, dtype, steps, bsz, full=full)
    nbytes = bsz * (3 * nao + 3) * torch.finfo(dtype).bits // 8
    return _bound({"operations": ops / PEAK_VECTOR[dtype],
                   "bytes": nbytes / PEAK_BYTES})


def fermi_density_bytes_ms(bsz: int, nao: int, dtype) -> float:
    """eps, the mask, nelec, nuhf and C read once and P written once, at
    the memory rate: ms."""
    nbytes = bsz * (2 * nao + 2 + 2 * nao * nao) * torch.finfo(dtype).bits // 8
    return 1e3 * nbytes / PEAK_BYTES


def fermi_density_bound(bsz: int, nao: int, dtype, steps=None, full=None):
    """(bound_ms, bound_by) of the fused fill and density: the fill's
    operations (no entropy; `_fill_ops`, steps=None the 80-step count) at
    the vector rate, P = C diag(f) C^T at 2 nao^3 FLOP per fragment at
    PEAK_FLOPS (FP64 on the tensor cores, FP32 outside them), or the
    bytes (`fermi_density_bytes_ms`): the largest of the three."""
    ops = _fill_ops(nao, dtype, steps, bsz, entropy=False, full=full)
    flop = 2 * bsz * nao**3
    return _bound({"operations": max(ops / PEAK_VECTOR[dtype],
                                     flop / PEAK_FLOPS[dtype]),
                   "bytes": fermi_density_bytes_ms(bsz, nao, dtype) / 1e3})


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
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
    """Mean device time of fn() over reps calls captured in one CUDA graph
    and replayed, after a warm-up call and a warm-up replay: the kernels'
    own time, with no host time between the launches."""
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


def wall(fn, reps: int = 1):
    """(result of the last call, mean host seconds per call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def build_baseline(jac, source: str, out_dir: str) -> ctypes.CDLL:
    """Compile another version of the kernel source with the port's nvcc
    flags into out_dir and load it."""
    so = os.path.join(out_dir, "baseline.so")
    from metalquicha_tpu_torch.ops import kernel_build

    subprocess.run([kernel_build.nvcc(), *kernel_build.NVCC_FLAGS, "-o", so,
                    source], check=True)
    lib = ctypes.CDLL(so)
    for name in ("mqc_jacobi_eigh_f32", "mqc_jacobi_eigh_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def baseline_eigh(lib, a: torch.Tensor):
    """SWEEPS sweeps of the baseline kernel on a: (w, v)."""
    bsz, n, _ = a.shape
    w = torch.empty((bsz, n), dtype=a.dtype, device=a.device)
    v = torch.empty((bsz, n, n), dtype=a.dtype, device=a.device)
    fn = (lib.mqc_jacobi_eigh_f64 if a.dtype == torch.float64
          else lib.mqc_jacobi_eigh_f32)
    err = fn(a.data_ptr(), w.data_ptr(), v.data_ptr(), bsz, n, SWEEPS,
             a.device.index, torch.cuda.current_stream(a.device).cuda_stream)
    check(err == 0, f"baseline kernel launch failed ({err})")
    return w, v


def kernel_phase(jac, rng, base_lib=None):
    """Kernel vs plain version vs torch.linalg.eigh: sorted eigenvalues
    (against the plain version, and against float64 eigh of the same
    input), max |AV - VL| and max |V^T V - I|. Eigenvectors are compared
    through these invariants only: near-degenerate pairs make them
    ill-conditioned (f32, N = 64: kernel and plain vectors differ by 0.6
    while both are exact to 2e-5). Returns the JSON entry's numbers at the
    slice's shape (512, 16) in float64."""
    worst = 0.0
    entry = {}
    for dtype in (torch.float64, torch.float32):
        for bsz, n in KERNEL_SHAPES:
            x = rng.normal(size=(bsz, n, n))
            a_np = (x + x.transpose(0, 2, 1)) / (2.0 * np.sqrt(n))
            a = torch.tensor(a_np, dtype=dtype, device=DEVICE)
            w_k, v_k = jac.jacobi_eigh(a)
            w_p, _ = jac.jacobi_eigh_reference(a, 10)
            # exact eigenvalues of the (rounded) input, in float64
            w_e = torch.linalg.eigvalsh(a.double())
            torch.cuda.synchronize()
            norm = float(torch.linalg.matrix_norm(a, ord=2).max())
            tol = TOL_F64_REL * norm if dtype == torch.float64 else TOL_F32
            eye = torch.eye(n, dtype=dtype, device=DEVICE)
            w_ks = torch.sort(w_k, -1).values
            d_plain = float((w_ks - torch.sort(w_p, -1).values).abs().max())
            d_eigh = float((w_ks.double() - w_e).abs().max())
            resid = float((a @ v_k - v_k * w_k[:, None, :]).abs().max())
            orth = float((v_k.mT @ v_k - eye).abs().max())
            line = (f"kernel {str(dtype)[6:]} B={bsz} N={n}: |A|={norm:.3f} "
                    f"tol={tol:.1e} vs_plain={d_plain:.2e} "
                    f"vs_eigh={d_eigh:.2e} resid={resid:.2e} "
                    f"orth={orth:.2e}")
            if (bsz, n) in TIMED_SHAPES:
                if base_lib:
                    t_b = cuda_ms(lambda: baseline_eigh(base_lib, a), 20)
                t_p = cuda_ms(lambda: jac.jacobi_eigh_reference(a, 10), 2)
                t_k = cuda_ms(lambda: jac.jacobi_eigh(a), 20)
                t_e = cuda_ms(lambda: torch.linalg.eigh(a), 10)
                t_k2 = cuda_ms(lambda: jac.jacobi_eigh(a), 20)
                t_p2 = cuda_ms(lambda: jac.jacobi_eigh_reference(a, 10), 2)
                t_k, t_p = 0.5 * (t_k + t_k2), 0.5 * (t_p + t_p2)
                bound, bound_by = jacobi_bound(bsz, n, dtype)
                line += (f" | ms: kernel={t_k:.4f} plain={t_p:.4f} "
                         f"eigh={t_e:.4f} bound={bound:.4f} ({bound_by}) "
                         f"share={bound / t_k:.3f}")
                if base_lib:
                    t_b2 = cuda_ms(lambda: baseline_eigh(base_lib, a), 20)
                    line += f" baseline={0.5 * (t_b + t_b2):.4f}"
                if dtype == torch.float64 and (bsz, n) == (512, 16):
                    entry = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                             "bound_by": bound_by, "library_ms": t_e}
            print(line, flush=True)
            for what, val in (("vs plain", d_plain), ("vs eigh", d_eigh),
                              ("residual", resid), ("orthogonality", orth)):
                check(val <= tol, f"kernel {what} {val:.3e} > {tol:.1e} "
                                  f"at B={bsz} N={n} {dtype}")
            worst = max(worst, d_plain)
    entry["max_abs_err"] = worst
    return entry


def fermi_inputs(rng, bsz: int, nao: int, dtype):
    """A batch for the Fermi fill: (eps, nelec, nuhf, ao_mask) on the card.
    Every third fragment padded to two thirds of its AOs, nuhf 0, 1 and 2
    in turn, nelec = 2 floor(n_real / 3) + nuhf; the lowest ceil(nelec / 2)
    levels in [-1.1, -0.5] Ha, the others 0.3 Ha higher or more, but every
    fifth fragment's lowest empty level 1e-4 Ha above its highest occupied
    one (fractional occupations at 300 K); padded AOs at +10 Ha; each row
    in a random order, as the Jacobi route leaves it."""
    pos = np.arange(nao)[None, :]
    n_real = np.where(np.arange(bsz) % 3 == 0, (2 * nao) // 3, nao)[:, None]
    nuhf = np.arange(bsz) % 3.0
    nelec = 2.0 * np.floor(n_real[:, 0] / 3.0) + nuhf
    n_occ = np.ceil(nelec / 2.0)[:, None]
    u = rng.uniform(0.0, 0.6, size=(bsz, nao))
    eps = np.where(pos < n_occ, -u, 0.3 + u) - 0.5
    homo = np.where(pos < n_occ, eps, -np.inf).max(1)
    near = (np.arange(bsz) % 5 == 0)[:, None] & (pos == n_occ)
    eps = np.where(near, homo[:, None] + 1e-4, eps)
    eps = np.where(pos < n_real, eps, 10.0)
    mask = (pos < n_real).astype(float)
    perm = np.argsort(rng.random((bsz, nao)), axis=1)
    eps = np.take_along_axis(eps, perm, 1)
    mask = np.take_along_axis(mask, perm, 1)
    return [torch.tensor(x, dtype=dtype, device=DEVICE)
            for x in (eps, nelec, nuhf, mask)]


def fermi_trace(ff, eps, nelec, nuhf, kt, mask):
    """(steps, full): int (B, 2) steps each channel's bisection takes on
    the plain arithmetic as the kernel takes them (`_bisect_skipping`),
    and those of them that evaluate a row sum (the rest: runs of clamped
    steps); 0 for a closed shell's beta channel, which is not filled."""
    e2, n_ch, mask2 = ff._channels(eps, nelec, nuhf, mask)
    e2 = torch.where(mask2 > 0.5, e2, 1.0e3)
    _, _, steps, full = ff._bisect_skipping(e2, n_ch, kt, mask2)
    bsz = eps.shape[0]
    closed = nuhf == 0

    def channels(x):
        return torch.stack([x[:bsz], torch.where(closed, 0, x[bsz:])], -1)

    return channels(steps), channels(full)


def fermi_bits_check(ff):
    """The Fermi kernels bit for bit the fingerprint of their versions
    before the fused kernel's redesign and the runs of clamped steps
    (commit bb294ac; `tests/data/fermi_bits.json`, written on the card
    from that commit by `tools/fermi_bits_torch.py --write`): the fill's f,
    entropy and steps at FERMI_SHAPES and the fused kernel's P at
    DENSITY_SHAPES (and odd sizes at its classes' edges, and batches on
    both sides of its launch thresholds), f64 and f32, 300 K and 5000 K, on
    mixed, gapless and margin inputs."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import fermi_bits_torch as bits

    fixture = bits.load_fixture()
    want = {bits.key_of(entry, family, d, kelvin, shape)
            for entry, shapes in (("fill", FERMI_SHAPES),
                                  ("density", DENSITY_SHAPES))
            for family in bits.FAMILIES for d in bits.DTYPES
            for kelvin in bits.KELVIN for shape in shapes}
    check(want <= set(fixture["cases"]), f"the Fermi fingerprint lacks "
          f"{sorted(want - set(fixture['cases']))}")
    t0 = time.perf_counter()
    differ = bits.compare(ff, fixture)
    check(not differ, f"the Fermi kernels' bits moved from the fingerprint:"
                      f" {differ}")
    print(f"fermi: {len(fixture['cases'])} cases bit for bit the fingerprint"
          f" of {fixture['module']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def fermi_phase(ff, rng):
    """The Fermi kernels against their plain versions. First their bits
    against the fingerprint (`fermi_bits_check`). The fill
    (`fermi_occupations`): max |df| and max |d entropy| at every shape, the
    bisection steps the kernel took and the plain version needs (min and
    max over the rows filled) and, on the plain trace, those taken without
    a row sum (runs of clamped steps), both timed at FERMI_TIMED beside the
    bound (`fermi_bound` on the plain trace, and the 80-step count). The
    fused fill and density (`fermi_density`): max |dP| against
    `fermi_density_reference` at DENSITY_SHAPES, timed beside the fill and
    the product it replaces in the SCC, the plain version and its bounds.
    Returns the JSON entry's numbers: times at the slice's (512, 16) in
    float64, the largest float64 differences over every shape."""
    from metalquicha_tpu_torch.constants import KB_HARTREE

    fermi_bits_check(ff)
    kt = 300.0 * KB_HARTREE
    worst = worst_p = 0.0
    entry = {}
    print("fermi bound: the fill's operations over the rows filled and the "
          "steps each needs on the plain version (a closed shell once), a "
          "step of a run of clamped ones as the scalar step it is; the "
          "80-step bound, 81 fills of both channels, printed beside it as "
          "bound_80", flush=True)
    for dtype in (torch.float64, torch.float32):
        tol_f, tol_s = FERMI_TOL[dtype]
        taken = []
        for bsz, nao in FERMI_SHAPES:
            args = fermi_inputs(rng, bsz, nao, dtype)
            eps, nelec, nuhf, mask = args

            def kernel():
                return ff.fermi_occupations(eps, nelec, nuhf, kt, mask)

            def plain():
                return ff.fermi_occupations_reference(eps, nelec, nuhf, kt,
                                                      mask)

            f_k, s_k, steps_k = ff.fermi_occupations_steps(eps, nelec, nuhf,
                                                           kt, mask)
            f_p, s_p = plain()
            steps_p, full_p = fermi_trace(ff, eps, nelec, nuhf, kt, mask)
            torch.cuda.synchronize()
            d_f = float((f_k - f_p).abs().max())
            d_s = float((s_k - s_p).abs().max())
            n_el = float((f_k.sum(1) - nelec).abs().max())
            frac = int(((f_k > 1e-3) & (f_k < 2 - 1e-3)
                        & ((f_k - 1).abs() > 1e-3)).any(1).sum())
            filled_k, filled_p = steps_k[steps_k > 0], steps_p[steps_p > 0]
            taken.append(filled_k)
            line = (f"fermi {str(dtype)[6:]} B={bsz} nao={nao} (rows "
                    f"{2 * bsz}, filled {filled_k.numel()}): max|df|={d_f:.2e}"
                    f" max|ds|={d_s:.2e} |sum f - nelec|={n_el:.2e} "
                    f"fractional rows={frac} steps kernel "
                    f"{int(filled_k.min())}-{int(filled_k.max())} plain "
                    f"{int(filled_p.min())}-{int(filled_p.max())}, full "
                    f"{int(full_p.sum())} skipped "
                    f"{int((steps_p - full_p).sum())}")
            if (bsz, nao) in FERMI_TIMED:
                t_p = cuda_ms(plain, 3)
                t_k = cuda_ms(kernel, 50)
                t_k2 = cuda_ms(kernel, 50)
                t_p2 = cuda_ms(plain, 3)
                t_k, t_p = 0.5 * (t_k + t_k2), 0.5 * (t_p + t_p2)
                bound, bound_by = fermi_bound(bsz, nao, dtype, steps_p,
                                              full_p)
                bound80, _ = fermi_bound(bsz, nao, dtype)
                line += (f" | ms: kernel={t_k:.4f} plain={t_p:.4f} "
                         f"bound={bound:.5f} ({bound_by}) "
                         f"share={bound / t_k:.4f} bound_80={bound80:.5f} "
                         f"share_80={bound80 / t_k:.4f} library=none")
                check(bound <= t_k, f"fermi fill faster than its bound at "
                                    f"B={bsz} nao={nao} {dtype}")
                if dtype == torch.float64 and (bsz, nao) == (512, 16):
                    entry = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                             "bound_by": bound_by, "library_ms": None}
            print(line, flush=True)
            check(d_f <= tol_f and d_s <= tol_s,
                  f"fermi kernel vs plain {d_f:.3e} / {d_s:.3e} > "
                  f"{tol_f:.0e} / {tol_s:.0e} at B={bsz} nao={nao} {dtype}")
            finite = bool(torch.isfinite(f_k).all()
                          and torch.isfinite(s_k).all())
            check(finite, f"fermi kernel: non-finite output at B={bsz} "
                          f"nao={nao}")
            check(bool((steps_k[:, 1][nuhf == 0] == 0).all()),
                  "fermi kernel filled a closed shell's beta channel")
            if dtype == torch.float64:
                worst = max(worst, d_f, d_s)
        taken = torch.cat(taken)
        print(f"fermi {str(dtype)[6:]} bisection steps over every row filled:"
              f" {int(taken.min())}-{int(taken.max())} of {ff.STEPS}",
              flush=True)

    for dtype in (torch.float64, torch.float32):
        tol = DENSITY_TOL[dtype]
        for bsz, nao in DENSITY_SHAPES:
            eps, nelec, nuhf, mask = fermi_inputs(rng, bsz, nao, dtype)
            q = np.linalg.qr(rng.normal(size=(bsz, nao, nao)))[0]
            C = torch.tensor(q, dtype=dtype, device=DEVICE)

            def fused():
                return ff.fermi_density(eps, C, nelec, nuhf, kt, mask)

            def fill_and_product():
                f, _ = ff.fermi_occupations(eps, nelec, nuhf, kt, mask)
                return (C * f[:, None, :]) @ C.transpose(-1, -2)

            def plain():
                return ff.fermi_density_reference(eps, C, nelec, nuhf, kt,
                                                  mask)

            p_k = fused()
            p_p = plain()
            torch.cuda.synchronize()
            d_p = float((p_k - p_p).abs().max())
            steps_p, full_p = fermi_trace(ff, eps, nelec, nuhf, kt, mask)
            t_p = cuda_ms(plain, 3)
            t_k = graph_ms(fused, 50)
            t_two = graph_ms(fill_and_product, 50)
            t_k2 = graph_ms(fused, 50)
            t_p2 = cuda_ms(plain, 3)
            t_k, t_p = 0.5 * (t_k + t_k2), 0.5 * (t_p + t_p2)
            bound, bound_by = fermi_density_bound(bsz, nao, dtype, steps_p,
                                                  full_p)
            bound80, _ = fermi_density_bound(bsz, nao, dtype)
            print(f"fermi density {str(dtype)[6:]} B={bsz} nao={nao} (class "
                  f"{ff.density_class(nao)}): max|dP|={d_p:.2e} (tol "
                  f"{tol:.0e}) steps full {int(full_p.sum())} skipped "
                  f"{int((steps_p - full_p).sum())} | ms (graph-replayed): "
                  f"kernel={t_k:.4f} fill+product={t_two:.4f} "
                  f"plain={t_p:.4f} bound={bound:.5f} ({bound_by}) "
                  f"share={bound / t_k:.4f} bound_80={bound80:.5f} "
                  f"bytes={fermi_density_bytes_ms(bsz, nao, dtype):.5f} "
                  f"library=none", flush=True)
            check(d_p <= tol, f"fused density vs plain {d_p:.3e} > {tol:.0e}"
                              f" at B={bsz} nao={nao} {dtype}")
            check(bool(torch.isfinite(p_k).all()),
                  f"fused density: non-finite output at B={bsz} nao={nao}")
            check(bound <= t_k, f"fused density faster than its bound at "
                                f"B={bsz} nao={nao} {dtype}")
            if dtype == torch.float64:
                worst_p = max(worst_p, d_p)
                if (bsz, nao) == (512, 16):
                    entry.update(density_ms=t_k, density_fill_product_ms=t_two,
                                 density_plain_ms=t_p, density_bound_ms=bound,
                                 density_bound_by=bound_by)
    entry["max_abs_err"] = worst
    entry["density_max_abs_err"] = worst_p
    return entry


def sp2_inputs(rng, bsz, n, n_real, gap=0.5):
    """(bsz, n, n) symmetric matrices: a random real block of n_real
    states, the lowest third occupied, with a gap below and above the
    highest occupied one (so that the closed shell and the doublet with
    one electron less are both gapped); the other states padding at
    +100 Ha; and the (bsz, n) mask."""
    a = np.zeros((bsz, n, n))
    pad = np.arange(n_real, n)
    a[:, pad, pad] = 100.0
    nocc = n_real // 3
    for b in range(bsz):
        q, _ = np.linalg.qr(rng.normal(size=(n_real, n_real)))
        w = np.concatenate([rng.uniform(-2.5, -1.0 - gap, size=nocc - 1),
                            [-1.0],
                            rng.uniform(-1.0 + gap, 1.0, size=n_real - nocc)])
        a[b, :n_real, :n_real] = (q * w[None, :]) @ q.T
    mask = np.zeros((bsz, n))
    mask[:, :n_real] = 1.0
    return a, mask, nocc


def eigh_density(a, n_alpha: int, n_beta: int):
    """T = 0 spin-summed density from torch.linalg.eigh: the n_alpha and
    n_beta lowest eigenvectors (padding sits at the top)."""
    _, v = torch.linalg.eigh(a)
    va, vb = v[..., :n_alpha], v[..., :n_beta]
    return va @ va.mT + vb @ vb.mT


def sp2_phase(rng):
    """`sp2_density` vs the eigh route: max |P_sp2 - P_eigh|, trace and
    padding; device ms of both and SP2's FLOP bound."""
    from metalquicha_tpu_torch.ops.sp2 import sp2_density

    for bsz, n, n_real in SP2_SHAPES:
        a_np, mask_np, nocc = sp2_inputs(rng, bsz, n, n_real)
        for dtype in (torch.float64, torch.float32):
            a = torch.tensor(a_np, dtype=dtype, device=DEVICE)
            mask = torch.tensor(mask_np, dtype=dtype, device=DEVICE)
            for shell, nuhf_val in (("closed", 0.0), ("open", 1.0)):
                n_a = nocc
                n_b = nocc - int(nuhf_val)
                nelec = torch.full((bsz,), float(n_a + n_b), dtype=dtype,
                                   device=DEVICE)
                nuhf = torch.full((bsz,), nuhf_val, dtype=dtype,
                                  device=DEVICE)
                closed = nuhf_val == 0.0

                def run_sp2():
                    return sp2_density(a, nelec, nuhf, mask,
                                       iters=SP2_ITERS, closed_shell=closed)

                p_s = run_sp2()
                p_e = eigh_density(a, n_a, n_b)
                torch.cuda.synchronize()
                err = float((p_s - p_e).abs().max())
                tr = float((torch.diagonal(p_s, dim1=-2, dim2=-1).sum(-1)
                            - nelec).abs().max())
                pad = float(p_s[:, n_real:, :].abs().max())
                t_s = cuda_ms(run_sp2, 5)
                t_e = cuda_ms(lambda: eigh_density(a, n_a, n_b), 3)
                flop = bsz * (1 if closed else 2) * SP2_ITERS * 2 * n**3
                bound = 1e3 * flop / PEAK_FLOPS[dtype]
                tol = SP2_TOL[dtype]
                print(f"sp2 {str(dtype)[6:]} B={bsz} N={n} real={n_real} "
                      f"{shell} shell: vs_eigh={err:.2e} (tol {tol:.0e}) "
                      f"trace={tr:.2e} padding={pad:.2e} | ms: "
                      f"sp2={t_s:.3f} eigh_route={t_e:.3f} "
                      f"bound={bound:.4f} (operations) "
                      f"share={bound / t_s:.3f}", flush=True)
                check(err <= tol, f"sp2 vs eigh {err:.3e} > {tol:.0e} at "
                                  f"B={bsz} N={n} {dtype} {shell}")
                check(tr <= tol * n, f"sp2 trace off by {tr:.3e}")
                check(pad <= tol, f"sp2 fills padding ({pad:.3e})")


# the SCC graph phase: (B, n) of the in-loop eigh against torch's: the
# dimer slice, the w20 MBE(4) chunks, the largest nao of the fused
# density, a chunk of the 73-atom Hessian, one fragment
EIGH_SHAPES = ((512, 16), (2581, 32), (5985, 32), (128, 64), (41, 241),
               (1, 16))
EIGH_TOL_F64 = 1e-12
SCC_ITERS = 32


def reuse_line(counts) -> dict:
    """A phase's SCC solves by reuse distance (`scc_graph.reuse`): those
    of keys new to the phase, those at each distance, and the hits a
    cache of each cap would have had."""
    dist = {d: n for d, n in counts.items() if d != "new"}
    return {"solves": sum(counts.values()), "new": counts["new"],
            "distances": dict(sorted(dist.items())),
            "hits_at_cap": {c: sum(n for d, n in dist.items() if d < c)
                            for c in (1, 2, 4, 8, 16, 32, 64, 128, 256)}}


def water_clusters(rng, n_clusters: int, k: int) -> list:
    """n_clusters seeded clusters of k waters each: the waters on a
    jittered grid 5.6 Bohr apart, each turned by a random rotation."""
    from metalquicha_tpu_torch.workloads import WATER_BOHR

    grid = np.array([[i, j, l] for l in range(3) for j in range(3)
                     for i in range(3)], dtype=float)[:k] * 5.6
    out = []
    for _ in range(n_clusters):
        coords = []
        for c in grid:
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            coords.append(WATER_BOHR @ q.T + c + 0.3 * rng.standard_normal(3))
        out.append((np.tile([8, 1, 1], k), np.vstack(coords), 0, 1))
    return out


def eigh_inputs(rng, bsz: int, n: int, dtype):
    """Seeded symmetric matrices, one upper element moved by 1e-3 (torch
    and the binding read the lower triangle)."""
    a = rng.standard_normal((bsz, n, n))
    a = a + a.transpose(0, 2, 1)
    a[:, 0, n - 1] += 1e-3
    return torch.tensor(a, dtype=dtype, device=DEVICE)


def torch_eigh_routine(dtype, n: int, batch: int) -> str:
    """The cuSOLVER routine `torch.linalg.eigh` calls (torch 2.11, as its
    kernel names in the profiler and each routine's bits showed):
    XsyevBatched for a batch of matrices up to 32, syevj one matrix at a
    time in float32 from 32 to 512, syevd one matrix at a time otherwise.
    Where it is XsyevBatched the binding's eigenpairs must be torch's bit
    for bit."""
    if batch > 1 and n <= 32:
        return "XsyevBatched"
    if dtype == torch.float32 and 32 <= n <= 512:
        return "syevj"
    return "syevd"


def eigh_binding_check(be):
    """The in-loop eigh (ops/batched_eigh.py) against torch.linalg.eigh."""
    rng = np.random.default_rng(12)
    rows = []
    for dtype in (torch.float64, torch.float32):
        for bsz, n in EIGH_SHAPES:
            a = eigh_inputs(rng, bsz, n, dtype)
            status = be.EighStatus(a)
            w, v = be.eigh(a, status)
            w_t, v_t = torch.linalg.eigh(a)
            torch.cuda.synchronize()
            status.check()
            sign = torch.sign((v * v_t).sum(-2, keepdim=True))
            d_w = float((w - w_t).abs().max())
            d_v = float((v * sign - v_t).abs().max())
            same = bool(torch.equal(w, w_t) and torch.equal(v, v_t))
            lower = a.tril() + a.tril(-1).transpose(-1, -2)
            resid = float((lower @ v - v * w[:, None, :]).abs().max()) / float(
                a.abs().amax())
            ms = cuda_ms(lambda: be.eigh(a, status), 5)
            lib_ms = cuda_ms(lambda: torch.linalg.eigh(a), 3 if n > 32 else 5)
            tag = "f64" if dtype == torch.float64 else "f32"
            routine = torch_eigh_routine(dtype, n, bsz)
            rows.append({"shape": [bsz, n], "dtype": tag, "bitwise": same,
                         "max_dw": d_w, "max_dv_sign": d_v,
                         "torch_routine": routine, "ms": ms,
                         "library_ms": lib_ms,
                         "workspace_bytes": status.work.numel()})
            print(f"in-loop eigh {tag} (B, n)=({bsz}, {n}): bitwise={same} "
                  f"max|dw|={d_w:.3e} max|dV.sign|={d_v:.3e} residual/|A|="
                  f"{resid:.2e} binding ms={ms:.4f} torch.linalg.eigh ms="
                  f"{lib_ms:.4f} (torch's routine {routine}) workspace "
                  f"{status.work.numel()} bytes", flush=True)
            if routine == "XsyevBatched":
                check(same, f"in-loop eigh {tag} at ({bsz}, {n}) is not "
                      f"torch's bit for bit (dw {d_w:.3e}, dV {d_v:.3e})")
            elif dtype == torch.float64:
                check(d_w <= EIGH_TOL_F64 and d_v <= EIGH_TOL_F64,
                      f"in-loop eigh f64 at ({bsz}, {n}) off torch's by "
                      f"{max(d_w, d_v):.3e} > {EIGH_TOL_F64:.0e}")
            check(resid <= (1e-12 if dtype == torch.float64 else 1e-4),
                  f"in-loop eigh {tag} at ({bsz}, {n}): residual {resid:.2e}")
    return rows


def scc_graph_phase(be):
    """Every route's SCC as a replayed CUDA graph against the eager loop:
    charges and residuals bit for bit, the same stop iteration, the same
    launches; the loop body under set_sync_debug_mode("error"); the
    in-loop eigh against torch.linalg.eigh. Returns the phase's JSON."""
    from metalquicha_tpu_torch.constants import KB_HARTREE
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import engine, scc_graph
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )
    from metalquicha_tpu_torch.ops import fermi_fill as ff
    from metalquicha_tpu_torch.ops import fragment_gemm as fm
    from metalquicha_tpu_torch.ops import fragment_reduce as fr
    from metalquicha_tpu_torch.ops import jacobi_eigh as jac
    from metalquicha_tpu_torch.ops import sp2
    from metalquicha_tpu_torch.workloads import bench_dimers

    eigh_rows = eigh_binding_check(be)
    kt = 300.0 * KB_HARTREE
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from memory_probe_torch import _w20_waters

    w20_numbers, w20_coords = _w20_waters()

    def w20_clusters(seed, n_clusters, k):
        """n_clusters sets of k waters of the w20 isomer, drawn by seed."""
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n_clusters):
            pick = np.sort(rng.choice(20, k, replace=False))
            out.append((w20_numbers[pick].reshape(-1),
                        w20_coords[pick].reshape(-1, 3), 0, 1))
        return out

    # label -> its fragments from a seed: seed 0 the miss's, seeds 1 and
    # 2 fresh inputs of the same shapes for the hits
    # (bench's dimers drawn anew; above 32 AOs, waters of the w20 isomer:
    # GFN2's SCC leaves some of water_clusters' hexamers unconverged in 64
    # iterations, and gives one of a new draw a NaN, in the JAX package
    # as in the port: tests/test_torch_reference_behaviour.py)
    sets = {"512x16": lambda seed: bench_dimers(512, seed=seed),
            "above32": lambda seed: (
                water_clusters(np.random.default_rng(5), 64, 6) if seed == 0
                else w20_clusters(seed, 64, 6)),                # nao 36
            "sp2": lambda seed: (
                water_clusters(np.random.default_rng(5), 16, 12) if seed == 0
                else w20_clusters(seed, 16, 12))}               # nao 72
    # route -> (variant, use_pallas_eigh, dtype, ALPB, set above 32 AOs)
    routes = {"gfn1_exact": ("gfn1", False, torch.float64, False, "above32"),
              "gfn1_jacobi": ("gfn1", True, torch.float32, False, "above32"),
              "sp2": ("gfn1", True, torch.float32, False, "sp2"),
              "gfn1_alpb": ("gfn1", False, torch.float64, True, "above32"),
              "gfn2": ("gfn2", False, torch.float64, False, "above32")}

    def launches():
        return (ff.launches, ff.density_launches, jac.launches, sp2.calls,
                be.launches, fm.launches, fr.launches)

    steps = [0]
    real_step = engine._anderson_step

    def counted_step(*args):
        steps[0] += 1
        return real_step(*args)

    def debug_step(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_step(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    out = {}
    for route, (variant, jacobi, dtype, alpb, above) in routes.items():
        for label in ("512x16", "above32"):
            if route == "sp2" and label == "512x16":
                continue  # the Jacobi route's shape
            frags_for = sets[above if label == "above32" else label]
            tol = 1e-9 if dtype == torch.float64 else 2e-5
            settings = engine.settings_from_params(
                variant, max_scf_iter=64, scf_tol=tol,
                use_pallas_eigh=jacobi)
            solv = BornSolvation(78.4, alpb=True) if alpb else None
            calc = tcalc.XtbCalculator(settings, variant=variant,
                                       dtype=dtype, device=DEVICE,
                                       solvation=solv)

            def operands(frags):
                frag = calc.make_batch(frags)
                with torch.no_grad():
                    S, H0, gamma, mp = tcalc._scc_operands(frag.coords,
                                                           frag, settings)
                    g_at = tcalc._solv_gamma(frag.coords, frag, solv)
                return S, H0, gamma, mp, g_at, frag

            def solve(ops, graph, st=settings):
                S, H0, gamma, mp, g_at, frag = ops
                with torch.no_grad():
                    if mp is None:
                        return engine.scf_solve(H0, S, gamma, frag, kt, st,
                                                g_at, graph=graph)
                    return engine.scf_solve_multipole(
                        H0, S, frag.coords, gamma, frag, kt, st, g_at, mp,
                        graph=graph)

            def run(ops, graph):
                """(charges, residuals, iterations, launches per counter,
                graphs captured)"""
                c0, s0 = launches(), steps[0]
                g0 = scc_graph.stats["captures"]
                r0 = scc_graph.stats["replays"]
                engine._anderson_step = counted_step
                try:
                    q, r = solve(ops, graph)
                    torch.cuda.synchronize()
                finally:
                    engine._anderson_step = real_step
                made = scc_graph.stats["captures"] - g0
                # a capture records the step without running it
                n = (steps[0] - s0 - made + scc_graph.stats["replays"] - r0)
                return q, r, n, [b - a for a, b in zip(c0, launches())], made

            def same_as(got, ref, what):
                q, r, n, made = got[:4]
                ok = bool(torch.equal(q, ref[0]) and torch.equal(r, ref[1]))
                check(ok, f"scc graph {route} {label} {what}: charges off by "
                      f"{float((q - ref[0]).abs().max()):.3e}")
                check(n == ref[2], f"scc graph {route} {label} {what}: "
                      f"stopped at {n} iterations, against {ref[2]}")
                check(made == ref[3], f"scc graph {route} {label} {what}: "
                      f"launches {made}, against {ref[3]}")
                return ok

            ops = operands(frags_for(0))
            nao = ops[0].shape[-1]
            fast = jacobi and dtype == torch.float32
            expect = ("sp2" if fast and nao > engine.PALLAS_EIGH_MAX_N
                      else "jacobi" if fast else "eigh")
            eager = run(ops, False)
            miss = run(ops, True)
            check(miss[4] == 1, f"scc graph {route} {label}: the first "
                  f"solve captured {miss[4]} graphs")
            same = same_as(miss, eager, "miss")
            miss_ms = sum(scc_graph.stats[k] for k in (
                "warmup_ms", "record_ms", "instantiate_ms"))
            n_eager, made_e = eager[2], eager[3]
            # the binding also diagonalizes S once per solve, for the
            # orthogonalizer (every route)
            used = {"eigh": made_e[4] - 1, "jacobi": made_e[2],
                    "sp2": made_e[3]}
            check(used[expect] == n_eager and all(
                v == 0 for k, v in used.items() if k != expect),
                f"scc graph {route} {label}: in-loop calls {used}, "
                f"expected {n_eager} of {expect}")
            # hits on fresh inputs: each the eager loop's bits and a new
            # capture's (made after the cache is cleared)
            hits = []
            for seed in (1, 2):
                ops_h = operands(frags_for(seed))
                check(ops_h[0].shape == ops[0].shape,
                      f"scc graph {route} {label}: seed {seed} gives "
                      f"{tuple(ops_h[0].shape)}")
                ref = run(ops_h, False)
                h0 = scc_graph.stats["hits"]
                hit = run(ops_h, True)
                setup_ms = scc_graph.stats["hit_setup_ms"]
                check(hit[4] == 0 and scc_graph.stats["hits"] == h0 + 1,
                      f"scc graph {route} {label}: seed {seed} was no hit")
                ok_e = same_as(hit, ref, f"hit (seed {seed})")
                check(not torch.equal(ref[0], eager[0]),
                      f"scc graph {route} {label}: seed {seed} gave the "
                      f"seed-0 charges")
                scc_graph.clear()
                fresh = run(ops_h, True)
                ok_f = same_as(hit, fresh[:4], f"hit (seed {seed}) against "
                               f"a new capture")
                hits.append({"seed": seed, "iterations": hit[2],
                             "bitwise_eager": ok_e,
                             "bitwise_new_capture": ok_f,
                             "setup_ms": setup_ms})
                check(setup_ms < 0.1 * miss_ms,
                      f"scc graph {route} {label}: a hit's setup took "
                      f"{setup_ms:.3f} ms, a miss's capture {miss_ms:.3f}")
            # no sync in the loop body
            engine._anderson_step = debug_step
            try:
                solve(ops, False, settings._replace(max_scf_iter=3))
                torch.cuda.synchronize()
            finally:
                engine._anderson_step = real_step
            rec = {"shape": [ops[0].shape[0], nao], "in_loop": expect,
                   "iterations": n_eager, "bitwise": same,
                   "launches_per_solve": miss[3], "miss_ms": miss_ms,
                   "capture_ms": {k: scc_graph.stats[k] for k in (
                       "warmup_ms", "record_ms", "instantiate_ms")},
                   "hits": hits,
                   "held_bytes": scc_graph.stats["held_bytes"]}
            if label == "512x16" or route == "sp2":
                # launch by launch, a miss, a hit, launch by launch
                fixed = settings._replace(scf_tol=0.0,
                                          max_scf_iter=SCC_ITERS)
                for graph in (False, True, True, False):
                    ms = cuda_ms(lambda g=graph: solve(ops, g, fixed), 1)
                    rec.setdefault("eager_ms_per_iteration" if not graph
                                   else "graph_ms_per_iteration",
                                   []).append(ms / SCC_ITERS)
            out[f"{route}_{label}"] = rec
            print(f"scc graph {route} {label}: {rec}", flush=True)
    return {"routes": out, "eigh": eigh_rows,
            "cache": {k: scc_graph.stats[k] for k in (
                "captures", "hits", "misses", "evictions", "held_bytes")}}


# the Anderson window kernel: (B fragments, nx) at the main path's shapes:
# the dimer slice in GFN1 (nsh) and GFN2 (nsh + 9 nat), the w20 MBE(4)
# chunk, GFN1 and GFN2 water hexamers; m = broyden_memory
WINDOW_SHAPES = ((512, 12), (512, 62), (5985, 24), (64, 36), (64, 186))
WINDOW_M = 12
# windows above the first kernel's 32 (ROADMAP C21), (B, nx, m, it,
# decay): at the dimer slice's GFN1 shape (a warp per fragment) with the
# window partly filled (at nx = 12 a full window of 40 would be rank 12,
# its coefficients set by the regularizer's rounding), and wrapped at
# GFN2's hexamer shape (a block per fragment)
WIDE_WINDOWS = ((512, 12, 40, 11, 0.5), (512, 12, 64, 11, 0.5),
                (64, 186, 40, 43, 0.8), (64, 186, 64, 67, 0.8))
WINDOW_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
#: (reg, c_lim) the engine passes per dtype
WINDOW_LIMITS = {torch.float64: (1e-12, 1e3), torch.float32: (1e-4, 2.0)}


def window_state(rng, bsz: int, nx: int, dtype, it: int = 11,
                 m: int = WINDOW_M, decay: float = 0.5):
    """A seeded Anderson state at iteration `it`: windows of a sequence of
    states converging to a fixed point (by `decay` an iteration), one
    frozen fragment; (x, f_res, hist_x, hist_f, resid, active, it) on the
    card."""
    target = rng.standard_normal((bsz, nx))
    hist_x = np.zeros((bsz, m, nx))
    hist_f = np.zeros((bsz, m, nx))
    for k in range(it):
        xk = target + decay ** k * rng.standard_normal((bsz, nx))
        hist_x[:, k % m] = xk
        hist_f[:, k % m] = (target - xk) * 0.7 + 1e-3 * decay ** k * (
            rng.standard_normal((bsz, nx)))
    x = target + decay ** it * rng.standard_normal((bsz, nx))
    active = np.ones(bsz, dtype=bool)
    active[-1] = False
    out = [torch.tensor(a, dtype=dtype, device=DEVICE) for a in
           (x, (target - x) * 0.7, hist_x, hist_f, rng.uniform(0, 1, bsz))]
    return (*out, torch.tensor(active, device=DEVICE),
            torch.tensor(it, dtype=torch.int64, device=DEVICE))


def window_bound(bsz: int, nx: int, dtype):
    """(bound_ms, bound_by) of one window step: (m(m+1)/2 + m) dot products
    of 2 nx operations, the elimination's 2 m^3 / 3, the step's 4 m nx and
    the update's 4 nx, at the vector rate; or the two windows, x and f_res
    read once and x, the two new window slots, the residual and the flag
    written once, at the memory rate."""
    m = WINDOW_M
    ops = bsz * ((m * (m + 1) // 2 + m) * 2 * nx + 2 * m**3 // 3
                 + 4 * m * nx + 4 * nx)
    size = torch.finfo(dtype).bits // 8
    nbytes = bsz * ((2 * m * nx + 2 * nx) * size + (3 * nx + 1) * size + 1)
    return _bound({"operations": ops / PEAK_VECTOR[dtype],
                   "bytes": nbytes / PEAK_BYTES})


def window_phase(aw):
    """The Anderson window kernel against its plain versions (the torch
    algebra it replaces, `anderson_window_reference`, and the kernel's order
    in plain ops, `anderson_window_rowwise`) at the main path's shapes:
    x, the windows and the residuals within WINDOW_TOL, the flags equal;
    a fragment's bits the same alone and in its batch; times of the kernel,
    the rowwise twin (plain_ms) and the reference's batched products and
    solve_ex (library_ms) beside the bound. Returns the kernels line's
    entry (the (512, 12) float64 shape)."""
    rng = np.random.default_rng(14)
    entry = None
    for dtype in (torch.float64, torch.float32):
        reg, c_lim = WINDOW_LIMITS[dtype]
        kw = dict(beta=0.4, reg=reg, c_lim=c_lim, scf_tol=1e-6)
        for bsz, nx in WINDOW_SHAPES:
            state = window_state(rng, bsz, nx, dtype)

            def run(fn, st=state):
                out = [t.clone() for t in st]
                fn(*out, **kw)
                return [out[0], out[2], out[3], out[4], out[5]]

            def plain(fn):
                return lambda *a, **k: fn(*a, k["beta"], k["reg"],
                                          k["c_lim"], k["scf_tol"])

            n0 = aw.launches
            got = run(aw.anderson_window)
            torch.cuda.synchronize()
            check(aw.launches == n0 + 1, "the window kernel did not count "
                  "its launch")
            err = 0.0
            for ref_fn in (aw.anderson_window_reference,
                           aw.anderson_window_rowwise):
                ref = run(plain(ref_fn))
                check(torch.equal(got[4], ref[4]),
                      f"window ({bsz}, {nx}): the active flags differ")
                for a, b in zip(got[:4], ref[:4]):
                    err = max(err, float((a - b).abs().max()))
            # a fragment alone, and the batch's last three: the same bits
            for rows in ([0], [bsz - 1, 1, 0]):
                idx = torch.tensor(rows, device=DEVICE)
                part = [t.index_select(0, idx) if t.dim() else t
                        for t in state]
                alone = run(aw.anderson_window, part)
                check(all(torch.equal(a, b.index_select(0, idx))
                          for a, b in zip(alone, got)),
                      f"window ({bsz}, {nx}): a fragment's bits depend on "
                      f"its batch")
            tag = "f64" if dtype == torch.float64 else "f32"
            check(err <= WINDOW_TOL[dtype], f"window {tag} ({bsz}, {nx}): "
                  f"max err {err:.3e} > {WINDOW_TOL[dtype]:.0e}")
            work = [t.clone() for t in state]
            times = {}
            for name, fn in (("library", plain(aw.anderson_window_reference)),
                             ("kernel", aw.anderson_window),
                             ("kernel2", aw.anderson_window),
                             ("plain", plain(aw.anderson_window_rowwise))):
                times[name] = cuda_ms(lambda f=fn: f(*work, **kw),
                                      3 if name == "plain" else 20)
            eager = min(times["kernel"], times["kernel2"])
            ms = graph_ms(lambda: aw.anderson_window(*work, **kw), 20)
            bound_ms, bound_by = window_bound(bsz, nx, dtype)
            print(f"anderson window {tag} (B, nx, m)=({bsz}, {nx}, "
                  f"{WINDOW_M}): max err={err:.3e} kernel ms={ms:.4f} "
                  f"(graph-replayed; launched one by one from Python "
                  f"{eager:.4f}) "
                  f"rowwise ms={times['plain']:.4f} library (batched "
                  f"products + solve_ex) ms={times['library']:.4f} bound "
                  f"ms={bound_ms:.6f} ({bound_by}, {100 * bound_ms / ms:.2f}%"
                  f" of it)", flush=True)
            if entry is None:
                entry = {"max_abs_err": err, "ms": ms, "eager_ms": eager,
                         "plain_ms": times["plain"], "bound_ms": bound_ms,
                         "bound_by": bound_by,
                         "library_ms": times["library"]}
        wide_window_check(aw, rng, dtype, kw)
    return entry


def wide_window_check(aw, rng, dtype, kw):
    """Windows above 32 (WIDE_WINDOWS, ROADMAP C21) on the kernel against
    both plain versions: x, the windows and the residuals within
    WINDOW_TOL, the flags equal."""
    tag = "f64" if dtype == torch.float64 else "f32"
    for bsz, nx, m, it, decay in WIDE_WINDOWS:
        state = window_state(rng, bsz, nx, dtype, it=it, m=m, decay=decay)
        outs = []
        for fn in (aw.anderson_window,
                   lambda *a, **k: aw.anderson_window_reference(
                       *a, k["beta"], k["reg"], k["c_lim"], k["scf_tol"]),
                   lambda *a, **k: aw.anderson_window_rowwise(
                       *a, k["beta"], k["reg"], k["c_lim"], k["scf_tol"])):
            out = [t.clone() for t in state]
            fn(*out, **kw)
            outs.append([out[0], out[2], out[3], out[4], out[5]])
        torch.cuda.synchronize()
        err = 0.0
        for ref in outs[1:]:
            check(torch.equal(outs[0][4], ref[4]),
                  f"window m={m} {tag}: the active flags differ")
            for a, b in zip(outs[0][:4], ref[:4]):
                err = max(err, float((a - b).abs().max()))
        check(err <= WINDOW_TOL[dtype], f"window m={m} {tag} ({bsz}, {nx}): "
              f"max err {err:.3e} > {WINDOW_TOL[dtype]:.0e}")
        print(f"anderson window {tag} (B, nx, m)=({bsz}, {nx}, {m}), it={it}:"
              f" max err={err:.3e} against both plain versions", flush=True)


# the batch-invariant product kernel: (B fragments, n) at the main path's
# shapes: the dimer slice, the w20 MBE(2) buckets, the w20 MBE(4) gradient
# and energy chunks, the largest fragments it takes
GEMM_SHAPES = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
               (128, 64))
# above 64 (the tiled class): the call_graph phase's dodecamers (nao 72
# padded to 96) and 128, small batches in 32 x 32 units; the 73-atom
# peptide (228 AOs padded to 241) as the FD Hessian's chunks run it, and
# SP2's (64, 256), in 64 x 64 units (each fingerprinted from the card's
# output of the tiled kernel before its redesign, or of the kernel that
# first took it)
GEMM_WIDE = ((16, 96), (3, 128), (41, 241), (64, 256))
GEMM_FINGERPRINTED_WIDE = GEMM_WIDE
GEMM_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
# rectangular products (B, m, k, n): a (1, R) by (R, R) product per atom
# pair, as D3's C6 backward runs it (its forward is the pair kernel), for
# a 73-atom Hessian chunk (41 x 73 x 73 pairs) and the w20 MBE(2) dimers
# (190 x 6 x 6), and the (R, 1) by (1, R) form of a product's backward
# (the fingerprinted cases of the kernel's first version); CPCM's B^T
# A^-1 B, (nat, points) by (points, nat), at the w20 MBE(2) dimers and
# monomers (110 points an atom), and its backward's (points, nat) by
# (nat, nat) (k and m of any length: the tiled class)
GEMM_RECT = ((41 * 73 * 73, 1, 5, 5), (190 * 36, 1, 5, 5),
             (190 * 36, 5, 1, 5), (190, 6, 660, 6), (20, 3, 330, 3),
             (190, 660, 6, 6))
# (B, nat) of D3's pair contraction (`pair_bilinear`) on the main path
PAIR_SHAPES = ((41, 73), (190, 6))
# (B, n) of the Coulomb matvec's own check: gamma at the shell count of the
# dimer slice (12 shells), of the w20 MBE(4) chunk (24) and of GFN1 water
# hexamers (36), and the sizes whose rows its kernel cuts into bands
# (the dodecamers' 96 AOs, 128, and the 73-atom peptide's 192 shells)
MATVEC_SHAPES = ((512, 12), (5985, 24), (64, 36), (16, 96), (3, 128),
                 (41, 192))


def gemm_bound(bsz: int, n: int, dtype, sandwich: bool = False):
    """(bound_ms, bound_by) of a batch of (n, n) products: 2 n^3
    operations a product at PEAK_FLOPS (FP64 on the tensor cores, FP32
    outside them), or the operands read and the result written once (3 n^2
    elements), at the memory rate; the sandwich two products and an add
    over 4 n^2 elements (x, f and the shift read, the result written)."""
    k = 2 if sandwich else 1
    flop = bsz * (k * 2 * n**3 + (n * n if sandwich else 0))
    nbytes = bsz * (k + 2) * n * n * torch.finfo(dtype).bits // 8
    return _bound({"operations": flop / PEAK_FLOPS[dtype],
                   "bytes": nbytes / PEAK_BYTES})


def rect_bound(bsz: int, m: int, k: int, n: int, dtype):
    """(bound_ms, bound_by) of a batch of (m, k) by (k, n) products: 2 m k
    n operations a product at PEAK_FLOPS, or the operands read and the
    result written once at the memory rate."""
    nbytes = bsz * (m * k + k * n + m * n) * torch.finfo(dtype).bits // 8
    return _bound({"operations": 2 * bsz * m * k * n / PEAK_FLOPS[dtype],
                   "bytes": nbytes / PEAK_BYTES})


def matvec_bound(bsz: int, n: int, dtype):
    """(bound_ms, bound_by) of a batch of (n, n) matvecs: M and x read
    and y written once at the memory rate, or 2 n^2 operations a fragment
    at the vector rate (FMA, no tensor cores)."""
    nbytes = bsz * (n * n + 2 * n) * torch.finfo(dtype).bits // 8
    return _bound({"operations": 2 * bsz * n * n / PEAK_VECTOR[dtype],
                   "bytes": nbytes / PEAK_BYTES})


def pair_bound(bsz: int, nat: int, dtype, r: int = 5):
    """(bound_ms, bound_by) of `pair_bilinear` on (bsz, nat, r) weights
    and (bsz, nat, nat, r, r) grids: both read and the (bsz, nat, nat)
    output written once at the memory rate, or 2 r^2 + 2 r operations a
    pair at the vector rate."""
    pairs = bsz * nat * nat
    nbytes = (bsz * nat * r + pairs * (r * r + 1)) * torch.finfo(
        dtype).bits // 8
    return _bound({"operations": pairs * (2 * r * r + 2 * r)
                   / PEAK_VECTOR[dtype], "bytes": nbytes / PEAK_BYTES})


def _rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def gemm_phase(fm):
    """The batch-invariant product kernel (csrc/fragment_gemm.cu) against
    its plain versions (the kernel's order in elementwise ops,
    `fragment_bmm_reference` / `matvec_reference`) and torch.matmul at the
    main path's shapes: the product with every transpose, the sandwich
    x f x + s and the matvec, max err relative to the largest entry within
    GEMM_TOL; a fragment's bits the same alone and in its batch; times of
    the kernel, the plain version and torch.matmul (library_ms: cuBLAS's
    batched product, which the engine ran before) beside the bound.
    Returns the kernels line's entries: the (512, 16) float64 product, the
    sandwich's numbers beside it, and `rect_phase`'s of the pair
    contraction (float64)."""
    gemm_bits_check(fm)
    layout_check(fm)
    rng = np.random.default_rng(15)
    entry = pair_entry = None
    for dtype in (torch.float64, torch.float32):
        for bsz, n in GEMM_SHAPES + GEMM_WIDE:
            a, b, s = (torch.tensor(rng.standard_normal((bsz, n, n)),
                                    dtype=dtype, device=DEVICE)
                       for _ in range(3))
            err = 0.0
            for ta, tb in ((False, False), (True, False), (False, True),
                           (True, True)):
                n0 = fm.launches
                got = fm.fragment_bmm(a, b, ta, tb)
                torch.cuda.synchronize()
                check(fm.launches == n0 + 1, "the product kernel did not "
                      "count its launch")
                ref = torch.matmul(a.mT if ta else a, b.mT if tb else b)
                err = max(err, _rel_err(got, ref), _rel_err(
                    got, fm.fragment_bmm_reference(a, b, ta, tb)))
            sw = fm.sandwich(a, b, s)
            err = max(err, _rel_err(sw, a @ b @ a + s), _rel_err(
                sw, fm.fragment_bmm_reference(
                    fm.fragment_bmm_reference(a, b), a) + s))
            mv = fm.fragment_matvec(a, b[:, 0])
            err = max(err, _rel_err(mv, (a @ b[:, 0, :, None])[..., 0]),
                      _rel_err(mv, fm.matvec_reference(a, b[:, 0])))
            # the transposed matvec of the Coulomb term's backward pass
            mvt = fm.fragment_matvec(a, b[:, 0], True)
            err = max(err, _rel_err(mvt, (a.mT @ b[:, 0, :, None])[..., 0]),
                      _rel_err(mvt, fm.matvec_reference(a, b[:, 0], True)))
            tag = "f64" if dtype == torch.float64 else "f32"
            check(err <= GEMM_TOL[dtype], f"fragment products {tag} ({bsz}, "
                  f"{n}): max err {err:.3e} > {GEMM_TOL[dtype]:.0e}")
            # a fragment alone, and the batch's last and first: the same bits
            whole = (fm.fragment_bmm(a, b, False, True), sw, mv, mvt)
            for rows in ([0], [bsz - 1, 0]):
                idx = torch.tensor(rows, device=DEVICE)
                a1, b1, s1 = (t.index_select(0, idx) for t in (a, b, s))
                part = (fm.fragment_bmm(a1, b1, False, True),
                        fm.sandwich(a1, b1, s1),
                        fm.fragment_matvec(a1, b1[:, 0]),
                        fm.fragment_matvec(a1, b1[:, 0], True))
                check(all(torch.equal(p, w.index_select(0, idx))
                          for p, w in zip(part, whole)),
                      f"fragment products ({bsz}, {n}): a fragment's bits "
                      f"depend on its batch")
            # graph-replayed: each call's own device time (the wrapper's
            # host time, longer than these kernels, left out); in turns;
            # the matvec's x contiguous, as the engine's charges (b[:, 0]
            # would time the wrapper's copy too)
            v = b[:, 0].contiguous()
            times = {}
            for name, fn in (
                    ("library", lambda: torch.matmul(a, b.mT)),
                    ("kernel", lambda: fm.fragment_bmm(a, b, False, True)),
                    ("kernel2", lambda: fm.fragment_bmm(a, b, False, True)),
                    ("plain", lambda: fm.fragment_bmm_reference(
                        a, b, False, True)),
                    ("sw_library", lambda: a @ b @ a + s),
                    ("sw_kernel", lambda: fm.sandwich(a, b, s)),
                    ("sw_kernel2", lambda: fm.sandwich(a, b, s)),
                    ("mv_library", lambda: torch.matmul(a, v[..., None])),
                    ("mv_kernel", lambda: fm.fragment_matvec(a, v))):
                times[name] = graph_ms(fn, 3 if name == "plain" else 20)
            ms = min(times["kernel"], times["kernel2"])
            sw_ms = min(times["sw_kernel"], times["sw_kernel2"])
            bound_ms, bound_by = gemm_bound(bsz, n, dtype)
            sw_bound, _ = gemm_bound(bsz, n, dtype, sandwich=True)
            mv_bound, mv_by = matvec_bound(bsz, n, dtype)
            print(f"fragment products {tag} (B, n)=({bsz}, {n}): max err="
                  f"{err:.3e} product ms={ms:.4f} plain ms="
                  f"{times['plain']:.4f} torch.matmul ms="
                  f"{times['library']:.4f} bound ms={bound_ms:.6f} "
                  f"({bound_by}, {100 * bound_ms / ms:.2f}% of it); "
                  f"sandwich ms={sw_ms:.4f} torch ms="
                  f"{times['sw_library']:.4f} bound ms={sw_bound:.6f} "
                  f"({100 * sw_bound / sw_ms:.2f}% of it); matvec ms="
                  f"{times['mv_kernel']:.4f} torch.matmul ms="
                  f"{times['mv_library']:.4f} bound ms={mv_bound:.6f} "
                  f"({mv_by})", flush=True)
            if entry is None:
                entry = {"max_abs_err": err, "ms": ms,
                         "plain_ms": times["plain"], "bound_ms": bound_ms,
                         "bound_by": bound_by,
                         "library_ms": times["library"],
                         "sandwich_ms": sw_ms,
                         "sandwich_library_ms": times["sw_library"],
                         "sandwich_bound_ms": sw_bound}
        pair = rect_phase(fm, rng, dtype)
        pair_entry = pair_entry or pair
    return entry, pair_entry


def gemm_bits_check(fm):
    """The product kernel bit for bit its first version (commit df9980a;
    the fixture
    `tests/data/fragment_gemm_bits.json`, written on the card from that
    commit by `tools/gemm_bits_torch.py --write`): every entry, transpose,
    shape and dtype the fixture holds, which covers GEMM_SHAPES and
    GEMM_RECT in both dtypes; the pair contraction bit for bit its card
    output at commit 759462b (the direct kernel, torch's multiply and
    sum) at PAIR_SHAPES and the fixture's other pair shapes; above 128
    (GEMM_FINGERPRINTED_WIDE, the matvec at (41, 192), CPCM's forms in
    GEMM_RECT) the card's output of the kernel that first took them."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import gemm_bits_torch as bits

    fixture = bits.load_fixture()
    want = {bits.key_of(e, d, shape, ta, tb)
            for d in ("f64", "f32")
            for shape in ([(b, n, n, n) for b, n in GEMM_SHAPES
                           + GEMM_FINGERPRINTED_WIDE] + list(GEMM_RECT))
            for e, ta, tb in [("bmm", ta, tb) for ta in (False, True)
                              for tb in (False, True)]}
    # the matvec, both forms, at its own shapes and on offset operands
    want |= {bits.key_of(e, d, (b, n, n, n), ta, False)
             for d in ("f64", "f32") for ta in (False, True)
             for e, shapes in (("matvec", MATVEC_SHAPES),
                               ("matvec_offset", ((512, 12), (16, 96))))
             for b, n in shapes}
    # the pair contraction at its main-path shapes
    want |= {bits.key_of("pair", d, shape) for d in ("f64", "f32")
             for shape in PAIR_SHAPES}
    check(want <= set(fixture["cases"]), f"the fingerprint fixture lacks "
          f"{sorted(want - set(fixture['cases']))}")
    t0 = time.perf_counter()
    differ = bits.compare(fm, fixture)
    check(not differ, f"the product kernel's bits moved from the "
          f"fingerprint: {differ}")
    print(f"fragment products: {len(fixture['cases'])} cases bit for bit "
          f"the fingerprint of {fixture['module']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def layout_check(fm):
    """Operands the kernel stages element by element against the same
    product on operands it stages 16 bytes at a time, bit for bit: a view
    whose storage offset leaves it 4 or 8 bytes off 16 (every entry and
    transpose, one shape of each size class), and rows of odd length (n =
    11, 37 and 97 against the product padded with a zero row and column to
    12, 38 and 98, whose leading block takes the same sums)."""
    rng = np.random.default_rng(16)
    for dtype in (torch.float64, torch.float32):
        for bsz, n in ((190, 16), (2581, 32), (128, 64), (16, 96)):
            flat = torch.tensor(rng.standard_normal(bsz * n * n + 1),
                                dtype=dtype, device=DEVICE)
            off = flat[1:].view(bsz, n, n)
            whole = off.clone()
            b, s = (torch.tensor(rng.standard_normal((bsz, n, n)),
                                 dtype=dtype, device=DEVICE)
                    for _ in range(2))
            pairs = [(fm.fragment_bmm(off, b, ta, tb),
                      fm.fragment_bmm(whole, b, ta, tb))
                     for ta in (False, True) for tb in (False, True)]
            pairs += [(fm.fragment_bmm(b, off, ta, tb),
                       fm.fragment_bmm(b, whole, ta, tb))
                      for ta in (False, True) for tb in (False, True)]
            pairs.append((fm.sandwich(off, b, s), fm.sandwich(whole, b, s)))
            pairs.append((fm.sandwich(b, off, off), fm.sandwich(b, whole,
                                                               whole)))
            check(all(torch.equal(x, y) for x, y in pairs),
                  f"fragment products ({bsz}, {n}): an operand with a "
                  f"storage offset changed the bits")
        for bsz, n in ((20, 11), (128, 37), (8, 97)):
            a, b, s = (torch.tensor(rng.standard_normal((bsz, n, n)),
                                    dtype=dtype, device=DEVICE)
                       for _ in range(3))
            pad = [torch.nn.functional.pad(t, (0, 1, 0, 1)) for t in (a, b, s)]
            cut = (slice(None), slice(0, n), slice(0, n))
            pairs = [(fm.fragment_bmm(a, b, ta, tb),
                      fm.fragment_bmm(pad[0], pad[1], ta, tb)[cut])
                     for ta in (False, True) for tb in (False, True)]
            pairs.append((fm.sandwich(a, b, s), fm.sandwich(*pad)[cut]))
            check(all(torch.equal(x, y) for x, y in pairs),
                  f"fragment products ({bsz}, {n}): rows of odd length "
                  f"changed the bits")
    print("fragment products: offset and odd-n operands bit for bit the "
          "same products on aligned ones", flush=True)


def matvec_phase(fm):
    """The Coulomb matvec on its kernel at MATVEC_SHAPES, both forms (the
    transposed one is the Coulomb term's backward), float64 and float32:
    against its plain version (`matvec_reference`, the kernel's order) and
    torch.matmul within GEMM_TOL; a fragment's bits alone and in its batch
    equal; an operand with a storage offset bit for bit the aligned one;
    the kernel, the plain version and torch.matmul (library_ms) timed
    graph-replayed beside `matvec_bound`. Returns the kernels line's
    entry, the (512, 12) float64 plain form."""
    rng = np.random.default_rng(19)
    entry = None
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for bsz, n in MATVEC_SHAPES:
            m = torch.tensor(rng.standard_normal((bsz, n, n)), dtype=dtype,
                             device=DEVICE)
            x = torch.tensor(rng.standard_normal((bsz, n)), dtype=dtype,
                             device=DEVICE)
            flat = torch.tensor(rng.standard_normal(bsz * n * n + 1),
                                dtype=dtype, device=DEVICE)
            line = []
            for trans in (False, True):
                form = "transposed" if trans else "plain"
                n0 = fm.launches
                got = fm.fragment_matvec(m, x, trans)
                torch.cuda.synchronize()
                check(fm.launches == n0 + 1, "the matvec did not count its "
                      "launch")
                ref = ((m.mT if trans else m) @ x[..., None])[..., 0]
                err = max(_rel_err(got, ref), _rel_err(
                    got, fm.matvec_reference(m, x, trans)))
                what = f"matvec {form} {tag} ({bsz}, {n})"
                check(err <= GEMM_TOL[dtype], f"{what}: max err {err:.3e} > "
                      f"{GEMM_TOL[dtype]:.0e}")
                for rows in ([0], [bsz - 1, 0], [bsz // 2]):
                    idx = torch.tensor(rows, device=DEVICE)
                    part = fm.fragment_matvec(m.index_select(0, idx),
                                              x.index_select(0, idx), trans)
                    check(torch.equal(part, got.index_select(0, idx)),
                          f"{what}: a fragment's bits depend on its batch")
                off = flat[1:].view(bsz, n, n)
                check(torch.equal(fm.fragment_matvec(off, x, trans),
                                  fm.fragment_matvec(off.clone(), x, trans)),
                      f"{what}: an operand with a storage offset changed "
                      f"the bits")
                ms = min(graph_ms(lambda: fm.fragment_matvec(m, x, trans),
                                  20),
                         graph_ms(lambda: fm.fragment_matvec(m, x, trans),
                                  20))
                plain_ms = graph_ms(
                    lambda: fm.matvec_reference(m, x, trans), 3)
                mt = m.mT if trans else m
                library_ms = graph_ms(lambda: torch.matmul(mt, x[..., None]),
                                      20)
                bound_ms, bound_by = matvec_bound(bsz, n, dtype)
                line.append(f"{form}: ms={ms:.4f} plain version ms="
                            f"{plain_ms:.4f} torch.matmul ms="
                            f"{library_ms:.4f} ({100 * bound_ms / ms:.2f}% "
                            f"of the bound)")
                if entry is None:
                    entry = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": library_ms}
            print(f"matvec {tag} (B, n)=({bsz}, {n}): bit for bit alone and "
                  f"in its batch, offset operands the same bits; bound ms="
                  f"{bound_ms:.6f} ({bound_by}); " + "; ".join(line),
                  flush=True)
    return entry


def rect_phase(fm, rng, dtype):
    """The product kernel's rectangular forms on the main path (GEMM_RECT,
    every transpose) against both plain versions, and D3's pair
    contraction (`pair_bilinear`, PAIR_SHAPES) on its own kernel: one
    launch a call, bit for bit its plain version
    (`pair_bilinear_reference`), within GEMM_TOL of the einsums it
    replaced, its bits and its backward's (dw, dgrids) the same for a
    fragment alone and in its batch; times beside torch's and
    `pair_bound`. Returns the kernels line's entry for `pair_bilinear`
    (its first shape)."""
    tag = "f64" if dtype == torch.float64 else "f32"
    tol = GEMM_TOL[dtype]
    for bsz, m, k, n in GEMM_RECT:
        err, times = 0.0, {}
        for ta, tb in ((False, False), (True, False), (False, True),
                       (True, True)):
            a = torch.tensor(rng.standard_normal(
                (bsz, *((k, m) if ta else (m, k)))), dtype=dtype,
                device=DEVICE)
            b = torch.tensor(rng.standard_normal(
                (bsz, *((n, k) if tb else (k, n)))), dtype=dtype,
                device=DEVICE)
            # a backward's form past MAX_N (CPCM's (points, nat) by (nat,
            # nat)) as the op's autograd Function launches it
            bmm = fm.fragment_bmm if fm.takes(m, n) else fm._launch_bmm
            got = bmm(a, b, ta, tb)
            check(tuple(got.shape) == (bsz, m, n),
                  f"fragment product shape {tuple(got.shape)}")
            ref = torch.matmul(a.mT if ta else a, b.mT if tb else b)
            err = max(err, _rel_err(got, ref), _rel_err(
                got, fm.fragment_bmm_reference(a, b, ta, tb)))
            for rows in ([0], [bsz - 1, 0]):
                idx = torch.tensor(rows, device=DEVICE)
                part = bmm(a.index_select(0, idx), b.index_select(0, idx),
                           ta, tb)
                check(torch.equal(part, got.index_select(0, idx)),
                      f"fragment products ({bsz}, {m}, {k}, {n}): a "
                      f"fragment's bits depend on its batch")
            if not (ta or tb):
                times["kernel"] = graph_ms(lambda: bmm(a, b, False, False),
                                           20)
                times["library"] = graph_ms(lambda: torch.matmul(a, b), 20)
        check(err <= tol, f"fragment products {tag} ({bsz}, {m}, {k}, {n}): "
              f"max err {err:.3e} > {tol:.0e}")
        bound_ms, bound_by = rect_bound(bsz, m, k, n, dtype)
        print(f"fragment products {tag} (B, m, k, n)=({bsz}, {m}, {k}, {n}),"
              f" every transpose: max err={err:.3e} product ms="
              f"{times['kernel']:.4f} torch.matmul ms="
              f"{times['library']:.4f} bound ms={bound_ms:.6f} ({bound_by}, "
              f"{100 * bound_ms / times['kernel']:.2f}% of it)", flush=True)
    entry = None
    pair_kind = fm.kind_of("pair_bilinear", 5)
    for bsz, nat in PAIR_SHAPES:
        w = torch.tensor(rng.random((bsz, nat, 5)), dtype=dtype,
                         device=DEVICE)
        w = w / w.sum(-1, keepdim=True)
        grids = torch.tensor(rng.random((bsz, nat, nat, 5, 5)) * 40.0,
                             dtype=dtype, device=DEVICE)
        before = dict(fm.launches_by_kind)
        got = fm.pair_bilinear(w, grids)
        torch.cuda.synchronize()
        made = {k: n - before.get(k, 0)
                for k, n in fm.launches_by_kind.items()
                if n != before.get(k, 0)}
        check(made == {pair_kind: 1}, f"pair_bilinear ({bsz}, {nat}): "
              f"launched {made}, not one pair kernel")

        def einsums():
            v = torch.einsum("bia,bijac->bijc", w, grids)
            return torch.einsum("bijc,bjc->bij", v, w)

        plain = fm.pair_bilinear_reference(w, grids)
        check(torch.equal(got, plain), f"pair_bilinear {tag} ({bsz}, "
              f"{nat}): not bit for bit its plain version")
        err = max(_rel_err(got, einsums()), _rel_err(got, plain))
        check(err <= tol, f"pair_bilinear {tag} ({bsz}, {nat}): max err "
              f"{err:.3e} > {tol:.0e}")
        # the backward: dw (CN's gradient) and dgrids (the theta fits')
        dc = torch.tensor(rng.standard_normal((bsz, nat, nat)),
                          dtype=dtype, device=DEVICE)

        def grads(w, grids, dc):
            w, grids = (t.detach().requires_grad_() for t in (w, grids))
            return torch.autograd.grad(fm.pair_bilinear(w, grids),
                                       (w, grids), dc)

        whole = grads(w, grids, dc)
        for idx in ([0], [bsz - 1, 0]):
            idx = torch.tensor(idx, device=DEVICE)
            part = fm.pair_bilinear(w.index_select(0, idx),
                                    grids.index_select(0, idx))
            check(torch.equal(part, got.index_select(0, idx)),
                  f"pair_bilinear ({bsz}, {nat}): a fragment's bits depend "
                  f"on its batch")
            back = grads(*(t.index_select(0, idx) for t in (w, grids, dc)))
            check(all(torch.equal(p, q.index_select(0, idx))
                      for p, q in zip(back, whole)),
                  f"pair_bilinear ({bsz}, {nat}): a fragment's gradient "
                  f"depends on its batch")
        ms = min(graph_ms(lambda: fm.pair_bilinear(w, grids), 20),
                 graph_ms(lambda: fm.pair_bilinear(w, grids), 20))
        lib = graph_ms(einsums, 20)
        plain_ms = graph_ms(lambda: fm.pair_bilinear_reference(w, grids), 3)
        bound_ms, bound_by = pair_bound(bsz, nat, dtype)
        print(f"pair_bilinear {tag} (B, nat)=({bsz}, {nat}): one launch, "
              f"bit for bit its plain version, its gradient alone and in "
              f"its batch: True; max err={err:.3e} ms={ms:.4f} plain ms="
              f"{plain_ms:.4f} torch.einsum ms={lib:.4f} bound ms="
              f"{bound_ms:.6f} ({bound_by}, {100 * bound_ms / ms:.2f}% of "
              f"it)", flush=True)
        if entry is None:
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib}
    return entry


#: (B, n) of the fragment sums' check: the dimer slice (16 AOs), the w20
#: MBE(4) chunk (32), GFN2 water hexamers (36 AOs, padded to 48), the 16
#: dodecamers (72, padded to 96), the 73-atom FD Hessian's one fragment
#: (241 AOs: odd rows, a fragment's bands in one cluster); the moments d =
#: 3 (dipoles) and 6 (quadrupoles)
REDUCE_SHAPES = ((512, 16), (5985, 32), (64, 48), (16, 96), (1, 241))
REDUCE_TOL = GEMM_TOL
#: the entries of csrc/fragment_reduce.cu: what each replaces in the JAX
#: package (XLA's contraction or sum there)
REDUCE_REPLACES = {
    "moment_fock": "metalquicha_tpu/methods/xtb/engine.py:567",
    "moment_rows": "metalquicha_tpu/methods/xtb/gfn2.py:50",
    "segment_sum": "metalquicha_tpu/methods/xtb/engine.py:458",
    "fragment_sum": "metalquicha_tpu/methods/xtb/engine.py:950",
}


def reduce_bound(entry: str, bsz: int, n: int, dtype, d: int = 6,
                 size: int = 0, length: int = 0, index: bool = True,
                 weights: bool = False, rows: int = 1, sym: bool = True):
    """(bound_ms, bound_by) of one launch of a fragment sum entry: every
    input read once and every output written once at the memory rate, or
    its multiplies and adds at the vector rate (no tensor cores), the
    larger. moment_fock over d planes in all (9: D and Q): v (n, d), the
    planes (d n^2) and, with `sym`, f in, F out, (2 d + 3) n^2
    operations; without `sym` (moment_contract) (d + 1) n^2 + d n elements
    and 2 d n^2 operations; moment_rows: a, m (d n^2), the int64 index and the weights
    where the form has them in, (size, d) out, 2 d n^2 operations;
    segment_sum: (n, d) values, the index and the weights where the form
    has them in, (size, d) out; fragment_sum: `rows` rows a fragment (the
    tensor's elements over `length`), each `length` elements in and one
    out."""
    item = torch.finfo(dtype).bits // 8
    read = (n if weights else 0), (8 * n if index else 0)
    if entry == "moment_fock":
        elems = (d + (2 if sym else 1)) * n * n + d * n
        ops, extra = (2 * d + (3 if sym else 0)) * n * n, 0
    elif entry == "moment_rows":
        elems, ops = (1 + d) * n * n + read[0] + size * d, 2 * d * n * n
        extra = read[1]
    elif entry == "segment_sum":
        elems, ops, extra = n * d + read[0] + size * d, n * d, read[1]
    else:
        elems, ops, extra = rows * (length + 1), rows * length, 0
    return _bound({"operations": bsz * ops / PEAK_VECTOR[dtype],
                   "bytes": bsz * (elems * item + extra) / PEAK_BYTES})


def _reduce_case(rng, bsz: int, n: int, dtype):
    """Seeded operands of the fragment sums at (bsz, n): f, P (n, n), the
    moment tables D (3, n, n) and Q (6, n, n), potentials (n, 3) and (n,
    6), an atom index of n // 3 segments in sorted runs (an AO's atom),
    the same index in a random order within each fragment (segments that
    are not runs), a 0/1 mask."""
    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device=DEVICE)

    nat = max(1, n // 3)
    idx = np.sort(rng.integers(0, nat, (bsz, n)), axis=1)
    mixed = np.take_along_axis(
        idx, np.argsort(rng.random((bsz, n)), axis=1), axis=1)
    mask = torch.tensor(rng.random((bsz, n)) < 0.9, dtype=dtype,
                        device=DEVICE)
    return {"f": t((bsz, n, n)), "P": t((bsz, n, n)), "D": t((bsz, 3, n, n)),
            "Q": t((bsz, 6, n, n)), "vD": t((bsz, n, 3)),
            "vQ": t((bsz, n, 6)), "nat": nat, "mask": mask,
            "idx": torch.tensor(idx, dtype=torch.int64, device=DEVICE),
            "mixed": torch.tensor(mixed, dtype=torch.int64, device=DEVICE)}


def reduce_forms(fr, n: int) -> dict:
    """The forms the main path calls each entry of csrc/fragment_reduce.cu
    in, on `_reduce_case`'s operands c: {entry: [(label, kernel, plain,
    torch's, reduce_bound's arguments)]}, each a function of c; the first
    of each entry gives the kernels line."""
    fock = ("f", "vD", "D", "vQ", "Q")

    def rows(m, idx="idx", weights=None):
        def args(c):
            return (c["P"], c[m]) if idx is None else (
                c["P"], c[m], c[idx], c["nat"],
                None if weights is None else c[weights])
        return (lambda c: fr.moment_rows(*args(c)),
                lambda c: fr.moment_rows_reference(*args(c)),
                lambda c: fr._torch_moment_rows(*args(c)))

    def seg(v, idx="idx", weights=None):
        def args(c):
            return (c[v] if v != "vD0" else c["vD"][..., 0], c[idx],
                    c["nat"], None if weights is None else c[weights])
        return (lambda c: fr.segment_sum(*args(c)),
                lambda c: fr.segment_sum_reference(*args(c)),
                lambda c: fr._torch_segment_sum(*args(c)))

    nat = max(1, n // 3)
    return {
        "moment_fock": [
            ("D+Q", lambda c: fr.moment_fock(*(c[k] for k in fock)),
             lambda c: fr.moment_fock_reference(*(c[k] for k in fock)),
             lambda c: fr._torch_moment_fock(*(c[k] for k in fock)),
             {"d": 9}),
            # the dipoles alone
            ("D", lambda c: fr.moment_fock(*(c[k] for k in fock[:3])),
             lambda c: fr.moment_fock_reference(*(c[k] for k in fock[:3])),
             lambda c: fr._torch_moment_fock(*(c[k] for k in fock[:3])),
             {"d": 3}),
            # moment_rows' backward: the contraction alone
            # (`moment_contract`, the Function it calls)
            ("contract d=6", lambda c: fr._Contract.apply(c["vQ"], c["Q"]),
             lambda c: fr.moment_contract_reference(c["vQ"], c["Q"]),
             lambda c: torch.einsum("bkd,bdkl->bkl", c["vQ"], c["Q"]),
             {"d": 6, "sym": False})],
        "moment_rows": [
            ("d=3 atoms", *rows("D"), {"d": 3, "size": nat}),
            ("d=6 atoms", *rows("Q"), {"d": 6, "size": nat}),
            # the backward's rows
            ("d=6 rows", *rows("Q", None), {"d": 6, "size": n,
                                            "index": False}),
            # GFN1's shell populations: one plane, the AO mask
            ("d=1 mask", *rows("f1", "idx", "mask"),
             {"d": 1, "size": nat, "weights": True}),
            ("d=3 unsorted", *rows("D", "mixed"), {"d": 3, "size": nat})],
        "segment_sum": [
            ("c=3", *seg("vD"), {"d": 3, "size": nat}),
            ("c=6", *seg("vQ"), {"d": 6, "size": nat}),
            # the atomic charges: one value an entry, the shell mask
            ("c=1 mask", *seg("vD0", "idx", "mask"),
             {"d": 1, "size": nat, "weights": True}),
            ("c=3 unsorted", *seg("vD", "mixed"), {"d": 3, "size": nat}),
            # take2's backward over an (n, n) table
            ("c=n", *seg("P"), {"d": n, "size": nat})],
        "fragment_sum": [(
            f"{x} dims {dims}",
            lambda c, x=x, dims=dims: fr.fragment_sum(c[x], dims),
            lambda c, x=x, dims=dims: fr.fragment_sum_reference(c[x], dims),
            lambda c, x=x, dims=dims: c[x].sum(dims),
            {"length": length, "rows": rows})
            for x, dims, length, rows in (("P", -1, n, n),
                                          ("P", (1, 2), n * n, 1),
                                          ("Q", (1, 2, 3), 6 * n * n, 1))],
    }


def reduce_long_fragments(fr) -> None:
    """Fragments too long for a block's shared memory, which the kernels
    sum in runs of entries (float64, seeded on the card): moment_rows at
    6000 AOs with d = 6 into an atom index with weights, segment_sum over
    40000 entries with weights; each bit for bit its plain version
    (checked)."""
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    f64 = torch.float64

    def case(n):
        idx = torch.randint(0, n // 3, (1, n), generator=gen, device=DEVICE)
        w = torch.rand((1, n), generator=gen, dtype=f64, device=DEVICE)
        return idx.sort(dim=1).values, (w < 0.9).to(f64)

    n = 6000
    a = torch.randn((1, n, n), generator=gen, dtype=f64, device=DEVICE)
    m = torch.randn((1, 6, n, n), generator=gen, dtype=f64, device=DEVICE)
    idx, w = case(n)
    same = torch.equal(fr.moment_rows(a, m, idx, n // 3, w),
                       fr.moment_rows_reference(a, m, idx, n // 3, w))
    check(same, f"moment_rows (1, {n}) d=6: not bit for bit the plain "
          f"version")
    del a, m
    n = 40000
    v = torch.randn((1, n), generator=gen, dtype=f64, device=DEVICE)
    idx, w = case(n)
    same = torch.equal(fr.segment_sum(v, idx, n // 3, w),
                       fr.segment_sum_reference(v, idx, n // 3, w))
    check(same, f"segment_sum (1, {n}): not bit for bit the plain version")
    print("fragment sums past a block's shared memory: moment_rows (1, "
          "6000) d=6 and segment_sum (1, 40000) bit for bit the plain "
          "versions: True", flush=True)


#: (rows, length) of fragment_sum's own check: rows of up to 4, 8 and 16
#: elements (2 to 8 rows a warp), 32 and one past the warp's longest row
#: (4096, 4097) with rows that fill the card (four rows a lane group),
#: GFN2's (6, n, n) at 96 AOs (55296) and at 241 AOs (348486) with rows
#: that take a cluster of 8, 4, 2 blocks a row or a block
ROW_SUM_CASES = ((5000, 3), (3000, 8), (40000, 11), (40000, 16),
                 (70000, 32), (300, 4096), (37, 4097), (16, 55296),
                 (100, 55296), (300, 55296), (1, 348486), (37, 348486))


def reduce_row_sums_check(fr) -> None:
    """fragment_sum at ROW_SUM_CASES, float64 and float32 (seeded on the
    card): bit for bit `fragment_sum_reference`, a row's bits the same
    alone and in its batch (checked), and a row of -0.0 (exact sum -0.0)
    whose lanes' +0 make it +0.0 in the kernel's order."""
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    for dtype in (torch.float64, torch.float32):
        for rows, length in ROW_SUM_CASES:
            x = torch.randn((rows, length), generator=gen, dtype=dtype,
                            device=DEVICE)
            x[rows // 2] = -0.0
            got = fr.fragment_sum(x)
            what = f"fragment_sum ({rows}, {length}) {dtype}"
            check(torch.equal(got, fr.fragment_sum_reference(x)),
                  f"{what}: not bit for bit the plain version")
            check(got[rows // 2].item() == 0.0
                  and not torch.signbit(got[rows // 2]).item(),
                  f"{what}: a row of -0.0 did not sum to +0.0")
            for sel in ([0], [rows - 1, 0], [rows // 2, min(1, rows - 1)]):
                sel = torch.tensor(sel, device=DEVICE)
                check(torch.equal(fr.fragment_sum(x.index_select(0, sel)),
                                  got.index_select(0, sel)),
                      f"{what}: a row's bits depend on its batch")
    print(f"fragment_sum at (rows, length) = {ROW_SUM_CASES}, f64 and f32: "
          f"bit for bit the plain version, alone and in the batch, a row of "
          f"-0.0 summed to +0.0: True", flush=True)


def reduce_phase(fr):
    """The fragment sums (csrc/fragment_reduce.cu) against their plain
    versions in the kernel's order (`ops/fragment_reduce.py`
    *_reference) at REDUCE_SHAPES in every form of `reduce_forms`, float64
    and float32: max err relative to the largest entry within REDUCE_TOL,
    and the bits the plain version's in every case (checked); a
    fragment's bits alone and in its batch equal; every form's kernel, its
    plain version and the torch expression it replaced (library_ms: the
    einsums, the row sums and scatter_add, sum) timed graph-replayed
    beside the bound; then `reduce_long_fragments`. Returns the kernels
    line's entries, the (512, 16) float64 case of each entry's first
    form."""
    rng = np.random.default_rng(17)
    entries = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for bsz, n in REDUCE_SHAPES:
            c = _reduce_case(rng, bsz, n, dtype)
            c["f1"] = c["f"][:, None]
            for entry, forms in reduce_forms(fr, n).items():
                for label, kernel, plain, library, kw in forms:
                    got, ref, lib = kernel(c), plain(c), library(c)
                    what = f"{entry} {label} {tag} ({bsz}, {n})"
                    check(got.shape == ref.shape == lib.shape,
                          f"{what}: shapes {tuple(got.shape)} "
                          f"{tuple(ref.shape)} {tuple(lib.shape)}")
                    err = max(_rel_err(got, ref), _rel_err(got, lib))
                    check(err <= REDUCE_TOL[dtype],
                          f"{what}: max err {err:.3e} > "
                          f"{REDUCE_TOL[dtype]:.0e}")
                    check(torch.equal(got, ref),
                          f"{what}: not bit for bit the plain version")
                    # a fragment alone, and the batch's last and first:
                    # the same bits
                    for sel in ([0], [bsz - 1, 0]):
                        sel = torch.tensor(sel, device=DEVICE)
                        part = {k: (v.index_select(0, sel)
                                    if torch.is_tensor(v) else v)
                                for k, v in c.items()}
                        part["f1"] = part["f"][:, None]
                        check(torch.equal(kernel(part),
                                          got.index_select(0, sel)),
                              f"{what}: a fragment's bits depend on its "
                              f"batch")
                    ms = min(graph_ms(lambda: kernel(c), 20),
                             graph_ms(lambda: kernel(c), 20))
                    plain_ms = graph_ms(lambda: plain(c), 3)
                    library_ms = graph_ms(lambda: library(c), 20)
                    bound_ms, bound_by = reduce_bound(entry, bsz, n, dtype,
                                                      **kw)
                    print(f"fragment sums {what}: max err={err:.3e} bit "
                          f"for bit the plain version: True; ms={ms:.4f} "
                          f"plain ms={plain_ms:.4f} torch "
                          f"ms={library_ms:.4f} bound ms={bound_ms:.6f} "
                          f"({bound_by}, {100 * bound_ms / ms:.2f}% of it)",
                          flush=True)
                    if entry not in entries:
                        entries[entry] = {
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms,
                            "bitwise_plain": True}
    reduce_long_fragments(fr)
    reduce_row_sums_check(fr)
    return entries


def call_graph_phase():
    """Every route's `energies` and `gradients` as replayed device programs
    (`scc_graph.Call`: the operand build, the loop and the functional):
    a miss and two hits on fresh inputs, each bit for bit `graph=False`'s
    (energies, gradients, every aux field); every stage's run under
    set_sync_debug_mode("error"); a hit's setup against the miss's
    warm-up. Returns the phase's JSON."""
    from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
    from metalquicha_tpu_torch.methods.xtb import engine, scc_graph
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )
    from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import (
        CpcmSolvation,
    )
    from metalquicha_tpu_torch.workloads import bench_dimers

    # route -> (variant, use_pallas_eigh, dtype, solvation, fragments of a
    # seed, gradients)
    dodecamers = lambda seed: water_clusters(  # noqa: E731 (nao 72)
        np.random.default_rng(40 + seed), 16, 12)
    routes = {
        "gfn1_exact": ("gfn1", False, torch.float64, None,
                       lambda seed: bench_dimers(512, seed=seed), True),
        "gfn1_jacobi": ("gfn1", True, torch.float32, None,
                        lambda seed: bench_dimers(512, seed=seed), True),
        "sp2": ("gfn1", True, torch.float32, None, dodecamers, True),
        "gfn1_alpb": ("gfn1", False, torch.float64, "alpb",
                      lambda seed: bench_dimers(512, seed=seed), True),
        "gfn1_cpcm": ("gfn1", False, torch.float64, "cpcm",
                      lambda seed: bench_dimers(64, seed=seed), False),
        "gfn2": ("gfn2", False, torch.float64, None,
                 lambda seed: bench_dimers(512, seed=seed), True),
        # GFN2's loop keeps the exact orthogonalizer on the fast route
        "gfn2_f32": ("gfn2", True, torch.float32, None,
                     lambda seed: bench_dimers(64, seed=seed), True),
    }
    real_stage = scc_graph.Call.stage

    def debug_stage(self, key, inputs, fn):
        def checked(inp):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(inp)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return real_stage(self, key, inputs, checked)

    def call(calc, frag, grad, graph):
        if grad:
            e, g, aux = calc.gradients(frag, graph=graph)
            return dict(aux, energy=e, gradient=g)
        e, aux = calc.energies(frag, graph=graph)
        return dict(aux, energy=e)

    out = {}
    for route, (variant, jacobi, dtype, solv, frags_for, grads) in (
            routes.items()):
        settings = engine.settings_from_params(
            variant, use_pallas_eigh=jacobi,
            scf_tol=1e-9 if dtype == torch.float64 else 2e-5,
            max_scf_iter=64)
        solvation = (BornSolvation(78.4, alpb=True) if solv == "alpb" else
                     CpcmSolvation(78.4) if solv == "cpcm" else None)
        calc = tcalc.XtbCalculator(settings, variant=variant, dtype=dtype,
                                   device=DEVICE, solvation=solvation)
        for grad in (False, True) if grads else (False,):
            kind = "gradients" if grad else "energies"
            rec = {"calls": []}
            for seed in (0, 1, 2):
                frag = calc.make_batch(frags_for(seed))
                e0 = scc_graph.stats["stage_eager"]
                ref = call(calc, frag, grad, False)
                check(scc_graph.stats["stage_eager"] == e0 + 2,
                      f"call graph {route} {kind}: graph=False ran "
                      f"{scc_graph.stats['stage_eager'] - e0} stages")
                c0 = scc_graph.stats["stage_captures"]
                h0 = scc_graph.stats["stage_hits"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = call(calc, frag, grad, True)
                torch.cuda.synchronize()
                host_s = time.perf_counter() - t0
                made = scc_graph.stats["stage_captures"] - c0
                hits = scc_graph.stats["stage_hits"] - h0
                # a gradients call shares the energies call's operand
                # build (run without grad), and captures its functional
                first = (2, 0) if not grad else (1, 1)
                check((made, hits) == (first if seed == 0 else (0, 2)),
                      f"call graph {route} {kind} seed {seed}: {made} "
                      f"captures, {hits} hits")
                same = all(torch.equal(got[k], ref[k]) for k in ref)
                bad = [k for k in ref if not torch.equal(got[k], ref[k])]
                check(same, f"call graph {route} {kind} seed {seed}: "
                      f"{bad} differ from graph=False, energies by "
                      f"{float((got['energy'] - ref['energy']).abs().max()):.3e}")
                check(bool(torch.isfinite(got["energy"]).all()),
                      f"call graph {route} {kind}: non-finite energies")
                rec["calls"].append({
                    "seed": seed, "host_s": host_s, "bitwise": same,
                    "miss_warmup_ms" if seed == 0 else "hit_setup_ms": (
                        scc_graph.stats["stage_warmup_ms"] if seed == 0
                        else scc_graph.stats["stage_hit_setup_ms"])})
            # every stage once more with the card's sync check on: a miss
            # (a new kT) and launch by launch
            scc_graph.Call.stage = debug_stage
            try:
                frag = calc.make_batch(frags_for(3))
                hot = tcalc.XtbCalculator(
                    settings._replace(electronic_temp=310.0),
                    variant=variant, dtype=dtype, device=DEVICE,
                    solvation=solvation)
                call(hot, frag, grad, True)
                call(hot, frag, grad, False)
                torch.cuda.synchronize()
            finally:
                scc_graph.Call.stage = real_stage
            rec["release_ms"] = scc_graph.stats["stage_release_ms"]
            rec["record_ms"] = scc_graph.stats["stage_record_ms"]
            rec["shape"] = list(frag.ao_mask.shape)
            out[f"{route}_{kind}"] = rec
            print(f"call graph {route} {kind}: {rec}", flush=True)
    return out


#: repeats of the deltas beyond GFN1 in one process: each must read 0 and
#: give the same values as the first
C17_REPEATS = 3


def c17_check():
    """ROADMAP C17: the rigid trimer MBE(2) gradient and total, and the
    w20 MBE(2) |g|, max |dg| and total in float64 and in float32 + the f64
    polish, from one batch and from a two-slot cut, equal bit for bit: the
    window solve, every GFN1 product up to 256 AOs and D3's C6 contraction
    (`ops/fragment_gemm.py`) no longer depend on the batch. Beyond GFN1,
    C17_REPEATS times (`beyond_deltas`): the w20 MBE(2) gradient in GFN2
    and in GFN1 with ALPB (|g|, max |dg|, total); as one batch against two
    halves (max |dE|, max |dg|) the call_graph phase's 16 dodecamers (nao
    72, padded to 96) in float64 and in float32 on SP2's route, 8 jittered
    73-atom peptides (228 AOs, padded to 241) and the w20 MBE(2) dimers in
    GFN2 through the refine route (190 against two of 95); the w20 MBE(2)
    energies with CPCM against the two-slot cut: every delta exactly 0
    with the products on `ops/fragment_gemm.py` and the sums on
    `ops/fragment_reduce.py`, and each repeat's values (totals, |g|, sums)
    the first's bit for bit."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from c17_probe_torch import beyond_deltas, cut_deltas

    deltas = cut_deltas(torch.device(DEVICE))
    print(f"c17 cut deltas: {deltas}", flush=True)
    check(all(v == 0.0 for v in deltas.values()),
          f"C17: a fragment's gradient depends on the cut: {deltas}")
    repeats = []
    for rep in range(C17_REPEATS):
        got = beyond_deltas(torch.device(DEVICE), values=True)
        print(f"c17 beyond GFN1, repeat {rep}: {got}", flush=True)
        moved = {k: v for k, v in got.items()
                 if ("_d_" in k or "_max_d" in k) and v != 0.0}
        check(not moved, f"C17: beyond GFN1 a result depends on the cut "
              f"(repeat {rep}): {moved}")
        if repeats:
            differ = {k: (repeats[0][k], v) for k, v in got.items()
                      if v != repeats[0][k]}
            check(not differ, f"C17: repeat {rep} of one process differs "
                  f"from the first: {differ}")
        repeats.append(got)
    return dict(deltas, beyond=repeats[0], repeats=len(repeats))


def slice_phase(jac, golden):
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.workloads import bench_dimers

    frags = bench_dimers(512)
    kern = settings_from_params("gfn1", use_pallas_eigh=True)
    calc = XtbCalculator(kern, dtype=torch.float64, device=DEVICE)
    frag = calc.make_batch(frags)
    n0 = jac.launches
    calc.gradients(frag)  # warm-up: library handles, allocator
    (e_k, aux_k), t_e = wall(lambda: calc.energies(frag), 3)
    (e_g, g_k, aux_g), t_g = wall(lambda: calc.gradients(frag), 3)
    launches64 = jac.launches - n0

    # in float64 the flag takes the exact route, as the JAX package's
    exact = XtbCalculator(kern._replace(use_pallas_eigh=False),
                          dtype=torch.float64, device=DEVICE)
    e_x, g_x, _ = exact.gradients(frag)
    d_e = float((e_k - e_x).abs().max())
    d_g = float((g_k - g_x).abs().max())
    resid = float(max(aux_k["scf_residual"].max(), aux_g["scf_residual"].max()))
    gd = golden["bench_dimers"]
    n = gd["n"]
    d_e_gold = float(np.abs(e_g[:n].cpu().numpy() - gd["energies"]).max())
    d_g_gold = float(np.abs(g_k[:n].cpu().numpy() - gd["gradients"]).max())
    print(f"slice f64 B=512: energies/s={512 / t_e:.1f} "
          f"gradients/s={512 / t_g:.1f} (energies {t_e:.4f} s, gradients "
          f"{t_g:.4f} s per call) resid={resid:.2e} flag-vs-exact dE="
          f"{d_e:.2e} dG={d_g:.2e} golden dE={d_e_gold:.2e} "
          f"dG={d_g_gold:.2e} jacobi launches={launches64}", flush=True)
    # the same route: its energies and gradients differ only where the
    # card's scatter sums (atomics) round in another order
    check(d_e <= 1e-10, f"flag vs exact energies {d_e:.3e} > 1e-10")
    check(d_g <= 1e-9, f"flag vs exact gradients {d_g:.3e} > 1e-9")
    check(launches64 == 0, "a float64 SCC launched the Jacobi kernel")
    check(resid < 1e-5, f"SCC residual {resid:.3e} >= 1e-5")
    check(d_e_gold <= 1e-9, f"energies vs golden {d_e_gold:.3e} > 1e-9")
    check(d_g_gold <= 1e-8, f"gradients vs golden {d_g_gold:.3e} > 1e-8")
    check(bool(torch.isfinite(e_k).all() and torch.isfinite(g_k).all()),
          "non-finite energies or gradients")

    # the Jacobi route: float32
    calc32 = XtbCalculator(kern, dtype=torch.float32, device=DEVICE)
    exact32 = XtbCalculator(kern._replace(use_pallas_eigh=False),
                            dtype=torch.float32, device=DEVICE)
    frag32 = calc32.make_batch(frags)
    calc32.energies(frag32)  # warm-up
    n0 = jac.launches
    (e32, aux32), t32 = wall(lambda: calc32.energies(frag32), 3)
    launches = jac.launches - n0
    resid32 = float(aux32["scf_residual"].max())
    e32_x, _ = exact32.energies(frag32)
    print(f"slice f32 B=512 on the Jacobi route: energies/s={512 / t32:.1f} "
          f"resid={resid32:.2e} "
          f"max|E32-E64|={float((e32.double() - e_k).abs().max()):.2e} "
          f"vs f32 exact route {float((e32 - e32_x).abs().max()):.2e} "
          f"jacobi launches={launches}", flush=True)
    check(resid32 < 1e-4, f"f32 SCC residual {resid32:.3e} >= 1e-4")
    check(launches > 0, "slice phase launched no Jacobi kernel in float32")
    check(bool(torch.isfinite(e32).all()), "non-finite f32 energies")
    return launches


def executor_phase(jac, golden):
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.workloads import (
        w20_mbe2_assemble,
        w20_mbe2_fragments,
    )

    settings = settings_from_params("gfn1", max_scf_iter=32,
                                    use_pallas_eigh=True)
    gold = golden["w20_mbe2"]
    launches = 0
    for dtype in (torch.float64, torch.float32):
        ex = FragmentExecutor(
            XtbCalculator(settings, dtype=dtype, device=DEVICE)
        )
        n0 = jac.launches
        (e, g, aux), t = wall(
            lambda: ex.run(w20_mbe2_fragments(), what="gradient")
        )
        n_l = jac.launches - n0
        total, gnorm = w20_mbe2_assemble(e, g)
        d_t = abs(total - gold["total"])
        d_n = abs(gnorm - gold["gradient_norm"])
        print(f"executor w20 MBE(2) gradient {str(dtype)[6:]}: wall={t:.3f} s"
              f" total={total:.10f} d_total={d_t:.2e} d|g|={d_n:.2e} "
              f"resid={aux['scf_residual'].max():.2e} jacobi launches={n_l}",
              flush=True)
        if dtype == torch.float64:
            # the exact route, as the JAX package's in float64
            check(d_t <= 1e-8, f"w20 MBE(2) total off the golden by "
                               f"{d_t:.3e}")
            check(n_l == 0, "a float64 SCC launched the Jacobi kernel")
        else:
            # raw float32 on the Jacobi route: its distance is printed
            check(np.isfinite(total) and n_l > 0,
                  "executor phase launched no Jacobi kernel in float32")
        launches += n_l
    # d|g| is printed, not held: the w20 waters are exact translates, so
    # far dimers have S eigenvalue gaps below eigh_safe's sqrt(eps) cut,
    # where the reference gradient depends on the eigenvector gauge at
    # the 1e-7 level (swapping the monomers of one dimer moves it 4e-7)
    return launches


def driver_phase(jac, golden):
    from metalquicha_tpu_torch.driver import (
        make_executor,
        read_mqc_file,
        run_calculation,
    )
    from metalquicha_tpu_torch.parallel.executor import logger

    logger.set_level("warning")  # no per-fragment XYZ dumps
    launches = 0
    for name, gold in golden["driver"].items():
        path = os.path.join(ROOT, gold["mqc"])
        cfg = read_mqc_file(path)
        # float64 with use_pallas_eigh: the exact route, as the JAX
        # package's; the Jacobi route in float32 + f64 polish (prism)
        legs = [("f64", None)] + ([("f32 + polish", {"force_dtype": "f32"})]
                                  if name == "prism_mbe" else [])
        for leg, overrides in legs:
            ex = make_executor(cfg, DEVICE, overrides)
            ex.calc.settings = ex.calc.settings._replace(use_pallas_eigh=True)
            n0 = jac.launches
            out, t = wall(lambda: run_calculation(
                cfg, write_json=False, executor=ex,
                driver_overrides=overrides))
            n_l = jac.launches - n0
            if overrides is None:
                WALLS[f"driver {name}"] = t
            total = float(out[""].result.total_energy)
            d = abs(total - gold["total_energy"])
            print(f"driver {name} {leg}: wall={t:.3f} s total={total:.10f} "
                  f"d_golden={d:.2e} jacobi launches={n_l}", flush=True)
            check(d <= 1e-7, f"{name} ({leg}) total off the golden by "
                             f"{d:.3e}")
            check((n_l > 0) == (overrides is not None),
                  f"driver {name} ({leg}): {n_l} Jacobi launches")
            launches += n_l

    # the factory path (exact in-loop eigh) through the command line
    gold = golden["driver"]["prism_mbe"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "metalquicha_tpu_torch",
             os.path.join(ROOT, gold["mqc"])],
            cwd=tmp, env=env, capture_output=True, text=True, check=False,
        )
        t_cli = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"python -m metalquicha_tpu_torch failed:\n{proc.stderr[-4000:]}")
    line = [s for s in proc.stdout.splitlines() if "total_energy" in s][-1]
    total = float(line.split("=")[1].split()[0])
    d = abs(total - gold["total_energy"])
    print(f"cli prism_mbe: wall={t_cli:.3f} s (process included) "
          f"total={total:.10f} d_golden={d:.2e}", flush=True)
    check(d <= 1e-7, f"cli prism total off the golden by {d:.3e}")
    return launches


def memory_phase(jac, golden):
    """The executor's byte guard: the byte model against the measured
    peak at the calibrated shapes, the 73-atom FD Hessian and the w20
    MBE(4) gradient through run_calculation."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import memory_probe_torch as probe

    from metalquicha_tpu_torch.methods.xtb import scc_graph

    def cache():
        return (f"SCC graph cache {scc_graph.stats['held_bytes'] / 2**30:.3f}"
                f" GiB ({len(scc_graph._entries)} entries, pools' unused "
                f"{scc_graph.idle_pool_bytes(device) / 2**30:.3f} GiB, this "
                f"thread's counted in the budget; pools given back: "
                f"{scc_graph.stats['pool_releases']}; stages captured "
                f"{scc_graph.stats['stage_captures']}, hits "
                f"{scc_graph.stats['stage_hits']} so far)")

    device = torch.device(DEVICE)
    with open(GOLDEN_MEMORY) as fh:
        gold = json.load(fh)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    n0 = jac.launches
    for row in probe.calibrate(device):
        check(1.0 <= row["ratio"] <= 2.0,
              f"byte model of {row['shape']} {row['what']} is "
              f"{row['ratio']}x the measured peak")
    # the calibration's Jacobi-route shapes run in float32
    launches = jac.launches - n0
    print(f"memory calibration: {launches} Jacobi launches", flush=True)
    check(launches > 0, "the memory calibration launched no Jacobi kernel")

    runs = {}

    def capture(jobs, out):
        runs[len(jobs)] = out

    gh = gold["hessian"]
    rec = probe.workflow("hessian", device, capture)
    print(f"memory hessian: ok={rec['ok']} wall={rec['wall_s']:.3f} s "
          f"peak={rec['peak_gib']} GiB budget={rec['budget_gib']} GiB "
          f"chunks={rec['chunks']} sizes={rec['chunk_sizes']}; {cache()}",
          flush=True)
    check(rec["ok"], f"the 73-atom Hessian failed: {rec.get('error')}")
    check(rec["peak_gib"] < rec["budget_gib"],
          "the Hessian's peak is above the executor's budget")
    # no more chunks than before the graph cache held bytes back
    check(rec["chunks"] <= 12, f"the Hessian ran in {rec['chunks']} chunks")
    _e, grads, _aux = runs[gh["n_jobs"]]
    g = np.stack([np.asarray(grads[i]) for i in gh["jobs"]]).reshape(
        len(gh["jobs"]), -1)
    rows = (g[0::2] - g[1::2]) / (2.0 * gh["displacement"])
    d_rows = float(np.abs(rows - np.asarray(gh["rows"])).max())
    hess = np.asarray(rec["output"].result.hessian)
    d_sym = float(np.abs(hess - hess.T).max())
    drift = float(np.abs(hess.reshape(len(hess), -1, 3).sum(1)).max())
    print(f"memory hessian: rows of atoms {gh['atoms']} d_golden="
          f"{d_rows:.2e} asymmetry={d_sym:.2e} translation={drift:.2e}",
          flush=True)
    check(d_rows <= 1e-6, f"Hessian rows off the golden by {d_rows:.3e}")
    check(d_sym <= 1e-6, f"Hessian asymmetric by {d_sym:.3e}")
    check(drift <= 1e-5, f"Hessian rows sum to {drift:.3e} over atoms")

    runs.clear()
    gw = gold["w20_mbe4_gradient"]
    rec = probe.workflow("w20_grad", device, capture)
    print(f"memory w20 MBE(4) gradient: ok={rec['ok']} wall="
          f"{rec['wall_s']:.3f} s peak={rec['peak_gib']} GiB budget="
          f"{rec['budget_gib']} GiB chunks={rec['chunks']} "
          f"sizes={rec['chunk_sizes']} launches={rec['jacobi_launches']}; "
          f"{cache()}", flush=True)
    check(rec["ok"], f"the w20 MBE(4) gradient failed: {rec.get('error')}")
    check(rec["peak_gib"] < rec["budget_gib"],
          "the w20 MBE(4) gradient's peak is above the executor's budget")
    check(rec["chunks"] <= 5,
          f"the w20 MBE(4) gradient ran in {rec['chunks']} chunks")
    e, grads, _aux = runs[gw["n_jobs"]]
    d_e = max(abs(e[i] - x) for i, x in zip(gw["jobs"], gw["energies"]))
    d_g = max(float(np.abs(np.asarray(grads[i]) - np.asarray(x)).max())
              for i, x in zip(gw["jobs"], gw["gradients"]))
    d_t = abs(rec["total_energy"] - golden["driver"]["w20_mbe"]
              ["total_energy"])
    net = float(np.abs(rec["output"].result.gradient.sum(0)).max())
    print(f"memory w20 MBE(4) gradient: {len(gw['jobs'])} tetramers "
          f"d_energy={d_e:.2e} d_gradient={d_g:.2e} d_total={d_t:.2e} "
          f"net force={net:.2e}", flush=True)
    check(d_e <= 1e-8, f"tetramer energies off the golden by {d_e:.3e}")
    check(d_g <= 1e-8, f"tetramer gradients off the golden by {d_g:.3e}")
    check(d_t <= 1e-8, f"w20 MBE(4) total off the golden by {d_t:.3e}")
    check(net <= 1e-7, f"w20 MBE(4) net force {net:.3e}")
    return launches + rec["jacobi_launches"]


def solvation_phase(jac, golden_full):
    """The solvated w20 MBE(2) list: ALPB gradients and CPCM energies
    with use_pallas_eigh in float64 (the exact route, as the JAX
    package's) against the JAX package's goldens; ALPB energies on the
    Jacobi route in float32."""
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation
    from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import CpcmSolvation
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.workloads import (
        w20_mbe2_assemble,
        w20_mbe2_fragments,
    )

    gold = golden_full["w20_mbe2_solvated"]
    eps = gold["dielectric"]
    settings = settings_from_params(
        "gfn1", max_scf_iter=gold["max_scf_iter"], use_pallas_eigh=True)
    frags = w20_mbe2_fragments()
    launches = 0
    for name, model, what, dtype in (
        ("alpb", BornSolvation(eps, alpb=True), "gradient", torch.float64),
        ("cpcm", CpcmSolvation(eps, nang=gold["cpcm"]["nang"]), "energy",
         torch.float64),
        ("alpb", BornSolvation(eps, alpb=True), "energy", torch.float32),
    ):
        ex = FragmentExecutor(XtbCalculator(
            settings, dtype=dtype, device=DEVICE, solvation=model))
        n0 = jac.launches
        torch.cuda.reset_peak_memory_stats()
        out, t = wall(lambda: ex.run(frags, what=what))
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_l = jac.launches - n0
        e, aux = out[0], out[-1]
        g = out[1] if what == "gradient" else [
            np.zeros((len(f[0]), 3)) for f in frags]
        total, gnorm = w20_mbe2_assemble(e, g)
        d_t = abs(total - gold[name]["total"])
        d_e = float(np.abs(e - np.asarray(gold[name]["energies"])).max())
        line = (f"solvation w20 MBE(2) {name} {what} {str(dtype)[6:]}: "
                f"wall={t:.3f} s peak={peak:.2f} GiB total={total:.10f} "
                f"d_total={d_t:.2e} max d_fragment={d_e:.2e} "
                f"resid={aux['scf_residual'].max():.2e} jacobi launches={n_l}")
        if dtype == torch.float32:
            # raw float32 on the Jacobi route: its distance is printed
            print(line, flush=True)
            check(np.isfinite(total) and n_l > 0,
                  f"solvation {name} launched no Jacobi kernel in float32")
            launches += n_l
            continue
        check(d_t <= 1e-8, f"{name} w20 MBE(2) total off the golden by "
                           f"{d_t:.3e}")
        if what == "gradient":
            d_n = abs(gnorm - gold[name]["gradient_norm"])
            line += f" d|g|={d_n:.2e}"
            check(d_n <= 1e-6, f"{name} w20 MBE(2) |g| off the golden by "
                               f"{d_n:.3e}")
        print(line, flush=True)
        check(n_l == 0, f"solvation {name}: a float64 SCC launched the "
                        f"Jacobi kernel")
    return launches


def validation_phase(jac, golden_full):
    """Every GFN1 validation case through `run_calculation` with the factory's
    settings; two of them again on the fast route; one through prep and
    the command line."""
    from metalquicha_tpu_torch.driver import (
        make_executor,
        read_mqc_file,
        run_calculation,
    )
    from metalquicha_tpu_torch.ops import sp2
    from metalquicha_tpu_torch.validation import (
        checks,
        golden_failures,
        observables,
    )

    def report(tag, name, gold, outputs, t, extra=""):
        obs = observables(outputs)
        deltas = " ".join(f"d_{label}={abs(got - exp):.2e}"
                          for label, got, exp in checks(obs, gold))
        print(f"validation {tag} {name}: wall={t:.3f} s max_nao="
              f"{gold['max_nao']} {deltas}{extra}", flush=True)
        bad = golden_failures(obs, gold)
        check(not bad, f"{name} ({tag}) off the JAX package's result: {bad}")

    for name, gold in golden_full["driver"].items():
        cfg = read_mqc_file(os.path.join(ROOT, gold["mqc"]))
        outputs, t = wall(lambda: run_calculation(cfg, write_json=False,
                                                  device=DEVICE))
        report("factory", name, gold, outputs, t)

    # use_pallas_eigh: in float64 the exact route, as the JAX package's
    # (neither SP2 nor the Jacobi kernel); in float32 + f64 polish the fast
    # route, SP2 at 241 AOs and the Jacobi kernel at 64
    launches = 0
    for name, counter in (("unfrag_gly3", "sp2"), ("gly10_mbe", "jacobi")):
        gold = golden_full["driver"][name]
        cfg = read_mqc_file(os.path.join(ROOT, gold["mqc"]))
        for tag, overrides in (("f64 flag", None),
                               ("f32 + polish fast",
                                {"force_dtype": "f32"})):
            ex = make_executor(cfg, DEVICE, overrides)
            ex.calc.settings = ex.calc.settings._replace(use_pallas_eigh=True)
            n_j, n_s = jac.launches, sp2.calls
            outputs, t = wall(lambda: run_calculation(
                cfg, write_json=False, executor=ex,
                driver_overrides=overrides))
            n_j, n_s = jac.launches - n_j, sp2.calls - n_s
            report(tag, name, gold, outputs, t,
                   f" jacobi_launches={n_j} sp2_calls={n_s}")
            if overrides is None:
                check(n_j == 0 and n_s == 0,
                      f"{name} in float64 took the fast route")
                continue
            check((n_s if counter == "sp2" else n_j) > 0,
                  f"{name} on the float32 fast route did not go through "
                  f"{counter}")
            if counter == "sp2":
                check(n_j == 0, f"{name} launched the Jacobi kernel at "
                                f"{gold['max_nao']} AOs")
            launches += n_j

    # a solvated case from its JSON: prep, then the command line
    gold = golden_full["driver"]["alpb_water"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    inputs = os.path.join(ROOT, "validation", "inputs")
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(inputs, "w1_water.json"), tmp)
        shutil.copytree(os.path.join(inputs, "sample_inputs"),
                        os.path.join(tmp, "sample_inputs"))
        t0 = time.perf_counter()
        for cmd in (["metalquicha_tpu_torch.io.prep", "w1_water.json"],
                    ["metalquicha_tpu_torch", "w1_water.mqc"]):
            proc = subprocess.run([sys.executable, "-m", *cmd], cwd=tmp,
                                  env=env, capture_output=True, text=True,
                                  check=False)
            check(proc.returncode == 0,
                  f"python -m {' '.join(cmd)} failed:\n{proc.stderr[-4000:]}")
        t_cli = time.perf_counter() - t0
    line = [s for s in proc.stdout.splitlines() if "total_energy" in s][-1]
    total = float(line.split("=")[1].split()[0])
    d = abs(total - gold["total_energy"])
    print(f"validation prep+cli alpb_water: wall={t_cli:.3f} s (two "
          f"processes) total={total:.10f} d_golden={d:.2e}", flush=True)
    check(d <= 1e-7, f"prep+cli alpb_water total off the golden by {d:.3e}")
    return launches


def scc_iteration_ms():
    """Device ms and device kernels of one SCC iteration at (512, 16) on
    GFN1's exact route (float64) and Jacobi route (float32) and GFN2's
    multipole route, and the Fermi launches per iteration
    (`tools/scc_probe_torch.py`)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import scc_probe_torch

    return scc_probe_torch.iteration_costs(DEVICE)


def gfn2_phase(jac, golden):
    """GFN2 against the JAX package's frozen float64 results, on the card.
    It launches no Jacobi kernel and makes no SP2 call, but the Fermi
    kernel in every filling."""
    from metalquicha_tpu_torch.driver import read_mqc_file, run_calculation
    from metalquicha_tpu_torch.errors import ConvergenceError
    from metalquicha_tpu_torch.constants import BOHR_TO_ANGSTROM
    from metalquicha_tpu_torch.methods.xtb.calculator import (
        XtbCalculator,
        single_point_energy,
    )
    from metalquicha_tpu_torch.methods.xtb import scc_graph
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation
    from metalquicha_tpu_torch.ops import sp2
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.validation import (
        checks,
        golden_failures,
        observables,
    )
    from metalquicha_tpu_torch.workloads import (
        bench_dimers,
        w20_mbe2_assemble,
        w20_mbe2_fragments,
    )

    from metalquicha_tpu_torch.ops import fermi_fill as ff

    n_j, n_s, n_f = jac.launches, sp2.calls, ff.launches
    gd = golden["bench_dimers"]
    settings = settings_from_params("gfn2", max_scf_iter=gd["max_scf_iter"])
    calc = XtbCalculator(settings, variant="gfn2", dtype=torch.float64,
                         device=DEVICE)
    frag = calc.make_batch(bench_dimers(512))
    calc.gradients(frag)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (e, aux), t_e = wall(lambda: calc.energies(frag), 3)
    (e_g, g, aux_g), t_g = wall(lambda: calc.gradients(frag), 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = gd["n"]
    d_e = float(np.abs(e[:n].cpu().numpy() - gd["energies"]).max())
    d_g = float(np.abs(g[:n].cpu().numpy() - gd["gradients"]).max())
    d_mu = float(np.abs(aux_g["dipole"][:n].cpu().numpy()
                        - gd["dipole"]).max())
    resid = float(max(aux["scf_residual"].max(), aux_g["scf_residual"].max()))
    print(f"gfn2 slice f64 B=512: energies/s={512 / t_e:.1f} "
          f"gradients/s={512 / t_g:.1f} (energies {t_e:.4f} s, gradients "
          f"{t_g:.4f} s per call) peak={peak:.2f} GiB resid={resid:.2e} "
          f"golden dE={d_e:.2e} dG={d_g:.2e} d_dipole={d_mu:.2e}", flush=True)
    check(d_e <= 1e-9, f"gfn2 energies vs golden {d_e:.3e} > 1e-9")
    check(d_g <= 1e-8, f"gfn2 gradients vs golden {d_g:.3e} > 1e-8")
    check(d_mu <= 1e-8, f"gfn2 dipoles vs golden {d_mu:.3e} > 1e-8")
    check(float((e - e_g).abs().max()) <= 1e-12,
          "gfn2 energies differ between the energy and the gradient call")
    check(resid < 1e-5, f"gfn2 SCC residual {resid:.3e} >= 1e-5")
    check(bool(torch.isfinite(e).all() and torch.isfinite(g).all()),
          "gfn2: non-finite energies or gradients")

    frags = w20_mbe2_fragments()
    for name, what, solvation in (
        ("w20_mbe2", "gradient", None),
        ("w20_mbe2_alpb", "energy",
         BornSolvation(golden["w20_mbe2_alpb"]["dielectric"], alpb=True)),
    ):
        gold = golden[name]
        ex = FragmentExecutor(XtbCalculator(
            settings_from_params("gfn2", max_scf_iter=gold["max_scf_iter"]),
            variant="gfn2", dtype=torch.float64, device=DEVICE,
            solvation=solvation))
        torch.cuda.reset_peak_memory_stats()
        out, t = wall(lambda: ex.run(frags, what=what))
        peak = torch.cuda.max_memory_allocated() / 2**30
        grads = out[1] if what == "gradient" else [
            np.zeros((len(f[0]), 3)) for f in frags]
        total, gnorm = w20_mbe2_assemble(out[0], grads)
        d_t = abs(total - gold["total"])
        d_f = float(np.abs(out[0] - np.asarray(gold["energies"])).max())
        line = (f"gfn2 executor {name} {what}: wall={t:.3f} s "
                f"peak={peak:.2f} GiB total={total:.10f} d_total={d_t:.2e} "
                f"max d_fragment={d_f:.2e} "
                f"resid={out[-1]['scf_residual'].max():.2e}")
        if what == "gradient":
            # printed, not held: the w20 waters are exact translates (see
            # executor_phase)
            line += f" d|g|={abs(gnorm - gold['gradient_norm']):.2e}"
        print(line, flush=True)
        check(d_t <= 1e-8, f"gfn2 {name} total off the golden by {d_t:.3e}")

    # the JAX package's own GFN2 pins (tests/data/gfn2_fixtures.json) at
    # the tolerances of tests/test_gfn2_fixtures.py, from a cold start and
    # warm-started from the JAX package's converged state. CH4's cold
    # start is printed, not held: its SCC map has a second fixed point and
    # its cold-start trajectory is chaotic, so rounding decides
    with open(GFN2_FIXTURES) as fh:
        fixtures = json.load(fh)
    pins = settings_from_params("gfn2", max_scf_iter=256, scf_tol=1e-11)
    pin_calc = XtbCalculator(pins, variant="gfn2", dtype=torch.float64,
                             device=DEVICE)
    for name, state in golden["fixture_states"].items():
        case = fixtures[name]
        z = np.array(case["numbers"])
        c = np.array(case["coords_angstrom"]) / BOHR_TO_ANGSTROM
        pin = pin_calc.make_batch([(z, c, 0, 1)])
        q_init = torch.tensor([state], dtype=torch.float64, device=DEVICE)
        for start, q0 in (("cold", None), ("warm", q_init)):
            with torch.no_grad():
                e_p, aux_p = single_point_energy(pin.coords, pin, pins, None,
                                                 q_init=q0)
            d_e = abs(float(e_p[0]) - case["energy_ha"])
            d_q = float(np.abs(aux_p["charges"][0][: len(z)].cpu().numpy()
                               - case["charges"]).max())
            d_mu = float(np.abs(aux_p["dipole"][0].cpu().numpy()
                                - case["dipole_au"]).max())
            r_p = float(aux_p["scf_residual"][0])
            held = not (name == "ch4" and start == "cold")
            print(f"gfn2 fixture {name} {start} start: dE={d_e:.2e} "
                  f"d_charges={d_q:.2e} d_dipole={d_mu:.2e} resid={r_p:.2e}"
                  f"{'' if held else ' (printed, not held)'}", flush=True)
            check(r_p < 1e-9, f"gfn2 fixture {name} residual {r_p:.3e}")
            if held:
                check(d_e <= 1e-9 and d_q <= 1e-8 and d_mu <= 1e-8,
                      f"gfn2 fixture {name} ({start} start) off: dE={d_e:.3e} "
                      f"d_charges={d_q:.3e} d_dipole={d_mu:.3e}")

    # the executor's chunk cap counts the moment integrals' tables: the
    # largest dimer chunk it would dispatch, with gradients, must fit
    ex = FragmentExecutor(calc)
    pad_to = ex._pad_shapes_for(6, [(0, bench_dimers(1)[0])])
    max_b = ex._max_chunk(pad_to, frag.prim_alpha.shape[-1])
    torch.cuda.reset_peak_memory_stats()
    out, t = wall(lambda: ex.run(bench_dimers(max_b), what="gradient"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    card = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"gfn2 executor chunk at the cap: {max_b} dimers padded to "
          f"{pad_to} in one chunk, gradients: wall={t:.3f} s "
          f"peak={peak:.2f} GiB of {card:.1f} GiB "
          f"resid={out[-1]['scf_residual'].max():.2e}", flush=True)
    check(peak <= 0.8 * card, f"a GFN2 chunk at the cap peaks at {peak:.1f} "
                              f"GiB of {card:.1f}")

    for name, gold in golden["driver"].items():
        cfg = read_mqc_file(os.path.join(ROOT, gold["mqc"]))
        torch.cuda.reset_peak_memory_stats()
        outputs, t = wall(lambda: run_calculation(cfg, write_json=False,
                                                  device=DEVICE))
        peak = torch.cuda.max_memory_allocated() / 2**30
        obs = observables(outputs)
        deltas = " ".join(f"d_{label}={abs(got - exp):.2e}"
                          for label, got, exp in checks(obs, gold))
        print(f"gfn2 driver {name}: wall={t:.3f} s peak={peak:.2f} GiB "
              f"{deltas}", flush=True)
        bad = golden_failures(obs, gold)
        check(not bad, f"gfn2 {name} off the JAX package's result: {bad}")

    # w20 MBE(4), 6195 fragments, for its wall time and peak memory. No
    # total is frozen: the JAX package's driver raises ConvergenceError
    # here (one tetramer's multipole SCC stalls far from convergence), after
    # every fragment has been evaluated. Where the SCC does not converge
    # rounding decides the trajectory, so either outcome is reported; a
    # total must be finite
    cfg = read_mqc_file(GFN2_MBE4)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        total = float(run_calculation(cfg, write_json=False, device=DEVICE)
                      [""].result.total_energy)
        check(np.isfinite(total), "gfn2 w20 MBE(4) total is not finite")
        outcome = (f"total={total:.10f} (the JAX package raises "
                   f"ConvergenceError)")
    except ConvergenceError as exc:
        outcome = f"ConvergenceError as in the JAX package: {exc}"
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"gfn2 driver w20_mbe4 (6195 fragments): wall={t:.3f} s "
          f"peak={peak:.2f} GiB {outcome}", flush=True)

    n_j2, n_s2 = jac.launches, sp2.calls
    # the probe's own launch-by-launch solves are its comparison, not the
    # main path's
    eager = scc_graph.stats["eager"]
    costs = scc_iteration_ms()
    scc_graph.stats["eager"] = eager
    for route, it in costs.items():
        per = it["kernels_per_iteration"]
        busy = it["busy_ms_per_iteration"]
        host = {k: round(v, 4) for k, v in it["host_ms_per_iteration"].items()}
        print(f"scc iteration at (512, 16), {route}: device ms="
              f"{it['ms_per_iteration']:.4f} device kernels="
              f"{'not measured' if per is None else f'{per:.2f}'} busy ms="
              f"{'not measured' if busy is None else f'{busy:.4f}'} "
              f"fermi launches={it['fermi_per_iteration']} (fused fill and "
              f"density {it['density_per_iteration']}) host ms {host} "
              f"top kernels {it['top_kernels']}", flush=True)
        gr = it.get("graph") or {}
        print(f"scc iteration at (512, 16), {route}, replayed graph: "
              f"stream ms={gr.get('ms_per_iteration')} device kernels="
              f"{gr.get('kernels_per_iteration')} busy ms="
              f"{gr.get('busy_ms_per_iteration')} host ms="
              f"{gr.get('host_ms_per_iteration')} capture ms "
              f"{gr.get('capture_ms')}", flush=True)
        check(it["fermi_per_iteration"] == 1.0,
              f"{route}: {it['fermi_per_iteration']} Fermi launches per SCC "
              f"iteration, not 1")
        check(it["density_per_iteration"] == 1.0,
              f"{route}: the SCC at nao 16 fused {it['density_per_iteration']}"
              f" densities per iteration, not 1")
    # the GFN1 routes' own launches are not the GFN2 path's
    n_j += jac.launches - n_j2
    n_s += sp2.calls - n_s2
    check(jac.launches == n_j and sp2.calls == n_s,
          "the GFN2 path launched the Jacobi kernel or called SP2")
    check(ff.launches > n_f, "the GFN2 path launched no Fermi kernel")
    return 0


def polish_phase(jac, goldens):
    """f32 + f64 polish against the all-f64 path, on the card."""
    from metalquicha_tpu_torch.driver import read_mqc_file, run_calculation
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.methods.xtb.polish import HostPolisher
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.validation import (
        checks,
        golden_failures,
        observables,
    )
    from metalquicha_tpu_torch.workloads import (
        bench_dimers,
        trimer_mbe2_assemble,
        trimer_mbe2_fragments,
        w20_mbe2_assemble,
        w20_mbe2_fragments,
        water_fragments,
    )

    golden, golden_gfn2 = goldens
    base = settings_from_params("gfn1", max_scf_iter=32)

    def executor(dtype, fast=False, polish=False, rescue_tol=None):
        calc = XtbCalculator(base._replace(use_pallas_eigh=fast), dtype=dtype,
                             device=DEVICE)
        return FragmentExecutor(calc, rescue_tol=rescue_tol,
                                polisher=HostPolisher(calc) if polish else None)

    frags = w20_mbe2_fragments()
    n0 = jac.launches
    ref = None
    for name, ex in (
        ("(a) f64", executor(torch.float64)),
        ("(b) f32 raw", executor(torch.float32)),
        ("(c) f32 + polish, exact in-loop solve",
         executor(torch.float32, polish=True)),
        ("(d) f32 on the Jacobi route + polish",
         executor(torch.float32, fast=True, polish=True)),
    ):
        ex.run(frags, what="gradient")  # warm-up
        n_l = jac.launches
        torch.cuda.reset_peak_memory_stats()
        (e, g, aux), t = wall(lambda: ex.run(frags, what="gradient"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_l = jac.launches - n_l
        total, gnorm = w20_mbe2_assemble(e, g)
        if ref is None:
            ref = (total, gnorm)
            d_gold = abs(total - golden["w20_mbe2"]["total"])
            check(d_gold <= 1e-8, f"f64 w20 MBE(2) total off the golden by "
                                  f"{d_gold:.3e}")
        d_t, d_n = abs(total - ref[0]), abs(gnorm - ref[1])
        print(f"polish w20 MBE(2) gradient {name}: wall={t:.3f} s "
              f"peak={peak:.2f} GiB total={total:.10f} d_total={d_t:.2e} "
              f"d|g|={d_n:.2e} resid={aux['scf_residual'].max():.2e} "
              f"jacobi_launches={n_l}", flush=True)
        if "polish" in name:
            # |g| to 1e-6 only: the w20 waters are exact translates (see
            # executor_phase), and the polished gradient also runs through
            # the recorded refine steps, where gaps of S just above
            # eigh_safe's cut amplify the last bits of the state by up to
            # 1/sqrt(eps); the trimer and the dimer slice below hold the
            # gradient to 1e-9 and 1e-8
            check(d_t <= 1e-9, f"{name}: total off f64 by {d_t:.3e}")
            check(d_n <= 1e-6, f"{name}: |g| off f64 by {d_n:.3e}")
        if name.startswith("(d)"):
            check(n_l > 0, "the f32 Jacobi leg launched no kernel")

    # the multi-device dry run's oracle: the water-trimer MBE(2) set, f32 +
    # polish within 1e-9 of f64 in total and gradient norm
    trimer = trimer_mbe2_fragments()
    e_x, g_x, _ = executor(torch.float64).run(trimer, what="gradient")
    total_x, gs_x = trimer_mbe2_assemble(e_x, g_x)
    for name, fast in (("exact in-loop solve", False), ("Jacobi route", True)):
        e_p, g_p, _ = executor(torch.float32, fast=fast, polish=True).run(
            trimer, what="gradient")
        total_p, gs_p = trimer_mbe2_assemble(e_p, g_p)
        d_t = abs(total_p - total_x)
        d_n = abs(float(np.sqrt((gs_p**2).sum()) - np.sqrt((gs_x**2).sum())))
        print(f"polish trimer MBE(2) f32 + polish, {name}: d_total={d_t:.2e} "
              f"d|g|={d_n:.2e} max|dG|={np.abs(gs_p - gs_x).max():.2e}",
              flush=True)
        check(d_t <= 1e-9 and d_n <= 1e-9,
              f"polished trimer ({name}) off f64: {d_t:.3e} / {d_n:.3e}")

    # the 512-dimer slice: one f64 gradient call beside f32 + polish
    dimers = bench_dimers(512)
    kern = base._replace(use_pallas_eigh=True)
    calc64 = XtbCalculator(kern, dtype=torch.float64, device=DEVICE)
    calc32 = XtbCalculator(kern, dtype=torch.float32, device=DEVICE)
    pol = HostPolisher(calc32)
    frag64, frag32 = calc64.make_batch(dimers), calc32.make_batch(dimers)

    def polished():
        _e, _g, aux = calc32.gradients(frag32)
        return pol.polish(dimers, None, aux["shell_charges"], "gradient")

    calc64.gradients(frag64)
    polished()
    torch.cuda.reset_peak_memory_stats()
    (e64, g64, _aux), t64 = wall(lambda: calc64.gradients(frag64), 3)
    peak64 = torch.cuda.max_memory_allocated() / 2**30
    (_e, _g, aux32), t32 = wall(lambda: calc32.gradients(frag32), 3)
    torch.cuda.reset_peak_memory_stats()
    (e_p, g_p, _aux), t_p = wall(polished, 3)
    peak_p = torch.cuda.max_memory_allocated() / 2**30
    d_e = float((e_p - e64).abs().max())
    d_g = float((g_p - g64).abs().max())
    print(f"polish slice B=512 gradients: f64={t64:.4f} s (peak "
          f"{peak64:.2f} GiB) f32 raw={t32:.4f} s f32+polish={t_p:.4f} s "
          f"(peak {peak_p:.2f} GiB; the polish's batch build on the host "
          f"included) max|dE|={d_e:.2e} max|dG|={d_g:.2e} "
          f"f32 resid={aux32['scf_residual'].max():.2e}", flush=True)
    check(d_e <= 1e-9, f"polished slice energies off f64 by {d_e:.3e}")
    check(d_g <= 1e-8, f"polished slice gradients off f64 by {d_g:.3e}")

    # rescue: an impossible gate sends every fragment to the f64 re-solve
    waters = water_fragments(3)
    e_r, g_r, aux_r = executor(torch.float32, polish=True,
                               rescue_tol=1e-30).run(waters, what="gradient")
    e_x, g_x, _ = executor(torch.float64).run(waters, what="gradient")
    d_e = float(np.abs(e_r - e_x).max())
    d_g = max(float(np.abs(a - b).max()) for a, b in zip(g_r, g_x))
    print(f"polish rescue (rescue_tol=1e-30) on three waters: max|dE|="
          f"{d_e:.2e} max|dG|={d_g:.2e} "
          f"resid={aux_r['scf_residual'].max():.2e}", flush=True)
    check(d_e <= 1e-12 and d_g <= 1e-12,
          f"rescue is not the f64 path: dE={d_e:.3e} dG={d_g:.3e}")

    # the driver with force_dtype="f32" (factory settings, polisher wired
    # by _make_executor) against the JAX package's f64 goldens
    for name, gold in (("prism_mbe", golden["driver"]["prism_mbe"]),
                       ("w1_vib_therm",
                        golden_gfn2["driver"]["w1_vib_therm"])):
        cfg = read_mqc_file(os.path.join(ROOT, gold["mqc"]))
        times = {}
        for dtype in ("f64", "f32"):
            outputs, times[dtype] = wall(lambda: run_calculation(
                cfg, write_json=False, device=DEVICE,
                driver_overrides={"force_dtype": dtype}))
        obs = observables(outputs)
        deltas = " ".join(f"d_{label}={abs(got - exp):.2e}"
                          for label, got, exp in checks(obs, gold))
        print(f"polish driver {name} force_dtype=f32: wall={times['f32']:.3f}"
              f" s (f64 {times['f64']:.3f} s) {deltas}", flush=True)
        bad = golden_failures(obs, gold)
        check(not bad, f"{name} with force_dtype=f32 off the JAX package's "
                       f"f64 result: {bad}")
    return jac.launches - n0


def mesh_phase(jac, golden):
    """The sharded executor: pad, cut, evaluate per slot (a worker process
    each on a mesh of several slots), join."""
    from metalquicha_tpu_torch.driver import (
        make_executor,
        read_mqc_file,
        run_calculation,
    )
    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
    from metalquicha_tpu_torch.parallel.mesh import fragment_mesh
    from metalquicha_tpu_torch.parallel.slot_worker import evaluate_piece
    from metalquicha_tpu_torch.workloads import (
        trimer_mbe2_assemble,
        trimer_mbe2_fragments,
        w20_mbe2_assemble,
        w20_mbe2_fragments,
    )

    class SerialSlots(FragmentExecutor):
        """For comparison: the pieces one after the other from this
        process."""

        def _run_pieces(self, tuples, pad_to, what):
            per = len(tuples) // self.n_devices
            parts = []
            for k, device in enumerate(self.mesh.flat):
                calc = self.calc.on(device)
                piece = tuples[k * per : (k + 1) * per]
                parts.append(evaluate_piece(
                    calc, None, calc.make_batch(piece, pad_to=pad_to), piece,
                    pad_to, what))
            return parts

    def gone(workers):
        """Whether every worker process has exited and been reaped."""
        for w in workers:
            if w.proc.poll() is None:
                return False
            try:
                os.kill(w.pid, 0)
            except ProcessLookupError:
                continue
            return False
        return True

    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    n0 = jac.launches
    calc = XtbCalculator(dtype=torch.float64, device=DEVICE)
    cards = fragment_mesh()
    two = fragment_mesh((cards.flat * 2)[:2], nodes_per_group=1)
    check(two.shape == {"group": 2, "frag": 1}, f"two-slot mesh is {two}")
    two_ex = FragmentExecutor(calc, mesh=two, timeout=600)
    # the dry run's rigid trimer: its dimers have exactly degenerate
    # cross-monomer spectra, where the gradient depends on the eigenvector
    # gauge (and so on the batch the library's eigh was handed) at the
    # 1e-7 level, so its gradient is held to 1e-8; with every atom moved
    # by a seeded 0.02 Bohr the gradient is held like the total
    for label, frags, g_tol in (
        ("rigid", trimer_mbe2_fragments(), 1e-8),
        ("atoms jittered", trimer_mbe2_fragments(atom_jitter=0.02), 1e-12),
    ):
        e1, g1, _ = FragmentExecutor(calc).run(frags, what="gradient")
        total1, gs1 = trimer_mbe2_assemble(e1, g1)
        for name, ex in (("every visible card",
                          FragmentExecutor(calc, mesh=cards, timeout=600)),
                         ("two worker slots", two_ex)):
            (e, g, aux), t = wall(lambda: ex.run(frags, what="gradient"))
            total, gs = trimer_mbe2_assemble(e, g)
            d_t = abs(total - total1)
            d_g = float(np.abs(gs - gs1).max())
            print(f"mesh trimer MBE(2) gradient ({label}), {name} "
                  f"{ex.mesh}: wall={t:.3f} s total={total:.10f} "
                  f"d_total={d_t:.2e} max|dG|={d_g:.2e} (held to "
                  f"{g_tol:.0e}) resid={aux['scf_residual'].max():.2e}",
                  flush=True)
            check(d_t <= 1e-12 and d_g <= g_tol,
                  f"{name} ({label}): off the one-device run by {d_t:.3e} / "
                  f"{d_g:.3e}")
            if ex is not two_ex:
                ex.close()
    two_ex.close()

    # w20 MBE(2) gradient: one slot, two worker processes, two slots
    # dispatched serially from this process; a warm-up pass each (the
    # workers start in theirs), then two timed passes each, in turns
    settings = settings_from_params("gfn1", max_scf_iter=32,
                                    use_pallas_eigh=True)
    calc = XtbCalculator(settings, dtype=torch.float64, device=DEVICE)
    frags = w20_mbe2_fragments()
    runs = {"one slot": FragmentExecutor(calc),
            "two worker processes": FragmentExecutor(calc, mesh=two,
                                                     timeout=900),
            "two slots serial": SerialSlots(calc, mesh=two)}
    procs = runs["two worker processes"]
    totals, walls = {}, {name: [] for name in runs}
    for name, ex in runs.items():
        _, t = wall(lambda: ex.run(frags, what="gradient"))
        print(f"mesh w20 MBE(2) gradient, {name}: warm-up {t:.3f} s",
              flush=True)
    workers = list(procs.workers)
    check(len(workers) == 2, f"{len(workers)} workers for two slots")
    before = [w.fermi_launches for w in workers]
    for _rep in range(2):
        for name, ex in runs.items():
            (e, g, _aux), t = wall(lambda: ex.run(frags, what="gradient"))
            walls[name].append(t)
            totals[name] = w20_mbe2_assemble(e, g)
    per_worker = [w.fermi_launches - b for w, b in zip(workers, before)]
    one = min(walls["one slot"])
    for name in runs:
        print(f"mesh w20 MBE(2) gradient, {name}: walls "
              f"{' '.join(f'{t:.3f}' for t in walls[name])} s "
              f"({min(walls[name]) / one:.2f}x one slot) "
              f"total={totals[name][0]:.10f} |g|={totals[name][1]:.10f}",
              flush=True)
    for w, n_l in zip(workers, per_worker):
        print(f"mesh worker slot {w.index}: pid {w.pid} on {w.device}, "
              f"start-up {w.startup_s:.2f} s, {n_l} Fermi launches in the "
              f"timed passes, {w.fermi_launches} in all; SCC graphs "
              f"{w.scc_captures} captured, {w.scc_hits} cache hits, eager "
              f"SCCs {w.scc_eager}; call stages {w.stage_captures} "
              f"captured, {w.stage_hits} hits, {w.stage_eager} launch by "
              f"launch; {w.window_launches} Anderson window launches, "
              f"{w.gemm_launches} fragment product launches, "
              f"{w.reduce_launches} fragment sum launches", flush=True)
        check(w.scc_captures + w.scc_hits > 0 and w.scc_eager == 0,
              f"worker slot {w.index}: {w.scc_captures} SCC graphs, "
              f"{w.scc_hits} hits and {w.scc_eager} SCCs launch by launch")
        check(w.stage_captures + w.stage_hits > 0 and w.stage_eager == 0
              and w.window_launches > 0 and w.gemm_launches > 0
              and w.reduce_launches > 0,
              f"worker slot {w.index}: {w.stage_captures} stage graphs, "
              f"{w.stage_hits} hits, {w.stage_eager} stages launch by "
              f"launch, {w.window_launches} window launches, "
              f"{w.gemm_launches} fragment product launches, "
              f"{w.reduce_launches} fragment sum launches")
    check(min(per_worker) > 0,
          f"a worker launched no Fermi kernel: {per_worker}")
    for w in workers:
        loaded = {"jax", "metalquicha_tpu"} & set(w.modules)
        check(not loaded, f"worker slot {w.index} loaded {sorted(loaded)}")
    d_t = abs(totals["two worker processes"][0] - totals["one slot"][0])
    d_g = abs(totals["two worker processes"][1] - totals["one slot"][1])
    d_gold = abs(totals["two worker processes"][0]
                 - golden["w20_mbe2"]["total"])
    print(f"mesh w20 MBE(2): two worker processes vs one slot "
          f"d_total={d_t:.2e} d|g|={d_g:.2e} d_golden={d_gold:.2e}",
          flush=True)
    check(d_t <= 1e-10, f"two-process w20 MBE(2) total off by {d_t:.3e}")
    check(d_gold <= 1e-8, f"two-process w20 MBE(2) off the golden by "
                          f"{d_gold:.3e}")

    # the Jacobi route runs in float32: one pass of the same list on the
    # two workers, each of which must launch the Jacobi kernel
    procs.calc = XtbCalculator(settings, dtype=torch.float32, device=DEVICE)
    l0 = [w.launches for w in workers]
    (e, g, _aux), t = wall(lambda: procs.run(frags, what="gradient"))
    total32 = w20_mbe2_assemble(e, g)[0]
    per_worker = [w.launches - b for w, b in zip(workers, l0)]
    print(f"mesh w20 MBE(2) gradient float32 on the Jacobi route, two worker "
          f"processes: wall={t:.3f} s total={total32:.10f} d_golden="
          f"{abs(total32 - golden['w20_mbe2']['total']):.2e} Jacobi launches "
          f"per worker {per_worker}", flush=True)
    check(np.isfinite(total32) and min(per_worker) > 0,
          f"a worker launched no Jacobi kernel: {per_worker}")

    # the w20 MBE(4) driver run through the same two worker processes
    gold = golden["driver"]["w20_mbe"]
    cfg = read_mqc_file(os.path.join(ROOT, gold["mqc"]))
    factory = make_executor(cfg, DEVICE)
    procs.calc = factory.calc
    procs.polisher, procs.rescue_tol = factory.polisher, factory.rescue_tol
    torch.cuda.reset_peak_memory_stats()
    l0 = [w.fermi_launches for w in workers]
    out, t = wall(lambda: run_calculation(cfg, write_json=False,
                                          executor=procs))
    total = float(out[""].result.total_energy)
    d = abs(total - gold["total_energy"])
    peaks = " ".join(f"slot {w.index} {w.peak_bytes / 2**30:.2f}"
                     for w in workers)
    print(f"mesh driver w20_mbe4 (6195 fragments), two worker processes: "
          f"wall={t:.3f} s (one slot in the driver phase: "
          f"{WALLS.get('driver w20_mbe', float('nan')):.3f} s) "
          f"total={total:.10f} d_golden={d:.2e}; peak GiB: this process "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}, {peaks}; "
          f"Fermi launches "
          f"{[w.fermi_launches - b for w, b in zip(workers, l0)]}",
          flush=True)
    check(d <= 1e-7, f"two-process w20_mbe4 total off the golden by "
                     f"{d:.3e}")

    # its gradient: each worker plans for half the card (the two share
    # it) and evaluates its piece of the tetramer chunk in parts
    cfg = read_mqc_file(os.path.join(ROOT, "tests", "data",
                                     "port_memory_w20_mbe4_grad.mqc"))
    out, t = wall(lambda: run_calculation(cfg, write_json=False,
                                          executor=procs))
    total = float(out[""].result.total_energy)
    d = abs(total - gold["total_energy"])
    net = float(np.abs(out[""].result.gradient.sum(0)).max())
    print(f"mesh driver w20_mbe4 gradient, two worker processes: "
          f"wall={t:.3f} s total={total:.10f} d_golden={d:.2e} net force="
          f"{net:.2e}; " + "; ".join(
              f"slot {w.index} budget {w.budget_bytes / 2**30:.2f} GiB "
              f"peak {w.peak_bytes / 2**30:.2f} GiB SCC graph cache "
              f"{w.scc_held_bytes / 2**30:.3f} GiB parts of its last "
              f"piece {w.parts}" for w in workers), flush=True)
    check(d <= 1e-7, f"two-process w20_mbe4 gradient total off the golden "
                     f"by {d:.3e}")
    check(net <= 1e-7, f"two-process w20_mbe4 net force {net:.3e}")
    for w in workers:
        # each run's peak against that run's budget
        runs = {run: (round(budget / 2**30, 2), round(peak / 2**30, 2))
                for run, (budget, peak) in w.run_memory.items()}
        print(f"mesh slot {w.index} (budget GiB, peak GiB) per run: {runs}",
              flush=True)
        for run, (budget, peak) in w.run_memory.items():
            check(peak < budget, f"slot {w.index} peaked at {peak} bytes "
                  f"in run {run}, above its budget of {budget}")
    check(any(w.parts > 1 for w in workers),
          "no worker cut its piece of the tetramer chunk")
    check([w.pid for w in procs.workers] == [w.pid for w in workers],
          "the workers did not live across runs")
    procs.close()
    check(gone(workers), "a worker is alive after close()")
    print(f"mesh workers {[w.pid for w in workers]} exited with "
          f"{[w.proc.returncode for w in workers]}", flush=True)
    return jac.launches - n0


def fit_phase(jac, _golden):
    """The differentiable parameterization on the card."""
    from metalquicha_tpu_torch.methods.xtb.calculator import (
        single_point_energy,
    )
    from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
    from metalquicha_tpu_torch.methods.xtb.param_fit import (
        FragmentSpec,
        theta_init,
        theta_leaves,
        theta_map,
    )
    from metalquicha_tpu_torch.workloads import bench_dimers

    n0 = jac.launches
    numbers = np.array([8, 1, 1, 6, 7, 1])
    coords = np.array([[0.0, 0.0, 0.2], [0.0, 1.4, -0.9], [0.0, -1.4, -0.9],
                       [4.0, 0.0, 0.0], [6.5, 0.5, 0.0], [8.2, 0.0, 0.5]])
    for variant in ("gfn1", "gfn2"):
        spec = FragmentSpec(numbers, coords, 0, 1, variant=variant,
                            device=DEVICE)
        frag = spec.rebuild(theta_init(variant, DEVICE))
        worst = max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(frag, spec.base))
        on_card = all(x.device.type == DEVICE for x in frag)
        print(f"fit rebuild(theta_init) {variant}: max field difference from "
              f"the host batch {worst:.2e}", flush=True)
        check(worst <= 1e-12 and on_card,
              f"rebuild(theta_init) differs from the host batch ({worst:.3e})"
              f" or left the card")

    settings = settings_from_params("gfn1")
    water = FragmentSpec(numbers[:3], coords[:3], 0, 1, device=DEVICE)

    def leafy():
        return theta_map(lambda t: t.clone().requires_grad_(True),
                         theta_init("gfn1", DEVICE))

    def energy(spec, theta, c=None, k=0):
        fr = spec.rebuild(theta, c)
        return single_point_energy(fr.coords, fr, settings,
                                   diff_scf_iters=k)[0]

    theta = leafy()
    (g_lev,) = torch.autograd.grad(energy(water, theta).sum(),
                                   theta["elements"][8]["levels"])
    h = 1e-4

    def shifted(d):
        th = theta_init("gfn1", DEVICE)
        th["elements"][8]["levels"][0] += d
        with torch.no_grad():
            return float(energy(water, th))

    fd = (shifted(h) - shifted(-h)) / (2 * h)
    rel = abs(fd - float(g_lev[0])) / abs(fd)
    print(f"fit dE/dtheta water, O level 0: autograd={float(g_lev[0]):.10f} "
          f"central difference={fd:.10f} rel={rel:.2e}", flush=True)
    check(rel <= 1e-4, f"dE/dtheta off its central difference by {rel:.3e}")

    dimers = bench_dimers(64)
    spec = FragmentSpec(*dimers[0], device=DEVICE)
    cb = torch.tensor(np.stack([d[1] for d in dimers]), device=DEVICE)

    def energy_loss():
        theta = leafy()
        leaves = theta_leaves(theta)
        val = energy(spec, theta, cb).sum()
        return val.detach(), torch.autograd.grad(val, leaves,
                                                 allow_unused=True)

    def force_loss():
        theta = leafy()
        leaves = theta_leaves(theta)
        c = cb.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(energy(spec, theta, c, 8).sum(), c,
                                   create_graph=True)
        val = (g**2).sum()
        return val.detach(), torch.autograd.grad(val, leaves,
                                                 allow_unused=True)

    for name, fn in (("sum E", energy_loss),
                     ("sum |grad_R E|^2, 8 recorded refine steps",
                      force_loss)):
        fn()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        (val, grads), t = wall(fn, 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        used = [g for g in grads if g is not None]
        finite = all(bool(torch.isfinite(g).all()) for g in used)
        print(f"fit value-and-gradient over theta, 64 bench dimers, {name}: "
              f"wall={t:.3f} s peak={peak:.2f} GiB value={float(val):.10f} "
              f"leaves with a gradient={len(used)} of {len(grads)}",
              flush=True)
        check(finite and len(used) >= 33,
              f"{name}: gradient over theta not finite or too sparse")
    return jac.launches - n0


#: fit target -> (driver golden file, case, observable) of the JAX package's
#: driver result that holds the same observable
FIT_DRIVER_GOLDEN = {
    "h3o": ("full", "h3o_unfrag", "total_energy"),
    "prism_unfrag": ("full", "multi_structure", "molecule_1"),
    "prism_mbe": ("gfn1", "prism_mbe", "total_energy"),
    "charged_cluster": ("full", "charged_cluster_mbe", "total_energy"),
    "gly10_unfrag": ("full", "unfrag_gly3", "total_energy"),
    "gly10_mbe": ("full", "gly10_mbe", "total_energy"),
    "gmbe_gly3": ("full", "gmbe1_gly3", "total_energy"),
    "gmbe_decane": ("full", "gmbe3_decane", "total_energy"),
    "gly3_unfrag": ("full", "hess_gly3_serial", "total_energy"),
    "w20_mbe": ("gfn1", "w20_mbe", "total_energy"),
    "h3o_gnorm": ("full", "hess_h3o", "gradient_norm"),
    "prism_gnorm": ("full", "prism_hessian", "gradient_norm"),
    "gly3ov_gnorm": ("full", "hess_gly3_ov", "gradient_norm"),
    "h3o_hnorm": ("full", "hess_h3o", "hessian_frobenius_norm"),
    "prism_hnorm": ("full", "prism_hessian", "hessian_frobenius_norm"),
    "gly3ov_hnorm": ("full", "hess_gly3_ov", "hessian_frobenius_norm"),
    "w1_energy": ("gfn2", "w1_vib_therm", "total_energy"),
    "w1_gnorm": ("gfn2", "w1_vib_therm", "gradient_norm"),
}
#: PERF.md's driver tolerances, by observable
FIT_DRIVER_TOL = {"total_energy": 1e-7, "molecule_1": 1e-7,
                  "gradient_norm": 1e-6, "hessian_frobenius_norm": 1e-5}


def _driver_value(goldens, target):
    which, case, key = FIT_DRIVER_GOLDEN[target]
    entry = goldens[which]["driver"][case]
    return entry["energies"][key] if key == "molecule_1" else entry[key]


def _timed_targets(fit1, records):
    """Wrap `value_and_grad` of the fit script's target classes so that the
    first call of each target (the fit's evaluation at theta_0) is timed
    and its peak memory read, and its object, value and gradient kept in
    `records`; returns the originals, to be put back."""
    originals = {}
    for cls in (fit1.TargetEval, fit1.GradNormTarget, fit1.HessNormTarget,
                fit1.MbeHessNormTarget):
        def timed(self, theta, orig=cls.value_and_grad):
            if self.name in records:
                return orig(self, theta)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            val, grad = orig(self, theta)
            torch.cuda.synchronize()
            records[self.name] = (self, val, grad, time.perf_counter() - t0,
                                  torch.cuda.max_memory_allocated() / 2**30)
            return val, grad

        originals[cls] = cls.value_and_grad
        cls.value_and_grad = timed
    return originals


def _fit_run(fit1, argv):
    """fit_gfn1_torch.main(argv) with each target's first evaluation
    recorded: (records, wall seconds)."""
    records = {}
    originals = _timed_targets(fit1, records)
    try:
        _, t = wall(lambda: fit1.main(argv))
    finally:
        for cls, orig in originals.items():
            cls.value_and_grad = orig
    return records, t


def _check_fit_targets(fit1, records, goldens, fit_gold, variant):
    """Every default target of a variant at theta_0, as the fit evaluated
    it: its time and peak; the value against the JAX driver's result of
    the same observable and, where frozen, value and gradient against the
    JAX script's; an energy target's gradient against a central difference
    along a seeded random direction in theta (relative 1e-5)."""
    from metalquicha_tpu_torch.methods.xtb.param_fit import theta_init

    flat, unravel = fit1.ravel_theta(theta_init(variant, DEVICE))
    names = [n for tbl in fit1.variant_targets(variant) for n in tbl]
    check(sorted(records) == sorted(names),
          f"the {variant} fit evaluated {sorted(records)}, not {names}")
    for name in names:
        tgt, val, grad, t, peak = records[name]
        ref = _driver_value(goldens, name)
        tol = FIT_DRIVER_TOL[FIT_DRIVER_GOLDEN[name][2]]
        d_ref = abs(val - ref)
        note = ""
        if name in fit_gold["targets"]:
            gold = fit_gold["targets"][name]
            g_ref = np.array(gold["grad_flat"], dtype=float)
            known = np.isfinite(g_ref)
            d_g = float(np.abs(grad - g_ref)[known].max()
                        / np.abs(g_ref[known]).max())
            d_v = abs(val - gold["value"])
            note = (f" JAX fit script: d_value={d_v:.2e} "
                    f"grad rel={d_g:.2e}")
            check(d_v <= 1e-9 and d_g <= 1e-6,
                  f"fit target {name} off the JAX script ({d_v:.3e}, "
                  f"{d_g:.3e})")
        if isinstance(tgt, fit1.TargetEval):
            d = np.random.default_rng(0).normal(size=flat.shape) * 1e-4 * (
                np.abs(flat) + 1e-2)
            fd = (tgt.value(unravel(flat + d))
                  - tgt.value(unravel(flat - d))) / 2
            rel = abs(fd - grad @ d) / abs(grad @ d)
            note += (f" dE along d: autograd={grad @ d:.10e} fd={fd:.10e} "
                     f"rel={rel:.2e}")
            check(rel <= 1e-5, f"fit target {name}: Jacobian off its "
                               f"central difference by {rel:.3e}")
        print(f"fit_tools {variant} target {name} ({type(tgt).__name__}): "
              f"value={val:.10f} residual={val - tgt.expected:+.3e} "
              f"value_and_grad={t:.3f} s peak={peak:.2f} GiB; JAX driver "
              f"{FIT_DRIVER_GOLDEN[name][1]} d={d_ref:.2e} (held to "
              f"{tol:.0e});{note}", flush=True)
        check(np.isfinite(grad).all(), f"fit target {name}: gradient not "
                                       "finite")
        check(d_ref <= tol, f"fit target {name} off the JAX driver's "
                            f"{FIT_DRIVER_GOLDEN[name][1]} by {d_ref:.3e}")


def fit_tools_phase(jac, goldens):
    """The training programs (tools/fit_*_torch.py) on the card."""
    from metalquicha_tpu_torch.methods.xtb.param_fit import (
        theta_from_overlay,
        theta_init,
    )

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import fit_gfn1_torch as fit1
    import fit_gfn2_w1_torch as fitw1
    import fit_solvation_torch as fits

    n0 = jac.launches
    with open(GOLDEN_FIT_TOOLS) as fh:
        fit_gold = json.load(fh)
    with tempfile.TemporaryDirectory() as tmp:
        # one evaluation of residuals and Jacobian at theta_0 (the shipped
        # overlay), one LM step, the final residuals
        out = os.path.join(tmp, "fit_gfn1.json")
        records, t = _fit_run(fit1, ["--iters", "1", "--out", out])
        with open(out) as fh:
            res = json.load(fh)
        back = theta_from_overlay(out, "gfn1", DEVICE)
        same = all(
            np.array_equal(back["elements"][int(z)][k].cpu().numpy(), v)
            for z, el in res["elements"].items() for k, v in el.items())
        same &= np.array_equal(back["d3_pairs"].cpu().numpy(),
                               res["d3_pairs"])
        print(f"fit_tools fit_gfn1_torch --iters 1, all "
              f"{len(res['residuals'])} default targets: wall={t:.1f} s; "
              f"final residuals {res['residuals']}; reads back through "
              f"theta_from_overlay: {same}", flush=True)
        check(len(res["residuals"]) == 16 and same,
              "fit_gfn1_torch's output is not the 16-target fit or does "
              "not read back")
        _check_fit_targets(fit1, records, goldens, fit_gold, "gfn1")

        out = os.path.join(tmp, "fit_gfn1_gfn2.json")
        records, t = _fit_run(fit1, ["--variant", "gfn2", "--iters", "1",
                                     "--out", out])
        with open(out) as fh:
            res = json.load(fh)["residuals"]
        print(f"fit_tools fit_gfn1_torch --variant gfn2 --iters 1: "
              f"wall={t:.1f} s final residuals {res}", flush=True)
        _check_fit_targets(fit1, records, goldens, fit_gold, "gfn2")

        obs = fitw1.build_eval(DEVICE)(theta_init("gfn2", DEVICE))
        ref = fit_gold["fit_gfn2_w1"]["observables"]
        for key, tol in (("energy", 1e-10), ("grad_norm", 1e-9),
                         ("hess_norm", 1e-7), ("freqs", 1e-3),
                         ("zpe", 1e-9), ("gibbs", 1e-9)):
            d = float(np.abs(np.subtract(obs[key], ref[key])).max())
            print(f"fit_tools w1 observable {key} at theta_0: {obs[key]} "
                  f"d_JAX={d:.2e} (held to {tol:.0e})", flush=True)
            check(d <= tol, f"w1 {key} off the JAX script by {d:.3e}")
        out = os.path.join(tmp, "fit_gfn2.json")
        _, t = wall(lambda: fitw1.main(["--iters", "1", "--out", out]))
        with open(out) as fh:
            res = json.load(fh)["final_observables"]
        print(f"fit_tools fit_gfn2_w1_torch --iters 1 (from the shipped "
              f"overlay): wall={t:.1f} s final {res}", flush=True)

        energies = fits.build_eval(DEVICE)
        gold = fit_gold["fit_solvation"]
        for point in ("x0", "x1"):
            got = energies(np.array(gold[point]))
            d = max(abs(got[m] - e) for m, e in
                    gold["energies_" + point].items())
            print(f"fit_tools solvation energies at {point}: {got} "
                  f"d_JAX={d:.2e} (held to 1e-10)", flush=True)
            check(d <= 1e-10, f"solvation energies off the JAX script by "
                              f"{d:.3e}")
        # warm-started, as the JAX script is from its own output, from the
        # shipped solvation overlay (a file in the script's output format)
        out = os.path.join(tmp, "fit_solv.json")
        shutil.copy(SOLV_OVERLAY, out)
        _, t = wall(lambda: fits.main(["--iters", "1", "--out", out]))
        with open(out) as fh:
            res = json.load(fh)["residuals"]
        print(f"fit_tools fit_solvation_torch --iters 1 (from the shipped "
              f"overlay): wall={t:.1f} s final residuals {res}", flush=True)
    launched = jac.launches - n0
    print(f"fit_tools: {launched} Jacobi launches (the fits run the exact "
          "in-loop solve, use_pallas_eigh=False, as the JAX fits do)",
          flush=True)
    check(launched == 0, "the fit tools launched the Jacobi kernel")
    return launched


#: bench.py:322-347, the keys of its JSON line in order
BENCH_PY_KEYS = [
    "metric", "value", "unit", "vs_baseline", "platform", "batch_size",
    "scf_residual", "gfn1_fragment_gradients_per_sec", "grad_scf_residual",
    "mbe2_w20_grad_wall_s", "mbe2_w20_total_ha", "eigh_tflops_b512_n16",
    "eigh_tflops_b64_n256", "sp2_density_speedup_b64_n256",
    "sp2_tflops_b64_n256", "jacobi_tflops_b512_n16",
    "jacobi_speedup_b512_n16", "jacobi_tflops_b128_n64",
    "jacobi_speedup_b128_n64",
]


def bench_phase(jac, golden):
    """bench_torch.py at its defaults, in this process; its line parsed."""
    import contextlib
    import io

    import bench_torch

    n0 = jac.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_torch.main([])
    text = out.getvalue().strip().splitlines()
    check(rc == 0 and len(text) == 1, f"bench_torch.py: rc {rc}, {text}")
    line = json.loads(text[0])
    launched = jac.launches - n0
    print(text[0], flush=True)
    d_gold = abs(line["mbe2_w20_total_ha"] - golden["w20_mbe2"]["total"])
    print(f"bench: {launched} Jacobi launches, mbe2_w20_total_ha "
          f"{d_gold:.2e} off the golden", flush=True)
    check(list(line) == BENCH_PY_KEYS, f"bench keys {list(line)}")
    check(line["platform"] == "cuda", f"bench platform {line['platform']}")
    check(line["scf_residual"] < 1e-5 and line["grad_scf_residual"] < 1e-5,
          "bench SCC residual at or above 1e-5")
    check(launched > 0 and line["jacobi_speedup_b512_n16"] > 0,
          "bench launched no Jacobi kernel")
    check(d_gold <= 1e-6, f"bench w20 MBE(2) total off by {d_gold:.3e}")
    return launched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="SRC",
                    help="another kernel source to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from metalquicha_tpu_torch.methods.xtb import scc_graph
    from metalquicha_tpu_torch.ops import anderson_window as aw
    from metalquicha_tpu_torch.ops import batched_eigh as be
    from metalquicha_tpu_torch.ops import fermi_fill as ff
    from metalquicha_tpu_torch.ops import fragment_gemm as fm
    from metalquicha_tpu_torch.ops import fragment_reduce as fr
    from metalquicha_tpu_torch.ops import jacobi_eigh as jac
    from metalquicha_tpu_torch.ops import sp2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    with open(GOLDEN_FULL) as fh:
        golden_full = json.load(fh)
    with open(GOLDEN_GFN2) as fh:
        golden_gfn2 = json.load(fh)

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    built = {}

    def build(name, mod):
        t = time.perf_counter()
        try:
            mod.build()
            built[name] = time.perf_counter() - t
        except Exception as exc:  # raised below, on this thread
            built[name] = exc

    threads = [threading.Thread(target=build, args=item)
               for item in (("jacobi_eigh", jac), ("fermi_fill", ff),
                            ("anderson_window", aw), ("fragment_gemm", fm),
                            ("fragment_reduce", fr), ("batched_eigh", be))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, res in built.items():
        if isinstance(res, Exception):
            raise res
    print(f"kernel builds: {time.perf_counter() - t0:.2f} s in all "
          + " ".join(f"{k}={v:.2f} s" for k, v in built.items()), flush=True)
    print(f"in-loop eigh: cuSOLVER {be.solver_version()}", flush=True)
    rng = np.random.default_rng(0)
    if args.baseline:
        with tempfile.TemporaryDirectory() as tmp:
            entry = kernel_phase(jac, rng, build_baseline(jac, args.baseline,
                                                          tmp))
    else:
        entry = kernel_phase(jac, rng)
    t0 = time.perf_counter()
    fermi_entry = fermi_phase(ff, rng)
    print(f"phase fermi: {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    window_entry = window_phase(aw)
    print(f"phase anderson window: {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    gemm_entry, pair_entry = gemm_phase(fm)
    matvec_entry = matvec_phase(fm)
    print(f"phase fragment products: {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    reduce_entries = reduce_phase(fr)
    print(f"phase fragment sums: {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    sp2_phase(rng)
    print(f"phase sp2: {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    graph_line = scc_graph_phase(be)
    print(f"phase scc_graph: {time.perf_counter() - t0:.2f} s", flush=True)
    print(json.dumps({"scc_graph": graph_line}), flush=True)

    t0 = time.perf_counter()
    call_line = call_graph_phase()
    print(f"phase call_graph: {time.perf_counter() - t0:.2f} s", flush=True)
    print(json.dumps({"call_graph": call_line}), flush=True)

    t0 = time.perf_counter()
    c17 = c17_check()
    print(f"phase c17: {time.perf_counter() - t0:.2f} s", flush=True)
    print(json.dumps({"c17": c17}), flush=True)

    jac.launches = 0
    ff.launches = ff.density_launches = 0
    ff.density_by_class.clear()
    aw.launches = 0
    fm.launches_by_kind.clear()
    fr.launches_by_kind.clear()
    sp2.calls = 0
    be.launches = 0
    scc_graph.stats.update(captures=0, replays=0, eager=0, hits=0,
                           misses=0, evictions=0, stage_captures=0,
                           stage_hits=0, stage_eager=0)
    scc_graph.reuse.clear()
    phases, fermi, density, captures, hits, reuse = {}, {}, {}, {}, {}, {}
    windows, stages, gemms, sums = {}, {}, {}, {}
    for name, fn, gold in (("slice", slice_phase, golden),
                           ("executor", executor_phase, golden),
                           ("driver", driver_phase, golden),
                           ("memory", memory_phase, golden),
                           ("solvation", solvation_phase, golden_full),
                           ("validation", validation_phase, golden_full),
                           ("gfn2", gfn2_phase, golden_gfn2),
                           ("polish", polish_phase, (golden, golden_gfn2)),
                           ("mesh", mesh_phase, golden),
                           ("fit", fit_phase, golden),
                           ("fit_tools", fit_tools_phase,
                            {"gfn1": golden, "full": golden_full,
                             "gfn2": golden_gfn2}),
                           ("bench", bench_phase, golden)):
        t0 = time.perf_counter()
        f0, d0 = ff.launches, ff.density_launches
        w0, m0, r0 = aw.launches, fm.launches, fr.launches
        s0 = (scc_graph.stats["stage_captures"], scc_graph.stats["stage_hits"])
        g0, h0 = scc_graph.stats["captures"], scc_graph.stats["hits"]
        u0 = collections.Counter(scc_graph.reuse)
        phases[name] = fn(jac, gold)
        fermi[name] = ff.launches - f0
        density[name] = ff.density_launches - d0
        captures[name] = scc_graph.stats["captures"] - g0
        hits[name] = scc_graph.stats["hits"] - h0
        reuse[name] = reuse_line(scc_graph.reuse - u0)
        windows[name] = aw.launches - w0
        gemms[name] = fm.launches - m0
        sums[name] = fr.launches - r0
        stages[name] = (scc_graph.stats["stage_captures"] - s0[0],
                        scc_graph.stats["stage_hits"] - s0[1])
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s, "
              f"{fermi[name]} Fermi launches, {windows[name]} Anderson "
              f"window launches, {gemms[name]} fragment product launches, "
              f"{sums[name]} fragment sum launches, "
              f"call stages {stages[name][0]} captured, "
              f"{stages[name][1]} hits, SCC graphs {captures[name]} "
              f"captured, {hits[name]} cache hits, the cache holding "
              f"{scc_graph.stats['held_bytes'] / 2**30:.3f} GiB; reuse "
              f"{reuse[name]}", flush=True)
        check(fermi[name] > 0, f"the {name} phase launched no Fermi kernel")
        check(captures[name] + hits[name] > 0 or name == "mesh",
              f"the {name} phase ran no SCC through a graph")
        check(hits[name] > 0 or name not in REPEATING,
              f"the {name} phase repeats shapes and hit no cached graph")
        check(scc_graph.stats["eager"] == 0,
              f"the {name} phase ran an SCC on the card launch by launch")
        check(windows[name] > 0,
              f"the {name} phase launched no Anderson window kernel")
        check(gemms[name] > 0,
              f"the {name} phase launched no fragment product kernel")
        check(sums[name] > 0,
              f"the {name} phase launched no fragment sum kernel")
        check(scc_graph.stats["stage_eager"] == 0,
              f"the {name} phase ran a calculator's stage launch by launch")
    launches = jac.launches
    check(launches > 0, "the main path launched no Jacobi kernel")
    check(phases["polish"] > 0, "the polish phase launched no Jacobi kernel")
    check(phases["mesh"] > 0, "the mesh phase launched no Jacobi kernel")
    check(sp2.calls > 0, "the main path never went through SP2")
    print(f"main path: jacobi launches={launches} {phases} "
          f"sp2 calls={sp2.calls}", flush=True)
    print(f"main path: fermi launches={ff.launches} {fermi}", flush=True)
    print(f"main path: anderson window launches={aw.launches} {windows}",
          flush=True)
    by_kind = {fm.kind_name(k): n
               for k, n in sorted(fm.launches_by_kind.items())}
    print(f"main path: fragment product launches={fm.launches} {gemms}; by "
          f"kind {by_kind}", flush=True)
    matvecs = sum(n for k, n in fm.launches_by_kind.items()
                  if k[0] == "matvec")
    pairs = fm.launches_by_kind[fm.kind_of("pair_bilinear", 5)]
    check(matvecs > 0, "the main path launched no matvec kernel")
    check(pairs > 0, "the main path launched no pair contraction kernel")
    check(fm.launches > matvecs + pairs,
          "the main path launched no fragment product kernel")
    check(fm.launches_by_kind[("bmm", 256)] > 0,
          "the main path launched no product past 128 (the peptide's, "
          "CPCM's)")
    sums_by_kind = dict(sorted(fr.launches_by_kind.items()))
    print(f"main path: fragment sum launches={fr.launches} {sums}; by "
          f"entry {sums_by_kind}", flush=True)
    for name in REDUCE_REPLACES:
        check(fr.launches_by_kind[name] > 0,
              f"the main path launched no {name} kernel")
    print(f"main path: call stages (captured, hits)={stages}", flush=True)
    density_classes = dict(sorted(ff.density_by_class.items()))
    print(f"main path: fused fill and density launches (among the fermi "
          f"launches)={ff.density_launches} {density}; by class of nao "
          f"(16: a warp a fragment, 32, 64: a block) {density_classes}",
          flush=True)
    print(f"main path: SCC graphs captured={scc_graph.stats['captures']} "
          f"{captures}, cache hits={scc_graph.stats['hits']} {hits}, "
          f"evictions={scc_graph.stats['evictions']}, "
          f"replays={scc_graph.stats['replays']}, in-loop eigh "
          f"calls={be.launches}", flush=True)
    print(json.dumps({"scc_reuse": reuse}), flush=True)
    check(be.launches > 0, "the main path never called the in-loop eigh")
    check(ff.density_launches > 0,
          "the main path launched no fused fill and density")
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "metalquicha_tpu"))
    check(not jax_side, f"the port loaded {jax_side}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "jacobi_eigh",
        "route": "cuda",
        "source": "metalquicha_tpu_torch/csrc/jacobi_eigh.cu",
        "replaces": "metalquicha_tpu/ops/jacobi_eigh.py:37",
        "launches": launches,
        "max_abs_err": entry["max_abs_err"],
        "ms": entry["ms"],
        "plain_ms": entry["plain_ms"],
        "bound_ms": entry["bound_ms"],
        "bound_by": entry["bound_by"],
        "library_ms": entry["library_ms"],
    }, {
        "name": "fermi_fill",
        "route": "cuda",
        "source": "metalquicha_tpu_torch/csrc/fermi_fill.cu",
        "replaces": "metalquicha_tpu/methods/xtb/engine.py:324",
        "launches": ff.launches,
        "max_abs_err": fermi_entry["max_abs_err"],
        "ms": fermi_entry["ms"],
        "plain_ms": fermi_entry["plain_ms"],
        "bound_ms": fermi_entry["bound_ms"],
        "bound_by": fermi_entry["bound_by"],
        "library_ms": fermi_entry["library_ms"],
        # the fused fill and density (`fermi_density`, replacing also the
        # product at metalquicha_tpu/methods/xtb/engine.py:787-793): its
        # launches are among `launches`
        "density_launches": ff.density_launches,
        "density_launches_by_class": density_classes,
        "density_max_abs_err": fermi_entry["density_max_abs_err"],
        "density_ms": fermi_entry["density_ms"],
        "density_fill_product_ms": fermi_entry["density_fill_product_ms"],
        "density_plain_ms": fermi_entry["density_plain_ms"],
        "density_bound_ms": fermi_entry["density_bound_ms"],
        "density_bound_by": fermi_entry["density_bound_by"],
    }, {
        "name": "anderson_window",
        "route": "cuda",
        "source": "metalquicha_tpu_torch/csrc/anderson_window.cu",
        "replaces": "metalquicha_tpu/methods/xtb/engine.py:808",
        "launches": aw.launches,
        **window_entry,
    }, {
        "name": "fragment_gemm",
        "route": "cuda",
        "source": "metalquicha_tpu_torch/csrc/fragment_gemm.cu",
        "replaces": "metalquicha_tpu/methods/xtb/engine.py:443",
        # the products and the sandwich; the matvec and the pair
        # contraction, on kernels of their own in the same source, are the
        # next entries
        "launches": fm.launches - matvecs - pairs,
        # the main path's launches by kind (the matvec's among them): the
        # direct kernel, or the size class (16, 32, 64 staged whole; 128
        # with k in tiles; 256 past 128, in bands of rows and columns)
        "launches_by_kind": by_kind,
        **gemm_entry,
    }, {
        "name": "fragment_matvec",
        "route": "cuda",
        "source": "metalquicha_tpu_torch/csrc/fragment_gemm.cu",
        "replaces": "metalquicha_tpu/methods/xtb/engine.py:463",
        "launches": matvecs,
        **matvec_entry,
    }, {
        "name": "pair_bilinear",
        "route": "cuda",
        "source": "metalquicha_tpu_torch/csrc/fragment_gemm.cu",
        "replaces": "metalquicha_tpu/methods/xtb/dispersion_d3.py:255",
        "launches": pairs,
        **pair_entry,
    }] + [{
        "name": entry,
        "route": "cuda",
        "source": "metalquicha_tpu_torch/csrc/fragment_reduce.cu",
        "replaces": REDUCE_REPLACES[entry],
        # moment_fock's entry also runs the contraction of moment_rows'
        # backward (`moment_contract`), counted with it
        "launches": fr.launches_by_kind[entry] + (
            fr.launches_by_kind["moment_contract"]
            if entry == "moment_fock" else 0),
        **reduce_entries[entry],
    } for entry in REDUCE_REPLACES]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
