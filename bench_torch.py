#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: GFN1-xTB fragment energies/sec
on one CUDA card, the counterpart of `bench.py` (which drives the JAX
package and stays as it is).

It measures what `bench.py` measures, on the same inputs (one generator,
seed 0, drawn in `bench.py`'s order) and in the same order:
- energies/s: a padded batch of `BENCH_BATCH` water dimers (6 atoms, 16
  AOs each), `BENCH_SCF_ITERS` SCC iterations, `BENCH_ITERS` timed calls
  after a warm-up, the coordinates moved by 1e-6 (i + 1) per call;
- `torch.linalg.eigh` TFLOP/s at (512, 16) and (64, 256), 9 N^3 per matrix;
- the SP2 density (`ops/sp2.py`) against the eigh route at (64, 256);
- the Jacobi kernel (`ops/jacobi_eigh.py`) against `torch.linalg.eigh` at
  (512, 16) and (128, 64), when `BENCH_PALLAS` selects the Jacobi route;
- gradients/s: `BENCH_GRAD_BATCH` dimers at 32 SCC iterations;
- the w20 MBE(2) gradient wall: 20 monomers + 190 dimers through
  `FragmentExecutor`, one warm-up and 3 timed passes, and the MBE(2) total.

Knobs (environment, `bench.py`'s names): BENCH_BATCH (512), BENCH_ITERS
(8), BENCH_SCF_ITERS (16), BENCH_GRAD_BATCH (256), BENCH_F64 ("1":
float64, the default; "0": float32), BENCH_PALLAS ("1": the fast in-loop
route, which the SCC takes in float32 only, as the JAX package's, so that
in float64 the SCC runs the exact eigh as `bench.py`'s would, and the
Jacobi kernel is timed alone at the shapes above; "0": the exact eigh and
no Jacobi timing). Runs on `cuda`
unless `--device cpu` is given, and raises without a card. Times are host
clocks around loops that end in `torch.cuda.synchronize()`, over inputs
staged on the device beforehand.

Prints the card's name and power limit on stderr, then ONE JSON line with
exactly `bench.py`'s keys:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

Usage: python3 bench_torch.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from metalquicha_tpu_torch.logging_ import global_logger  # noqa: E402
from metalquicha_tpu_torch.methods.xtb.calculator import (  # noqa: E402
    XtbCalculator,
    check_device,
)
from metalquicha_tpu_torch.methods.xtb.engine import (  # noqa: E402
    settings_from_params,
)
from metalquicha_tpu_torch.ops.jacobi_eigh import (  # noqa: E402
    batched_jacobi_eigh,
)
from metalquicha_tpu_torch.ops.sp2 import sp2_density  # noqa: E402
from metalquicha_tpu_torch.parallel.executor import (  # noqa: E402
    FragmentExecutor,
)
from metalquicha_tpu_torch.workloads import (  # noqa: E402
    dimers_from,
    w20_mbe2_assemble,
    w20_mbe2_fragments,
)

# energies/s of this program's defaults in its first full reading, on an
# NVIDIA H100 80GB HBM3 at a power limit of 700.00 W (PERF.md); bench.py
# divides by a TPU figure instead, which is not carried over
BASELINE_FRAGS_PER_SEC = 1920.13

#: the keys of the line, in bench.py's order (bench.py:322-347)
KEYS = (
    "metric", "value", "unit", "vs_baseline", "platform", "batch_size",
    "scf_residual", "gfn1_fragment_gradients_per_sec", "grad_scf_residual",
    "mbe2_w20_grad_wall_s", "mbe2_w20_total_ha", "eigh_tflops_b512_n16",
    "eigh_tflops_b64_n256", "sp2_density_speedup_b64_n256",
    "sp2_tflops_b64_n256", "jacobi_tflops_b512_n16",
    "jacobi_speedup_b512_n16", "jacobi_tflops_b128_n64",
    "jacobi_speedup_b128_n64",
)

#: residual bench.py asserts for both SCC settings
MAX_RESIDUAL = 1e-5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _symmetric(rng, nmat: int, n: int, dtype, device) -> torch.Tensor:
    """A + A^T of a seeded normal (nmat, n, n), as bench.py draws it."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    a = rng.normal(size=(nmat, n, n)).astype(np_dtype)
    return torch.from_numpy(a + a.transpose(0, 2, 1)).to(device)


def _staged(a: torch.Tensor, count: int) -> list:
    """count distinct copies a * (1 + 1e-4 (i + 1)), made before timing."""
    out = [a * (1.0 + 1e-4 * (i + 1)) for i in range(count)]
    _sync(a.device)
    return out


def _calculator(max_scf_iter, use_pallas, dtype, device) -> XtbCalculator:
    settings = settings_from_params("gfn1", max_scf_iter=max_scf_iter,
                                    use_pallas_eigh=use_pallas)
    return XtbCalculator(settings, dtype=dtype, device=device)


def _moved(frag, n_iters: int) -> list:
    """The batch with its coordinates moved 1e-6 (i + 1), i < n_iters."""
    out = [frag._replace(coords=frag.coords + 1e-6 * (i + 1))
           for i in range(n_iters)]
    _sync(frag.coords.device)
    return out


def energies_rate(calc, frags, n_iters: int):
    """(energies/s, max SCC residual, energies of the last call)."""
    frag = calc.make_batch(frags)
    calc.energies(frag)  # warm-up
    variants = _moved(frag, n_iters)
    t0 = time.perf_counter()
    for v in variants:
        e, aux = calc.energies(v)
    _sync(calc.device)
    dt = time.perf_counter() - t0
    return (len(frags) * n_iters / dt,
            float(aux["scf_residual"].abs().max()), e.cpu().numpy())


def gradients_rate(calc, frags, n_iters: int):
    """(gradients/s, max SCC residual)."""
    frag = calc.make_batch(frags)
    calc.gradients(frag)  # warm-up
    variants = _moved(frag, n_iters)
    t0 = time.perf_counter()
    for v in variants:
        _e, _g, aux = calc.gradients(v)
    _sync(calc.device)
    dt = time.perf_counter() - t0
    return len(frags) * n_iters / dt, float(aux["scf_residual"].abs().max())


def mbe_gradient_wall(calc, fragments, total, passes: int = 3):
    """(seconds per pass, MBE total of the last pass): fragments(jitter)
    through FragmentExecutor with gradients, one warm-up pass and `passes`
    timed ones with every atom moved by 1e-5 (i + 1) Bohr."""
    ex = FragmentExecutor(calc)
    ex.run(fragments(np.zeros(3)), what="gradient")  # warm-up
    t0 = time.perf_counter()
    for i in range(passes):
        e, g, _aux = ex.run(fragments(np.full(3, 1e-5 * (i + 1))),
                            what="gradient")
    dt = time.perf_counter() - t0
    return dt / passes, total(e, g)


def eigh_tflops(rng, nmat: int, n: int, dtype, device, iters: int = 4):
    """torch.linalg.eigh at 9 N^3 FLOP per matrix."""
    staged = _staged(_symmetric(rng, nmat, n, dtype, device), iters + 1)
    torch.linalg.eigh(staged[0])
    _sync(device)
    t0 = time.perf_counter()
    for x in staged[1:]:
        torch.linalg.eigh(x)
    _sync(device)
    return 9.0 * nmat * n**3 * iters / (time.perf_counter() - t0) / 1e12


def density_secs(rng, nmat: int, n: int, route: str, dtype, device,
                 iters: int = 10):
    """Seconds per call to make the density of a batch of Fock matrices,
    by SP2 (`route="sp2"`) or by torch.linalg.eigh."""
    a = _symmetric(rng, nmat, n, dtype, device)
    nocc = torch.full((nmat,), float(2 * (n // 4)), dtype=dtype, device=device)
    nuhf = torch.zeros((nmat,), dtype=dtype, device=device)
    mask = torch.ones((nmat, n), dtype=dtype, device=device)
    occ = (torch.arange(n, device=device)[None, :] < (nocc[:, None] / 2.0))
    fill = torch.where(occ, 2.0, 0.0).to(dtype)

    def density(m):
        if route == "sp2":
            # closed shell decided once, outside the loop, as the SCC does
            return sp2_density(m, nocc, nuhf, mask, closed_shell=True)
        _w, v = torch.linalg.eigh(m)
        return torch.einsum("bik,bk,bjk->bij", v, fill, v)

    staged = _staged(a, iters + 3)
    for x in staged[:3]:
        density(x)
    _sync(device)
    t0 = time.perf_counter()
    for x in staged[3:]:
        density(x)
    _sync(device)
    return (time.perf_counter() - t0) / iters


def jacobi_pair(rng, nmat: int, n: int, dtype, device, iters: int = 8):
    """(Jacobi TFLOP/s at 9 N^3 per matrix, eigh seconds / Jacobi seconds)."""
    a = _symmetric(rng, nmat, n, dtype, device)
    secs = {}
    for name, fn in (("jacobi", batched_jacobi_eigh),
                     ("eigh", torch.linalg.eigh)):
        staged = _staged(a, iters + 2)
        for x in staged[:2]:
            fn(x)
        _sync(device)
        t0 = time.perf_counter()
        for x in staged[2:]:
            fn(x)
        _sync(device)
        secs[name] = (time.perf_counter() - t0) / iters
    return 9.0 * nmat * n**3 / secs["jacobi"] / 1e12, secs["eigh"] / secs["jacobi"]


def _w20_total(energies, gradients) -> float:
    return w20_mbe2_assemble(energies, gradients)[0]


def measure(device="cuda", dtype=torch.float64, batch_size: int = 512,
            n_iters: int = 8, scf_iters: int = 16, grad_batch: int = 256,
            use_pallas: bool = True, mbe=(w20_mbe2_fragments, _w20_total),
            mbe_passes: int = 3, eigh_shapes=((512, 16), (64, 256)),
            sp2_shape=(64, 256), jacobi_shapes=((512, 16), (128, 64))):
    """bench.py's measurements at the given sizes: (the line as a dict,
    the energies of the timed batch's last call). Raises when an SCC
    residual is at or above MAX_RESIDUAL."""
    device = check_device(device)
    rng = np.random.default_rng(0)

    calc = _calculator(scf_iters, use_pallas, dtype, device)
    frags_per_sec, max_resid, energies = energies_rate(
        calc, dimers_from(rng, batch_size), n_iters)
    if not max_resid < MAX_RESIDUAL:
        raise RuntimeError(f"SCF not converged in bench: {max_resid}")

    eigh_small = eigh_tflops(rng, *eigh_shapes[0], dtype, device)
    eigh_large = eigh_tflops(rng, *eigh_shapes[1], dtype, device)

    sp2_t = density_secs(rng, *sp2_shape, "sp2", dtype, device)
    eigh_t = density_secs(rng, *sp2_shape, "eigh", dtype, device)
    nmat, n = sp2_shape
    sp2_tflops = 48 * 2.0 * nmat * n**3 / sp2_t / 1e12

    if use_pallas:
        jac_small = jacobi_pair(rng, *jacobi_shapes[0], dtype, device)
        jac_large = jacobi_pair(rng, *jacobi_shapes[1], dtype, device)
    else:
        jac_small = jac_large = (0.0, 0.0)

    calc_prod = _calculator(32, use_pallas, dtype, device)
    grads_per_sec, grad_resid = gradients_rate(
        calc_prod, dimers_from(rng, grad_batch), n_iters)
    if not grad_resid < MAX_RESIDUAL:
        raise RuntimeError(f"production SCC not converged: {grad_resid}")

    mbe2_wall, total_mbe = mbe_gradient_wall(calc_prod, *mbe, mbe_passes)

    line = {
        "metric": "gfn1_fragment_energies_per_sec",
        "value": round(frags_per_sec, 2),
        "unit": "fragments/s",
        "vs_baseline": round(frags_per_sec / BASELINE_FRAGS_PER_SEC, 3),
        "platform": device.type,
        "batch_size": batch_size,
        "scf_residual": max_resid,
        "gfn1_fragment_gradients_per_sec": round(grads_per_sec, 2),
        "grad_scf_residual": grad_resid,
        "mbe2_w20_grad_wall_s": round(mbe2_wall, 3),
        "mbe2_w20_total_ha": round(total_mbe, 6),
        "eigh_tflops_b512_n16": round(eigh_small, 4),
        "eigh_tflops_b64_n256": round(eigh_large, 4),
        "sp2_density_speedup_b64_n256": round(eigh_t / sp2_t, 2),
        "sp2_tflops_b64_n256": round(sp2_tflops, 4),
        "jacobi_tflops_b512_n16": round(jac_small[0], 4),
        "jacobi_speedup_b512_n16": round(jac_small[1], 2),
        "jacobi_tflops_b128_n64": round(jac_large[0], 4),
        "jacobi_speedup_b128_n64": round(jac_large[1], 2),
    }
    return line, energies


def card(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return f"device: {device} (no card)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return f"card: {torch.cuda.get_device_name(device)}; {smi}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; fails without one)")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    global_logger.set_level("warning")  # stdout holds the one line
    env = os.environ.get
    f64 = env("BENCH_F64", "1") == "1"
    print(card(device), file=sys.stderr, flush=True)
    line, _energies = measure(
        device=device,
        dtype=torch.float64 if f64 else torch.float32,
        batch_size=int(env("BENCH_BATCH", "512")),
        n_iters=int(env("BENCH_ITERS", "8")),
        scf_iters=int(env("BENCH_SCF_ITERS", "16")),
        grad_batch=int(env("BENCH_GRAD_BATCH", "256")),
        use_pallas=env("BENCH_PALLAS", "1") == "1",
    )
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
