#!/usr/bin/env python3
"""The torch port's Fermi kernels on a card, beside an earlier version's.

Usage:
  python3 tools/fermi_probe_torch.py [--baseline SRC] [--json-out F]
  python3 tools/fermi_probe_torch.py --host-only [--json-out F]

On the inputs of `chip_smoke.py`'s fermi phase (`chip_smoke.fermi_inputs`,
one generator, seed 0), it prints one JSON line per measurement:

- "fill", per (B, nao) of `chip_smoke.FERMI_TIMED` in float64 and
  float32: `ms`, the fill's (`fermi_occupations`) time per call from CUDA
  events over 50 back-to-back calls; `device_ms`, its kernel's device
  time per launch from torch.profiler; `steps`, the least and most
  bisection steps the kernel took over the rows it filled; `bound_ms` and
  `share` (`chip_smoke.fermi_bound` on the plain version's steps) beside
  `bound_80_ms` and `share_80` (the 80-step count). With --baseline SRC
  (an earlier `csrc/fermi_fill.cu` with the C interface
  `mqc_fermi_fill_f64(eps, mask, nelec, nuhf, kt, f, entropy, batch, nao,
  device, stream)`, built with the port's nvcc flags into a temporary
  directory) also `base_ms` and `base_device_ms`, timed in turns (baseline,
  this, this, baseline), and whether both give the same bits
  (`same_bits`, with max |df| and |d entropy|).
- "fill_closed", at (512, 16) and (5985, 32) in float64 and float32, the
  same with every fragment a closed shell (nuhf 0, nelec even), as the
  water MBE runs are: `ms`, `device_ms`, `steps`, bound and share, and
  with --baseline the earlier kernel's times and the bits compared.
- "density", per (B, nao) of `chip_smoke.DENSITY_SHAPES`: the fused fill
  and density's (`fermi_density`) `ms` and `device_ms` beside the fill
  and product it replaces in the SCC (`fermi_occupations`, then
  `(C * f) @ C^T`; `two_ms`, `two_device_ms`), its bound and share.
- with --host-only, "host" instead: the host microseconds one
  `fermi_occupations` call takes at (512, 16) float64, from the host
  clock over 2000 calls (`wall_us`; the device's 0.02-0.03 ms per launch
  is shorter, so the loop waits on the host) and from torch.profiler's CPU
  time of a `record_function` around each call (`profiler_us`); and the
  host microseconds of the two ways to allocate f and the entropy on the
  card: two `new_empty` (`alloc_two_us`) or one cut into two views
  (`alloc_one_views_us`). It uses only the package's entry point, so an
  older checkout first on PYTHONPATH is measured the same way.

The card's name and power limit are in the first line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)

HOST_CALLS = 2000


def _emit(line: dict, out) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out is not None:
        out.write(text + "\n")


def _device_ms(fn, reps: int = 20, name: str | None = None) -> float:
    """Device time per call of fn's kernels (those whose name holds
    `name`, or all), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if name is None or name in ev.key:
            us += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
    return us / reps / 1e3


def _share(bound: float, device_ms: float):
    """bound / device_ms, or None where the profiler showed no device
    time (then time with CUDA events: `ms`)."""
    return bound / device_ms if device_ms else None


def _baseline(source: str, out_dir: str):
    """The earlier kernel source built with the port's flags: a launch
    function (eps, nelec, nuhf, kt, mask) -> (f, entropy)."""
    from metalquicha_tpu_torch.ops import kernel_build

    so = os.path.join(out_dir, "fermi_baseline.so")
    subprocess.run([kernel_build.nvcc(), *kernel_build.NVCC_FLAGS, "-o", so,
                    source], check=True)
    lib = ctypes.CDLL(so)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for name in ("mqc_fermi_fill_f32", "mqc_fermi_fill_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_double, ptr, ptr, cint,
                       cint, cint, ptr]
        fn.restype = cint

    def launch(eps, nelec, nuhf, kt, mask):
        bsz, nao = eps.shape
        f = torch.empty_like(eps)
        s = torch.empty((bsz,), dtype=eps.dtype, device=eps.device)
        fn = (lib.mqc_fermi_fill_f64 if eps.dtype == torch.float64
              else lib.mqc_fermi_fill_f32)
        err = fn(eps.data_ptr(), mask.data_ptr(), nelec.data_ptr(),
                 nuhf.data_ptr(), float(kt), f.data_ptr(), s.data_ptr(), bsz,
                 nao, eps.device.index,
                 torch.cuda.current_stream(eps.device).cuda_stream)
        if err:
            raise RuntimeError(f"baseline Fermi kernel failed ({err})")
        return f, s

    return launch


def _closed(eps, nelec, nuhf, mask):
    """The batch with every fragment a closed shell: nuhf 0, nelec the
    even number below."""
    return eps, 2.0 * torch.floor(0.5 * nelec), torch.zeros_like(nuhf), mask


def fills(cs, ff, kt, base, out) -> None:
    rng = np.random.default_rng(0)
    cases = [("fill", dtype, shape, False)
             for dtype in (torch.float64, torch.float32)
             for shape in cs.FERMI_TIMED]
    cases += [("fill_closed", dtype, shape, True)
              for dtype in (torch.float64, torch.float32)
              for shape in ((512, 16), (5985, 32))]
    for what, dtype, (bsz, nao), closed in cases:
        eps, nelec, nuhf, mask = cs.fermi_inputs(rng, bsz, nao, dtype)
        if closed:
            eps, nelec, nuhf, mask = _closed(eps, nelec, nuhf, mask)

        def this():
            return ff.fermi_occupations(eps, nelec, nuhf, kt, mask)

        _f, _s, steps = ff.fermi_occupations_steps(eps, nelec, nuhf, kt,
                                                   mask)
        filled = steps[steps > 0]
        steps_p = ff.fermi_steps_reference(eps, nelec, nuhf, kt, mask)
        bound, by = cs.fermi_bound(bsz, nao, dtype, steps_p)
        bound80, _ = cs.fermi_bound(bsz, nao, dtype)
        rec = {"what": what, "dtype": str(dtype)[6:], "B": bsz,
               "nao": nao, "steps": [int(filled.min()),
                                     int(filled.max())],
               "bound_ms": bound, "bound_by": by,
               "bound_80_ms": bound80}
        if base is not None:
            def old():
                return base(eps, nelec, nuhf, kt, mask)

            f_o, s_o = old()
            f_n, s_n = this()
            rec["same_bits"] = bool(torch.equal(f_o, f_n)
                                    and torch.equal(s_o, s_n))
            rec["max_df"] = float((f_o - f_n).abs().max())
            rec["max_ds"] = float((s_o - s_n).abs().max())
            t_o = cs.cuda_ms(old, 50)
        t_n = cs.cuda_ms(this, 50)
        t_n2 = cs.cuda_ms(this, 50)
        rec["ms"] = 0.5 * (t_n + t_n2)
        if base is not None:
            rec["base_ms"] = 0.5 * (t_o + cs.cuda_ms(old, 50))
            rec["base_device_ms"] = _device_ms(old, name="fermi")
        rec["device_ms"] = _device_ms(this, name="fermi")
        rec["share"] = bound / rec["ms"]
        rec["share_80"] = bound80 / rec["ms"]
        rec["device_share"] = _share(bound, rec["device_ms"])
        _emit(rec, out)


def densities(cs, ff, kt, out) -> None:
    rng = np.random.default_rng(1)
    for dtype in (torch.float64, torch.float32):
        for bsz, nao in cs.DENSITY_SHAPES:
            eps, nelec, nuhf, mask = cs.fermi_inputs(rng, bsz, nao, dtype)
            C = torch.tensor(np.linalg.qr(rng.normal(size=(bsz, nao, nao)))[0],
                             dtype=dtype, device=eps.device)

            def fused():
                return ff.fermi_density(eps, C, nelec, nuhf, kt, mask)

            def two():
                f, _ = ff.fermi_occupations(eps, nelec, nuhf, kt, mask)
                return (C * f[:, None, :]) @ C.transpose(-1, -2)

            steps_p = ff.fermi_steps_reference(eps, nelec, nuhf, kt, mask)
            bound, by = cs.fermi_density_bound(bsz, nao, dtype, steps_p)
            t_two = cs.cuda_ms(two, 50)
            t_k = cs.cuda_ms(fused, 50)
            t_k2 = cs.cuda_ms(fused, 50)
            t_two2 = cs.cuda_ms(two, 50)
            rec = {"what": "density", "dtype": str(dtype)[6:], "B": bsz,
                   "nao": nao, "ms": 0.5 * (t_k + t_k2),
                   "two_ms": 0.5 * (t_two + t_two2),
                   "device_ms": _device_ms(fused, name="fermi"),
                   "two_device_ms": _device_ms(two),
                   "bound_ms": bound, "bound_by": by}
            rec["share"] = bound / rec["ms"]
            rec["device_share"] = _share(bound, rec["device_ms"])
            _emit(rec, out)


def host(cs, ff, kt, out) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    import metalquicha_tpu_torch

    rng = np.random.default_rng(0)
    eps, nelec, nuhf, mask = cs.fermi_inputs(rng, 512, 16, torch.float64)

    def call():
        return ff.fermi_occupations(eps, nelec, nuhf, kt, mask)

    for _ in range(50):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        call()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    reps = 200
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            with record_function("fermi_occupations"):
                call()
    torch.cuda.synchronize()
    cpu_us = sum(ev.cpu_time_total for ev in prof.key_averages()
                 if ev.key == "fermi_occupations") / reps

    def host_us(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        return 1e6 * (time.perf_counter() - t0) / HOST_CALLS

    def two():
        return eps.new_empty((512, 16)), eps.new_empty((512,))

    def one_views():
        buf = eps.new_empty((512 * 17,))
        return buf[: 512 * 16].view(512, 16), buf[512 * 16 :]

    _emit({"what": "host", "package": os.path.dirname(
        metalquicha_tpu_torch.__file__), "B": 512, "nao": 16,
        "dtype": "float64", "wall_us": 1e6 * wall / HOST_CALLS,
        "profiler_us": cpu_us, "alloc_two_us": host_us(two),
        "alloc_one_views_us": host_us(one_views)}, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="SRC",
                    help="an earlier csrc/fermi_fill.cu to time beside")
    ap.add_argument("--host-only", action="store_true",
                    help="host time per fermi_occupations call only")
    ap.add_argument("--json-out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fermi_probe_torch: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from metalquicha_tpu_torch.constants import KB_HARTREE
    from metalquicha_tpu_torch.ops import fermi_fill as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    kt = 300.0 * KB_HARTREE
    ff.build()
    out = open(args.json_out, "a") if args.json_out else None
    try:
        _emit({"card": cs.nvidia_smi(), "torch": torch.__version__}, out)
        if args.host_only:
            host(cs, ff, kt, out)
            return 0
        with tempfile.TemporaryDirectory() as tmp:
            base = _baseline(args.baseline, tmp) if args.baseline else None
            fills(cs, ff, kt, base, out)
        densities(cs, ff, kt, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
