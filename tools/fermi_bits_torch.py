#!/usr/bin/env python3
"""A bit fingerprint of the Fermi kernels' outputs, on a card.

The fill (`ops/fermi_fill.py` `fermi_occupations_steps`: f, the entropy
and the steps each channel took) at the fill's shapes (`FILL`:
`chip_smoke.py`'s FERMI_SHAPES) and the fused fill and density
(`fermi_density`: P) at the density's (`DENSITY`: `chip_smoke.py`'s
DENSITY_SHAPES, and odd sizes on both sides of each class's edges), in
float64 and float32, at 300 K and 5000 K, on three families of inputs
made from a seed with numpy (`inputs`, RECIPE):
- "mixed": `chip_smoke.fermi_inputs`' batch (every third fragment
  padded, nuhf 0, 1 and 2 in turn, near-degenerate pairs, unsorted
  levels), with a NaN level in the first row and a NaN electron count in
  the last;
- "gapless": every real level within 20 kT of 0, so within 60 kT of mu;
- "margin": levels placed 1-3 ulps on either side of the clamp's margin
  (the least d with d / kt >= 60, `clamp_margin`) from where mid lands:
  at the first step (mid exactly 0), and at the fourth, where a run of
  clamped steps tests its nearest level above (or below) against it.
Each output's bytes are hashed (SHA-256), and so are the inputs'.

`--write F` records the fingerprints of whatever kernel comes first on
the path: with an older checkout first on PYTHONPATH (unpacked with `git
archive` into the gitignored `_archive/`), that checkout's kernel. The
fixture `tests/data/fermi_bits.json` holds those of the kernels before
the redesign of the fused kernel and the runs of clamped steps (commit
bb294ac). `--add F` writes the fixture with the cases it lacks added from
the kernel first on the path. `--check` (and `chip_smoke.py`'s fermi
phase) recomputes every case with the kernels of this tree and compares:
the kernels may be redesigned, their bits may not move. The fused
kernel's launch chooses its path by the batch (a class of nao on half-
warps or on blocks, the bisection evaluated ahead or not), so DENSITY
holds batches on both sides of each choice.

Usage: python3 tools/fermi_bits_torch.py [--write F | --add F | --check]
           [--fixture F]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)
FIXTURE = os.path.join(ROOT, "tests", "data", "fermi_bits.json")

SEED = 23
#: Boltzmann's constant in Hartree per Kelvin (the port's KB_HARTREE)
KB_HARTREE = 3.1668115634556e-06
KELVIN = (300, 5000)
#: (B, nao) of the fill: chip_smoke.FERMI_SHAPES (the dimer slice, the
#: w20 MBE(2) buckets, the w20 MBE(4) chunks, the FD Hessian's chunk at 241
#: AOs, a row longer than the kernel keeps in registers, rows of 8)
FILL = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32), (41, 241),
        (3, 300), (64, 8))
#: (B, nao) of the fused fill and density: chip_smoke.DENSITY_SHAPES, then
#: odd sizes at each class's edges (8, 17, 33 with an odd count of 8-row
#: tiles, 57 and 63), then batches on both sides of the launch's
#: thresholds: f64 rows of 17-31 on half-warps (17, 25 and 31: a lane's
#: second level partly past the row, odd rows staged shifted), blocks of
#: two warps at 20 AOs, and at 33-64 blocks of eight warps evaluating
#: ahead (300 fragments) and of two warps past kWideAheadPerSM (600)
DENSITY = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
           (128, 64), (7, 8), (5, 17), (9, 33), (6, 57), (3, 63),
           (2200, 17), (2200, 25), (2200, 31), (300, 20), (300, 40),
           (600, 41))
FAMILIES = ("mixed", "gapless", "margin")
DTYPES = ("f64", "f32")
ENTRIES = ("fill", "density")
RECIPE = (
    "rng = numpy.random.default_rng([SEED, family index in FAMILIES, "
    "kelvin, B, nao, bits of the dtype]); kt = kelvin * KB_HARTREE; "
    "levels, nelec, nuhf, mask drawn by the family's function in float64 "
    "(margin: in the dtype) and cast to the dtype; density: C = "
    "numpy.random.default_rng([SEED, 99, family index, kelvin, B, nao, "
    "bits]).standard_normal((B, nao, nao)) / sqrt(nao), cast; inputs "
    "hashed in the order eps, nelec, nuhf, mask[, C]")


def cases():
    """Every case as (key, entry, family, dtype, kelvin, (B, nao))."""
    out = []
    for entry, shapes in (("fill", FILL), ("density", DENSITY)):
        for family in FAMILIES:
            for dtype in DTYPES:
                for kelvin in KELVIN:
                    for shape in shapes:
                        out.append((entry, family, dtype, kelvin, shape))
    return [(key_of(*c), *c) for c in out]


def key_of(entry, family, dtype, kelvin, shape) -> str:
    return f"{entry}/{family}/{dtype}/{kelvin}K/{shape[0]}x{shape[1]}"


def _layout(bsz, nao):
    """Every third fragment padded to two thirds of its AOs, nuhf 0, 1
    and 2 in turn, nelec = 2 floor(n_real / 3) + nuhf: (n_real, nelec,
    nuhf, mask)."""
    pos = np.arange(nao)[None, :]
    n_real = np.where(np.arange(bsz) % 3 == 0, (2 * nao) // 3, nao)
    nuhf = np.arange(bsz) % 3.0
    nelec = 2.0 * np.floor(n_real / 3.0) + nuhf
    mask = (pos < n_real[:, None]).astype(float)
    return n_real, nelec, nuhf, mask


def _shuffle(rng, eps, mask):
    perm = np.argsort(rng.random(eps.shape), axis=1)
    return (np.take_along_axis(eps, perm, 1),
            np.take_along_axis(mask, perm, 1))


def mixed(rng, bsz, nao, kt):
    """chip_smoke.fermi_inputs' levels, a NaN level in the first row and a
    NaN electron count in the last."""
    pos = np.arange(nao)[None, :]
    n_real, nelec, nuhf, mask = _layout(bsz, nao)
    n_occ = np.ceil(nelec / 2.0)[:, None]
    u = rng.uniform(0.0, 0.6, size=(bsz, nao))
    eps = np.where(pos < n_occ, -u, 0.3 + u) - 0.5
    homo = np.where(pos < n_occ, eps, -np.inf).max(1)
    near = (np.arange(bsz) % 5 == 0)[:, None] & (pos == n_occ)
    eps = np.where(near, homo[:, None] + 1e-4, eps)
    eps = np.where(pos < n_real[:, None], eps, 10.0)
    eps[0, 0] = np.nan
    nelec[-1] = np.nan
    eps, mask = _shuffle(rng, eps, mask)
    return eps, nelec, nuhf, mask


def gapless(rng, bsz, nao, kt):
    """Every real level within 20 kT of 0."""
    n_real, nelec, nuhf, mask = _layout(bsz, nao)
    eps = np.where(mask > 0.5, kt * rng.uniform(-20.0, 20.0, (bsz, nao)),
                   10.0)
    eps, mask = _shuffle(rng, eps, mask)
    return eps, nelec, nuhf, mask


def clamp_margin(kt, np_dtype, sign):
    """The least m > 0 of np_dtype with (sign m) / kt at or past sign 60,
    stepped an ulp at a time from 60 kt (the kernel's `clamp_margin`)."""
    kt = np_dtype(kt)
    inf, zero, lim = np_dtype(np.inf), np_dtype(0.0), np_dtype(60.0)

    def past(m):
        return sign * ((np_dtype(sign) * m) / kt) >= lim

    m = lim * kt
    while not past(m):
        m = np.nextafter(m, inf)
    while past(np.nextafter(m, zero)):
        m = np.nextafter(m, zero)
    return m


def _steps(x, n, np_dtype):
    """x moved n ulps (n < 0: down)."""
    for _ in range(abs(n)):
        x = np.nextafter(x, np_dtype(np.inf if n > 0 else -np.inf))
    return x


def margin(rng, bsz, nao, kt, np_dtype):
    """Rows whose levels sit 1-3 ulps from the clamp's margin off a mid.
    Row r (kind r % 3, d = r // 3 % 7 - 3 ulps, closed where r // 21 is
    even, else nuhf 1 with the alpha channel on the designed path):
    levels -(6 + u) and 6 + u (u drawn in [0.3, 0.5]), so that the first
    mid is exactly 0, and the others away from every mid of the first
    four steps; kind 0: a level at margin_hi + d ulps and one at
    -(margin_lo + d ulps) (the first step's levels at the edge); kind 1:
    the fourth step's mid after decisions not, too many, not (so mid_4 =
    (mid_3 + mid_2) / 2), the lowest empty level at the first level
    clamped to 60 from it, + d ulps, every step before clamped (the run
    from the third step tests that level at mid_4); kind 2 its mirror
    (too many, not, too many; the highest occupied level at the first
    level clamped to -60 from mid_4, - d ulps)."""
    dt = np_dtype
    m_hi = clamp_margin(kt, dt, 1)
    m_lo = clamp_margin(kt, dt, -1)
    half = dt(0.5)
    eps = np.full((bsz, nao), 10.0, dtype=dt)
    mask = np.zeros((bsz, nao))
    nelec = np.zeros(bsz)
    nuhf = np.zeros(bsz)
    for r in range(bsz):
        kind, d = r % 3, (r // 3) % 7 - 3
        n_real = nao if r % 2 else max(4, (2 * nao) // 3)
        u = dt(rng.uniform(0.3, 0.5))
        top = dt(6.0) + u
        bottom = -top
        lo, hi = bottom - dt(10.0), top + dt(10.0)
        mid1 = half * (lo + hi)
        if kind == 0:
            special = [_steps(m_hi, d, dt), -_steps(m_lo, d, dt)]
        elif kind == 1:     # not, too many, not
            mid2 = half * (mid1 + hi)
            mid3 = half * (mid1 + mid2)
            mid4 = half * (mid3 + mid2)
            e = mid4 + m_hi
            while not e - mid4 >= m_hi:
                e = np.nextafter(e, dt(np.inf))
            while np.nextafter(e, dt(-np.inf)) - mid4 >= m_hi:
                e = np.nextafter(e, dt(-np.inf))
            special = [_steps(e, d, dt)]
        else:               # too many, not, too many
            mid2 = half * (lo + mid1)
            mid3 = half * (mid2 + mid1)
            mid4 = half * (mid2 + mid3)
            e = mid4 - m_lo
            while not e - mid4 <= -m_lo:
                e = np.nextafter(e, dt(-np.inf))
            while np.nextafter(e, dt(np.inf)) - mid4 <= -m_lo:
                e = np.nextafter(e, dt(np.inf))
            special = [_steps(e, -d, dt)]
        # the rest: occupied levels in [bottom + 0.1, -4], empty ones in
        # [4.7 + u, top - 0.05], away from every mid of the first three
        # steps; in kinds 1 and 2 on the far side of the special level
        rest = n_real - len(special) - 2
        n_low = rest // 2
        w_low = rng.uniform(0.0, 1.0, n_low).astype(dt)
        w_high = rng.uniform(0.0, 1.0, rest - n_low).astype(dt)
        low = (bottom + dt(0.1)) + w_low * (dt(-4.0) - (bottom + dt(0.1)))
        high = (dt(4.7) + u) + w_high * (top - dt(0.05) - (dt(4.7) + u))
        if kind == 1:
            high = np.clip(high, special[0] + dt(0.05), top)
        if kind == 2:
            low = np.clip(low, bottom, special[0] - dt(0.05))
        row = np.concatenate([np.asarray([bottom, top] + special, dtype=dt),
                              low.astype(dt), high.astype(dt)])
        # kind 0: mid_1 = 0 has as many electrons as levels below it; kinds
        # 1 and 2: the levels below mid_3 (and 0) number n_el and n_el + 1
        n_el = int((row < mid1).sum()) if kind == 0 else n_low + 1
        eps[r, :n_real] = row
        mask[r, :n_real] = 1.0
        if r // 21 % 2:
            nuhf[r], nelec[r] = 1.0, 2.0 * n_el - 1.0
        else:
            nelec[r] = 2.0 * n_el
    eps, mask = _shuffle(rng, eps, mask)
    return eps, nelec, nuhf, mask


def inputs(entry, family, dtype, kelvin, shape):
    """The case's inputs as numpy arrays of its dtype (RECIPE): [eps,
    nelec, nuhf, mask] and, for the density, C."""
    bsz, nao = shape
    bits = 64 if dtype == "f64" else 32
    np_dtype = np.float64 if dtype == "f64" else np.float32
    kt = kelvin * KB_HARTREE
    rng = np.random.default_rng(
        [SEED, FAMILIES.index(family), kelvin, bsz, nao, bits])
    if family == "margin":
        arrays = margin(rng, bsz, nao, kt, np_dtype)
    else:
        arrays = {"mixed": mixed, "gapless": gapless}[family](
            rng, bsz, nao, kt)
    out = [np.asarray(a).astype(np_dtype) for a in arrays]
    if entry == "density":
        rng_c = np.random.default_rng(
            [SEED, 99, FAMILIES.index(family), kelvin, bsz, nao, bits])
        c = rng_c.standard_normal((bsz, nao, nao)) / np.sqrt(nao)
        out.append(c.astype(np_dtype))
    return out


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def run(ff, entry, args, kt):
    """The case's outputs on the card, {name: array}, through the
    wrapper's entries."""
    eps, nelec, nuhf, mask = args[:4]
    if entry == "fill":
        f, s, steps = ff.fermi_occupations_steps(eps, nelec, nuhf, kt, mask)
        return {"f": f.cpu().numpy(), "entropy": s.cpu().numpy(),
                "steps": steps.cpu().numpy()}
    p = ff.fermi_density(eps, args[4], nelec, nuhf, kt, mask)
    return {"P": p.cpu().numpy()}


def fingerprints(ff, keys=None):
    """{key: {"inputs": [sha...], output name: sha}} of the kernels in
    module ff, every case (or those of `keys`)."""
    import torch

    out = {}
    for key, entry, family, dtype, kelvin, shape in cases():
        if keys is not None and key not in keys:
            continue
        arrays = inputs(entry, family, dtype, kelvin, shape)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        outs = run(ff, entry, args, kelvin * KB_HARTREE)
        out[key] = {"inputs": [digest(a) for a in arrays],
                    **{name: digest(a) for name, a in outs.items()}}
    return out


def load_fixture(path=FIXTURE) -> dict:
    with open(path) as fh:
        return json.load(fh)


def compare(ff, fixture: dict) -> list:
    """The keys whose outputs (or inputs) differ from the fixture's, and
    the cases it lacks."""
    want = fixture["cases"]
    got = fingerprints(ff)
    return sorted(k for k in got if k not in want or got[k] != want[k])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", default=None,
                    help="record the fingerprints of the kernels first on "
                         "the path into this file")
    ap.add_argument("--add", default=None,
                    help="write the fixture with the cases it lacks "
                         "added, from the kernels first on the path, into "
                         "this file")
    ap.add_argument("--check", action="store_true",
                    help="compare this tree's kernels with the fixture")
    ap.add_argument("--fixture", default=FIXTURE)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fermi_bits: CUDA is not available", file=sys.stderr)
        return 1
    from metalquicha_tpu_torch.ops import fermi_fill as ff

    ff.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"fermi_bits: kernels of {ff.__file__} on {card}", flush=True)
    t0 = time.perf_counter()
    if args.write:
        doc = {"seed": SEED, "recipe": RECIPE, "module": os.path.relpath(
            ff.__file__, ROOT), "card": card, "cases": fingerprints(ff)}
        with open(args.write, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"fermi_bits: {len(doc['cases'])} cases written to "
              f"{args.write}", flush=True)
    if args.add:
        doc = load_fixture(args.fixture)
        lack = {c[0] for c in cases()} - set(doc["cases"])
        doc["cases"].update(fingerprints(ff, lack))
        doc["recipe"] = RECIPE
        doc.setdefault("added", []).append({
            "module": os.path.relpath(ff.__file__, ROOT), "card": card,
            "keys": sorted(lack)})
        with open(args.add, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"fermi_bits: {len(lack)} cases added into {args.add}",
              flush=True)
    if args.check:
        bad = compare(ff, load_fixture(args.fixture))
        print(json.dumps({"fermi_bits": {
            "cases": len(cases()), "differ": bad,
            "seconds": round(time.perf_counter() - t0, 1)}}), flush=True)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
