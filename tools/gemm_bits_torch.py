#!/usr/bin/env python3
"""A bit fingerprint of the fragment product kernel's outputs, on a card.

Every entry of `ops/fragment_gemm.py` that `chip_smoke.py`'s gemm phase
names (the product with each transpose, the sandwich x f x + s, the
matvec and its transpose at the square shapes; the product with each
transpose at the rectangular ones; the matvec and its transpose at the
shapes of MATVEC, and on operands with a storage offset at those of
MATVEC_OFFSET; D3's pair contraction `pair_bilinear` at the shapes of
PAIR), in float64 and float32, on inputs made from a seed with numpy
(`inputs`: one generator per case, seeded with SEED and the case's
entry, shape, transposes and dtype; standard normal values drawn in
float64 and cast; the pair contraction's weights and grids as
`chip_smoke.py`'s rect phase draws them). Each output's bytes are hashed
(SHA-256), and so are the inputs'.

`--write F` records the fingerprints of whatever kernel comes first on
the path: with an older checkout first on PYTHONPATH (unpacked with `git
archive` into the gitignored `_archive/`), that checkout's kernel. The
fixture `tests/data/fragment_gemm_bits.json` holds the fingerprints of the
kernel's first version (commit df9980a), and the matvec cases of
MATVEC and MATVEC_OFFSET those of the matvec's first kernel (the direct
kernel, as at commit d37ed60; `added` in the file), and the pair cases
those of the pair contraction as commit 759462b ran it on a card (the
direct kernel's products, torch's multiply and torch's sum over R;
`added`), and the cases above 128 (SQUARE's (41, 241) and (64, 256), the
matvec at (41, 192), CPCM's RECT) those of the kernel that first took
them (`added`), and the small batches and plan boundaries of the tiled
class (SQUARE's (16, 96), (3, 128), (66, 97); the last four of RECT)
those of the tiled kernel before its redesign (commit 70a0267, `added`),
as are the partial last k tiles (SQUARE's (66, 125), RECT's (66, 97, 94,
97) and (3, 8, 127, 8); `added` again);
`--add F` writes the fixture with the cases it lacks added from the
kernel first on the path.
`--check` (and `chip_smoke.py`'s gemm phase) recomputes every case with
the kernel of this tree and compares: the kernel may be redesigned, its
bits may not move.

Usage: python3 tools/gemm_bits_torch.py [--write F | --add F | --check]
           [--fixture F]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)
FIXTURE = os.path.join(ROOT, "tests", "data", "fragment_gemm_bits.json")

SEED = 16
#: (B, n) and (B, m, k, n) of chip_smoke.py's GEMM_SHAPES and GEMM_RECT,
#: and of its GEMM_WIDE above 128 (the peptide's 241, SP2's 256; CPCM's
#: (nat, points) by (points, nat) at the w20 dimers and monomers and its
#: backward's (points, nat) by (nat, nat)), recorded from the card's
#: output of the kernel that first took them (`added`); the small batches
#: above 64 (the dodecamers' (16, 96), (3, 128)) and a case at each
#: boundary of the tiled class's plan (wide units from 66 fragments at n =
#: 97, m and n of 8 with k one past a skinny tile, m of 9 beside n of 8,
#: m of 33, one fragment of 131 by 129 over 660) and last k tiles that
#: end 1-3 short of their length beside odd rows (wide units over k = 125
#: and 94 in tiles of 32, a skinny unit over k = 127 in tiles of 128),
#: recorded from the card's output of the tiled kernel before its redesign
#: (commit 70a0267, `added`)
SQUARE = ((512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
          (128, 64), (41, 241), (64, 256), (16, 96), (3, 128), (66, 97),
          (66, 125))
RECT = ((41 * 73 * 73, 1, 5, 5), (190 * 36, 1, 5, 5), (190 * 36, 5, 1, 5),
        (190, 6, 660, 6), (20, 3, 330, 3), (190, 660, 6, 6),
        (3, 8, 129, 8), (2, 9, 130, 8), (5, 33, 97, 31), (1, 131, 660, 129),
        (66, 97, 94, 97), (3, 8, 127, 8))
#: (B, n) of the matvec alone: chip_smoke.MATVEC_SHAPES (the peptide's
#: 192 shells among them), and shapes whose operands its kernel stages an
#: element a copy (n = 11 and 97)
MATVEC = ((512, 12), (5985, 24), (64, 36), (16, 96), (3, 128), (64, 11),
          (8, 97), (41, 192))
#: (B, n) of the matvec on operands with a storage offset of one element
MATVEC_OFFSET = ((512, 12), (16, 96))
#: (B, nat) of `pair_bilinear` (D3's C6 from its R = 5 reference grids):
#: chip_smoke.PAIR_SHAPES (a 73-atom Hessian chunk, the w20 MBE(2)
#: dimers), an odd batch and width, a few atoms, one atom
PAIR = ((190, 6), (41, 73), (12, 23), (3, 7), (1, 1))
PAIR_R = 5
TRANS = ((False, False), (True, False), (False, True), (True, True))
DTYPES = ("f64", "f32")
ENTRIES = ("bmm", "sandwich", "matvec", "matvec_offset", "pair")
RECIPE = ("numpy.random.default_rng([SEED, entry index in ENTRIES, B, m, "
          "k, n, trans_a, trans_b, bits of the dtype]).standard_normal(shape)"
          " per input in the order listed, drawn in float64 and cast to the "
          "case's dtype; bmm: a stored (B, k, m) if trans_a else (B, m, k), "
          "b stored (B, n, k) if trans_b else (B, k, n); sandwich: x, f, s "
          "(B, n, n); matvec: mat (B, n, n) (trans_a: its transpose is "
          "applied), x (B, n); matvec_offset: mat (B n n + 1,) and x (B n "
          "+ 1,), passed as the views [1:] shaped (B, n, n) and (B, n); "
          "pair (shape (B, nat), no flags): w = rng.random((B, nat, 5)), "
          "w = w / w.sum(-1, keepdims=True), grids = rng.random((B, nat, "
          "nat, 5, 5)) * 40.0, in float64, then cast")


def cases():
    """Every case as (key, entry, dtype, (B, m, k, n), trans_a, trans_b)."""
    out = []
    for dtype in DTYPES:
        shapes = [((bsz, n, n, n), True) for bsz, n in SQUARE]
        shapes += [(shape, False) for shape in RECT]
        for shape, square in shapes:
            for ta, tb in TRANS:
                out.append(("bmm", dtype, shape, ta, tb))
            if square:
                out.append(("sandwich", dtype, shape, False, False))
                out.append(("matvec", dtype, shape, False, False))
                out.append(("matvec", dtype, shape, True, False))
        for entry, sizes in (("matvec", MATVEC),
                             ("matvec_offset", MATVEC_OFFSET)):
            for bsz, n in sizes:
                for ta in (False, True):
                    out.append((entry, dtype, (bsz, n, n, n), ta, False))
        out += [("pair", dtype, shape, False, False) for shape in PAIR]
    return [(key_of(*c), *c) for c in out]


def key_of(entry, dtype, shape, ta=False, tb=False) -> str:
    """entry/dtype/shape/flags; the pair contraction's without flags
    (pair/dtype/BxNAT)."""
    key = f"{entry}/{dtype}/{'x'.join(map(str, shape))}"
    if entry == "pair":
        return key
    return key + "/" + ("T" if ta else "N") + ("T" if tb else "N")


def input_shapes(entry, shape, ta, tb):
    if entry == "pair":
        bsz, nat = shape
        return [(bsz, nat, PAIR_R), (bsz, nat, nat, PAIR_R, PAIR_R)]
    bsz, m, k, n = shape
    if entry == "bmm":
        return [(bsz, *((k, m) if ta else (m, k))),
                (bsz, *((n, k) if tb else (k, n)))]
    if entry == "sandwich":
        return [(bsz, n, n)] * 3
    if entry == "matvec_offset":
        return [(bsz * n * n + 1,), (bsz * n + 1,)]
    return [(bsz, n, n), (bsz, n)]


def inputs(entry, dtype, shape, ta, tb):
    """The case's inputs as numpy arrays of its dtype (RECIPE)."""
    bits = 64 if dtype == "f64" else 32
    rng = np.random.default_rng(
        [SEED, ENTRIES.index(entry), *shape, int(ta), int(tb), bits])
    np_dtype = np.float64 if dtype == "f64" else np.float32
    if entry == "pair":
        w_shape, grid_shape = input_shapes(entry, shape, ta, tb)
        w = rng.random(w_shape)
        w = w / w.sum(-1, keepdims=True)
        grids = rng.random(grid_shape) * 40.0
        return [w.astype(np_dtype), grids.astype(np_dtype)]
    return [rng.standard_normal(s).astype(np_dtype)
            for s in input_shapes(entry, shape, ta, tb)]


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def run(fm, entry, args, ta, tb, shape):
    """The case's output on the card, through the wrapper's entry."""
    if entry == "bmm":
        _, m, _, n = shape
        if hasattr(fm, "takes") and not fm.takes(m, n):
            # a backward's form (CPCM's (points, nat) by (nat, nat)):
            # launched as the op's autograd Function launches it
            return fm._launch_bmm(args[0], args[1], ta, tb)
        return fm.fragment_bmm(args[0], args[1], ta, tb)
    if entry == "sandwich":
        return fm.sandwich(*args)
    if entry == "pair":
        return fm.pair_bilinear(*args)
    if entry == "matvec_offset":
        bsz, n = shape[0], shape[-1]
        return fm.fragment_matvec(args[0][1:].view(bsz, n, n),
                                  args[1][1:].view(bsz, n), ta)
    return fm.fragment_matvec(args[0], args[1], ta)


def fingerprints(fm, keys=None):
    """{key: {"inputs": [sha...], "output": sha}} of the kernel in module
    fm, every case (or those of `keys`)."""
    import torch

    out = {}
    for key, entry, dtype, shape, ta, tb in cases():
        if keys is not None and key not in keys:
            continue
        arrays = inputs(entry, dtype, shape, ta, tb)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        got = run(fm, entry, args, ta, tb, shape)
        out[key] = {"inputs": [digest(a) for a in arrays],
                    "output": digest(got.cpu().numpy())}
    return out


def load_fixture(path=FIXTURE) -> dict:
    with open(path) as fh:
        return json.load(fh)


def compare(fm, fixture: dict) -> list:
    """The keys whose output (or inputs) differ from the fixture's, and the
    cases it lacks."""
    want = fixture["cases"]
    got = fingerprints(fm)
    return sorted(k for k in got
                  if k not in want or got[k] != want[k])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", default=None,
                    help="record the fingerprints of the kernel first on "
                         "the path into this file")
    ap.add_argument("--add", default=None,
                    help="write the fixture with the cases it lacks "
                         "added, from the kernel first on the path, into "
                         "this file")
    ap.add_argument("--check", action="store_true",
                    help="compare this tree's kernel with the fixture")
    ap.add_argument("--fixture", default=FIXTURE)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gemm_bits: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from metalquicha_tpu_torch.ops import fragment_gemm as fm

    fm.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"gemm_bits: kernel of {fm.__file__} on {card}", flush=True)
    if args.write:
        doc = {"seed": SEED, "recipe": RECIPE, "module": os.path.relpath(
            fm.__file__, ROOT), "card": card,
            "cases": fingerprints(fm)}
        with open(args.write, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"gemm_bits: {len(doc['cases'])} cases written to "
              f"{args.write}", flush=True)
    if args.add:
        doc = load_fixture(args.fixture)
        lack = {c[0] for c in cases()} - set(doc["cases"])
        doc["cases"].update(fingerprints(fm, lack))
        doc["recipe"] = RECIPE
        doc.setdefault("added", []).append({
            "module": os.path.relpath(fm.__file__, ROOT), "card": card,
            "keys": sorted(lack)})
        with open(args.add, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"gemm_bits: {len(lack)} cases added into {args.add}",
              flush=True)
    if args.check:
        bad = compare(fm, load_fixture(args.fixture))
        print(json.dumps({"gemm_bits": {"cases": len(cases()),
                                        "differ": bad}}), flush=True)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
