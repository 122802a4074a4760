#!/usr/bin/env python3
"""A bit fingerprint of the fragment sums `moment_fock`, `moment_rows`,
`segment_sum` and `fragment_sum`.

The plain versions in the kernel's order (`ops/fragment_reduce.py`
`moment_fock_reference`, `moment_contract_reference`,
`moment_rows_reference`, `segment_sum_reference`), which the kernel
(`csrc/fragment_reduce.cu`) equals bit for bit on a card, in every form the
main path calls them in: moment_fock with the dipole and quadrupole
potentials (GFN2's Fock matrix) and with the dipoles alone, and its
contraction without the symmetrisation (`moment_contract`, d = 6: the
backward of moment_rows); moment_rows with one plane and a 0/1 mask (the
shell populations), with d = 3 and 6 into segments (GFN2's atomic
moments), without an index (the backward's rows), and with an unsorted
index; segment_sum of one value with a mask (the atomic charges), of 3 and
6, of n (take2's backward over an (n, n) table), and with an unsorted
index. At (B, n) = SHAPES in float64 and float32, on inputs made from a
seed with numpy (RECIPE). Each output's bytes are hashed (SHA-256), and so
are the inputs'. Under "row_sums": `row_sum_reference` (fragment_sum's
order: 32 lanes up to 4096 elements, 256 above, then halved pairwise) of
ROW_COUNT rows of each length in ROW_LENGTHS, float64 and float32, values
spread over 17 decades so another order rounds otherwise, the middle row
all -0.0 (its exact sum -0.0; the lanes' +0 make it +0.0) (ROW_RECIPE).

`--write F` records the fingerprints of the plain versions first on the
path (on the CPU): the fixture `tests/data/fragment_reduce_bits.json` was
written from the commit before the kernel's redesign (a35780e, unpacked
with `git archive` into the gitignored `_archive/` and put first on
PYTHONPATH); its "row_sums" from the commit before fragment_sum's
redesign (d37ed60) by `--add F`, which writes the fixture with the cases
and row sums it lacks added from the plain versions first on the path;
the moment_fock and moment_contract cases so from the commit before their
kernel's redesign (759462b). `--check`
recomputes every case and compares: with `--device cuda`, through the ops
on a card, so the kernel's bits against the plain versions' of those
commits.

Usage: python3 tools/reduce_bits_torch.py [--write F | --add F | --check]
           [--device cpu|cuda] [--fixture F]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)
FIXTURE = os.path.join(ROOT, "tests", "data", "fragment_reduce_bits.json")

SEED = 18
SHAPES = ((4, 16), (2, 48), (1, 97))
DTYPES = ("f64", "f32")
#: form -> (entry, operand, index, weights): moment_rows of a with m's
#: first d planes ("m1", "m3", "m6"), segment_sum of v's first c columns
#: ("v1" a (B, n) vector, "v3", "v6") or of a itself ("a": c = n);
#: moment_fock of f = a with v1 = v[..., :3], m1 = m[:, :3] and, "dq", v2
#: = v, m2 = m ("d": without); moment_contract of v and m (d = 6)
FORMS = {
    "fock_dq": ("moment_fock", "dq", None, None),
    "fock_d": ("moment_fock", "d", None, None),
    "contract_d6": ("moment_contract", "m6", None, None),
    "rows_d1_mask": ("moment_rows", "m1", "idx", "mask"),
    "rows_d3": ("moment_rows", "m3", "idx", None),
    "rows_d6": ("moment_rows", "m6", "idx", None),
    "rows_d3_no_index": ("moment_rows", "m3", None, None),
    "rows_d6_no_index": ("moment_rows", "m6", None, None),
    "rows_d3_unsorted": ("moment_rows", "m3", "mixed", None),
    "seg_c1_mask": ("segment_sum", "v1", "idx", "mask"),
    "seg_c3": ("segment_sum", "v3", "idx", None),
    "seg_c6": ("segment_sum", "v6", "idx", None),
    "seg_cn": ("segment_sum", "a", "idx", None),
    "seg_c3_unsorted": ("segment_sum", "v3", "mixed", None),
}
INPUTS = ("a", "m", "v", "idx", "mixed", "mask")
RECIPE = ("per (B, n) and dtype, rng = numpy.random.default_rng([SEED, B, "
          "n, bits of the dtype]); in this order: a = rng.standard_normal((B,"
          " n, n)), m = rng.standard_normal((B, 6, n, n)), v = "
          "rng.standard_normal((B, n, 6)), each drawn in float64 and cast; "
          "idx = sort(rng.integers(0, max(1, n // 3), (B, n)), axis=1) "
          "(int64); mixed = take_along_axis(idx, argsort(rng.random((B, n)), "
          "axis=1), axis=1); mask = (rng.random((B, n)) < 0.9) in the dtype; "
          "size = max(1, n // 3)")
#: fragment_sum's rows: a few shells, a warp's row, the dodecamers' 96
#: AOs, the warp's longest row and one past it (256 lanes), GFN2's (6, n,
#: n) at 96 AOs
ROW_LENGTHS = (11, 16, 32, 96, 4096, 4097, 55296)
ROW_COUNT = 3
ROW_RECIPE = ("per length and dtype, rng = numpy.random.default_rng([SEED, "
              "1, length, bits of the dtype]); x = rng.standard_normal("
              "(ROW_COUNT, length)) * 10.0 ** rng.integers(-8, 9, "
              "(ROW_COUNT, length)), drawn in float64 and cast; then x[1] "
              "= -0.0")


def cases():
    """Every case as (key, form, dtype, (B, n))."""
    return [(key_of(form, dtype, shape), form, dtype, shape)
            for dtype in DTYPES for shape in SHAPES for form in FORMS]


def key_of(form, dtype, shape) -> str:
    return f"{form}/{dtype}/{'x'.join(map(str, shape))}"


def inputs(dtype, shape) -> dict:
    """The inputs of every case at (B, n) and dtype, as numpy arrays
    (RECIPE)."""
    bsz, n = shape
    bits = 64 if dtype == "f64" else 32
    np_dtype = np.float64 if dtype == "f64" else np.float32
    rng = np.random.default_rng([SEED, bsz, n, bits])
    out = {"a": rng.standard_normal((bsz, n, n)).astype(np_dtype),
           "m": rng.standard_normal((bsz, 6, n, n)).astype(np_dtype),
           "v": rng.standard_normal((bsz, n, 6)).astype(np_dtype)}
    idx = np.sort(rng.integers(0, max(1, n // 3), (bsz, n)), axis=1)
    out["idx"] = idx.astype(np.int64)
    out["mixed"] = np.take_along_axis(
        idx, np.argsort(rng.random((bsz, n)), axis=1), axis=1).astype(
            np.int64)
    out["mask"] = (rng.random((bsz, n)) < 0.9).astype(np_dtype)
    return out


def row_key(dtype, length) -> str:
    return f"row_sum/{dtype}/{length}"


def row_cases():
    """Every row sum case as (key, dtype, length)."""
    return [(row_key(dtype, length), dtype, length)
            for dtype in DTYPES for length in ROW_LENGTHS]


def row_inputs(dtype, length):
    """The rows of a row sum case as a numpy array (ROW_RECIPE)."""
    bits = 64 if dtype == "f64" else 32
    rng = np.random.default_rng([SEED, 1, length, bits])
    x = rng.standard_normal((ROW_COUNT, length)) * 10.0 ** rng.integers(
        -8, 9, (ROW_COUNT, length))
    x = x.astype(np.float64 if dtype == "f64" else np.float32)
    x[1] = -0.0
    return x


def row_fingerprints(fr, device="cpu", plain=True, keys=None) -> dict:
    """{"inputs": {key: sha}, "cases": {key: sha of the sums}} of module
    fr's `row_sum_reference` (or `fragment_sum`, on a card the kernel),
    every row sum case (or those of `keys`)."""
    import torch

    out = {"inputs": {}, "cases": {}}
    for key, dtype, length in row_cases():
        if keys is not None and key not in keys:
            continue
        x = row_inputs(dtype, length)
        t = torch.from_numpy(x).to(device)
        got = fr.row_sum_reference(t) if plain else fr.fragment_sum(t)
        out["inputs"][key] = digest(x)
        out["cases"][key] = digest(got.cpu().contiguous().numpy())
    return out


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def run(fr, form, arrays, device="cpu", plain=True):
    """The case's output: the plain version (plain) or the op (a CUDA
    tensor goes to the kernel) of module fr, on `device`."""
    import torch

    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    entry, operand, index, weights = FORMS[form]
    if entry == "moment_fock":
        args = (t["a"], t["v"][..., :3], t["m"][:, :3])
        if operand == "dq":
            args += (t["v"], t["m"])
        fn = fr.moment_fock_reference if plain else fr.moment_fock
        return fn(*args)
    if entry == "moment_contract":
        # the op is the Function moment_rows' backward calls
        fn = fr.moment_contract_reference if plain else fr._Contract.apply
        return fn(t["v"], t["m"])
    size = max(1, arrays["a"].shape[-1] // 3)
    idx = None if index is None else t[index]
    w = None if weights is None else t[weights]
    if entry == "moment_rows":
        m = t["m"][:, :int(operand[1:])]
        fn = fr.moment_rows_reference if plain else fr.moment_rows
        return fn(t["a"], m, idx, None if idx is None else size, w)
    vals = {"v1": t["v"][..., 0], "v3": t["v"][..., :3], "v6": t["v"],
            "a": t["a"]}[operand]
    fn = fr.segment_sum_reference if plain else fr.segment_sum
    return fn(vals, idx, size, w)


def fingerprints(fr, device="cpu", plain=True, keys=None) -> dict:
    """{"inputs": {dtype/BxN: [sha of each of INPUTS]}, "cases": {key: sha
    of the output}} of module fr's plain versions (or ops), every case (or
    those of `keys`)."""
    out = {"inputs": {}, "cases": {}}
    for dtype in DTYPES:
        for shape in SHAPES:
            arrays = inputs(dtype, shape)
            out["inputs"][f"{dtype}/{'x'.join(map(str, shape))}"] = [
                digest(arrays[k]) for k in INPUTS]
            for form in FORMS:
                if keys is not None and key_of(form, dtype, shape) not in keys:
                    continue
                got = run(fr, form, arrays, device, plain)
                out["cases"][key_of(form, dtype, shape)] = digest(
                    got.cpu().contiguous().numpy())
    return out


def load_fixture(path=FIXTURE) -> dict:
    with open(path) as fh:
        return json.load(fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", default=None,
                    help="record the plain versions' fingerprints here")
    ap.add_argument("--add", default=None,
                    help="write the fixture with the cases and row sums "
                         "it lacks added from the plain versions first on "
                         "the path into this file")
    ap.add_argument("--check", action="store_true",
                    help="compare with the fixture")
    ap.add_argument("--device", default="cpu",
                    help="cuda: the ops (the kernel) on a card")
    ap.add_argument("--fixture", default=FIXTURE)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    from metalquicha_tpu_torch.ops import fragment_reduce as fr

    if args.write:
        doc = {"seed": SEED, "recipe": RECIPE, "inputs_order": list(INPUTS),
               "module": os.path.relpath(fr.__file__, ROOT),
               **fingerprints(fr),
               "row_sums": {"recipe": ROW_RECIPE,
                            "module": os.path.relpath(fr.__file__, ROOT),
                            **row_fingerprints(fr)}}
        with open(args.write, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"reduce_bits: {len(doc['cases'])} cases of {fr.__file__} "
              f"written to {args.write}", flush=True)
    if args.add:
        doc = load_fixture(args.fixture)
        lack = {c[0] for c in cases()} - set(doc["cases"])
        doc["cases"].update(fingerprints(fr, keys=lack)["cases"])
        if lack:
            doc.setdefault("added", []).append({
                "module": os.path.relpath(fr.__file__, ROOT),
                "keys": sorted(lack)})
        print(f"reduce_bits: {len(lack)} cases of {fr.__file__} added",
              flush=True)
        rows = doc.setdefault("row_sums", {"recipe": ROW_RECIPE,
                                           "module": os.path.relpath(
                                               fr.__file__, ROOT),
                                           "inputs": {}, "cases": {}})
        lack = {c[0] for c in row_cases()} - set(rows["cases"])
        new = row_fingerprints(fr, keys=lack)
        rows["inputs"].update(new["inputs"])
        rows["cases"].update(new["cases"])
        with open(args.add, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"reduce_bits: {len(lack)} row sums of {fr.__file__} added "
              f"into {args.add}", flush=True)
    if args.check:
        if args.device != "cpu" and not torch.cuda.is_available():
            print("reduce_bits: CUDA is not available", file=sys.stderr)
            return 1
        want = load_fixture(args.fixture)
        got = fingerprints(fr, args.device, plain=args.device == "cpu")
        bad = sorted(k for k in got["cases"]
                     if got["cases"][k] != want["cases"].get(k))
        bad += sorted(k for k in got["inputs"]
                      if got["inputs"][k] != want["inputs"].get(k))
        rows = row_fingerprints(fr, args.device, plain=args.device == "cpu")
        want_rows = want.get("row_sums", {"inputs": {}, "cases": {}})
        bad += sorted(k for k in rows["cases"]
                      if rows["cases"][k] != want_rows["cases"].get(k)
                      or rows["inputs"][k] != want_rows["inputs"].get(k))
        print(json.dumps({"reduce_bits": {"device": args.device,
                                          "cases": len(got["cases"])
                                          + len(rows["cases"]),
                                          "differ": bad}}), flush=True)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
