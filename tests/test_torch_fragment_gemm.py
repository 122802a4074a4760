"""The batch-invariant product kernel (`ops/fragment_gemm.py`): its plain
versions, its gradients, its dispatch, and the engine's products through it.

On the CPU:
- `fragment_bmm_reference` (the kernel's order, ascending k, in
  elementwise ops) and the ops' plain versions against torch.matmul, with
  every transpose, and against the JAX package's `_ortho_factors` and
  `_general_eigh` on seeded inputs (float64 1e-13, float32 1e-5,
  relative to the largest entry);
- `pair_bilinear` (D3's C6 contraction) on the CPU: the two einsums bit
  for bit, and the pair kernel's arithmetic (`pair_bilinear_reference`,
  its FMAs emulated exactly by `fma_reference`) within tolerance of them
  and of the JAX package's `c6_coefficients`; that plain version bit for
  bit the fingerprint of the contraction's card output before its kernel
  (commit 759462b; the fixture's pair cases); its Function's gradients
  (gradcheck and gradgradcheck in w and the grids); on a card one launch
  of its kernel with the operands as the C entry takes them;
- the autograd Functions with the launchers monkeypatched to the plain
  versions: gradcheck and gradgradcheck in float64;
- the engine sends every product of a GFN1 SCC iteration (the Fock
  transforms, the Coulomb matvec), of its orthogonalizers and of the
  functional through the op, fragments of 72 and 144 AOs too (the
  kernel's tiled class up to MAX_N = 256, k of any length), GFN2's refine
  density and CPCM's (nat, points) by (points, nat); above MAX_N, and for
  GFN2's multipole products, it does not; above 64 the sandwich is two
  product launches and an add; on a card m or n above MAX_N raises;
- the plain versions above 128 (the peptide's 241, two bands of columns,
  CPCM's k of 660 points and its backward's m) against torch.matmul, and
  against the JAX package's `_general_eigh` at n = 160;
- the dispatch: a CPU tensor never builds the kernel, another device
  raises, a CUDA tensor goes to the launch, a failed launch raises
  uncounted; a launch from another thread on a captured stream (a
  backward pass) counted per replay, and by kind (direct, or the size
  class); the ctypes declarations against the C signatures;
- what the wrapper hands the C entry (a launcher recording its
  arguments): every operand as it lies (a view with a storage offset with
  its own address, never copied; a transposed view as it is stored, its
  flag flipped), at n = 11, 16, 20, 32 and 64;
- a plain-Python model of the kernel's persistent walk over (fragment,
  row band, column band) units and its ring (two stages in f32, one in
  f64 up to 64; above, the tiled class's plan by shape and batch and its
  ring of two or three stages), with the band heights and widths read from the
  source: every unit once, its k tiles in ascending order, every output
  element of every fragment once, for every grid of 1 to 2 x 132 blocks;
  the plan's choice at the main path's shapes and at its boundaries;
- the bit fingerprint of the kernel's first version (commit df9980a;
  `tests/data/
  fragment_gemm_bits.json`, `tools/gemm_bits_torch.py`) covers every
  shape, dtype and entry of `chip_smoke.py`'s gemm phase, and its recipe
  remakes the inputs it hashed.
The `gpu` cases hold the kernel to both plain versions on the card at the
main path's shapes, square and rectangular (D3's (1, R) by (R, R) and its
backward's forms, CPCM's), up to 256 in two bands of columns, the pair
kernel bit for bit to its plain version, and check that a fragment's bits
do not depend on its batch, SP2's density's too (`python3 -m pytest
--noconftest tests/test_torch_fragment_gemm.py -m gpu`).
"""

import collections
import itertools
import math
import os
import re
import sys
import threading
import types

import numpy as np
import pytest
import torch
from _torch_port_common import H3O, WATER

from metalquicha_tpu_torch.constants import KB_HARTREE
from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.ops import fragment_gemm as fm

torch.set_num_threads(1)
KT = 300.0 * KB_HARTREE
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
TRANS = [(False, False), (True, False), (False, True), (True, True)]


def _mats(shape, dtype=torch.float64, seed=0, n=2):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype)
            for _ in range(n)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _op(t, trans):
    return t.transpose(-1, -2) if trans else t


def _bits_tool():
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import gemm_bits_torch

    return gemm_bits_torch


def _operands(bsz, m, k, n, trans, dtype=torch.float64, seed=0, lead=()):
    """a, b whose op(a) is (m, k) and op(b) is (k, n)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((*lead, bsz, *((k, m) if trans[0] else (m, k))))
    b = rng.standard_normal((*lead, bsz, *((n, k) if trans[1] else (k, n))))
    return (torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype))


#: (m, k, n) of the products: a square, D3's (1, R) by (R, R) and the two
#: products of its backward pass, one of each size class; above 128 (the
#: tiled class in bands of rows and columns, k in tiles at any length):
#: the peptide's 241, n = 129 in two bands of columns, CPCM's (nat,
#: points) by (points, nat) at the w20 dimers and its backward's (points,
#: nat) by (nat, nat), a long k beside both bands of columns
RECT = [(11, 11, 11), (1, 5, 5), (5, 1, 5), (30, 7, 19), (64, 3, 40),
        (241, 241, 241), (256, 40, 129), (6, 660, 6), (660, 6, 6),
        (131, 660, 256)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("trans", TRANS)
@pytest.mark.parametrize("mkn", RECT)
def test_reference_matches_matmul(mkn, trans, dtype):
    a, b = _operands(6, *mkn, trans, dtype)
    want = torch.matmul(_op(a, trans[0]), _op(b, trans[1]))
    assert _rel(fm.fragment_bmm_reference(a, b, *trans), want) <= TOL[dtype]
    assert torch.equal(fm.fragment_bmm(a, b, *trans), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [192, 241, 256])
def test_sandwich_and_matvec_plain_versions_above_128(n, dtype):
    """The sandwich and the matvec at the sizes above 128 that the kernel
    now takes (the peptide's 192 shells and 241 AOs, SP2's 256): the ops
    on the CPU the torch expressions bit for bit, the kernel's order
    within tolerance of them."""
    x, f, s = _mats((2, n, n), dtype, seed=n, n=3)
    want = x @ f @ x + s
    assert torch.equal(fm.sandwich(x, f, s), want)
    kernel_order = fm.fragment_bmm_reference(
        fm.fragment_bmm_reference(x, f), x) + s
    assert _rel(kernel_order, want) <= TOL[dtype]
    v = f[:, :, 0]
    for trans in (False, True):
        ref = (_op(x, trans) @ v[..., None])[..., 0]
        assert torch.equal(fm.fragment_matvec(x, v, trans), ref)
        assert _rel(fm.matvec_reference(x, v, trans), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sandwich_and_matvec_plain_versions(dtype):
    x, f, s = _mats((5, 16, 16), dtype, n=3)
    want = x @ f @ x + s
    assert torch.equal(fm.sandwich(x, f, s), want)
    kernel_order = fm.fragment_bmm_reference(
        fm.fragment_bmm_reference(x, f), x) + s
    assert _rel(kernel_order, want) <= TOL[dtype]
    v = f[:, :, 0]
    for trans in (False, True):
        ref = (_op(x, trans) @ v[..., None])[..., 0]
        assert torch.equal(fm.fragment_matvec(x, v, trans), ref)
        assert _rel(fm.matvec_reference(x, v, trans), ref) <= TOL[dtype]


def _pair_inputs(bsz, nat, dtype=torch.float64, seed=3, device="cpu"):
    rng = np.random.default_rng(seed)
    w = rng.random((bsz, nat, 5))
    w = w / w.sum(-1, keepdims=True)
    grids = rng.random((bsz, nat, nat, 5, 5)) * 40.0
    return (torch.tensor(w, dtype=dtype, device=device),
            torch.tensor(grids, dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_bilinear_plain_versions(dtype):
    """On the CPU the two einsums D3 ran before, bit for bit; the pair
    kernel's arithmetic agrees within tolerance."""
    w, grids = _pair_inputs(3, 7, dtype)
    v = torch.einsum("bia,bijac->bijc", w, grids)
    want = torch.einsum("bijc,bjc->bij", v, w)
    assert torch.equal(fm.pair_bilinear(w, grids), want)
    assert _rel(fm.pair_bilinear_reference(w, grids), want) <= TOL[dtype]


def test_fma_reference_rounds_once():
    """`fma_reference` is a b + c rounded once: against the exact value
    (fractions) on seeded operands, cancellation and signed zeros among
    them, float64 and float32."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    n = 3000
    for dtype, npd in ((torch.float64, np.float64),
                       (torch.float32, np.float32)):
        a = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
             ).astype(npd)
        b = rng.standard_normal(n).astype(npd)
        c = (rng.standard_normal(n) * 10.0 ** rng.integers(-12, 4, n)
             ).astype(npd)
        # a third nearly cancels, a few are exact zeros of either sign
        k = n // 3
        c[:k] = (-(a[:k].astype(np.float64) * b[:k]) * (
            1.0 + rng.standard_normal(k) * 1e-6)).astype(npd)
        a[k:k + 4] = 0.0
        c[k:k + 4] = (-0.0, 0.0, -0.0, 0.0)
        b[k:k + 4] = (-1.0, -1.0, 1.0, 1.0)
        got = fm.fma_reference(*(torch.from_numpy(x) for x in (a, b, c)))
        for i in range(n):
            exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
                float(c[i]))
            lo = npd(float(exact))
            # the nearest of the dtype, ties to even
            cands = sorted({np.nextafter(lo, npd(-np.inf)), lo,
                            np.nextafter(lo, npd(np.inf))},
                           key=lambda q: (abs(Fraction(float(q)) - exact),
                                          int(q.view(np.uint64 if npd is
                                                     np.float64 else
                                                     np.uint32)) & 1))
            want = cands[0]
            if exact == 0:
                # a b + c of zeros keeps -0 only where both are -0
                want = npd(float(a[i]) * float(b[i]) + float(c[i]))
            assert got[i].item() == float(want), (i, a[i], b[i], c[i])
            assert bool(torch.signbit(got[i])) == bool(np.signbit(want)), i


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nat", [6, 23])
def test_pair_bilinear_matches_jax_c6(nat, dtype):
    """The pair kernel's arithmetic (`pair_bilinear_reference`) and the
    CPU's einsums against the JAX package's `c6_coefficients` without the
    geometric-mean atoms (sqrtc6=None: the pair contraction alone), on
    seeded weights from its `ref_weights` and a seeded table of 4
    elements (float64 1e-12, float32 1e-5, relative to the largest
    entry)."""
    # imported here: the file's `gpu` cases run where jax is not installed
    from metalquicha_tpu.methods.xtb import dispersion_d3 as jd3

    rng = np.random.default_rng(nat)
    npd = _jax_np(dtype)
    r, nz = 5, 4
    cn = rng.uniform(0.0, 4.0, nat).astype(npd)
    ref_cn = rng.uniform(0.0, 4.0, (nat, r)).astype(npd)
    zidx = rng.integers(0, nz, nat)
    table = (rng.random((nz, nz, r, r)) * 40.0).astype(npd)
    want = np.asarray(jd3.c6_coefficients(cn, ref_cn, zidx, table))
    w = torch.tensor(np.asarray(jd3.ref_weights(cn, ref_cn)))[None]
    grids = torch.tensor(table[zidx[:, None], zidx[None, :]])[None]
    assert w.dtype == grids.dtype == dtype
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    want = torch.tensor(want)[None]
    assert _rel(fm.pair_bilinear_reference(w, grids), want) <= tol
    assert _rel(fm.pair_bilinear(w, grids), want) <= tol


def _pair_cases():
    return [c for c in _bits_tool().cases() if c[1] == "pair"]


@pytest.mark.parametrize("key, entry, dtype, shape, ta, tb", _pair_cases(),
                         ids=[c[0] for c in _pair_cases()])
def test_pair_bilinear_reference_matches_the_card_fingerprint(
        key, entry, dtype, shape, ta, tb):
    """`pair_bilinear_reference` on the CPU is bit for bit the pair
    contraction's card output before its kernel (commit 759462b: the
    direct kernel's FMAs, torch's multiply and torch's sum over R), as the
    fixture's pair cases hold it, at every recorded shape and dtype."""
    bits = _bits_tool()
    arrays = bits.inputs(entry, dtype, shape, ta, tb)
    got = fm.pair_bilinear_reference(*(torch.from_numpy(a) for a in arrays))
    assert got.shape == shape + shape[1:]
    assert bits.digest(got.numpy()) == (
        bits.load_fixture()["cases"][key]["output"])


def _jax_np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _against_jax_general_eigh(dtype, bsz, n, seed, scale, columns=True):
    """The orthogonalizer and the generalized eigenproblem built from the
    kernel's order (`fragment_bmm_reference`) against the JAX package's
    `_ortho_factors` and `_general_eigh` under vmap, on a seeded batch
    (S's off-diagonal part scaled by `scale`). The eigenvectors column by
    column up to sign where `columns`, else through C diag(eps) C^T, which
    holds every product's error but neither eigensolver's gauge nor its
    own eigenvector error (eps |A| / gap, 1e-13 and more at n = 160)."""
    # imported here: the file's `gpu` cases run where jax is not installed
    import jax

    from metalquicha_tpu.methods.xtb import engine as je

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((bsz, n, n)) * scale
    S = np.eye(n) + a + a.transpose(0, 2, 1)
    F = rng.standard_normal((bsz, n, n))
    F = F + F.transpose(0, 2, 1) + np.diag(np.arange(n, dtype=float) * 2.0)
    npd = _jax_np(dtype)
    xs_j, proj_j = jax.vmap(je._ortho_factors)(S.astype(npd))
    eps_j, c_j = jax.vmap(je._general_eigh)(
        F.astype(npd), (xs_j, proj_j))

    St, Ft = (torch.tensor(t, dtype=dtype) for t in (S, F))
    s, U = torch.linalg.eigh(St)
    keep = (s > 1e-7).to(dtype)
    w = torch.where(s > 1e-7, torch.rsqrt(torch.clamp(s, min=1e-7)), 0.0)
    xs = fm.fragment_bmm_reference(U * w[:, None, :], U, trans_b=True)
    proj = torch.eye(n, dtype=dtype) - fm.fragment_bmm_reference(
        U * keep[:, None, :], U, trans_b=True)
    assert _rel(xs, torch.tensor(np.asarray(xs_j))) <= TOL[dtype]
    assert float(proj.abs().max()) <= TOL[dtype]
    a_ref = fm.fragment_bmm_reference(
        fm.fragment_bmm_reference(xs, Ft), xs) + te.PAD_LEVEL * proj
    eps, cp = torch.linalg.eigh(a_ref)
    c = fm.fragment_bmm_reference(xs, cp)
    assert _rel(eps, torch.tensor(np.asarray(eps_j))) <= TOL[dtype]
    # eigenvectors up to each column's sign, in float64 (in float32 they
    # carry the eigh's own error, eps |A| / gap, about 1e-5 here)
    c_j = torch.tensor(np.asarray(c_j))
    if dtype == torch.float64 and columns:
        sign = torch.sign((c * c_j).sum(-2, keepdim=True))
        assert _rel(c * sign, c_j) <= TOL[dtype]
    elif not columns:
        eps_j = torch.tensor(np.asarray(eps_j))
        assert _rel(
            fm.fragment_bmm_reference(c * eps[:, None, :], c, trans_b=True),
            c_j * eps_j[:, None, :] @ c_j.transpose(-1, -2)) <= TOL[dtype]
    # and the port's own engine functions on the plain route
    xs_p, proj_p = te._ortho_factors(St)
    assert _rel(xs_p, xs) <= TOL[dtype]
    eps_p, _ = te._general_eigh(Ft, (xs_p, proj_p))
    assert _rel(eps_p, eps) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_versions_match_jax_ortho_and_general_eigh(dtype):
    """The orthogonalizer and the generalized eigenproblem built from the
    kernel's order (`fragment_bmm_reference`) against the JAX package's
    `_ortho_factors` and `_general_eigh` under vmap."""
    _against_jax_general_eigh(dtype, 4, 12, seed=7, scale=0.05)


def test_plain_versions_match_jax_general_eigh_above_128():
    """The same at n = 160, a size the kernel takes in two bands of
    columns with k in five tiles (float64 1e-13), the eigenvectors through
    C diag(eps) C^T."""
    _against_jax_general_eigh(torch.float64, 2, 160, seed=160, scale=0.01,
                              columns=False)


@pytest.fixture
def plain_launchers(monkeypatch):
    """The Functions' launches sent to the plain versions on the CPU."""
    monkeypatch.setattr(fm, "_launch_bmm", fm.fragment_bmm_reference)
    monkeypatch.setattr(fm, "_launch_pair", fm.pair_bilinear_reference)
    monkeypatch.setattr(
        fm, "_launch_sandwich", lambda x, f, s: fm.fragment_bmm_reference(
            fm.fragment_bmm_reference(x, f), x) + s)
    monkeypatch.setattr(fm, "_launch_matvec", fm.matvec_reference)


@pytest.mark.parametrize("trans", TRANS)
def test_bmm_gradients(plain_launchers, trans):
    a = _mats((2, 4, 3) if trans[0] else (2, 3, 4), seed=1)[0]
    b = _mats((2, 5, 4) if trans[1] else (2, 4, 5), seed=2)[0]
    a.requires_grad_()
    b.requires_grad_()

    def fn(a, b):
        return fm._Bmm.apply(a, b, *trans)

    assert torch.autograd.gradcheck(fn, (a, b))
    assert torch.autograd.gradgradcheck(fn, (a, b))


def test_sandwich_gradients(plain_launchers):
    x, f, s = (t.requires_grad_() for t in _mats((2, 4, 4), seed=4, n=3))
    assert torch.autograd.gradcheck(fm._Sandwich.apply, (x, f, s))
    assert torch.autograd.gradgradcheck(fm._Sandwich.apply, (x, f, s))


@pytest.mark.parametrize("trans", [False, True])
def test_matvec_gradients(plain_launchers, trans):
    m = _mats((3, 4, 5), seed=5)[0].requires_grad_()
    x = _mats((3, 4 if trans else 5), seed=6)[0].requires_grad_()

    def fn(m, x):
        return fm._Matvec.apply(m, x, trans)

    assert torch.autograd.gradcheck(fn, (m, x))
    assert torch.autograd.gradgradcheck(fn, (m, x))


@pytest.mark.parametrize("needs", ["w", "grids", "both"])
def test_pair_bilinear_gradients(plain_launchers, needs):
    """The pair contraction's Function in w and in the grids, its backward
    built of the products, `fragment_sum`, `broadcast` and elementwise
    products (on the CPU their torch forms)."""
    w, grids = _pair_inputs(2, 3, seed=8)
    w.requires_grad_(needs in ("w", "both"))
    grids.requires_grad_(needs in ("grids", "both"))
    assert torch.autograd.gradcheck(fm._PairBilinear.apply, (w, grids))
    assert torch.autograd.gradgradcheck(fm._PairBilinear.apply, (w, grids))


def test_pair_bilinear_on_a_card_is_one_launch(monkeypatch):
    """On a card the op is the Function, whose forward is one launch of
    the pair kernel (never the einsums): the wrapper hands the C entry w,
    the grids as they lie contiguous, the output and (B, nat, R), and
    counts one launch of its own kind."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fm, "_device", lambda *t: "cuda")
    monkeypatch.setattr(fm, "_fn", lambda name, dtype: entry)
    monkeypatch.setattr(fm, "_stream", lambda t: (0, 5))
    monkeypatch.setattr(torch, "einsum", None)
    w, grids = _pair_inputs(3, 4)
    before = dict(fm.launches_by_kind)
    out = fm.pair_bilinear(w, grids)
    assert out.shape == (3, 4, 4) and len(calls) == 1
    args = calls[0]
    assert args[:2] == (w.data_ptr(), grids.data_ptr())
    assert args[2] == out.data_ptr() and args[3:] == (3, 4, 5, 0, 5)
    kind = fm.kind_of("pair_bilinear", 5)
    assert fm.launches_by_kind[kind] == before.get(kind, 0) + 1
    assert fm.kind_name(kind) == "pair_bilinear"
    with pytest.raises(ValueError, match="PAIR_R"):
        fm.pair_bilinear(w[:1, :2], grids[:1, :3, :3])
    with pytest.raises(ValueError, match="PAIR_R"):
        fm.pair_bilinear(w[..., :4], grids[..., :4, :4])


@pytest.fixture
def counted(monkeypatch):
    """Calls of the engine's kernel ops by name."""
    calls = {}
    for name in ("fragment_bmm", "sandwich", "fragment_matvec"):
        real = getattr(te, name)

        def count(*args, _name=name, _real=real, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kw)

        monkeypatch.setattr(te, name, count)
    return calls


def _per_iteration(calls, frag, settings):
    """Each op's calls in one SCC iteration (3 iterations less 1)."""
    counts = []
    for n_iter in (1, 3):
        calls.clear()
        tcalc._converge_charges(frag.coords, frag, KT,
                                settings._replace(max_scf_iter=n_iter))
        counts.append(dict(calls))
    return {k: (counts[1].get(k, 0) - counts[0].get(k, 0)) // 2
            for k in set(counts[0]) | set(counts[1])}


def test_engine_products_go_through_the_op(counted):
    calc = tcalc.XtbCalculator(tsp("gfn1"), device="cpu")
    frag = calc.make_batch([WATER, H3O])
    exact = _per_iteration(counted, frag, tsp("gfn1"))
    # the Fock transform, C = Xs Cp and the Coulomb matvec
    assert exact == {"sandwich": 1, "fragment_bmm": 1, "fragment_matvec": 1}
    counted.clear()
    te._ortho_factors(torch.eye(8, dtype=torch.float64).expand(2, 8, 8))
    assert counted == {"fragment_bmm": 2}
    counted.clear()
    te._jacobi_route(torch.eye(8, dtype=torch.float32).expand(2, 8, 8))
    assert counted == {"fragment_bmm": 2}

    fast = tsp("gfn1", use_pallas_eigh=True)
    calc32 = tcalc.XtbCalculator(fast, dtype=torch.float32, device="cpu")
    frag32 = calc32.make_batch([WATER, H3O])
    jacobi = _per_iteration(counted, frag32, fast)
    assert jacobi["sandwich"] == 1 and jacobi["fragment_bmm"] == 1

    counted.clear()
    with torch.no_grad():
        q, _ = tcalc._converge_charges(frag.coords, frag, KT, tsp("gfn1"))
    counted.clear()
    te.electronic_energy(frag.coords, q, frag, KT, tsp("gfn1"))
    # the orthogonalizer's two products, the transform and C; a matvec in
    # the Fock matrix's potential, the band energy's potential and the
    # Coulomb energy
    assert counted == {"fragment_bmm": 3, "sandwich": 1,
                       "fragment_matvec": 3}
    counted.clear()
    te.scf_refine(*(tcalc._scc_operands(frag.coords, frag, tsp("gfn1"))[k]
                    for k in (1, 0, 2)), frag, KT, tsp("gfn1"), q, 1)
    # two in the orthogonalizer, the transform's C and the density
    assert counted["fragment_bmm"] == 4 and counted["sandwich"] == 1


def _water_ring(k):
    return [(np.tile(WATER[0], k),
             np.concatenate([WATER[1] + np.array([6.0 * i, 0.0, 0.0])
                             for i in range(k)]), 0, 1)]


def test_large_fragments_and_gfn2_multipoles_stay_on_matmul(counted):
    """A 24-water ring (144 AOs and shells, above 128) takes the op's
    products as the smaller ones do (the kernel's tiled class up to MAX_N
    = 256, rows and columns in bands); a 44-water ring (264 AOs and
    shells, above MAX_N) stays on torch.matmul, as the JAX package leaves
    every product to XLA; GFN2's moment products are not the op's."""
    calc = tcalc.XtbCalculator(tsp("gfn1"), device="cpu")
    frag = calc.make_batch(_water_ring(24))
    assert 128 < frag.ao_mask.shape[1] <= fm.MAX_N
    assert 128 < frag.sh_mask.shape[1] <= fm.MAX_N
    # the Fock transform, C = Xs Cp, the density and the Coulomb matvec
    assert _per_iteration(counted, frag, tsp("gfn1")) == {
        "sandwich": 1, "fragment_bmm": 2, "fragment_matvec": 1}
    frag = calc.make_batch(_water_ring(44))
    assert frag.ao_mask.shape[1] > fm.MAX_N
    assert frag.sh_mask.shape[1] > fm.MAX_N
    assert _per_iteration(counted, frag, tsp("gfn1")) == {}
    gfn2 = tsp("gfn2")
    calc2 = tcalc.XtbCalculator(gfn2, variant="gfn2", device="cpu")
    frag2 = calc2.make_batch([WATER, H3O])
    per = _per_iteration(counted, frag2, gfn2)
    # the Fock transform and C only: the moments' products stay einsums
    assert per["sandwich"] == 1 and per["fragment_bmm"] == 1


def test_engine_takes_the_op_by_the_output_shape(counted):
    """`_mm`, `_sandwich` and `_matvec` go to the op where the output's m
    and n are up to MAX_N, whatever k (CPCM's points), and to torch above
    it, with torch's bits on the CPU either way."""
    a, b = _operands(2, 6, 660, 6, (True, False))
    want = torch.matmul(a.transpose(-1, -2), b)
    assert torch.equal(te._mm(a, b, trans_a=True), want)
    assert counted == {"fragment_bmm": 1}
    counted.clear()
    n = fm.MAX_N + 1
    x, f, s = _mats((1, n, n), n=3)
    assert torch.equal(te._mm(x, f, trans_b=True), x @ f.mT)
    assert torch.equal(te._mm(x[:, :5], f), x[:, :5] @ f)
    assert torch.equal(te._sandwich(x, f, s), x @ f @ x + s)
    assert torch.equal(te._matvec(x, s[:, 0]), (x @ s[:, 0, :, None])[..., 0])
    assert counted == {}
    n = fm.MAX_N
    x, f, s = (t[:, :n, :n] for t in (x, f, s))
    te._mm(x, f)
    te._sandwich(x, f, s)
    te._matvec(x, s[:, 0])
    assert counted == {"fragment_bmm": 1, "sandwich": 1,
                       "fragment_matvec": 1}


def test_gfn2_refine_density_goes_through_the_op(counted):
    """GFN2's differentiable refinement (`scf_refine_multipole`, the route
    of diff_scf_iters and of a polish warm start) builds its density with
    `_mm`, as GFN1's `scf_refine` does: two products in the
    orthogonalizer, then a step's transform, C and density (and its
    Coulomb matvec)."""
    gfn2 = tsp("gfn2")
    calc = tcalc.XtbCalculator(gfn2, variant="gfn2", device="cpu")
    frag = calc.make_batch([WATER, H3O])
    with torch.no_grad():
        z, _ = tcalc._converge_charges(frag.coords, frag, KT, gfn2)
    S, H0, gamma, mp = tcalc._scc_operands(frag.coords, frag, gfn2)
    counted.clear()
    for n_iter, products in ((1, 4), (2, 6)):
        counted.clear()
        te.scf_refine_multipole(H0, S, frag.coords, gamma, frag, KT, gfn2,
                                None, mp, z, n_iter)
        assert counted == {"fragment_bmm": products, "sandwich": n_iter,
                           "fragment_matvec": n_iter}


def test_cpcm_product_goes_through_the_op(counted):
    """CPCM's B^T A^-1 B, (nat, points) by (points, nat), is the op's
    product (trans_a, k the points), torch's bits on the CPU."""
    from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import (
        CpcmSolvation,
    )

    calc = tcalc.XtbCalculator(tsp("gfn1", max_scf_iter=2), device="cpu",
                               solvation=CpcmSolvation(78.4))
    frag = calc.make_batch([WATER, H3O])
    seen = []
    real = te.fragment_bmm
    te.fragment_bmm = lambda a, b, ta=False, tb=False: (
        seen.append((tuple(a.shape), ta, tb)) or real(a, b, ta, tb))
    try:
        calc.energies(frag, graph=False)
    finally:
        te.fragment_bmm = real
    npts = frag.atom_mask.shape[1] * 110
    assert ((2, npts, frag.atom_mask.shape[1]), True, False) in seen


def test_fragments_above_64_aos_go_through_the_op(counted):
    """A fragment of 72 AOs (12 waters, padded to 96) takes the op's
    products as the small ones do, up to MAX_N (the kernel's k-tiled
    class on a card); its shells (above 64) take the op's matvec too."""
    calc = tcalc.XtbCalculator(tsp("gfn1"), device="cpu")
    frag = calc.make_batch(_water_ring(12))
    assert fm.STAGED_N < frag.ao_mask.shape[1] <= fm.MAX_N
    # the Fock transform, C = Xs Cp, the density (above the fused fill's
    # 64) and the Coulomb matvec
    assert _per_iteration(counted, frag, tsp("gfn1")) == {
        "sandwich": 1, "fragment_bmm": 2, "fragment_matvec": 1}


def test_sandwich_above_the_staged_size_is_two_products(recorded):
    """Above STAGED_N the wrapper runs the sandwich as two product
    launches (X F rounded to memory, as the kernel rounds it to shared
    memory) and the add: two launches counted, no sandwich entry."""
    n = fm.STAGED_N + 8
    x, f, shift = _mats((2, n, n), n=3)
    before = fm.launches
    out = fm._launch_sandwich(x, f, shift)
    names = [name for name, _ in recorded.calls]
    assert names == ["mqc_fragment_bmm_f64"] * 2
    first, second = (args for _, args in recorded.calls)
    assert first[0] == x.data_ptr() and first[1] == f.data_ptr()
    assert second[1] == x.data_ptr() and second[0] == first[2]
    assert second[3:9] == (2, n, n, n, 0, 0)
    assert fm.launches == before + 2 and out.shape == (2, n, n)
    assert fm.kind_of("bmm", n, n, n) == ("bmm", 128)


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    def refuse(*_args):
        raise AssertionError("the kernel was built for a CPU tensor")

    monkeypatch.setattr(fm._LIB, "load", refuse)
    before = fm.launches
    a, b, s = _mats((3, 5, 5), n=3)
    fm.fragment_bmm(a, b, True, False)
    fm.sandwich(a, b, s)
    fm.fragment_matvec(a, b[:, 0])
    fm.pair_bilinear(*_pair_inputs(2, 3))
    assert fm.launches == before


def test_other_devices_raise():
    a = torch.zeros(2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        fm.fragment_bmm(a, a)
    with pytest.raises(ValueError, match="device"):
        fm.sandwich(a, a, a)
    with pytest.raises(ValueError, match="device"):
        fm.fragment_matvec(a, a[:, 0])
    with pytest.raises(ValueError, match="device"):
        fm.pair_bilinear(a[:, :, :2], torch.zeros(2, 4, 4, 2, 2,
                                                  device="meta"))


def test_d3_c6_goes_through_the_op(monkeypatch):
    """D3's C6 contraction is `pair_bilinear`, the method code leaves the
    device to the op."""
    from metalquicha_tpu_torch.methods.xtb import dispersion_d3

    calls = []
    real = dispersion_d3.pair_bilinear
    monkeypatch.setattr(dispersion_d3, "pair_bilinear",
                        lambda *a: calls.append(a) or real(*a))
    calc = tcalc.XtbCalculator(tsp("gfn1", max_scf_iter=2), device="cpu")
    calc.energies(calc.make_batch([WATER, H3O]))
    assert calls and all(c[1].shape[-2:] == (5, 5) for c in calls)


def test_cuda_tensor_goes_to_the_kernel(monkeypatch):
    """The dispatch reads the device only: tensors that say they lie on a
    card go to the Functions, never to torch.matmul."""
    launched = []

    class Stub:
        @staticmethod
        def apply(*args):
            launched.append(args)
            return "kernel"

    for name in ("_Bmm", "_Sandwich", "_Matvec"):
        monkeypatch.setattr(fm, name, Stub)
    monkeypatch.setattr(fm, "_check", lambda *args: None)

    def card(shape):
        t = types.SimpleNamespace(device=torch.device("cuda", 0),
                                  shape=shape, dtype=torch.float64)
        t.transpose = lambda *_: t
        return t

    m, v = card((2, 4, 4)), card((2, 4))
    assert fm.fragment_bmm(m, m) == "kernel"
    assert fm.sandwich(m, m, m) == "kernel"
    assert fm.fragment_matvec(m, v) == "kernel"
    assert len(launched) == 3


def test_failed_launch_raises(monkeypatch):
    """A launch that returns a CUDA error raises with its message and is
    not counted."""
    lib = types.SimpleNamespace(
        mqc_fragment_bmm_f64=lambda *args: 9,
        mqc_cuda_error_string=lambda code: b"invalid configuration argument")
    monkeypatch.setattr(fm._LIB, "lib", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    a, b = _mats((2, 4, 4))
    before = fm.launches
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        fm._launch_bmm(a, b, False, True)
    assert fm.launches == before


def test_launches_of_another_thread_reach_the_capture_of_their_stream():
    """A backward pass launches from autograd's device thread: a launch on
    a captured stream is recorded for each replay, whatever thread makes
    it; one on another stream is counted at once."""
    from metalquicha_tpu_torch.ops import replay_counts

    before = fm.launches
    with replay_counts.capturing(stream=77) as tally:
        worker = threading.Thread(target=lambda: (fm._count(77),
                                                  fm._count(78)))
        worker.start()
        worker.join()
    assert fm.launches == before + 1
    for _ in range(3):
        tally.replayed(77)
    assert fm.launches == before + 4
    fm._count(77)
    assert fm.launches == before + 5


def test_sizes_above_the_kernel_raise_on_a_card(monkeypatch):
    """On a card an output's m or n above MAX_N (256) raises, for the
    product, the sandwich and the matvec; a product's k of any length
    (CPCM's points) goes to the kernel."""
    monkeypatch.setattr(fm, "_device", lambda *t: "cuda")
    a = torch.zeros(2, fm.MAX_N + 1, fm.MAX_N + 1)
    with pytest.raises(ValueError, match="MAX_N"):
        fm.fragment_bmm(a, a)
    with pytest.raises(ValueError, match="MAX_N"):
        fm.fragment_bmm(a[:, :4], a[:, :4, :4], True, False)
    with pytest.raises(ValueError, match="MAX_N"):
        fm.sandwich(a, a, a)
    with pytest.raises(ValueError, match="MAX_N"):
        fm.fragment_matvec(a[:, :, :4], a[:, 0, :4])
    with pytest.raises(TypeError, match="float32/float64"):
        fm.fragment_bmm(a.to(torch.int32), a.to(torch.int32))

    class Stub:
        @staticmethod
        def apply(*args):
            return "kernel"

    monkeypatch.setattr(fm, "_Bmm", Stub)
    long_k = torch.zeros(2, 660, fm.MAX_N)
    assert fm.fragment_bmm(long_k, long_k, True, False) == "kernel"
    assert fm.fragment_bmm(long_k[:, :, :6].mT, long_k[:, :, :6]) == "kernel"


class _Recorder:
    """A stand-in for the kernel's library: records each entry's
    arguments and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mqc_fragment_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorded(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(fm._LIB, "lib", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    return lib


def _offset_view(shape, dtype, elements=1):
    """A contiguous view whose storage starts `elements` in (its address
    then off 16 bytes by 4 or 8)."""
    flat = torch.arange(math.prod(shape) + elements, dtype=dtype)
    return flat[elements:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [11, 16, 20, 32, 64])
def test_wrapper_passes_operands_as_they_lie(recorded, n, dtype):
    """The wrapper hands the C entry each operand's own address: a view
    with a storage offset is not copied (the kernel stages it element by
    element), a transposed view goes as it is stored with its flag
    flipped, and the sizes are op(a)'s and op(b)'s; the launch is counted
    by kind."""
    tag = "f64" if dtype == torch.float64 else "f32"
    a = _offset_view((3, n, n), dtype)
    b = torch.ones(3, n, n, dtype=dtype)
    cases = [(a, b, False, False, False, False),      # offset, contiguous
             (a.mT, b, False, False, True, False),    # transposed views
             (a, b.mT, True, True, True, False)]
    kind = fm.kind_of("bmm", n)
    before = fm.launches_by_kind[kind]
    for x, y, tx, ty, want_tx, want_ty in cases:
        fm._launch_bmm(x, y, tx, ty)
        name, args = recorded.calls[-1]
        assert name == f"mqc_fragment_bmm_{tag}"
        stored_x = x.mT if want_tx != tx else x
        stored_y = y.mT if want_ty != ty else y
        assert args[0] == stored_x.data_ptr() and args[1] == stored_y.data_ptr()
        assert args[3:9] == (3, n, n, n, int(want_tx), int(want_ty))
        assert args[9:] == (None, 7)
    # the offset view's own address, 4 or 8 bytes past the storage start
    assert recorded.calls[0][1][0] == a.untyped_storage().data_ptr() + (
        a.element_size())
    assert fm.launches_by_kind[kind] == before + 3
    fm._launch_sandwich(a, b, a)
    name, args = recorded.calls[-1]
    assert name == f"mqc_fragment_sandwich_{tag}"
    assert args[0] == a.data_ptr() and args[2] == a.data_ptr()
    assert args[4:6] == (3, n)
    fm._launch_matvec(a.mT, b[:, 0], False)
    name, args = recorded.calls[-1]
    assert name == f"mqc_fragment_matvec_{tag}" and args[0] == a.data_ptr()
    assert args[3:7] == (3, n, n, 1)


def test_launch_kinds():
    """Counts by kind: the direct kernel for products whose sizes are all 8
    or less, else the size class of the staged tiles (the sandwich and the
    matvec, on a kernel of its own, have no direct form)."""
    assert fm.kind_of("bmm", 1, 5, 5) == ("bmm", 0)
    assert fm.kind_of("bmm", 8, 8, 9) == ("bmm", 16)
    assert fm.kind_of("bmm", 20, 20, 20) == ("bmm", 32)
    assert fm.kind_of("bmm", 64, 3, 40) == ("bmm", 64)
    assert fm.kind_of("bmm", 65, 3, 40) == ("bmm", 128)
    # past 128: the peptide's 241, CPCM's k and its backward's m
    assert fm.kind_of("bmm", 241, 241, 241) == ("bmm", 256)
    assert fm.kind_of("bmm", 6, 6, 660) == ("bmm", 256)
    assert fm.kind_of("bmm", 660, 6, 6) == ("bmm", 256)
    assert fm.kind_of("matvec", 192, 192) == ("matvec", 256)
    assert fm.kind_of("sandwich", 6) == ("sandwich", 16)
    assert fm.kind_of("matvec", 64, 64) == ("matvec", 64)
    assert fm.kind_of("matvec", 3, 3) == ("matvec", 16)
    assert fm.kind_of("pair_bilinear", 5) == ("pair_bilinear", 0)
    assert [fm.kind_name(fm.kind_of(*k)) for k in (
        ("bmm", 1, 5, 5), ("sandwich", 40), ("bmm", 97),
        ("matvec", 12, 12), ("pair_bilinear", 5))] == [
        "bmm direct", "sandwich 64", "bmm 128", "matvec 16",
        "pair_bilinear"]


def _source_constant(name):
    """A constexpr int of the kernel's source."""
    src = fm._LIB.source.read_text()
    return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))


def _walk(units, grid, tiles=1, stages=2, tiled=False):
    """The kernel's walk for every block of a grid (its `ring` of one or
    two stages, and the tiled kernel's ring of `stages` over items):
    (unit, k tile) in each block's order; the item a stage holds is
    computed from it before a later item refills it."""
    out = []
    for block in range(grid):
        if block >= units:
            continue
        mine = (units - 1 - block) // grid + 1
        items = mine * tiles
        held = {}
        if tiled:
            # the tiled kernel: items 0 .. stages - 2 issued ahead; at item
            # i (after the barrier that ends item i - 1) item i + stages -
            # 1 refills the stage item i - 1 was computed from
            for i in range(min(stages - 1, items)):
                held[i % stages] = i
            for i in range(items):
                nxt = i + stages - 1
                if nxt < items:
                    assert nxt % stages == (i - 1) % stages
                    assert (nxt % stages) not in held  # computed, released
                    held[nxt % stages] = nxt
                assert held.pop(i % stages) == i
                out.append((block + (i // tiles) * grid, i % tiles))
            continue
        for i in range(items):
            stage = i % stages
            if i == 0 or stages == 1:
                assert stage not in held
                held[stage] = i
            if stages == 2 and i + 1 < items:
                assert (stage ^ 1) not in held  # computed and released
                held[stage ^ 1] = i + 1
            assert held.pop(stage) == i
            out.append((block + (i // tiles) * grid, i % tiles))
    return out


#: the tiled class's plan (`tiled_shape` in the source): its constants
TILED_CONSTANTS = ("kTileK", "kSkinnyTileK", "kWideBand", "kSmallBand",
                   "kTallBand", "kSkinnyN", "kWideUnitsPerSm",
                   "kTiledStages", "kWideStages")
SMS = 132


def _tiled_plan(batch, m, k, n, sms=SMS):
    """A model of the tiled class's plan (`tiled_shape` and `TileCfg`):
    (shape, rows a unit, columns a unit, k a tile, stages of the ring), the
    constants read from the source."""
    c = {name: _source_constant(name) for name in TILED_CONSTANTS}
    stages = c["kTiledStages"]
    if m <= c["kSkinnyN"] and n <= c["kSkinnyN"]:
        return ("skinny", c["kSkinnyN"], c["kSkinnyN"], c["kSkinnyTileK"],
                stages)
    if n <= c["kSkinnyN"]:
        return "tall", c["kTallBand"], c["kSkinnyN"], c["kTileK"], stages
    small = ("small", c["kSmallBand"], c["kSmallBand"], c["kTileK"], stages)
    if m <= c["kSmallBand"] and n <= c["kSmallBand"]:
        return small
    wide = batch * -(-m // c["kWideBand"]) * -(-n // c["kWideBand"])
    if wide >= c["kWideUnitsPerSm"] * sms:
        return ("wide", c["kWideBand"], c["kWideBand"], c["kTileK"],
                c["kWideStages"])
    return small


def test_tiled_plan_constants_match_the_source():
    """The plan's constants as the source states them, and its rule
    (`tiled_shape`) in the order the model takes it."""
    assert [_source_constant(n) for n in TILED_CONSTANTS] == [
        32, 128, 64, 32, 64, 8, 2, 3, 2]
    src = fm._LIB.source.read_text()
    rule = re.search(r"inline int tiled_shape\(.*?\n\}", src, re.S).group(0)
    assert re.findall(r"\b(kSkinny|kTall|kSmall|kWide)\b", rule) == [
        "kSkinny", "kTall", "kSmall", "kWide", "kSmall"]


#: (B, m, k, n) of the plan's cases: the small batches, the wide squares,
#: CPCM's forward and backward at the w20 dimers and monomers, one
#: fragment of 131 by 129 over 660 points, and each boundary: 66 and 65
#: fragments at 97 (wide and small), m and n of 8 beside 9, m of 33
PLAN_CASES = [
    ((3, 128, 128, 128), "small", 48), ((16, 96, 96, 96), "small", 144),
    ((41, 241, 241, 241), "wide", 656), ((64, 256, 256, 256), "wide", 1024),
    ((190, 6, 660, 6), "skinny", 190), ((190, 660, 6, 6), "tall", 2090),
    ((20, 3, 330, 3), "skinny", 20), ((1, 131, 660, 129), "small", 25),
    ((66, 97, 97, 97), "wide", 264), ((65, 97, 97, 97), "small", 1040),
    ((3, 8, 129, 8), "skinny", 3), ((2, 9, 130, 8), "tall", 2),
    ((5, 33, 97, 31), "small", 10), ((4, 7, 300, 9), "small", 4)]


@pytest.mark.parametrize("bmkn, shape, units", PLAN_CASES)
def test_tiled_plan_by_shape_and_batch(bmkn, shape, units):
    """The plan's unit at the main path's shapes and at its boundaries:
    a small batch keeps at least about two units an SM where its shape
    allows ((3, 128) and (16, 96) in 32 x 32 units), wide squares take 64
    x 64 units, CPCM's forward a warp a fragment with k tiles of 128, its
    backward 64 x 8 units (no 128-wide band for 6 columns)."""
    bsz, m, k, n = bmkn
    got, bm, bn, bk, _ = _tiled_plan(bsz, m, k, n)
    assert got == shape
    assert bsz * -(-m // bm) * -(-n // bn) == units
    if shape == "skinny":
        assert bk == 128 and k > 64
    if shape == "tall":
        assert bn == 8 and bm * bn < 128 * 32


def test_work_unit_walk_covers_every_band_once():
    """A plain-Python model of the persistent walk: for every grid of 1 to
    2 x 132 blocks, every (fragment, row band, column band) unit is
    computed exactly once (above 64, each of its k tiles once and in
    ascending order), from the stage it was issued to, and the bands of a
    fragment cover its rows and columns exactly once, at the band heights
    and widths of the source and of the whole tile (classes 16 and 32);
    with a ring of one stage (f64) and of two (f32) up to 64, and above 64
    the tiled class's plan (`_tiled_plan`: units cut to the batch and the
    shape) and its ring (kWideStages for wide units, kTiledStages for the
    others): among them the small batches,
    the peptide's 241, n = 256, CPCM's k of 660 points and its backward's m
    of 660, and each of the plan's boundaries."""
    band64 = _source_constant("kBand64")
    assert band64 == 32
    cases = [((band64, 128, 64, 64, 64), s) for s in (1, 2)]
    cases += [((band64, 3, 37, 9, 37), s) for s in (1, 2)]
    cases += [((16, 190, 16, 16, 16), s) for s in (1, 2)]
    cases += [((32, 5, 20, 20, 20), s) for s in (1, 2)]
    cases += [((None, *shape), None) for shape in (
        (16, 96, 96, 96), (3, 128, 70, 128), (3, 241, 241, 241),
        (2, 256, 40, 256), (5, 6, 660, 6), (2, 660, 6, 6),
        (1, 131, 660, 129), (66, 97, 97, 97), (3, 8, 129, 8),
        (2, 9, 130, 8), (5, 33, 97, 31))]
    for (band, batch, m, k, n), stages in cases:
        tiled = band is None
        if tiled:
            _, band, width, tile_k, stages = _tiled_plan(batch, m, k, n)
            tiles = -(-k // tile_k)
        else:
            width, tiles = n, 1
        rbands = -(-m // band)
        cbands = -(-n // width)
        units = batch * rbands * cbands
        for grid in range(1, 2 * 132 + 1):
            walked = _walk(units, min(grid, units), tiles, stages, tiled)
            assert sorted(walked) == [(u, t) for u in range(units)
                                      for t in range(tiles)]
            order = collections.defaultdict(list)
            for u, t in walked:
                order[u].append(t)
            assert all(ts == list(range(tiles)) for ts in order.values())
        # every grid walks every unit once: the units cover each output
        # element of each fragment once
        cells = np.zeros((batch, m, n), dtype=np.int64)
        for u in range(units):
            f, rest = divmod(u, rbands * cbands)
            rb, cb = divmod(rest, cbands)
            cells[f, rb * band:rb * band + band,
                  cb * width:cb * width + width] += 1
        assert (cells == 1).all()


def test_bit_fingerprint_covers_the_gemm_phase():
    """The fixture holds a fingerprint for every shape, dtype and entry
    `chip_smoke.py`'s gemm phase names (the product with each transpose,
    the sandwich, the matvec and its transpose at GEMM_SHAPES and, above
    128, at GEMM_FINGERPRINTED_WIDE; the product with each transpose at
    GEMM_RECT, CPCM's forms among them; the matvec and its transpose at
    MATVEC_SHAPES, at n = 11 and 97, and on offset operands; the pair
    contraction at PAIR_SHAPES), and the tool's recipe remakes the inputs
    it hashed, shape and bytes."""
    import chip_smoke

    bits = _bits_tool()
    fixture = bits.load_fixture()
    assert fixture["seed"] == bits.SEED and fixture["recipe"] == bits.RECIPE
    assert "H100" in fixture["card"]
    want = set()
    for dtype in ("f64", "f32"):
        for bsz, n in (chip_smoke.GEMM_SHAPES
                       + chip_smoke.GEMM_FINGERPRINTED_WIDE):
            shape = (bsz, n, n, n)
            want |= {bits.key_of("bmm", dtype, shape, ta, tb)
                     for ta, tb in TRANS}
            want |= {bits.key_of("sandwich", dtype, shape, False, False),
                     bits.key_of("matvec", dtype, shape, False, False),
                     bits.key_of("matvec", dtype, shape, True, False)}
        want |= {bits.key_of("bmm", dtype, tuple(shape), ta, tb)
                 for shape in chip_smoke.GEMM_RECT for ta, tb in TRANS}
        # the matvec's own shapes, odd n (staged an element a copy) and
        # offset operands, both forms
        want |= {bits.key_of(entry, dtype, (bsz, n, n, n), ta, False)
                 for entry, shapes in (
                     ("matvec", chip_smoke.MATVEC_SHAPES
                      + ((64, 11), (8, 97))),
                     ("matvec_offset", ((512, 12), (16, 96))))
                 for bsz, n in shapes for ta in (False, True)}
        want |= {bits.key_of("pair", dtype, shape)
                 for shape in chip_smoke.PAIR_SHAPES}
    cases = bits.cases()
    assert want <= set(fixture["cases"]) == {c[0] for c in cases}
    for key, entry, dtype, shape, ta, tb in cases:
        arrays = bits.inputs(entry, dtype, shape, ta, tb)
        assert [a.shape for a in arrays] == bits.input_shapes(
            entry, shape, ta, tb)
        assert {a.dtype.itemsize for a in arrays} == {
            8 if dtype == "f64" else 4}
        assert [bits.digest(a) for a in arrays] == (
            fixture["cases"][key]["inputs"]), key


def test_entry_points_match_the_source():
    """The ctypes declarations of the wrapper against the C signatures of
    csrc/fragment_gemm.cu (a mismatch shows only on a card otherwise)."""
    src = fm._LIB.source.read_text()
    declared = set(re.findall(r"^int (mqc_\w+)\(", src, re.M))
    assert declared == set(fm._LIB.entry_points) == {
        f"mqc_fragment_{k}_{t}" for k in ("bmm", "sandwich", "matvec")
        for t in ("f32", "f64")} | {
        f"mqc_pair_bilinear_{t}" for t in ("f32", "f64")}
    kinds = {"double": "c_double", "int": "c_int"}
    for name, argtypes in fm._LIB.entry_points.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        want = []
        for p in params.split(","):
            words = p.replace("*", " * ").split()
            want.append("c_void_p" if "*" in words else kinds[words[-2]])
        assert [t.__name__ for t in argtypes] == want, name


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    # torch.matmul in full float32, as the engine's products were
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: (B, n) of the main path: the dimer slice, the w20 MBE(4) chunk, the
#: largest fragments the kernel stages whole, one fragment, an odd batch,
#: and sizes of 8 (the products on the direct kernel, the sandwich not);
#: above 64, k in tiles (the dodecamers' 96, 128, and one past 64: the
#: tiled class's small units); above 128, several bands of columns (the
#: peptide's 241 AOs, SP2's 256: wide units; the peptide's 192 shells);
#: the boundary of the wide units at n = 97 (66 fragments wide, 65 small);
#: wide units whose last k tile ends 3 short of its 32 (n = 125, odd rows
#: staged by bulk copies); the Coulomb matvec's shells of the dimer slice
#: and of GFN2 hexamers (its rows cut into bands at (3, 128), (16, 96) and
#: (64, 36))
GPU_SHAPES = [(512, 16), (5985, 32), (128, 64), (1, 16), (7, 64), (20, 8),
              (16, 96), (3, 128), (5, 65), (512, 12), (64, 36), (41, 241),
              (64, 256), (8, 192), (3, 129), (66, 97), (65, 97), (66, 125)]


def _card_mats(shape, dtype, device, n=3, seed=0):
    return [t.to(device) for t in _mats(shape, dtype, seed, n)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_matches_plain_versions(cuda, shape, dtype):
    bsz, n = shape
    a, b, s = _card_mats((bsz, n, n), dtype, cuda)
    tol = TOL[dtype]
    for trans in TRANS:
        before = fm.launches
        got = fm.fragment_bmm(a, b, *trans)
        torch.cuda.synchronize()
        assert fm.launches == before + 1
        assert _rel(got, fm.fragment_bmm_reference(a, b, *trans)) <= tol
        ref = torch.matmul(_op(a, trans[0]), _op(b, trans[1]))
        assert _rel(got, ref) <= tol
    got = fm.sandwich(a, b, s)
    ref = fm.fragment_bmm_reference(fm.fragment_bmm_reference(a, b), a) + s
    assert _rel(got, ref) <= tol and _rel(got, a @ b @ a + s) <= tol
    for trans in (False, True):
        got = fm.fragment_matvec(a, b[:, 0], trans)
        assert _rel(got, fm.matvec_reference(a, b[:, 0], trans)) <= tol
        ref = (_op(a, trans) @ b[:, 0, :, None])[..., 0]
        assert _rel(got, ref) <= tol


#: (B, m, k, n) of rectangular products on the main path: D3's (1, R) by
#: (R, R) per atom pair of a 73-atom Hessian chunk (41 x 73 x 73) and of
#: the w20 MBE(2) dimers (190 x 6 x 6), the forms of its backward pass,
#: one of each size class; CPCM's (nat, points) by (points, nat) at the
#: w20 dimers and monomers and its backward's (points, nat) by (nat, nat);
#: a long k beside two bands of columns, and two bands of rows beside one
#: of columns; the tiled class's plan boundaries: m and n of 8 with k one
#: past a skinny tile, m of 9 beside n of 8 (tall), m of 33 and m of 7
#: beside n of 9 (small), one fragment of 131 by 129 over 660; last k
#: tiles that end 1-3 short of their length, with odd rows staged by bulk
#: copies: wide units over k = 94, a skinny unit over k = 127
GPU_RECT = [(41 * 73 * 73, 1, 5, 5), (190 * 36, 1, 5, 5), (6840, 5, 1, 5),
            (300, 30, 7, 19), (33, 64, 3, 40), (9, 100, 70, 128),
            (7, 65, 3, 40), (190, 6, 660, 6), (20, 3, 330, 3),
            (190, 660, 6, 6), (5, 131, 660, 256), (3, 241, 40, 200),
            (3, 8, 129, 8), (2, 9, 130, 8), (5, 33, 97, 31), (4, 7, 300, 9),
            (1, 131, 660, 129), (66, 97, 94, 97), (3, 8, 127, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bmkn", GPU_RECT)
def test_rectangular_products_on_the_card(cuda, bmkn, dtype):
    bsz, m, k, n = bmkn
    # a backward's form past MAX_N (CPCM's (points, nat) by (nat, nat)) as
    # the op's autograd Function launches it
    bmm = fm.fragment_bmm if fm.takes(m, n) else fm._launch_bmm
    for trans in TRANS:
        a, b = (t.to(cuda) for t in _operands(bsz, m, k, n, trans, dtype))
        got = bmm(a, b, *trans)
        assert got.shape == (bsz, m, n)
        assert _rel(got, fm.fragment_bmm_reference(a, b, *trans)) <= TOL[dtype]
        ref = torch.matmul(_op(a, trans[0]), _op(b, trans[1]))
        assert _rel(got, ref) <= TOL[dtype]
        for rows in ([0], [bsz - 1, 0]):
            idx = torch.tensor(rows, device=cuda)
            part = bmm(a.index_select(0, idx), b.index_select(0, idx),
                       *trans)
            assert torch.equal(part, got.index_select(0, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_bilinear_on_the_card(cuda, dtype):
    """D3's C6 contraction on its kernel, one launch: bit for bit its plain
    version (`pair_bilinear_reference`), within tolerance of the einsums,
    its bits the same for a fragment alone; grids at an offset of one
    element (staged an element a copy) the same bits."""
    w, grids = _pair_inputs(12, 23, dtype, device=cuda)
    before = fm.launches
    got = fm.pair_bilinear(w, grids)
    assert fm.launches == before + 1
    assert torch.equal(got, fm.pair_bilinear_reference(w, grids))
    want = torch.einsum("bijc,bjc->bij",
                        torch.einsum("bia,bijac->bijc", w, grids), w)
    assert _rel(got, want) <= TOL[dtype]
    assert torch.equal(fm.pair_bilinear(w[-1:], grids[-1:]), got[-1:])
    flat = torch.empty(grids.numel() + 1, dtype=dtype, device=cuda)
    off = flat[1:].view(grids.shape)
    off.copy_(grids)
    assert torch.equal(fm.pair_bilinear(w, off), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_bits_do_not_depend_on_the_batch(cuda, shape, dtype):
    bsz, n = shape
    a, b, s = _card_mats((bsz, n, n), dtype, cuda, seed=1)
    whole = (fm.fragment_bmm(a, b, False, True), fm.sandwich(a, b, s),
             fm.fragment_matvec(a, b[:, 0]),
             fm.fragment_matvec(a, b[:, 0], True))
    for rows in ([0], [bsz - 1, 0], [bsz - 1, bsz // 2, 0]):
        idx = torch.tensor(rows, device=cuda)
        a1, b1, s1 = (t.index_select(0, idx) for t in (a, b, s))
        part = (fm.fragment_bmm(a1, b1, False, True),
                fm.sandwich(a1, b1, s1), fm.fragment_matvec(a1, b1[:, 0]),
                fm.fragment_matvec(a1, b1[:, 0], True))
        for p, w in zip(part, whole):
            assert torch.equal(p, w.index_select(0, idx))


@pytest.mark.gpu
def test_gradients_on_the_card(cuda):
    """The Functions' backward passes on the card against torch's own
    gradients of the plain expression (float64, 1e-12); CPCM's product,
    whose backward's products have the points as m."""
    x, f, s = (t.requires_grad_() for t in _card_mats((64, 16, 16),
                                                        torch.float64, cuda))
    out = fm.sandwich(x, f, s)
    got = torch.autograd.grad((out * out).sum(), (x, f, s))
    ref_out = x @ f @ x + s
    want = torch.autograd.grad((ref_out * ref_out).sum(), (x, f, s))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12
    a, b = (t.to(cuda).requires_grad_() for t in _operands(
        19, 6, 660, 6, (True, False)))
    out = fm.fragment_bmm(a, b, True, False)
    got = torch.autograd.grad((out * out).sum(), (a, b))
    ref_out = a.mT @ b
    want = torch.autograd.grad((ref_out * ref_out).sum(), (a, b))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


#: (B, m, k, n) of products whose k, or whose backward's k, leaves a last
#: tile 1-3 short of its length, odd rows staged by bulk copies: wide
#: squares (k = m = n of 125 and 127 over tiles of 32; the backward's
#: op(A)^T dC is the same shape, transposed), wide units over k = 94, a
#: skinny unit over k = 127 (tiles of 128)
PARTIAL_TILES = [(66, 125, 125, 125), (66, 127, 127, 127), (66, 97, 94, 97),
                 (3, 8, 127, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("bmkn", PARTIAL_TILES)
def test_partial_k_tile_gradients_on_the_card(cuda, bmkn):
    """The product and its gradients with every transpose where the last
    k tile is partial within its last block of 4: within GEMM's f64
    tolerance of torch's own (the padding past k read as zeros), and each
    fragment's bits the same alone as in its batch."""
    bsz, m, k, n = bmkn
    rng = np.random.default_rng(k)
    dc = torch.tensor(rng.standard_normal((bsz, m, n)), device=cuda)
    idx = torch.tensor([bsz - 1, 0], device=cuda)
    for trans in TRANS:
        a, b = (t.to(cuda).requires_grad_() for t in _operands(
            bsz, m, k, n, trans))
        out = fm.fragment_bmm(a, b, *trans)
        got = torch.autograd.grad(out, (a, b), dc)
        ref = torch.matmul(_op(a, trans[0]), _op(b, trans[1]))
        want = torch.autograd.grad(ref, (a, b), dc)
        assert _rel(out, ref) <= TOL[torch.float64]
        for g, w in zip(got, want):
            assert _rel(g, w) <= TOL[torch.float64]
        a1, b1 = (t.detach().index_select(0, idx).requires_grad_()
                  for t in (a, b))
        out1 = fm.fragment_bmm(a1, b1, *trans)
        got1 = torch.autograd.grad(out1, (a1, b1), dc.index_select(0, idx))
        assert torch.equal(out1, out.index_select(0, idx))
        for g1, g in zip(got1, got):
            assert torch.equal(g1, g.index_select(0, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("bsz, n", [(16, 96), (8, 241)])
def test_sp2_density_bits_do_not_depend_on_the_batch(cuda, bsz, n):
    """SP2's density on the card (float32, its products and sums on the
    batch-invariant kernels): a fragment's bits alone, and in its batch in
    another order, equal; one launch of the product per iteration."""
    from metalquicha_tpu_torch.ops import sp2

    rng = np.random.default_rng(n)
    q, _ = np.linalg.qr(rng.standard_normal((bsz, n, n)))
    lam = np.sort(rng.uniform(-2.0, 1.0, (bsz, n)), -1)
    half = n // 4
    lam[:, half:] += 0.5  # a gap above the occupied states
    fo = torch.tensor((q * lam[:, None, :]) @ q.transpose(0, 2, 1),
                      dtype=torch.float32, device=cuda)
    nelec = torch.full((bsz,), 2.0 * half, device=cuda)
    nuhf = torch.zeros(bsz, device=cuda)
    mask = torch.ones(bsz, n, device=cuda)
    before = fm.launches
    whole = sp2.sp2_density(fo, nelec, nuhf, mask, closed_shell=True)
    torch.cuda.synchronize()
    assert fm.launches == before + 48
    for rows in ([0], [bsz - 1, 0], [bsz - 1, bsz // 2, 0]):
        idx = torch.tensor(rows, device=cuda)
        part = sp2.sp2_density(*(t.index_select(0, idx) for t in (
            fo, nelec, nuhf, mask)), closed_shell=True)
        assert torch.equal(part, whole.index_select(0, idx))
