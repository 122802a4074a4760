"""The batch-invariant sums (`ops/fragment_reduce.py`): their plain
versions against the JAX package and torch, their gradients, their
dispatch, and the engine's sums through them (ROADMAP C17 beyond GFN1).

On the CPU:
- each plain version in the kernel's order against the JAX function it
  stands for, float64 1e-12: `moment_fock_reference` against the Fock
  matrix of the JAX package's `_aes_fock` (H0 and S zero: F = (G +
  G^T) / 2), `moment_rows_reference` against its `camm_moments`;
  `fragment_sum_reference` and `segment_sum_reference` against torch's
  sum and scatter_add (1e-13), row lengths on both sides of the warp's
  and the block's lanes;
- the ops on a CPU tensor are the torch expressions the engine ran before
  (bit for bit the einsums, the row sums, scatter_add, sum);
- the autograd Functions with the launchers sent to the plain versions:
  gradcheck and gradgradcheck in float64;
- a GFN2 dimer's energy and gradient through the port with every one of
  these ops routed through the plain versions against the live JAX
  package (1e-10 Ha, 1e-9 Ha/Bohr);
- the engine's sums go through the ops: the shell populations, the atomic
  charges and moments, GFN2's Fock matrix, the energies' sums;
- the dispatch: a CPU tensor never builds the kernel, another device
  raises, a CUDA tensor goes to the Functions, a failed launch raises
  uncounted, a backward pass's launch reaches the capture of its stream;
  the ctypes declarations against `csrc/fragment_reduce.cu`.
The `gpu` cases hold the kernel to the plain versions on the card, bit
for bit, at the main path's shapes (241 AOs and an unsorted index among
them), moment_fock in its three forms at FOCK_SHAPES, and at fragments
too long for a block's shared memory, and a fragment's bits alone and in
its batch (`python3 -m pytest --noconftest
tests/test_torch_c17_gfn2.py -m gpu`).
"""

import ctypes
import re
import threading
import types

import numpy as np
import pytest
import torch
from _torch_port_common import H3O, WATER

from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb import gfn2 as tg2
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.ops import fragment_reduce as fr

torch.set_num_threads(1)
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rand(shape, dtype=torch.float64, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                        device=device)


def _segments(bsz, n, size, seed=0, device="cpu"):
    """A (B, n) int64 index into `size` segments: sorted runs, as the
    engine's ao_shell / ao_atom, some segments empty."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, size, (bsz, n)), axis=1)
    return torch.tensor(idx, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package and torch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_batch():
    """(JAX FragmentData, the port's from the same arrays), GFN2: a water
    and the hydronium cation."""
    from _torch_port_common import port_from_jax, restore_jax_overlay

    from metalquicha_tpu.methods.xtb import calculator as jcalc
    from metalquicha_tpu.methods.xtb.batch import build_batch

    restore_jax_overlay()
    jf = jcalc.fragment_data_from_batch(
        build_batch([WATER, H3O], variant="gfn2"), variant="gfn2")
    return jf, port_from_jax(jf)


def _moment_tables(tf):
    from metalquicha_tpu_torch.methods.xtb import multipole as tmp_

    return tmp_.moment_matrices(tf.coords, tf.ao_atom, tf.ao_lxyz,
                                tf.prim_alpha, tf.prim_coeff)


def test_moment_fock_reference_matches_jax_aes_fock(jax_batch):
    """The JAX package's `_aes_fock` with H0 and S zero gives (G + G^T) / 2
    and the potentials it was built from; the kernel's order from the same
    potentials gives the same matrix."""
    import jax
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb import calculator as jcalc
    from metalquicha_tpu.methods.xtb import engine as je
    from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp

    jf, tf = jax_batch
    settings = tsp("gfn2")
    with torch.no_grad():
        _S, _H0, gamma, mp = tcalc._scc_operands(tf.coords, tf, settings)
    rng = np.random.default_rng(4)
    bsz, nat = tf.atom_mask.shape
    q = 0.2 * rng.standard_normal(tf.sh_mask.shape) * tf.sh_mask.numpy()
    mu = 0.2 * rng.standard_normal((bsz, nat, 3))
    th = 0.2 * rng.standard_normal((bsz, nat, 6))
    z = te._aes_pack(*(torch.tensor(x) for x in (q, mu, th)))
    zero = np.zeros(tuple(_S.shape))

    def one(zz, g, f, cn, d, qq):
        mp_j = jcalc._mp_tables(f, cn)
        mp_j["D"], mp_j["Q"] = d, qq
        return je._aes_fock(jnp.asarray(zero[0]), jnp.asarray(zero[0]), zz,
                            f.coords, g, f, jsp("gfn2"), None, mp_j)

    F_j, (_vq, vmu_j, vth_j) = jax.vmap(one)(
        jnp.asarray(z.numpy()), jnp.asarray(gamma.numpy()), jf,
        *(jnp.asarray(mp[k].numpy()) for k in ("cn", "D", "Q")))
    vmu, vth = (torch.tensor(np.asarray(v)) for v in (vmu_j, vth_j))
    got = fr.moment_fock_reference(
        torch.zeros_like(_S), te._take(vmu, tf.ao_atom), mp["D"],
        te._take(vth, tf.ao_atom), mp["Q"])
    want = torch.tensor(np.asarray(F_j))
    assert float(want.abs().max()) > 1e-3
    assert float((got - want).abs().max()) <= 1e-12
    # and the torch expression a CPU tensor runs
    assert float((fr.moment_fock(torch.zeros_like(_S),
                                 te._take(vmu, tf.ao_atom), mp["D"],
                                 te._take(vth, tf.ao_atom), mp["Q"])
                  - want).abs().max()) <= 1e-12


def test_moment_rows_reference_matches_jax_camm_moments(jax_batch):
    import jax
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb import gfn2 as jg2

    jf, tf = jax_batch
    _S, D, Q = _moment_tables(tf)
    rng = np.random.default_rng(5)
    nao = tf.ao_mask.shape[1]
    nat = tf.atom_mask.shape[1]
    P = rng.standard_normal((2, nao, nao))
    P = torch.tensor(P + P.transpose(0, 2, 1))
    mu = -fr.moment_rows_reference(P, D, tf.ao_atom, nat)
    th = -fr.moment_rows_reference(P, Q, tf.ao_atom, nat)
    tr = (th[..., 0] + th[..., 1] + th[..., 2]) / 3.0
    th = torch.cat([th[..., :3] - tr[..., None], th[..., 3:]], -1)
    mu_j, th_j = jax.vmap(
        lambda p, d, q, a: jg2.camm_moments(p, None, d, q, a, nat)
    )(jnp.asarray(P.numpy()), jnp.asarray(D.numpy()),
      jnp.asarray(Q.numpy()), jf.ao_atom)
    assert float(mu.abs().max()) > 1e-2
    assert float((mu - torch.tensor(np.asarray(mu_j))).abs().max()) <= 1e-12
    assert float((th - torch.tensor(np.asarray(th_j))).abs().max()) <= 1e-12
    # the port's camm_moments (torch's row sums and scatter_add on the CPU)
    mu_p, th_p = tg2.camm_moments(P, None, D, Q, tf.ao_atom, nat)
    assert float((mu_p - mu).abs().max()) <= 1e-12
    assert float((th_p - th).abs().max()) <= 1e-12


#: trailing sizes of fragment_sum: a few AOs, pair tables, the warp's
#: largest row and the block's rows (D3's ATM triples)
SUM_SHAPES = [(7, (16,)), (5, (6, 6)), (3, (36, 36)), (2, (4096,)),
              (2, (4097,)), (2, (20, 20, 20)), (1, (1,)), (3, (0,))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bsz, trailing", SUM_SHAPES)
def test_fragment_sum_reference_matches_torch_sum(bsz, trailing, dtype):
    x = _rand((bsz, *trailing), dtype, seed=len(trailing))
    dims = tuple(range(1, 1 + len(trailing)))
    want = x.sum(dims)
    got = fr.fragment_sum_reference(x, dims)
    assert got.shape == want.shape
    scale = max(float(x.abs().sum(dims).max()), 1e-300)
    assert float((got - want).abs().max()) / scale <= TOL[dtype]
    assert torch.equal(fr.fragment_sum(x, dims), want)


def _lanes_then_halves(row, lanes):
    """The documented order, one scalar at a time in numpy float64."""
    part = [np.float64(0.0)] * lanes
    for i, x in enumerate(row):
        part[i % lanes] = part[i % lanes] + np.float64(x)
    h = lanes // 2
    while h:
        part = [part[t] + part[t + h] for t in range(h)]
        h //= 2
    return part[0]


@pytest.mark.parametrize("length", [1, 31, 32, 33, 100, 4096, 4097, 5000])
def test_fragment_sum_reference_order(length):
    """The kernel's order: lanes strided, then halved pairwise; rows
    longer than WARP_ROW_MAX take BLOCK_LANES lanes. Values spread over
    many magnitudes, so another order would round differently."""
    rng = np.random.default_rng(length)
    row = rng.standard_normal(length) * 10.0 ** rng.integers(-8, 9, length)
    got = fr.row_sum_reference(torch.tensor(row)[None])
    lanes = fr.lanes_of(length)
    assert lanes == (fr.WARP_LANES if length <= fr.WARP_ROW_MAX
                     else fr.BLOCK_LANES)
    assert float(got[0]) == float(_lanes_then_halves(row, lanes))


@pytest.mark.parametrize("c", [None, 1, 3, 6])
def test_segment_sum_reference_matches_scatter_add(c):
    bsz, n, size = 4, 11, 5
    values = _rand((bsz, n) if c is None else (bsz, n, c), seed=2)
    idx = _segments(bsz, n, size, seed=3)
    w = (torch.rand(bsz, n, generator=torch.Generator().manual_seed(1))
         > 0.3).to(torch.float64)
    for weights in (None, w):
        v = values if weights is None else values * (
            weights if c is None else weights[..., None])
        out = torch.zeros(bsz, size, *v.shape[2:], dtype=v.dtype)
        full = idx if c is None else idx[:, :, None].expand(-1, -1, c)
        want = out.scatter_add(1, full, v)
        got = fr.segment_sum_reference(values, idx, size, weights)
        assert _rel(got, want) <= 1e-13
        assert torch.equal(fr.segment_sum(values, idx, size, weights), want)
    # empty segments are exact zeros
    empty = [s for s in range(size) if not bool((idx == s).any())]
    for s in empty:
        assert float(got[:, s].abs().max()) == 0.0


def test_moment_rows_reference_matches_torch_rows():
    bsz, n, d, size = 3, 9, 6, 4
    a, m = _rand((bsz, n, n), seed=1), _rand((bsz, d, n, n), seed=2)
    rows = (a[:, None] * m).sum(-1).transpose(1, 2)
    assert _rel(fr.moment_rows_reference(a, m), rows) <= 1e-13
    idx = _segments(bsz, n, size, seed=4)
    w = torch.tensor(np.random.default_rng(3).random((bsz, n)))
    seg = fr.moment_rows_reference(a, m, idx, size, w)
    want = torch.zeros(bsz, size, d, dtype=a.dtype).scatter_add(
        1, idx[:, :, None].expand(-1, -1, d), rows * w[..., None])
    assert _rel(seg, want) <= 1e-13


def test_cpu_ops_are_the_engines_torch_expressions():
    """A CPU tensor runs the expression each site ran before, bit for
    bit: the einsums of GFN2's Fock matrix, the row sums of the shell
    populations and of the atomic moments, scatter_add, sum."""
    bsz, n, nat = 3, 12, 4
    f, P, S = (_rand((bsz, n, n), seed=s) for s in (1, 2, 3))
    D, Q = _rand((bsz, 3, n, n), seed=4), _rand((bsz, 6, n, n), seed=5)
    v1, v2 = _rand((bsz, n, 3), seed=6), _rand((bsz, n, 6), seed=7)
    G = (-torch.einsum("bkd,bdkl->bkl", v1, D)
         - torch.einsum("bkd,bdkl->bkl", v2, Q))
    assert torch.equal(fr.moment_fock(f, v1, D, v2, Q),
                       f + 0.5 * (G + G.transpose(-1, -2)))
    idx = _segments(bsz, n, nat, seed=8)
    mask = (_rand((bsz, n), seed=9) > -1.0).to(torch.float64)
    ps = (P * S).sum(-1)
    want = torch.zeros(bsz, nat, dtype=P.dtype).scatter_add(1, idx,
                                                            ps * mask)
    assert torch.equal(fr.moment_rows(P, S[:, None], idx, nat, mask)[..., 0],
                       want)
    contr = (P[:, None] * D).sum(-1).transpose(1, 2)
    want = torch.zeros(bsz, nat, 3, dtype=P.dtype).scatter_add(
        1, idx[:, :, None].expand(-1, -1, 3), contr)
    assert torch.equal(fr.moment_rows(P, D, idx, nat), want)
    x = _rand((bsz, 5, 6, 7), seed=10)
    assert torch.equal(fr.fragment_sum(x, (1, 2, 3)), x.sum((1, 2, 3)))
    assert torch.equal(fr.fragment_sum(x, 1), x.sum(1))


# ---------------------------------------------------------------------------
# the Functions on the plain versions
# ---------------------------------------------------------------------------


def _plain_fock(f, v1, m1, v2, m2, sym=True):
    if sym:
        return fr.moment_fock_reference(f, v1, m1, v2, m2)
    return fr.moment_contract_reference(v1, m1)


@pytest.fixture
def plain_route(monkeypatch):
    """Every op of `fragment_reduce` on the Functions a card runs, their
    launches sent to the plain versions on the CPU."""
    monkeypatch.setattr(fr, "_device", lambda *t: "cuda")
    monkeypatch.setattr(fr, "_launch_fock", _plain_fock)
    monkeypatch.setattr(fr, "_launch_rows", fr.moment_rows_reference)
    monkeypatch.setattr(fr, "_launch_segment", fr.segment_sum_reference)
    monkeypatch.setattr(fr, "_launch_sum", fr.row_sum_reference)


def _leaf(shape, seed):
    return _rand(shape, seed=seed).requires_grad_()


def test_moment_fock_gradients(plain_route):
    f, v1, m1 = _leaf((2, 4, 4), 1), _leaf((2, 4, 3), 2), _leaf((2, 3, 4, 4), 3)
    v2, m2 = _leaf((2, 4, 2), 4), _leaf((2, 2, 4, 4), 5)
    assert torch.autograd.gradcheck(fr.moment_fock, (f, v1, m1, v2, m2))
    assert torch.autograd.gradgradcheck(fr.moment_fock, (f, v1, m1, v2, m2))
    assert torch.autograd.gradgradcheck(fr.moment_fock, (f, v1, m1))


def test_moment_rows_gradients(plain_route):
    a, m = _leaf((2, 5, 5), 1), _leaf((2, 3, 5, 5), 2)
    idx = _segments(2, 5, 3, seed=3)
    w = torch.tensor([[1.0, 1.0, 0.0, 1.0, 1.0], [1.0, 0.5, 1.0, 1.0, 0.0]],
                     dtype=torch.float64)
    for args in ((), (idx, 3), (idx, 3, w)):
        def fn(a, m, _args=args):
            return fr.moment_rows(a, m, *_args)

        assert torch.autograd.gradcheck(fn, (a, m))
        assert torch.autograd.gradgradcheck(fn, (a, m))


def test_segment_sum_take_and_fragment_sum_gradients(plain_route):
    idx = _segments(2, 6, 4, seed=5)
    w = torch.tensor(np.random.default_rng(2).random((2, 6)))
    for shape in ((2, 6), (2, 6, 3)):
        v = _leaf(shape, 6)
        assert torch.autograd.gradcheck(
            lambda v: fr.segment_sum(v, idx, 4, w), (v,))
        assert torch.autograd.gradgradcheck(
            lambda v: fr.segment_sum(v, idx, 4), (v,))
    x = _leaf((2, 4, 3), 7)
    assert torch.autograd.gradcheck(lambda x: fr.take(x, idx), (x,))
    assert torch.autograd.gradgradcheck(lambda x: fr.take(x, idx), (x,))
    m = _leaf((2, 4, 4), 8)
    assert torch.autograd.gradcheck(lambda m: fr.take2(m, idx), (m,))
    assert torch.autograd.gradgradcheck(lambda m: fr.take2(m, idx), (m,))
    b = _leaf((2, 1, 4, 1), 10)
    assert torch.autograd.gradcheck(
        lambda b: fr.broadcast(b, (2, 3, 4, 5)) * 1.5, (b,))
    assert torch.autograd.gradgradcheck(
        lambda b: fr.broadcast(b, (2, 3, 4, 5)) ** 2, (b,))
    y = _leaf((2, 3, 4, 5), 9)
    for dims in (-1, (1, 2), (1, 2, 3), 1):
        assert torch.autograd.gradcheck(
            lambda y, _d=dims: fr.fragment_sum(y, _d), (y,))
        assert torch.autograd.gradgradcheck(
            lambda y, _d=dims: fr.fragment_sum(y, _d), (y,))


def test_gfn2_dimer_through_the_plain_versions_matches_live_jax(plain_route):
    """A GFN2 dimer's energy and gradient with every op of
    `fragment_reduce` on its Functions and plain versions (the kernel's
    orders) against the JAX package."""
    import jax.numpy as jnp
    from _torch_port_common import restore_jax_overlay

    from metalquicha_tpu.methods.xtb import calculator as jcalc
    from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp
    from metalquicha_tpu_torch.workloads import bench_dimers

    tight = dict(max_scf_iter=64, scf_tol=1e-11)
    dimer = bench_dimers(1, seed=7)
    restore_jax_overlay()
    jc = jcalc.XtbCalculator(jsp("gfn2", **tight), variant="gfn2",
                             dtype=jnp.float64)
    e_j, g_j, _ = jc.gradients(jc.make_batch(dimer))
    before = dict(fr.launches_by_kind)
    calc = tcalc.XtbCalculator(tsp("gfn2", **tight), variant="gfn2",
                               device="cpu")
    e, g, aux = calc.gradients(calc.make_batch(dimer))
    assert float(aux["scf_residual"].max()) <= 1e-11
    assert float((e - torch.tensor(np.asarray(e_j))).abs().max()) <= 1e-10
    assert float((g - torch.tensor(np.asarray(g_j))).abs().max()) <= 1e-9
    # nothing counted: the plain versions launched nothing
    assert dict(fr.launches_by_kind) == before


def test_gfn2_refine_on_the_kernels_plain_versions(monkeypatch):
    """GFN2's refine route (diff_scf_iters = 2, whose recorded density is
    the product op's `_mm`) with every product and sum on the Functions a
    card runs, their launches sent to the plain versions, against the
    CPU's torch expressions: energies 1e-10 Ha, gradients 1e-9 Ha/Bohr;
    the density's products among the launches."""
    from metalquicha_tpu_torch.ops import fragment_gemm as fm
    from metalquicha_tpu_torch.workloads import bench_dimers

    settings = tsp("gfn2", max_scf_iter=64, scf_tol=1e-11)
    calc = tcalc.XtbCalculator(settings, variant="gfn2", device="cpu")
    frag = calc.make_batch(bench_dimers(2, seed=7))

    def run():
        coords = frag.coords.clone().requires_grad_()
        e, _ = tcalc.single_point_energy(coords, frag, settings,
                                         diff_scf_iters=2)
        (g,) = torch.autograd.grad(e.sum(), coords)
        return e.detach(), g

    e_ref, g_ref = run()
    shapes = []

    def bmm(a, b, ta=False, tb=False):
        shapes.append((ta, tb))
        return fm.fragment_bmm_reference(a, b, ta, tb)

    monkeypatch.setattr(fm, "_device", lambda *t: "cuda")
    monkeypatch.setattr(fm, "_launch_bmm", bmm)
    monkeypatch.setattr(fm, "_launch_sandwich", lambda x, f, s: bmm(
        bmm(x, f), x) + s)
    monkeypatch.setattr(fm, "_launch_matvec", fm.matvec_reference)
    monkeypatch.setattr(fm, "_launch_pair", fm.pair_bilinear_reference)
    monkeypatch.setattr(fr, "_device", lambda *t: "cuda")
    monkeypatch.setattr(fr, "_launch_fock", _plain_fock)
    monkeypatch.setattr(fr, "_launch_rows", fr.moment_rows_reference)
    monkeypatch.setattr(fr, "_launch_segment", fr.segment_sum_reference)
    monkeypatch.setattr(fr, "_launch_sum", fr.row_sum_reference)
    e, g = run()
    assert float((e - e_ref).abs().max()) <= 1e-10
    assert float((g - g_ref).abs().max()) <= 1e-9
    # C diag(f) C^T of each of the two recorded steps, and its backward
    assert shapes.count((False, True)) >= 2


# ---------------------------------------------------------------------------
# the engine's sums through the ops
# ---------------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Calls of the ops by name, in every module that imports them."""
    from metalquicha_tpu_torch.methods.xtb import calculator, dispersion_d3
    from metalquicha_tpu_torch.methods.xtb import xbond
    from metalquicha_tpu_torch.methods.xtb.solvation import born

    calls = {}
    for mod in (te, tg2, calculator, dispersion_d3, xbond, born):
        # (the name a module calls, the op); the engine's gathers are
        # `_take` and `_take2`
        for attr, name in (("fragment_sum", "fragment_sum"),
                           ("moment_fock", "moment_fock"),
                           ("moment_rows", "moment_rows"),
                           ("segment_sum", "segment_sum"),
                           ("_take", "take"), ("_take2", "take2"),
                           ("broadcast", "broadcast")):
            real = mod.__dict__.get(attr)
            if real is None:
                continue

            def count(*args, _name=name, _real=real, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*args, **kw)

            monkeypatch.setattr(mod, attr, count)
    return calls


def test_scc_iterations_go_through_the_ops(counted):
    """A GFN1 iteration: the atomic charges and the shell populations (one
    launch each on a card); a GFN2 iteration: the Fock matrix's moment
    contraction, the moments' two row sums and the interaction energy's
    sums."""
    kt = 300.0 * 3.166808578545117e-06
    for variant in ("gfn1", "gfn2"):
        settings = tsp(variant)
        calc = tcalc.XtbCalculator(settings, variant=variant, device="cpu")
        frag = calc.make_batch([WATER, H3O])
        counts = []
        for n_iter in (1, 3):
            counted.clear()
            tcalc._converge_charges(frag.coords, frag, kt,
                                    settings._replace(max_scf_iter=n_iter))
            counts.append(dict(counted))
        per = {k: (counts[1].get(k, 0) - counts[0].get(k, 0)) // 2
               for k in set(counts[0]) | set(counts[1])}
        per = {k: v for k, v in per.items() if v}
        if variant == "gfn1":
            assert per == {"segment_sum": 1, "moment_rows": 1,
                           "take": 2}
        else:
            assert per["moment_fock"] == 1 and per["moment_rows"] == 3
            assert per["fragment_sum"] >= 5


def test_functional_sums_go_through_the_ops(counted):
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )

    for variant, solvation in (("gfn1", None), ("gfn2", None),
                               ("gfn1", BornSolvation(78.4, alpb=True))):
        calc = tcalc.XtbCalculator(tsp(variant, max_scf_iter=3),
                                   variant=variant, device="cpu",
                                   solvation=solvation)
        frag = calc.make_batch([WATER, H3O])
        counted.clear()
        calc.gradients(frag)
        assert counted["fragment_sum"] >= 8 and counted["take"] >= 4
        assert counted["take2"] >= 2
        if variant == "gfn2":
            assert counted["moment_fock"] >= 2
        if solvation is not None:
            # the SASA's broadcast operands
            assert counted["broadcast"] == 5


# ---------------------------------------------------------------------------
# dispatch and declarations
# ---------------------------------------------------------------------------


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    def refuse(*_args):
        raise AssertionError("the kernel was built for a CPU tensor")

    monkeypatch.setattr(fr._LIB, "load", refuse)
    before = fr.launches
    calc = tcalc.XtbCalculator(tsp("gfn2", max_scf_iter=2), variant="gfn2",
                               device="cpu")
    calc.gradients(calc.make_batch([WATER, H3O]))
    assert fr.launches == before


def test_other_devices_raise():
    a = torch.zeros(2, 4, 4, device="meta")
    m = torch.zeros(2, 3, 4, 4, device="meta")
    idx = torch.zeros(2, 4, dtype=torch.int64, device="meta")
    for call in (lambda: fr.moment_fock(a, a[..., :3], m),
                 lambda: fr.moment_rows(a, m),
                 lambda: fr.segment_sum(a[..., 0], idx, 3),
                 lambda: fr.fragment_sum(a, (1, 2)),
                 lambda: fr.take(a, idx),
                 lambda: fr.broadcast(a, (2, 4, 4))):
        with pytest.raises(ValueError, match="device"):
            call()


def test_cuda_tensor_goes_to_the_functions(monkeypatch):
    """The dispatch reads the device only: tensors on a card go to the
    Functions, never to the torch expressions."""
    launched = []

    class Stub:
        def __init__(self, name):
            self.name = name

        def apply(self, *args):
            launched.append(self.name)
            return torch.zeros(2, 3, 4)

    for name in ("_MomentFock", "_MomentRows", "_SegmentSum",
                 "_FragmentSum", "_Take", "_Take2", "_Broadcast"):
        monkeypatch.setattr(fr, name, Stub(name))
    monkeypatch.setattr(fr, "_device", lambda *t: "cuda")
    a, m = torch.zeros(2, 4, 4), torch.zeros(2, 3, 4, 4)
    idx = torch.zeros(2, 4, dtype=torch.int64)
    fr.moment_fock(a, a[..., :3], m)
    fr.moment_rows(a, m, idx, 3)
    fr.segment_sum(a, idx, 3)
    fr.fragment_sum(a, (1, 2))
    fr.take(a.requires_grad_(), idx)
    fr.take2(a, idx)
    fr.broadcast(a[:, None], (2, 3, 4, 4))
    assert launched == ["_MomentFock", "_MomentRows", "_SegmentSum",
                        "_FragmentSum", "_Take", "_Take2", "_Broadcast"]
    # without a gradient the gathers and the broadcast stay torch's (no
    # launch)
    fr.take(torch.zeros(2, 4), idx)
    y = torch.zeros(2, 1, 4)
    assert fr.broadcast(y, (2, 3, 4)) is y
    assert len(launched) == 7


def test_shapes_checked_on_a_card(monkeypatch):
    monkeypatch.setattr(fr, "_device", lambda *t: "cuda")
    a = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match="moment_fock"):
        fr.moment_fock(a, a[..., :3], torch.zeros(2, 3, 5, 5))
    with pytest.raises(ValueError, match="moment_rows"):
        fr.moment_rows(a, torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="int64"):
        fr.segment_sum(a, torch.zeros(2, 4, dtype=torch.int32), 3)
    with pytest.raises(TypeError, match="float32/float64"):
        fr.fragment_sum(torch.zeros(2, 4, dtype=torch.float16))


def test_failed_launch_raises(monkeypatch):
    """A launch that returns a CUDA error raises with its message and is
    not counted."""
    lib = types.SimpleNamespace(
        mqc_fragment_sum_f64=lambda *args: 9,
        mqc_cuda_error_string=lambda code: b"invalid configuration argument")
    monkeypatch.setattr(fr._LIB, "lib", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    before = fr.launches
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        fr._launch_sum(torch.zeros(3, 5, dtype=torch.float64))
    assert fr.launches == before


def test_launches_of_another_thread_reach_the_capture_of_their_stream():
    from metalquicha_tpu_torch.ops import replay_counts

    before = fr.launches
    with replay_counts.capturing(stream=91) as tally:
        worker = threading.Thread(
            target=lambda: (fr._count(91, kind="segment_sum"),
                            fr._count(92, kind="fragment_sum")))
        worker.start()
        worker.join()
    assert fr.launches == before + 1
    for _ in range(3):
        tally.replayed(91)
    assert fr.launches == before + 4
    assert fr.launches_by_kind["segment_sum"] >= 3


def test_entry_points_match_the_source():
    """The ctypes declarations of the wrapper against the C signatures of
    csrc/fragment_reduce.cu (a mismatch shows only on a card otherwise)."""
    src = fr._LIB.source.read_text()
    declared = set(re.findall(r"^int (mqc_\w+)\(", src, re.M))
    assert declared == set(fr._LIB.entry_points) == {
        f"mqc_{k}_{t}" for k in ("moment_fock", "moment_rows",
                                 "segment_sum", "fragment_sum")
        for t in ("f32", "f64")}
    # (ctypes names c_longlong c_long where the two are one size)
    kinds = {"int": ctypes.c_int.__name__,
             "long long": ctypes.c_longlong.__name__}
    for name, argtypes in fr._LIB.entry_points.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        want = []
        for p in params.split(","):
            if "*" in p:
                want.append("c_void_p")
            else:
                want.append(kinds[" ".join(p.split()[:-1]).replace(
                    "const ", "")])
        assert [t.__name__ for t in argtypes] == want, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


#: (B, n) of the main path: the dimer slice, the w20 MBE(4) chunk, GFN2
#: hexamers, the dodecamers; one fragment; the 73-atom FD Hessian's
#: single fragment (241 AOs, odd rows: element-wise staging, a cluster of
#: bands) and the largest product size
GPU_SHAPES = [(512, 16), (5985, 32), (64, 48), (16, 96), (1, 16), (1, 241),
              (16, 128)]
#: fragment_sum's long rows: one past the warp's longest, GFN2's (6, n, n)
#: at 96 AOs, (6, n, n) at 241 AOs (the FD Hessian's fragment); as many
#: rows as the shape's batch, up to 300 (a block a row) or 40 at the
#: longest, so the rows take a cluster of 8, 4 or 2 blocks, or one
LONG_ROWS = (4097, 55296, 348486)


def _long_rows(bsz, dtype, device, seed=0):
    return [_rand((min(bsz, 300 if n < 100000 else 40), n), dtype,
                  seed + n, device) for n in LONG_ROWS]


def _unsorted(idx, seed=0):
    """idx with each fragment's entries in a seeded random order: segments
    that are not runs."""
    rng = np.random.default_rng(seed)
    perm = np.argsort(rng.random(tuple(idx.shape)), axis=1)
    return torch.gather(idx, 1, torch.tensor(perm, device=idx.device))


def _card_case(shape, d, dtype, device, seed=0):
    bsz, n = shape
    f, a = (_rand((bsz, n, n), dtype, seed + s, device) for s in (0, 1))
    m = _rand((bsz, d, n, n), dtype, seed + 2, device)
    v = _rand((bsz, n, d), dtype, seed + 3, device)
    idx = _segments(bsz, n, max(1, n // 3), seed, device)
    w = (_rand((bsz, n), dtype, seed + 4, device) > -1.0).to(dtype)
    return f, a, m, v, idx, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_is_the_plain_versions_bit_for_bit(cuda, shape, d, dtype):
    f, a, m, v, idx, w = _card_case(shape, d, dtype, cuda)
    size = int(idx.max()) + 1
    mixed = _unsorted(idx, seed=d)
    pairs = [
        (fr.moment_fock(f, v, m, v[..., :1], m[:, :1]),
         fr.moment_fock_reference(f, v, m, v[..., :1], m[:, :1])),
        (fr.moment_rows(a, m), fr.moment_rows_reference(a, m)),
        (fr.moment_rows(a, m, idx, size, w),
         fr.moment_rows_reference(a, m, idx, size, w)),
        # the shell populations' form: one plane, a 0/1 mask
        (fr.moment_rows(a, m[:, :1], idx, size, w),
         fr.moment_rows_reference(a, m[:, :1], idx, size, w)),
        (fr.moment_rows(a, m, mixed, size),
         fr.moment_rows_reference(a, m, mixed, size)),
        (fr.segment_sum(v, idx, size), fr.segment_sum_reference(v, idx,
                                                                 size)),
        (fr.segment_sum(v, mixed, size, w),
         fr.segment_sum_reference(v, mixed, size, w)),
        # take2's backward: a row of n values an entry
        (fr.segment_sum(a, idx, size), fr.segment_sum_reference(a, idx,
                                                                 size)),
        (fr.fragment_sum(m, (1, 2, 3)),
         fr.fragment_sum_reference(m, (1, 2, 3))),
        (fr.fragment_sum(a), fr.fragment_sum_reference(a)),
    ]
    pairs += [(fr.fragment_sum(x), fr.fragment_sum_reference(x))
              for x in _long_rows(shape[0], dtype, cuda)]
    for got, want in pairs:
        assert torch.equal(got, want)


#: (B, n) of moment_fock's own check: the dodecamers (96 AOs), GFN2
#: hexamers (48), one fragment of odd n (tiles past its edge)
FOCK_SHAPES = [(16, 96), (64, 48), (1, 97)]


def _fock_forms(f, v, m):
    """moment_fock with the dipoles and quadrupoles, with the dipoles
    alone, and its contraction without the symmetrisation (the Function
    moment_rows' backward calls), each beside its plain version."""
    d, q = (v[..., :3], m[:, :3]), (v[..., 3:], m[:, 3:])
    return [
        (fr.moment_fock(f, *d, *q), fr.moment_fock_reference(f, *d, *q)),
        (fr.moment_fock(f, *d), fr.moment_fock_reference(f, *d)),
        (fr._Contract.apply(v, m), fr.moment_contract_reference(v, m))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", FOCK_SHAPES)
def test_moment_fock_bit_for_bit_alone_and_in_a_batch(cuda, shape, dtype):
    """moment_fock in every form bit for bit its plain version, and a
    fragment's bits the same alone and in its batch."""
    f, _a, m, v, _idx, _w = _card_case(shape, 6, dtype, cuda, seed=3)
    whole = _fock_forms(f, v, m)
    for got, want in whole:
        assert torch.equal(got, want)
    bsz = shape[0]
    for rows in ([0], [bsz - 1, 0]):
        sel = torch.tensor(rows, device=cuda)
        part = _fock_forms(*(t.index_select(0, sel) for t in (f, v, m)))
        for (p, _), (q, _) in zip(part, whole):
            assert torch.equal(p, q.index_select(0, sel))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_bits_do_not_depend_on_the_batch(cuda, shape):
    f, a, m, v, idx, w = _card_case(shape, 6, torch.float64, cuda, seed=1)
    size = int(idx.max()) + 1

    mixed = _unsorted(idx, seed=1)

    def ops(f, a, m, v, idx, w, mixed):
        return (fr.moment_fock(f, v, m), fr.moment_rows(a, m, idx, size, w),
                fr.moment_rows(a, m), fr.moment_rows(a, m[:, :1], mixed,
                                                     size, w),
                fr.segment_sum(v, idx, size), fr.segment_sum(a, mixed, size),
                fr.fragment_sum(m, (1, 2, 3)))

    whole = ops(f, a, m, v, idx, w, mixed)
    bsz = shape[0]
    for rows in ([0], [bsz - 1, 0]):
        sel = torch.tensor(rows, device=cuda)
        part = ops(*(t.index_select(0, sel)
                     for t in (f, a, m, v, idx, w, mixed)))
        for p, q in zip(part, whole):
            assert torch.equal(p, q.index_select(0, sel))
    # long rows: a row alone, and the last and first, as in the batch
    for x in _long_rows(bsz, torch.float64, cuda, seed=1):
        got = fr.fragment_sum(x)
        for rows in ([0], [x.shape[0] - 1, 0]):
            sel = torch.tensor(rows, device=cuda)
            assert torch.equal(fr.fragment_sum(x.index_select(0, sel)),
                               got.index_select(0, sel))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fragments_past_shared_memory_are_the_plain_versions(cuda, dtype):
    """Fragments whose c, index or values one block's shared memory cannot
    hold, which the kernels sum in runs of entries: moment_rows at 6000
    AOs with d = 6 (sorted with weights, unsorted without), segment_sum
    over 40000 entries alone and over 24000 a fragment in a batch that
    fills the card; bit for bit the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=cuda)

    n = 6000
    a, m = rand(1, n, n), rand(1, 6, n, n)
    idx = _segments(1, n, n // 3, 5, cuda)
    w = (rand(1, n) > -1.0).to(dtype)
    mixed = _unsorted(idx, seed=5)
    assert torch.equal(fr.moment_rows(a, m, idx, n // 3, w),
                       fr.moment_rows_reference(a, m, idx, n // 3, w))
    assert torch.equal(fr.moment_rows(a, m, mixed, n // 3),
                       fr.moment_rows_reference(a, m, mixed, n // 3))
    del a, m
    for bsz, n in ((1, 40000), (300, 24000)):
        v = rand(bsz, n)
        idx = _segments(bsz, n, n // 3, 6, cuda)
        w = (rand(bsz, n) > -1.0).to(dtype)
        assert torch.equal(fr.segment_sum(v, idx, n // 3, w),
                           fr.segment_sum_reference(v, idx, n // 3, w))


@pytest.mark.gpu
def test_gradients_on_the_card(cuda):
    """The Functions' backward passes on the card against torch's own
    gradients of the plain expressions (float64, 1e-12)."""
    f, a, m, v, idx, w = (t.requires_grad_() if t.is_floating_point()
                          and t.dim() > 2 else t
                          for t in _card_case((64, 16), 3, torch.float64,
                                              cuda, seed=2))
    out = fr.moment_fock(f, v, m) + fr.take(
        fr.moment_rows(a, m, idx, 6, w)[..., :1], idx)
    got = torch.autograd.grad((out * out).sum(), (f, a, m, v))
    ref = fr._torch_moment_fock(f, v, m) + fr._torch_take(
        fr._torch_moment_rows(a, m, idx, 6, w)[..., :1], idx)
    want = torch.autograd.grad((ref * ref).sum(), (f, a, m, v))
    for g, h in zip(got, want):
        assert _rel(g, h) <= 1e-12
