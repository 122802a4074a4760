"""The port's SP2 in-loop route against the JAX package's and against eigh.

The same gapped symmetric matrices, made with NumPy from a seed, go
through `metalquicha_tpu.ops.sp2` and `metalquicha_tpu_torch.ops.sp2` in
float64 on the CPU. Tolerances: 1e-8 against the JAX functions (a tie in
the branch criterion may take the other recursion, which lands on the same
projector through other iterates) and against the T = 0 density built from
`eigh`; the SP2-driven SCC must land on the exact route's converged shell
charges to 1e-8 in float64 and 1e-4 in float32 (two solvers, each with
float32 noise at the 1e-5 level).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import GLY3_FRAG, WATER, jax_fragment_data, port_from_jax

from metalquicha_tpu.ops import sp2 as jax_sp2
from metalquicha_tpu_torch.constants import KB_HARTREE
from metalquicha_tpu_torch.methods.xtb import engine
from metalquicha_tpu_torch.methods.xtb.calculator import (
    XtbCalculator,
    _converge_charges,
)
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.ops import sp2

TOL = 1e-8


def _gapped_symmetric(rng, n, nocc, gap=0.5):
    """Random symmetric matrix with a controlled HOMO-LUMO gap."""
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lo = np.sort(rng.uniform(-2.0, -1.0, size=nocc))
    hi = np.sort(rng.uniform(-1.0 + gap, 1.0, size=n - nocc))
    return (q * np.concatenate([lo, hi])[None, :]) @ q.T


def _eigh_projector(a, nocc):
    _, v = np.linalg.eigh(a)
    occ = v[:, :nocc]
    return occ @ occ.T


def _padded_batch(seed, n_real, n_pad, noccs):
    """(B, N, N) matrices whose last n_pad states are padding at +100 Ha,
    with the real blocks and the mask."""
    rng = np.random.default_rng(seed)
    n = n_real + n_pad
    blocks = [_gapped_symmetric(rng, n_real, k) for k in noccs]
    a = np.zeros((len(noccs), n, n))
    pad = np.arange(n_real, n)
    for b, blk in enumerate(blocks):
        a[b, :n_real, :n_real] = blk
        a[b, pad, pad] = 100.0
    mask = np.concatenate([np.ones(n_real), np.zeros(n_pad)])
    return a, blocks, np.tile(mask, (len(noccs), 1))


def test_sp2_projector_matches_jax_and_eigh():
    noccs = [9, 5, 12]
    a, blocks, mask = _padded_batch(7, 24, 0, noccs)
    p = sp2.sp2_projector(
        torch.tensor(a), torch.tensor(noccs, dtype=torch.float64),
        torch.tensor(mask),
    ).numpy()
    for b, nocc in enumerate(noccs):
        ref = np.asarray(jax_sp2.sp2_projector(
            jnp.asarray(a[b]), jnp.asarray(float(nocc)), jnp.asarray(mask[b])
        ))
        assert np.abs(p[b] - ref).max() <= TOL
        assert np.abs(p[b] - _eigh_projector(blocks[b], nocc)).max() <= TOL
        assert abs(np.trace(p[b]) - nocc) <= TOL
        assert np.abs(p[b] @ p[b] - p[b]).max() <= TOL  # idempotent


def test_sp2_projector_on_the_ops_plain_versions_matches_jax(monkeypatch):
    """The projector with its products and sums in the kernels' order (the
    ops' plain versions, `fragment_bmm_reference` and
    `fragment_sum_reference`, which a card's kernels hold to) against the
    JAX package's `sp2_projector` at a seeded (2, 144) batch, 120 real
    states and 24 padded (the tiled product class, two bands of columns),
    float64."""
    from metalquicha_tpu_torch.ops import fragment_gemm as fm
    from metalquicha_tpu_torch.ops import fragment_reduce as fr

    monkeypatch.setattr(sp2, "fragment_bmm", fm.fragment_bmm_reference)
    monkeypatch.setattr(sp2, "fragment_sum", fr.fragment_sum_reference)
    noccs = [40, 33]
    a, blocks, mask = _padded_batch(144, 120, 24, noccs)
    p = sp2.sp2_projector(
        torch.tensor(a), torch.tensor(noccs, dtype=torch.float64),
        torch.tensor(mask),
    ).numpy()
    for b, nocc in enumerate(noccs):
        ref = np.asarray(jax_sp2.sp2_projector(
            jnp.asarray(a[b]), jnp.asarray(float(nocc)), jnp.asarray(mask[b])
        ))
        assert np.abs(p[b] - ref).max() <= TOL
        assert np.abs(
            p[b, :120, :120] - _eigh_projector(blocks[b], nocc)).max() <= TOL


def test_sp2_products_and_sums_go_through_the_ops(monkeypatch):
    """SP2's route on the batch-invariant ops: in the engine the
    transformed Fock matrix is `sandwich`'s and the back-transform two
    `fragment_bmm` products; in the projector each iteration's square is
    `fragment_bmm` and its two traces and the Gershgorin row sums (as (B
    N) rows of N) `fragment_sum`. On the CPU each op is the torch
    expression it replaced: the projector's bits are those of torch's
    `X @ X`, diagonal sums and row sums."""
    calls = collections.Counter()
    for mod, name in ((engine, "sandwich"), (engine, "fragment_bmm"),
                      (sp2, "fragment_bmm"), (sp2, "fragment_sum")):
        real = getattr(mod, name)

        def count(*args, _real=real, _key=(mod.__name__, name), **kw):
            if _key[1] == "fragment_sum":
                calls[_key + (tuple(args[0].shape),)] += 1
            else:
                calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, count)
    noccs, iters = [9, 5], 6
    a, _, mask = _padded_batch(7, 24, 0, noccs)
    args = (torch.tensor(a), torch.tensor(noccs, dtype=torch.float64),
            torch.tensor(mask))
    got = sp2.sp2_projector(*args, iters=iters)
    sp2_mod = sp2.__name__
    assert calls == {(sp2_mod, "fragment_bmm"): iters,
                     (sp2_mod, "fragment_sum", (2, 24, 24)): 1,
                     (sp2_mod, "fragment_sum", (2, 24)): 2 * iters}
    # the torch expressions the ops replaced, bit for bit
    Fo, nocc, m = args
    pair = m[..., :, None] * m[..., None, :]
    Fo = Fo * pair
    diag = torch.diagonal(Fo, dim1=-2, dim2=-1)
    offsum = Fo.abs().sum(-1) - diag.abs()
    real = m > 0
    lo = torch.where(real, diag - offsum, 1e30).amin(-1)
    hi = torch.where(real, diag + offsum, -1e30).amax(-1)
    width = torch.clamp(hi - lo, min=1e-6)
    X = (hi[..., None, None] * torch.eye(24, dtype=Fo.dtype) - Fo) / (
        width[..., None, None])
    X = torch.where(pair > 0, X, 0.0)
    for _ in range(iters):
        X2 = X @ X
        tr2 = torch.diagonal(X2, dim1=-2, dim2=-1).sum(-1)
        tr = torch.diagonal(X, dim1=-2, dim2=-1).sum(-1)
        take_sq = (tr2 - nocc).abs() < (2.0 * tr - tr2 - nocc).abs()
        X = torch.where(take_sq[..., None, None], X2, 2.0 * X - X2)
    assert torch.equal(got, X)

    # the engine's SP2 density: one sandwich, two products a call
    frag = port_from_jax(jax_fragment_data([WATER, WATER], pad_to=(4, 8, 11)),
                         torch.float32)
    base = settings_from_params("gfn1", max_scf_iter=3, scf_tol=0.0,
                                use_pallas_eigh=True)
    monkeypatch.setattr(engine, "PALLAS_EIGH_MAX_N", 2)
    kt = base.electronic_temp * KB_HARTREE
    calls.clear()
    n0 = sp2.calls
    _converge_charges(frag.coords, frag, kt, base)
    made = sp2.calls - n0
    assert made > 0
    eng = engine.__name__
    assert calls[(eng, "sandwich")] == made
    # the orthogonalizer's two, then two a density
    assert calls[(eng, "fragment_bmm")] == 2 + 2 * made


def test_sp2_projector_respects_padding():
    """Padded AOs stay empty and do not perturb the real block."""
    n_real, noccs = 18, [7, 3]
    a, blocks, mask = _padded_batch(3, n_real, 14, noccs)
    p = sp2.sp2_projector(
        torch.tensor(a), torch.tensor(noccs, dtype=torch.float64),
        torch.tensor(mask),
    ).numpy()
    for b, nocc in enumerate(noccs):
        ref = np.asarray(jax_sp2.sp2_projector(
            jnp.asarray(a[b]), jnp.asarray(float(nocc)), jnp.asarray(mask[b])
        ))
        assert np.abs(p[b] - ref).max() <= TOL
        assert np.abs(
            p[b, :n_real, :n_real] - _eigh_projector(blocks[b], nocc)
        ).max() <= TOL
        assert np.abs(p[b, n_real:, :]).max() < 1e-12
        assert np.abs(p[b, :, n_real:]).max() < 1e-12


@pytest.mark.parametrize("closed_shell", [None, True, False])
def test_sp2_density_closed_and_open_shell(closed_shell):
    """Closed shell: 2 proj(n/2); a doublet: proj(na) + proj(nb); a batch
    that holds both takes the open-shell branch for all (same result)."""
    rng = np.random.default_rng(11)
    n = 16
    a = _gapped_symmetric(rng, n, 5, gap=0.4)
    mask = np.ones(n)
    cases = {"closed": (10.0, 0.0, 2.0 * _eigh_projector(a, 5)),
             "doublet": (9.0, 1.0,
                         _eigh_projector(a, 5) + _eigh_projector(a, 4))}
    names = ["closed"] if closed_shell else ["closed", "doublet"]
    nelec = torch.tensor([cases[k][0] for k in names], dtype=torch.float64)
    nuhf = torch.tensor([cases[k][1] for k in names], dtype=torch.float64)
    n0 = sp2.calls
    p = sp2.sp2_density(
        torch.tensor(np.stack([a] * len(names))), nelec, nuhf,
        torch.tensor(np.stack([mask] * len(names))),
        closed_shell=closed_shell,
    ).numpy()
    assert sp2.calls == n0 + 1
    for b, k in enumerate(names):
        ref = np.asarray(jax_sp2.sp2_density(
            jnp.asarray(a), jnp.asarray(cases[k][0]),
            jnp.asarray(cases[k][1]), jnp.asarray(mask),
        ))
        assert np.abs(p[b] - ref).max() <= TOL
        assert np.abs(p[b] - cases[k][2]).max() <= TOL


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-8),
                                       (torch.float32, 1e-4)])
def test_sp2_scc_lands_on_the_exact_fixed_point(monkeypatch, dtype, tol):
    """Full SCC on a padded water batch with the gate forced below water's
    AO count, so `use_pallas_eigh` takes SP2 (48 products per iteration)
    in float32 where it would take the Jacobi route. In float64 the flag
    takes the exact route, as the JAX package's: no SP2 call, the exact
    route's charges bit for bit."""
    frag = port_from_jax(jax_fragment_data([WATER, WATER], pad_to=(4, 8, 11)),
                         dtype)
    base = settings_from_params("gfn1", max_scf_iter=64,
                                scf_tol=1e-9 if dtype == torch.float64 else 2e-6)
    kt = base.electronic_temp * KB_HARTREE
    q_ref, r_ref = _converge_charges(frag.coords, frag, kt, base)
    monkeypatch.setattr(engine, "PALLAS_EIGH_MAX_N", 2)
    n0 = sp2.calls
    q_sp2, r_sp2 = _converge_charges(
        frag.coords, frag, kt, base._replace(use_pallas_eigh=True)
    )
    if dtype == torch.float64:
        assert sp2.calls == n0 and torch.equal(q_sp2, q_ref)
    else:
        assert sp2.calls > n0
    res_tol = 1e-8 if dtype == torch.float64 else 1e-5
    assert float(r_ref.max()) < res_tol
    assert float(r_sp2.max()) < res_tol
    assert float((q_sp2 - q_ref).abs().max()) <= tol


def test_use_pallas_eigh_above_the_kernel_ceiling_runs(monkeypatch):
    """The fast route does not raise above the Jacobi kernel's N: a
    float32 closed-shell batch goes through SP2, and its energy and
    gradient match the float32 exact route's (1e-5 Ha, 1e-4 Ha/Bohr:
    float32 noise of two solvers, 9.5e-7 and 1.8e-5 on this water). In
    float64 the flag takes the exact route, as the JAX package's: no SP2
    call, the exact route's energy and gradient bit for bit."""
    monkeypatch.setattr(engine, "PALLAS_EIGH_MAX_N", 2)
    for dtype, scf_tol in ((torch.float64, 1e-10), (torch.float32, 2e-6)):
        fast = XtbCalculator(
            settings_from_params("gfn1", use_pallas_eigh=True,
                                 max_scf_iter=64, scf_tol=scf_tol),
            dtype=dtype, device="cpu")
        exact = XtbCalculator(fast.settings._replace(use_pallas_eigh=False),
                              dtype=dtype, device="cpu")
        frag = fast.make_batch([WATER])
        n0 = sp2.calls
        e_f, g_f, _ = fast.gradients(frag)
        made = sp2.calls - n0
        e_x, g_x, _ = exact.gradients(frag)
        if dtype == torch.float64:
            assert made == 0
            assert torch.equal(e_f, e_x) and torch.equal(g_f, g_x)
        else:
            assert made > 0
            assert float((e_f - e_x).abs().max()) <= 1e-5
            assert float((g_f - g_x).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_settings_for_reroutes_d_block_and_open_shell(monkeypatch, dtype):
    """Above the kernel's ceiling, d-block and open-shell float32 batches
    get the exact in-loop eigensolver; gapped closed-shell main-group
    batches keep the fast route (SP2). A float64 calculator's settings
    pass through unchanged, as the JAX package's: its SCC takes the exact
    route anyway."""
    calc = XtbCalculator(settings_from_params("gfn1", use_pallas_eigh=True),
                         dtype=dtype, device="cpu")
    fast = dtype == torch.float32
    monkeypatch.setattr(engine, "PALLAS_EIGH_MAX_N", 2)
    closed = calc.make_batch([WATER])
    assert calc._settings_for(closed).use_pallas_eigh is True
    tio = (np.array([22, 8]), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.1]]),
           0, 1)
    d_block = calc.make_batch([tio])
    assert calc._settings_for(d_block).use_pallas_eigh is not fast
    doublet = calc.make_batch([WATER, GLY3_FRAG])
    assert calc._settings_for(doublet).use_pallas_eigh is not fast
    if not fast:
        assert calc._settings_for(doublet) is calc.settings
    # below the ceiling the Jacobi route (a true eigh) stays on
    monkeypatch.setattr(engine, "PALLAS_EIGH_MAX_N", 64)
    assert calc._settings_for(d_block).use_pallas_eigh is True
    assert calc._settings_for(doublet).use_pallas_eigh is True
    # and without the fast route nothing changes
    plain = XtbCalculator(device="cpu", dtype=dtype)
    assert plain._settings_for(d_block) is plain.settings
