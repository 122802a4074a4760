"""Torch port vs JAX package: the SCC and the eigen-machinery.

- q* from the exact in-loop eigh and from the Jacobi route against the JAX
  package's `scf_solve` (float64, exact eigh) at 1e-9; above the kernel's
  ceiling the fast route is SP2 (more in test_torch_sp2.py);
- the per-fragment freeze with scf_tol > 0: a batch whose members stop at
  different iterations matches JAX's vmapped while_loop and the port's own
  one-fragment runs;
- `eigh_safe`'s backward on an exactly degenerate spectrum: finite, and
  equal to JAX's for a function that is invariant within the degenerate
  block; finite energy gradients for an exactly degenerate dimer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import (
    GLY3_FRAG,
    H3O,
    HALOGEN,
    WATER,
    jax_fragment_data,
    max_abs_diff,
    port_from_jax,
    restore_jax_overlay,
)

from metalquicha_tpu.constants import KB_HARTREE
from metalquicha_tpu.methods.xtb import engine as je
from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.overlap import overlap_matrix
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp

torch.set_num_threads(1)
KT = 300.0 * KB_HARTREE


def _scc_inputs(tf, settings):
    """(H0, S, gamma) for the port's batch (shared by both packages)."""
    c = tf.coords
    cn = te.coordination_numbers(c, tf.at_rcov, tf.atom_mask, tf.glb[:, 11],
                                 settings.cn_type)
    S = overlap_matrix(c, tf.ao_atom, tf.ao_lxyz, tf.prim_alpha,
                       tf.prim_coeff)
    return te.h0_matrix(S, c, tf, cn, settings), S, te.gamma_matrix(
        c, tf, settings
    )


def _jax_scf(inputs, jf, settings):
    H0, S, gamma = (jnp.asarray(x.numpy()) for x in inputs)
    fn = jax.jit(jax.vmap(
        lambda h, s, g, f: je.scf_solve(h, s, g, f, KT, settings)
    ))
    q, resid = fn(H0, S, gamma, jf)
    return np.asarray(q), np.asarray(resid)


@pytest.fixture(scope="module")
def batch():
    restore_jax_overlay()
    jf = jax_fragment_data([WATER, H3O, GLY3_FRAG, HALOGEN])
    return jf, port_from_jax(jf)


@pytest.fixture(scope="module")
def jax_q_exact(batch):
    jf, tf = batch
    settings = tsp("gfn1")
    return _jax_scf(_scc_inputs(tf, settings), jf, jsp("gfn1"))


@pytest.mark.parametrize("use_pallas_eigh", [False, True])
def test_scf_charges_match_jax(batch, jax_q_exact, use_pallas_eigh):
    _, tf = batch
    settings = tsp("gfn1", use_pallas_eigh=use_pallas_eigh)
    q, resid = te.scf_solve(*_scc_inputs(tf, settings), tf, KT, settings)
    q_j, resid_j = jax_q_exact
    assert float(resid.max()) < 1e-10 and float(resid_j.max()) < 1e-10
    assert max_abs_diff(q, q_j) <= 1e-9


def test_scf_per_fragment_freeze(batch):
    """scf_tol > 0: each fragment stops on its own, as under JAX's vmap."""
    jf, tf = batch
    tol = 1e-6
    settings = tsp("gfn1", scf_tol=tol, max_scf_iter=64)
    inputs = _scc_inputs(tf, settings)
    q, resid = te.scf_solve(*inputs, tf, KT, settings)
    q_j, resid_j = _jax_scf(inputs, jf, jsp("gfn1", scf_tol=tol,
                                            max_scf_iter=64))
    assert float(resid.max()) <= tol
    assert max_abs_diff(q, q_j) <= 1e-9
    # same stopping iteration: a residual one Anderson step earlier or
    # later differs by the contraction factor, not by 1%; the residual is
    # a difference of converged charges, so its own digits are few
    np.testing.assert_allclose(resid.numpy(), resid_j, rtol=1e-2, atol=0)

    # the members stopped at different iterations: running all of them on
    # to the budget moves some charges, and the frozen batch equals each
    # fragment's own run
    q_full, _ = te.scf_solve(*inputs, tf, KT, settings._replace(scf_tol=0.0))
    assert max_abs_diff(q, q_full) > 1e-10
    for b in range(q.shape[0]):
        one = type(tf)(*(x[b : b + 1] for x in tf))
        q_b, resid_b = te.scf_solve(*(x[b : b + 1] for x in inputs), one, KT,
                                    settings)
        assert max_abs_diff(q_b[0], q[b]) <= 1e-13
        assert max_abs_diff(resid_b[0], resid[b]) <= 1e-13


def test_jacobi_route_raises_above_kernel_size():
    """The kernel's wrapper refuses N above its ceiling; the SCC's fast
    route does not reach it there: in float32 it takes SP2, and lands on
    the float32 exact route's charges (1e-4: two solvers with float32
    noise, as tests/test_torch_sp2.py); in float64 the flag takes the
    exact route, as the JAX package's (no SP2 call, the same charges bit
    for bit)."""
    from metalquicha_tpu_torch.ops import jacobi_eigh, sp2

    n = te.PALLAS_EIGH_MAX_N + 1
    with pytest.raises(ValueError, match="exceeds MAX_N"):
        jacobi_eigh.batched_jacobi_eigh(torch.eye(n, dtype=torch.float64)[None])
    jf = jax_fragment_data([WATER], pad_to=(3, 6, n))
    for dtype, scf_tol in ((torch.float64, 1e-10), (torch.float32, 2e-6)):
        tf = port_from_jax(jf, dtype)
        settings = tsp("gfn1", use_pallas_eigh=True, max_scf_iter=64,
                       scf_tol=scf_tol)
        inputs = _scc_inputs(tf, settings)
        n0 = sp2.calls
        q_fast, resid = te.scf_solve(*inputs, tf, KT, settings)
        made = sp2.calls - n0
        q_exact, _ = te.scf_solve(*inputs, tf, KT,
                                  settings._replace(use_pallas_eigh=False))
        if dtype == torch.float64:
            assert made == 0 and torch.equal(q_fast, q_exact)
            assert float(resid.max()) < 1e-9
        else:
            assert made > 0
            assert float(resid.max()) < 1e-5
            assert max_abs_diff(q_fast, q_exact) <= 1e-4


def test_eigh_safe_backward_degenerate_matches_jax():
    """Exactly degenerate spectrum: the gap cut keeps the backward finite;
    for a loss invariant within the degenerate block it is exact, so both
    packages agree whatever eigenvectors their eigh returns."""
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.normal(size=(5, 5)))
    A = Q @ np.diag([-1.0, 0.5, 0.5, 0.5, 2.0]) @ Q.T
    A = 0.5 * (A + A.T)
    B = rng.normal(size=(5, 5))
    B = B + B.T
    c = np.array([0.3, -1.2, -1.2, -1.2, 0.7])   # equal on the block
    d = np.array([1.0, 2.0, 2.0, 2.0, -0.5])

    def loss_j(a):
        w, v = je.eigh_safe(a)
        return (jnp.asarray(c) * w).sum() + jnp.sum(
            (v * jnp.asarray(d)) @ v.T * B
        )

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(A)))

    a = torch.tensor(A, requires_grad=True)
    w, v = te.eigh_safe(a[None])
    loss = (torch.tensor(c) * w[0]).sum() + (
        (v[0] * torch.tensor(d)) @ v[0].T * torch.tensor(B)
    ).sum()
    (g_t,) = torch.autograd.grad(loss, a)
    assert bool(torch.isfinite(g_t).all())
    assert max_abs_diff(g_t, g_j) <= 1e-10


def test_degenerate_dimer_gradient_finite():
    """Two identical waters related by a pure translation: the overlap
    and Fock spectra are exactly degenerate; the energy gradient stays
    finite and translation-invariant."""
    numbers, coords, _, _ = WATER
    far = np.vstack([coords, coords + np.array([30.0, 0.0, 0.0])])
    calc = XtbCalculator(device="cpu")
    frag = calc.make_batch([(np.concatenate([numbers, numbers]), far, 0, 1)])
    S = overlap_matrix(frag.coords, frag.ao_atom, frag.ao_lxyz,
                       frag.prim_alpha, frag.prim_coeff)
    gaps = np.diff(np.sort(torch.linalg.eigvalsh(S)[0].numpy()))
    assert gaps.min() < 1e-12  # exactly degenerate pairs
    _, g, aux = calc.gradients(frag)
    assert bool(torch.isfinite(g).all())
    assert float(aux["scf_residual"].max()) < 1e-10
    assert abs(float(g[0].sum(0).abs().max())) < 1e-9
