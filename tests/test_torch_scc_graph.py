"""The SCC loop stepped on device state (`engine._anderson_step`) and
replayed as a captured CUDA graph (`methods/xtb/scc_graph.py`).

On the CPU:
- the stepped loop (state updated in place, the iteration counter a 0-d
  tensor) against the loop it replaced, kept below as
  `_loop_before_graph`: charges, residuals and the iteration at which it
  stops, bit for bit, on GFN1's exact route, the Jacobi route (its plain
  twin), SP2, ALPB's atom-level kernel and GFN2, at scf_tol = 0 and at a
  tolerance that freezes fragments at different iterations;
- one live cross-check against the JAX package's `scf_solve` and
  `scf_solve_multipole` (1e-9, as tests/test_torch_scc.py and
  tests/test_torch_gfn2.py);
- `scc_graph.solve`'s control flow with stand-ins for the CUDA graph
  (`_torch_scc_standins.py`: a replay runs the recorded step again with no
  counting): the eager loop's results, stop and counts;
- the replay accounting of the launch counters (`ops/replay_counts.py`).
The capture itself needs a card: the `gpu` cases hold the graph to the
eager loop bit for bit (`python3 -m pytest --noconftest
tests/test_torch_scc_graph.py -m gpu`).
"""

import numpy as np
import pytest
import torch
from _torch_scc_standins import no_card  # noqa: F401 (a fixture)
from _torch_port_common import (
    GLY3_FRAG,
    H3O,
    WATER,
    jax_fragment_data,
    max_abs_diff,
    port_from_jax,
    restore_jax_overlay,
)

from metalquicha_tpu_torch.constants import KB_HARTREE
from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb import scc_graph
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation
from metalquicha_tpu_torch.ops import batched_eigh, fermi_fill, jacobi_eigh
from metalquicha_tpu_torch.ops import replay_counts, sp2

torch.set_num_threads(1)
KT = 300.0 * KB_HARTREE
FRAGMENTS = [WATER, H3O, GLY3_FRAG]


def _loop_before_graph(fixed_point, x0, settings, graph=True):
    """The Anderson loop as it ran before the stepped one: Python ints for
    the iteration, new tensors every iteration (kept to compare with)."""
    bsz, nx = x0.shape
    m = settings.broyden_memory
    beta = settings.mixer_damping
    dtype, dev = x0.dtype, x0.device
    f32 = dtype == torch.float32
    reg = 1e-4 if f32 else 1e-12
    c_lim = 2.0 if f32 else 1e3
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    slots = torch.arange(m, device=dev)

    x = x0
    resid = torch.ones(bsz, dtype=dtype, device=dev)
    active = torch.ones(bsz, dtype=torch.bool, device=dev)
    hist_x = torch.zeros(bsz, m, nx, dtype=dtype, device=dev)
    hist_f = torch.zeros(bsz, m, nx, dtype=dtype, device=dev)

    for it in range(settings.max_scf_iter):
        if (settings.scf_tol > 0 and it and it % te._DONE_CHECK_EVERY == 0
                and not bool(active.any())):
            break
        f_res = fixed_point(x) - x
        it_resid = f_res.abs().amax(-1)

        slot = it % m
        hist_x[:, slot] = x
        hist_f[:, slot] = f_res

        prev = (it - 1) % m
        valid = ((slots <= it) & (slots != prev))[None, :, None]
        dX = torch.where(valid, hist_x - hist_x[:, prev, None], 0.0)
        dF = torch.where(valid, hist_f - hist_f[:, prev, None], 0.0)
        G = dF @ dF.transpose(-1, -2)
        trace = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
        G = G + (reg * trace / m + 1e-30)[:, None, None] * eye_m
        rhs = (dF @ f_res[..., None])[..., 0]
        c, _ = torch.linalg.solve_ex(G, rhs)
        step = (c[:, None, :] @ (dX + beta * dF))[:, 0]
        x_and = x + beta * f_res - step
        x_damped = x + beta * f_res
        bad = (
            (it < 1)
            | ~torch.isfinite(x_and).all(-1)
            | (c.abs().amax(-1) > c_lim)
        )
        x_next = torch.where(bad[:, None], x_damped, x_and)

        x = torch.where(active[:, None], x_next, x)
        resid = torch.where(active, it_resid, resid)
        active = active & (resid > settings.scf_tol)
    return x, resid


def _before(make_fixed_point, inputs, x0, settings, key, graph=True):
    """`_loop_before_graph` in `engine._anderson_solve`'s place."""
    fixed_point, status = make_fixed_point(inputs)
    out = _loop_before_graph(fixed_point, x0, settings)
    if status is not None:
        status.check()
    return out


#: route -> (variant, use_pallas_eigh, dtype, solvation, SP2 forced)
ROUTES = {
    "gfn1_exact": ("gfn1", False, torch.float64, False, False),
    "jacobi": ("gfn1", True, torch.float32, False, False),
    "sp2": ("gfn1", True, torch.float32, False, True),
    "alpb": ("gfn1", False, torch.float64, True, False),
    "gfn2": ("gfn2", False, torch.float64, False, False),
}
#: scf_tol per dtype that freezes the fragments at different iterations
FREEZE_TOL = {torch.float64: 1e-7, torch.float32: 2e-5}


def _solver(route, scf_tol, max_scf_iter):
    """solve(graph) on the route's SCC inputs for FRAGMENTS, and the engine
    function called once per iteration (to count iterations)."""
    variant, jacobi, dtype, solvated, _ = ROUTES[route]
    settings = tsp(variant, use_pallas_eigh=jacobi, scf_tol=scf_tol,
                   max_scf_iter=max_scf_iter)
    solvation = BornSolvation(78.4, alpb=True) if solvated else None
    calc = tcalc.XtbCalculator(settings, variant=variant, dtype=dtype,
                               device="cpu", solvation=solvation)
    frag = calc.make_batch(FRAGMENTS)
    with torch.no_grad():
        S, H0, gamma, mp = tcalc._scc_operands(frag.coords, frag, settings)
        gamma_at = tcalc._solv_gamma(frag.coords, frag, solvation)

    def solve(**kw):
        with torch.no_grad():
            if mp is None:
                return te.scf_solve(H0, S, gamma, frag, KT, settings,
                                    gamma_at, **kw)
            return te.scf_solve_multipole(H0, S, frag.coords, gamma, frag,
                                          KT, settings, gamma_at, mp, **kw)

    return solve, ("_shell_populations" if mp is None else
                   "_aes_moments_of_P")


def _counted(monkeypatch, name, solve, **kw):
    """solve(**kw) and the calls it made to engine.<name>."""
    calls = []
    orig = getattr(te, name)

    def counted(*args):
        calls.append(1)
        return orig(*args)

    with monkeypatch.context() as mp:
        mp.setattr(te, name, counted)
        q, resid = solve(**kw)
    return q, resid, len(calls)


@pytest.mark.parametrize("freeze", [False, True], ids=["tol0", "freeze"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_stepped_loop_equals_the_loop_before(monkeypatch, route, freeze):
    """Charges, residuals and the stop iteration bit for bit."""
    if ROUTES[route][4]:
        monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    dtype = ROUTES[route][2]
    tol, n_max = (FREEZE_TOL[dtype], 64) if freeze else (0.0, 12)
    solve, per_iteration = _solver(route, tol, n_max)
    n0 = sp2.calls
    q, resid, its = _counted(monkeypatch, per_iteration, solve)
    made = sp2.calls - n0
    with monkeypatch.context() as mp:
        mp.setattr(te, "_anderson_solve", _before)
        q_b, resid_b, its_b = _counted(monkeypatch, per_iteration, solve)
    assert torch.equal(q, q_b) and torch.equal(resid, resid_b)
    assert its == its_b
    assert (made == its) == ROUTES[route][4]
    if freeze:
        # stopped early, at a check, with the fragments frozen at different
        # iterations: running all of them on moves some charges
        assert its < n_max and its % te._DONE_CHECK_EVERY == 0
        assert float(resid.max()) <= tol
        solve_on, _ = _solver(route, 0.0, its)
        assert max_abs_diff(solve_on()[0], q) > 0.0
    else:
        assert its == n_max


def test_warm_start_is_not_written_to():
    """The state is updated in place: a warm start passed in stays as it
    was."""
    q0 = torch.tensor(np.random.default_rng(0).standard_normal((3, 5)))
    before = q0.clone()
    settings = tsp("gfn1", max_scf_iter=4)
    x, _ = te._anderson_solve(lambda _inp: (lambda z: 0.5 * z, None), {},
                              q0, settings, None)
    assert torch.equal(q0, before) and x.data_ptr() != q0.data_ptr()


def test_stepped_loop_matches_jax():
    """The stepped loop against the JAX package's while_loop, GFN1
    (`scf_solve`) and GFN2 (`scf_solve_multipole`), float64, 1e-9."""
    # imported here: the file's `gpu` cases run where jax is not installed
    import jax

    from metalquicha_tpu.methods.xtb import calculator as jcalc
    from metalquicha_tpu.methods.xtb import engine as je
    from metalquicha_tpu.methods.xtb.batch import build_batch
    from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp

    restore_jax_overlay()
    jf = jax_fragment_data([WATER, H3O, GLY3_FRAG])
    tf = port_from_jax(jf)
    tight = dict(max_scf_iter=64, scf_tol=1e-10)
    settings = tsp("gfn1", **tight)
    with torch.no_grad():
        S, H0, gamma, _ = tcalc._scc_operands(tf.coords, tf, settings)
    q, resid = te.scf_solve(H0, S, gamma, tf, KT, settings)
    jset = jsp("gfn1", **tight)
    q_j, resid_j = jax.jit(jax.vmap(
        lambda h, s, g, f: je.scf_solve(h, s, g, f, KT, jset)
    ))(*(np.asarray(t.numpy()) for t in (H0, S, gamma)), jf)
    assert float(resid.max()) <= 1e-10 and float(np.max(resid_j)) <= 1e-10
    assert max_abs_diff(q, q_j) <= 1e-9

    jf2 = jcalc.fragment_data_from_batch(
        build_batch(FRAGMENTS, variant="gfn2"), variant="gfn2")
    tf2 = port_from_jax(jf2)
    tight = dict(max_scf_iter=128, scf_tol=1e-11)
    z, resid = tcalc._converge_charges(tf2.coords, tf2, KT,
                                       tsp("gfn2", **tight))
    jset = jsp("gfn2", **tight)
    z_j, resid_j = jax.jit(jax.vmap(
        lambda c, f: jcalc._converge_charges(c, f, KT, jset)
    ))(jf2.coords, jf2)
    assert float(resid.max()) <= 1e-11 and float(np.max(resid_j)) <= 1e-11
    assert max_abs_diff(z, z_j) <= 1e-9


@pytest.mark.parametrize("freeze", [False, True], ids=["tol0", "freeze"])
def test_run_replayed_stops_and_counts_as_the_eager_loop(monkeypatch,
                                                         no_card, freeze):
    """`run_replayed` driving the engine's step on the SP2 route (SP2
    counts its calls on the CPU too): the eager loop's charges, residuals,
    stop iteration and call count."""
    monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    tol, n_max = (FREEZE_TOL[torch.float32], 64) if freeze else (0.0, 9)
    solve, per_iteration = _solver("sp2", tol, n_max)
    n0 = sp2.calls
    q, resid, its = _counted(monkeypatch, per_iteration, solve)
    eager = sp2.calls - n0

    def replayed(make_fixed_point, inputs, x0, settings, key, graph=True):
        loop = scc_graph.solve(
            (key, settings), inputs, x0,
            lambda inp: te._SccLoop(make_fixed_point, inp, x0, settings),
            settings.max_scf_iter)
        return loop.state.x.clone(), loop.state.resid.clone()

    with monkeypatch.context() as mp:
        mp.setattr(te, "_anderson_solve", replayed)
        n0 = sp2.calls
        q_g, resid_g, its_g = _counted(monkeypatch, per_iteration, solve)
    assert torch.equal(q, q_g) and torch.equal(resid, resid_g)
    # the step ran once per iteration: warm-up, capture, replays after
    # the first
    assert its_g == its and sp2.calls - n0 == eager == its
    assert (its < n_max) == freeze
    # the next solve of the same inputs replays the cached graph from
    # iteration 0, with no warm-up and no capture
    (entry,) = scc_graph._entries.values()
    with monkeypatch.context() as mp:
        mp.setattr(te, "_anderson_solve", replayed)
        n0 = sp2.calls
        q_2, resid_2, its_2 = _counted(monkeypatch, per_iteration, solve)
    assert scc_graph._entries[next(iter(scc_graph._entries))] is entry
    assert scc_graph.stats["captures"] == 1 and scc_graph.stats["hits"] == 1
    assert torch.equal(q_2, q) and torch.equal(resid_2, resid)
    assert its_2 == its and sp2.calls - n0 == its


def test_replay_adds_the_recorded_launches():
    """Under `capturing` every wrapper's count goes to the tally and not to
    its module; `replayed` adds the tally once per replay, per stream."""
    before = (fermi_fill.launches, fermi_fill.density_launches,
              jacobi_eigh.launches, sp2.calls, batched_eigh.launches)
    with replay_counts.capturing() as tally:
        fermi_fill._count(5)
        fermi_fill._count(5, density=True)
        jacobi_eigh._count(5)
        sp2._count(None)
        batched_eigh._count(5)
        batched_eigh._count(5)
    assert (fermi_fill.launches, fermi_fill.density_launches,
            jacobi_eigh.launches, sp2.calls,
            batched_eigh.launches) == before
    stream = 123456789
    by_stream = (fermi_fill.launches_by_stream.get(stream, 0),
                 jacobi_eigh.launches_by_stream.get(stream, 0))
    for _ in range(4):
        tally.replayed(stream)
    assert fermi_fill.launches == before[0] + 8
    assert fermi_fill.density_launches == before[1] + 4
    assert jacobi_eigh.launches == before[2] + 4
    assert sp2.calls == before[3] + 4
    assert batched_eigh.launches == before[4] + 8
    assert fermi_fill.launches_by_stream[stream] == by_stream[0] + 8
    assert jacobi_eigh.launches_by_stream[stream] == by_stream[1] + 4
    # outside a capture the counts go to the modules again
    sp2._count(None)
    assert sp2.calls == before[3] + 5


def test_nested_capture_keeps_its_own_tally():
    with replay_counts.capturing() as outer:
        with replay_counts.capturing() as inner:
            jacobi_eigh._count(1)
        jacobi_eigh._count(1)
        jacobi_eigh._count(1)
    assert sum(inner.counts.values()) == 1
    assert sum(outer.counts.values()) == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("freeze", [False, True], ids=["tol0", "freeze"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_graph_equals_eager_on_the_card(cuda, monkeypatch, route, freeze):
    """On a card the replayed graph gives the eager loop's charges,
    residuals and stop, bit for bit, and counts the kernels' launches of
    every replay."""
    if ROUTES[route][4]:
        monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    variant, jacobi, dtype, solvated, _ = ROUTES[route]
    tol, n_max = (FREEZE_TOL[dtype], 64) if freeze else (0.0, 12)
    settings = tsp(variant, use_pallas_eigh=jacobi, scf_tol=tol,
                   max_scf_iter=n_max)
    solvation = BornSolvation(78.4, alpb=True) if solvated else None
    calc = tcalc.XtbCalculator(settings, variant=variant, dtype=dtype,
                               device=cuda, solvation=solvation)
    frag = calc.make_batch(FRAGMENTS)
    with torch.no_grad():
        S, H0, gamma, mp = tcalc._scc_operands(frag.coords, frag, settings)
        gamma_at = tcalc._solv_gamma(frag.coords, frag, solvation)

        def counts():
            return (fermi_fill.launches + jacobi_eigh.launches + sp2.calls
                    + batched_eigh.launches)

        def solve(graph):
            n = counts()
            if mp is None:
                out = te.scf_solve(H0, S, gamma, frag, KT, settings,
                                   gamma_at, graph=graph)
            else:
                out = te.scf_solve_multipole(H0, S, frag.coords, gamma,
                                             frag, KT, settings, gamma_at,
                                             mp, graph=graph)
            torch.cuda.synchronize()
            return (*out, counts() - n)

        q_e, r_e, n_e = solve(False)
        q_g, r_g, n_g = solve(True)
    assert torch.equal(q_g, q_e) and torch.equal(r_g, r_e)
    assert n_g == n_e > 0
