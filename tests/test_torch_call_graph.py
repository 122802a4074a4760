"""A calculator's call as replayed device programs (`scc_graph.Call`,
`calculator.evaluate`): the operand build, the SCC loop and the
functional, each a cached graph.

On the CPU, with the stand-ins of `_torch_scc_standins.py` (a capture runs
the stage once into its tally; a replay reruns it on the entry's buffers,
uncounted) and a `Call` that takes the graph route off a card:
- `energies` and `gradients` with the graph, a miss and then a hit on
  other coordinates (the fragments in another order), each bit for bit
  `graph=False`'s: energies, gradients, every aux field and the SCC's
  stop, on GFN1's exact route (f64), Jacobi (f32, the plain twin), SP2
  (f32), ALPB (f64), CPCM (f64) and GFN2 (f64, and f32 on the fast
  route);
- call 1's returned tensors unchanged after call 2 (nothing aliases the
  cache);
- keys that differ in kT, a settings field, the solvation model,
  `cpcm.COSMO_X` and the grad mode capture separately;
- the stages counted in the reuse record like the loop;
- the stage entries evicted with the run's (`executor.make_room`), and the
  calling thread's pool given back where its idle blocks do not fit beside
  a new piece; a call outside a planned run, and such a run at its end,
  giving the pool back where it outgrows the room beside it, and a run's
  chunks of one shape replaying the first's stages;
- one live JAX `gradients` check (GFN1, 1e-9 Ha/Bohr);
- GFN2's loop on the exact orthogonalizer on the float32 fast route: the
  operand stage's pair `_ortho_factors`' on an S with eigenvalues in
  (1e-7, 1e-5), the call bit for bit `single_point_energy`'s and near
  the JAX package's;
- ALPB's electrostatic size and its gradient bit for bit those of
  `torch.linalg.eigvalsh`, and CPCM's kernel those of
  `torch.linalg.solve`.
The `gpu` cases hold every route's graph to `graph=False` on the card
(`python3 -m pytest --noconftest tests/test_torch_call_graph.py -m gpu`).
"""

import numpy as np
import pytest
import torch
from _torch_port_common import (
    GLY3_FRAG,
    H3O,
    WATER,
    max_abs_diff,
    restore_jax_overlay,
)
from _torch_scc_standins import no_card, staged  # noqa: F401 (fixtures)

from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb import scc_graph
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.methods.xtb.solvation import cpcm
from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation
from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import CpcmSolvation
from metalquicha_tpu_torch.parallel import executor as executor_mod

torch.set_num_threads(1)
#: two calls' fragments: one list in two orders, so every row differs
CALLS = ([WATER, H3O, GLY3_FRAG], [GLY3_FRAG, WATER, H3O])
#: closed shells only, for SP2
CLOSED = ([WATER, H3O], [H3O, WATER])
#: route -> (variant, use_pallas_eigh, dtype, solvation, SP2 forced)
ROUTES = {
    "gfn1_exact": ("gfn1", False, torch.float64, None, False),
    "jacobi": ("gfn1", True, torch.float32, None, False),
    "sp2": ("gfn1", True, torch.float32, None, True),
    "alpb": ("gfn1", False, torch.float64, "alpb", False),
    "cpcm": ("gfn1", False, torch.float64, "cpcm", False),
    "gfn2": ("gfn2", False, torch.float64, None, False),
    "gfn2_f32": ("gfn2", True, torch.float32, None, False),
}
FREEZE_TOL = {torch.float64: 1e-7, torch.float32: 2e-5}


def _solvation(name):
    if name == "alpb":
        return BornSolvation(78.4, alpb=True)
    if name == "cpcm":
        return CpcmSolvation(78.4, nang=26)
    return None


def _calc(route, device="cpu", **overrides):
    variant, jacobi, dtype, solv, _ = ROUTES[route]
    kw = dict(use_pallas_eigh=jacobi, scf_tol=FREEZE_TOL[dtype],
              max_scf_iter=48)
    kw.update(overrides)
    return tcalc.XtbCalculator(tsp(variant, **kw), variant=variant,
                               dtype=dtype, device=device,
                               solvation=_solvation(solv))


def _batches(route, calc):
    """The two calls' batches, padded to one shape."""
    calls = CLOSED if ROUTES[route][4] else CALLS
    first = calc.make_batch(calls[0])
    pad_to = (first.coords.shape[1], first.sh_mask.shape[1],
              first.ao_mask.shape[1])
    return first, calc.make_batch(calls[1], pad_to=pad_to)


def _call(calc, frag, grad, graph, steps):
    """(outputs as a dict, SCC steps taken)."""
    s0 = steps[0]
    if grad:
        e, g, aux = calc.gradients(frag, graph=graph)
        out = dict(aux, energy=e, gradient=g)
    else:
        e, aux = calc.energies(frag, graph=graph)
        out = dict(aux, energy=e)
    return out, steps[0] - s0


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("grad", [False, True], ids=["energies",
                                                      "gradients"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_miss_and_hit_equal_launch_by_launch(monkeypatch, staged, route,
                                             grad):
    if ROUTES[route][4]:
        monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    calc = _calc(route)
    frags = _batches(route, calc)
    eager = [_call(calc, f, grad, False, staged) for f in frags]
    assert scc_graph.stats["stage_eager"] == 2 * len(frags)
    kept = []
    for k, (frag, (ref, its)) in enumerate(zip(frags, eager)):
        out, n = _call(calc, frag, grad, True, staged)
        assert _equal(out, ref), route
        # the same stop (GFN2's glycine doublet runs every iteration)
        assert n == its <= calc.settings.max_scf_iter
        assert its < calc.settings.max_scf_iter or calc.variant == "gfn2"
        # a miss captures the operand build and the functional, a hit
        # replays them
        assert scc_graph.stats["stage_captures"] == 2
        assert scc_graph.stats["stage_hits"] == 2 * k
        kept.append((out, {key: v.clone() for key, v in out.items()}))
    assert not torch.equal(eager[0][0]["energy"], eager[1][0]["energy"])
    # call 1's results, unchanged by call 2's replays
    assert _equal(*kept[0])


def test_keys_that_differ_capture_separately(staged):
    """kT, a settings field, the solvation model (its class and fields),
    cpcm.COSMO_X and the grad mode each key a stage of their own; the same
    call again hits every stage."""
    base = _calc("gfn1_exact", max_scf_iter=6)
    frag = base.make_batch(CALLS[0])
    variants = [
        ("base", base, False),
        ("grad", base, True),
        ("kt", tcalc.XtbCalculator(base.settings._replace(
            electronic_temp=600.0), device="cpu"), False),
        ("settings", tcalc.XtbCalculator(base.settings._replace(
            mixer_damping=0.3), device="cpu"), False),
        ("alpb", tcalc.XtbCalculator(base.settings, device="cpu",
                                     solvation=BornSolvation(78.4)), False),
        ("gbsa", tcalc.XtbCalculator(base.settings, device="cpu",
                                     solvation=BornSolvation(
                                         78.4, alpb=False)), False),
    ]
    made = []
    for name, calc, grad in variants:
        c0 = scc_graph.stats["stage_captures"]
        _call(calc, calc.make_batch(CALLS[0]), grad, True, staged)
        made.append(scc_graph.stats["stage_captures"] - c0)
    # the grad mode's call shares the operand build (run without grad)
    assert made == [2, 1, 2, 2, 2, 2]
    # a module constant a solvation kernel reads keys its stages too
    cp = tcalc.XtbCalculator(base.settings, device="cpu",
                             solvation=CpcmSolvation(78.4, nang=26))
    frag_cp = cp.make_batch(CALLS[0])
    _call(cp, frag_cp, False, True, staged)
    c0 = scc_graph.stats["stage_captures"]
    _call(cp, frag_cp, False, True, staged)
    assert scc_graph.stats["stage_captures"] == c0
    old = cpcm.COSMO_X
    try:
        cpcm.COSMO_X = old + 0.1
        _call(cp, frag_cp, False, True, staged)
    finally:
        cpcm.COSMO_X = old
    assert scc_graph.stats["stage_captures"] == c0 + 2
    h0 = scc_graph.stats["stage_hits"]
    for name, calc, grad in variants:
        _call(calc, frag, grad, True, staged)
    assert scc_graph.stats["stage_hits"] == h0 + 2 * len(variants)


def test_stage_solves_count_in_the_reuse_record(staged):
    """A call's stages are solves of the cache like its loop's: the reuse
    record (`scc_graph.reuse`, from which MAX_ENTRIES is set) counts the
    operand build, the loop and the functional, each at distance 2 when
    the same call comes again."""
    calc = _calc("gfn1_exact", max_scf_iter=6)
    frag = calc.make_batch(CALLS[0])
    _call(calc, frag, False, True, staged)
    assert scc_graph.reuse == {"new": 3}
    _call(calc, frag, False, True, staged)
    assert scc_graph.reuse == {"new": 3, 2: 3}


def test_stage_entries_are_evicted_with_the_run(monkeypatch, staged):
    """The entries a call makes count since a mark and go with
    `evict_since`; `make_room` gives the calling thread's pool back where
    its idle blocks do not fit beside a new piece."""
    calc = _calc("gfn1_exact", max_scf_iter=6)
    frag = calc.make_batch(CALLS[0])
    mark = scc_graph.mark()
    _call(calc, frag, True, True, staged)
    # operands, loop, functional
    assert len(scc_graph._entries) == 3
    held = scc_graph.held_since(mark)
    assert held == sum(e.nbytes for e in scc_graph._entries.values()) > 0
    stage = [e for e in scc_graph._entries.values() if e.loop is None]
    assert len(stage) == 2 and all(e.nbytes > 0 for e in stage)
    scc_graph.evict_since(mark)
    assert not scc_graph._entries and scc_graph.held_since(mark) == 0
    # make_room: a new shape whose piece fits beside the run's entries
    # keeps them; where the pool's idle blocks do not fit, the pool goes
    _call(calc, frag, True, True, staged)
    released = []
    monkeypatch.setattr(scc_graph, "own_idle_bytes", lambda device: 50)
    monkeypatch.setattr(scc_graph, "evict_own_pool",
                        lambda device: released.append(device))
    monkeypatch.setattr(torch, "device", _AnyCard(torch.device))
    last = executor_mod.make_room(10**9, mark, "a", 10, None, "cuda:0")
    assert last == "a" and len(scc_graph._entries) == 3 and not released
    executor_mod.make_room(held + 59, mark, "b", 10, last, "cuda:0")
    assert len(scc_graph._entries) == 3 and released == ["cuda:0"]


class _AnyCard:
    """torch.device that reads "cuda:0" as a card on the CPU."""

    def __init__(self, real):
        self.real = real

    def __call__(self, spec):
        if spec == "cuda:0":
            return type("Card", (), {"type": "cuda", "index": 0})()
        return self.real(spec)


def test_gradients_match_jax():
    """The port's staged `gradients` (the functional's autograd inside the
    stage) against the JAX package's, float64: energies 1e-10 Ha,
    gradients 1e-9 Ha/Bohr."""
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator as JaxCalc

    restore_jax_overlay()
    jc = JaxCalc(dtype=jnp.float64)
    e_j, g_j, _ = jc.gradients(jc.make_batch(CALLS[0]))
    calc = tcalc.XtbCalculator(device="cpu")
    e, g, aux = calc.gradients(calc.make_batch(CALLS[0]))
    assert float(aux["scf_residual"].max()) < 1e-10
    assert max_abs_diff(e, e_j) <= 1e-10
    assert max_abs_diff(g, g_j) <= 1e-9


def test_gfn2_fast_route_keeps_the_exact_orthogonalizer():
    """GFN2's loop takes `_ortho_factors` whatever use_pallas_eigh says
    (the JAX package's `scf_solve_multipole`): the operand stage of a
    float32 GFN2 call on the fast route hands the loop (Xs, proj_out), not
    the Jacobi route's (Xs, PAD_LEVEL-scaled shift) with its 1e-5 cut. On
    an S with two eigenvalues in (1e-7, 1e-5) the two differ; GFN1 keeps
    the Jacobi route."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(2, 8, 8)))
    s = np.tile(np.geomspace(3e-6, 2.0, 8), (2, 1))
    S = torch.tensor((q * s[:, None, :]) @ q.transpose(0, 2, 1),
                     dtype=torch.float32)
    gfn2 = tsp("gfn2", use_pallas_eigh=True)
    exact = te._ortho_factors(S)
    got = te.scc_orthogonalizer(S, gfn2)
    assert all(torch.equal(a, b) for a, b in zip(got, exact))
    jacobi = te.scc_orthogonalizer(S, tsp("gfn1", use_pallas_eigh=True))
    assert all(torch.equal(a, b) for a, b in zip(jacobi, te._jacobi_route(S)))
    assert not torch.equal(jacobi[1], exact[1])


def test_gfn2_float32_fast_route_is_single_point_energy():
    """GFN2 in float32 with use_pallas_eigh through `evaluate` (its stages)
    equals `single_point_energy` (the launch-by-launch solve, whose loop
    builds `_ortho_factors` itself) bit for bit: energies, gradients and
    every aux field. The padded AOs of the batch (S eigenvalues 0) are the
    removed combinations; the Jacobi route's shift, scaled by PAD_LEVEL
    again in `_general_eigh`, made the float32 eigh fail there. Against the
    JAX package in float64 to the float32 route's accuracy (the JAX
    package's own float32 call is 1.9e-4 Ha and 5.7e-3 Ha/Bohr from its
    float64 one on this batch): energies 1e-3 Ha, gradients 5e-3
    Ha/Bohr."""
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb import calculator as jcalc
    from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp

    kw = dict(use_pallas_eigh=True, scf_tol=1e-6, max_scf_iter=48)
    calc = tcalc.XtbCalculator(tsp("gfn2", **kw), variant="gfn2",
                               dtype=torch.float32, device="cpu")
    frag = calc.make_batch(CALLS[0])
    e, g, aux = calc.gradients(frag)
    c = frag.coords.clone().requires_grad_(True)
    e_ref, aux_ref = tcalc.single_point_energy(c, frag, calc.settings)
    (g_ref,) = torch.autograd.grad(e_ref.sum(), c)
    assert torch.equal(e, e_ref.detach()) and torch.equal(g, g_ref)
    assert _equal(aux, {k: v.detach() for k, v in aux_ref.items()})
    assert torch.isfinite(e).all() and torch.isfinite(g).all()
    restore_jax_overlay()
    jc = jcalc.XtbCalculator(jsp("gfn2", **kw), variant="gfn2",
                             dtype=jnp.float64)
    e_j, g_j, _ = jc.gradients(jc.make_batch(CALLS[0]))
    assert max_abs_diff(e, e_j) <= 1e-3
    assert max_abs_diff(g, g_j) <= 5e-3


def _cluster(seed, n=3):
    rng = np.random.default_rng(seed)
    coords = np.concatenate([WATER[1] + np.array([5.5 * k, 0.3 * k, 0.0])
                             for k in range(n)])
    return torch.tensor(coords + rng.normal(0, 0.2, coords.shape))[None]


def test_alpb_size_is_eigvalsh_bit_for_bit():
    """ALPB's electrostatic size through the port's `eigvalsh` (the eigh
    binding's forward on a card): its value and gradient those of
    `torch.linalg.eigvalsh`, bit for bit, on the CPU."""
    solv = BornSolvation(78.4)
    tables = solv.host_tables(np.tile(WATER[0], 3))
    rvdw = torch.tensor(tables["solv_rvdw"])[None].repeat(4, 1)
    mask = torch.ones_like(rvdw)
    coords = torch.cat([_cluster(s) for s in range(4)])

    def size(eig):
        c = coords.clone().requires_grad_(True)
        real = te.eigvalsh
        try:
            import metalquicha_tpu_torch.methods.xtb.solvation.born as born

            born.eigvalsh = eig
            a = solv.electrostatic_size(c, rvdw, mask)
        finally:
            born.eigvalsh = real
        (g,) = torch.autograd.grad((a * torch.arange(1.0, 5.0)).sum(), c)
        return a, g

    a, g = size(te.eigvalsh)
    a_t, g_t = size(torch.linalg.eigvalsh)
    assert torch.equal(a, a_t) and torch.equal(g, g_t)


def test_cpcm_kernel_is_solve_bit_for_bit(monkeypatch):
    """CPCM's kernel through `batched_eigh.solve` (`torch.linalg.solve_ex`
    on the CPU, its info read): the bits of `torch.linalg.solve`."""
    solv = CpcmSolvation(78.4, nang=26)
    tables = solv.host_tables(np.tile(WATER[0], 2))
    rvdw = torch.tensor(tables["solv_rvdw"])[None].repeat(3, 1)
    mask = torch.ones_like(rvdw)
    coords = torch.cat([_cluster(s, 2) for s in range(3)])
    got = solv.gamma_atoms(coords, rvdw, None, mask)
    monkeypatch.setattr(torch.linalg, "solve_ex",
                        lambda a, b: (torch.linalg.solve(a, b),
                                      torch.zeros(a.shape[0],
                                                  dtype=torch.int32)))
    assert torch.equal(got, solv.gamma_atoms(coords, rvdw, None, mask))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    scc_graph.clear()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("grad", [False, True], ids=["energies",
                                                      "gradients"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_call_graph_equals_launch_by_launch_on_the_card(cuda, monkeypatch,
                                                        route, grad):
    if ROUTES[route][4]:
        monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    calc = _calc(route, device=cuda)
    steps = [0]
    frags = _batches(route, calc)
    for k, frag in enumerate(frags + frags[:1]):
        eager0 = scc_graph.stats["stage_eager"]
        ref, _ = _call(calc, frag, grad, False, steps)
        assert scc_graph.stats["stage_eager"] == eager0 + 2
        c0 = scc_graph.stats["stage_captures"]
        out, _ = _call(calc, frag, grad, True, steps)
        torch.cuda.synchronize()
        assert _equal(out, ref), (route, k)
        assert scc_graph.stats["stage_captures"] - c0 == (2 if k == 0
                                                          else 0)


def test_a_call_gives_a_large_pool_back(monkeypatch, staged):
    """A call whose captures leave the thread's pools holding more idle
    bytes than the card has beside them (`scc_graph._room_beside`) evicts
    their entries at its end (`scc_graph.give_back_pool`); where they fit
    they stay, and a hit captures nothing and leaves them. Within a
    planned run the call leaves them to the run."""
    released = []
    monkeypatch.setattr(scc_graph, "_room_beside", lambda device: 100)
    monkeypatch.setattr(scc_graph, "evict_own_pool",
                        lambda device: released.append(device))
    calc = _calc("gfn1_exact", max_scf_iter=4)
    frag = calc.make_batch(CALLS[0])
    cpu = torch.device("cpu")
    for idle, want in ((100, []), (101, [cpu])):
        monkeypatch.setattr(scc_graph, "own_idle_bytes",
                            lambda device, idle=idle: idle)
        scc_graph.clear()
        _call(calc, frag, False, True, [0])
        assert released == want
    _call(calc, frag, False, True, [0])
    assert released == [cpu]
    scc_graph.clear()
    c0 = scc_graph.stats["stage_captures"]
    with scc_graph.planned():
        _call(calc, frag, False, True, [0])
    assert scc_graph.stats["stage_captures"] == c0 + 2
    assert released == [cpu]


@pytest.mark.parametrize("budget,chunks,released", [(2.5, 2, 1),
                                                    (4.5, 1, 0)])
def test_a_runs_chunks_of_one_shape_replay_the_first(monkeypatch, staged,
                                                     budget, chunks,
                                                     released):
    """An executor run of four fragments under a budget of two and a half
    fragments: two chunks of two, one shape; the second replays the stages
    the first captured, however large the pool they left, and the run's
    end gives the pool back, as the budget cut its chunks. Under a budget
    of four and a half, one chunk, and the pool stays."""
    from _torch_port_common import jittered_trimers

    gone = []
    monkeypatch.setattr(scc_graph, "own_idle_bytes", lambda device: 101)
    monkeypatch.setattr(scc_graph, "_room_beside", lambda device: 100)
    monkeypatch.setattr(scc_graph, "evict_own_pool",
                        lambda device: gone.append(device))
    calc = _calc("gfn1_exact", max_scf_iter=6)
    ex = executor_mod.FragmentExecutor(calc)
    frags = jittered_trimers(4)
    members = list(enumerate(frags))
    per = ex.fragment_bytes(ex._pad_shapes_for(12, members), members,
                            "energy")
    monkeypatch.setattr(executor_mod, "device_budget",
                        lambda device, sharing=1: int(budget * per))
    monkeypatch.setattr(executor_mod.FragmentExecutor, "_budget",
                        lambda self: executor_mod.device_budget("cpu"))
    h0 = scc_graph.stats["stage_hits"]
    e, _aux = ex.run(frags)
    assert scc_graph.stats["stage_captures"] == 2
    assert scc_graph.stats["stage_hits"] - h0 == 2 * (chunks - 1)
    assert gone == [torch.device("cpu")] * released
    ref, _ = calc.energies(calc.make_batch(frags), graph=False)
    assert np.abs(e - ref.numpy()).max() <= 1e-10
