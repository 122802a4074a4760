"""The cache of captured SCC iterations (`methods/xtb/scc_graph.py`): a
solve whose key and shapes were seen replays the kept graph on the new
inputs, and gives the loop's results.

On the CPU, with the stand-ins for torch.cuda's streams and graphs of
`_torch_scc_standins.py` (a capture runs the step once into its tally; a
hit's replays rerun the cached step on the entry's buffers, uncounted):
- two solves of one key with different inputs of the same shapes (the
  fragments in another order): the second is a hit, captures
  nothing and runs no warm-up, and both equal the eager loop bit for bit
  with the same stop, on GFN1's exact route, Jacobi (the plain twin), SP2,
  ALPB and GFN2. Every row of every input differs between the two calls,
  so a tensor the cached step read from outside its buffers would show;
- keys that differ in dtype, B, nao, route, one settings field, kT,
  solvation or SP2's closed-shell flag capture separately;
- A-B-A interleaving, eviction at the cap (an evicted graph is never
  replayed) and at the byte cap, SP2's call count after hits, the pools'
  and entries' bytes;
- `executor.device_budget` holds out the pools' unused bytes, with the
  memory queries monkeypatched as tests/test_torch_chunk_bytes.py does;
- the entries made since a mark are counted and evicted together, and the
  executor and a mesh worker keep the graphs a run made only while they
  fit beside its next chunk in the budget (`executor.make_room`), and a
  worker's handle keeps each run's budget and peak;
- the reuse record counts each solve's reuse distance, the hits a cache
  of any cap would have had.
The `gpu` cases run the same comparisons on the card, every route,
interleaved (`python3 -m pytest --noconftest
tests/test_torch_scc_graph_cache.py -m gpu`).
"""

import collections

import numpy as np
import pytest
import torch
from _torch_port_common import GLY3_FRAG, H3O, WATER
from _torch_scc_standins import no_card  # noqa: F401 (a fixture)

from metalquicha_tpu_torch.constants import KB_HARTREE
from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb import scc_graph
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.methods.xtb.solvation.born import BornSolvation
from metalquicha_tpu_torch.ops import batched_eigh, fermi_fill, jacobi_eigh
from metalquicha_tpu_torch.ops import sp2
from metalquicha_tpu_torch.parallel import executor as executor_mod
from metalquicha_tpu_torch.parallel import slot_worker

torch.set_num_threads(1)
KT = 300.0 * KB_HARTREE
#: two calls' fragments: one list in two orders, so every row differs
CALLS = ([WATER, H3O, GLY3_FRAG], [GLY3_FRAG, WATER, H3O])
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


def _operands(route, fragments, device="cpu", pad_to=None, **overrides):
    """The route's settings and SCC operands for `fragments`."""
    variant, jacobi, dtype, solvated, _ = ROUTES[route]
    kw = dict(use_pallas_eigh=jacobi, scf_tol=FREEZE_TOL[dtype],
              max_scf_iter=64)
    kw.update(overrides)
    settings = tsp(variant, **kw)
    solvation = BornSolvation(78.4, alpb=True) if solvated else None
    calc = tcalc.XtbCalculator(settings, variant=variant, dtype=dtype,
                               device=device, solvation=solvation)
    frag = calc.make_batch(fragments, pad_to=pad_to)
    with torch.no_grad():
        S, H0, gamma, mp = tcalc._scc_operands(frag.coords, frag, settings)
        gamma_at = tcalc._solv_gamma(frag.coords, frag, solvation)
    return settings, (S, H0, gamma, mp, gamma_at, frag)


def _solve(settings, ops, kt=KT, graph=True):
    S, H0, gamma, mp, gamma_at, frag = ops
    with torch.no_grad():
        if mp is None:
            return te.scf_solve(H0, S, gamma, frag, kt, settings, gamma_at,
                                graph=graph)
        return te.scf_solve_multipole(H0, S, frag.coords, gamma, frag, kt,
                                      settings, gamma_at, mp, graph=graph)


def _cached(make_fixed_point, inputs, x0, settings, key, graph=True):
    """`engine._anderson_solve`'s card branch, for CPU tensors."""
    loop = scc_graph.solve(
        (key, settings), inputs, x0,
        lambda inp: te._SccLoop(make_fixed_point, inp, x0, settings),
        settings.max_scf_iter)
    if loop.status is not None:
        loop.status.check()
    return loop.state.x.clone(), loop.state.resid.clone()


@pytest.fixture
def cached(monkeypatch, no_card):
    """Every solve through the cache (`_cached`); yields the number of
    steps taken so far, as a one-element list."""
    steps = [0]
    real = te._anderson_step

    def counted(*args):
        steps[0] += 1
        return real(*args)

    monkeypatch.setattr(te, "_anderson_solve", _cached)
    monkeypatch.setattr(te, "_anderson_step", counted)
    return steps


def _eager(monkeypatch, settings, ops, kt=KT):
    """The loop launch by launch, with the number of steps it took."""
    steps = [0]
    real = te._anderson_step

    def counted(*args):
        steps[0] += 1
        return real(*args)

    with monkeypatch.context() as mp:
        mp.setattr(te, "_anderson_step", counted)
        q, resid = _solve(settings, ops, kt)
    return q, resid, steps[0]


@pytest.mark.parametrize("route", list(ROUTES))
def test_hit_equals_the_eager_loop(monkeypatch, no_card, route):
    """A miss, then a hit on other inputs of the same shapes: each the
    eager loop's charges, residuals and stop, bit for bit; the hit
    captures nothing and takes no step beyond its iterations."""
    if ROUTES[route][4]:
        monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    first = CALLS[0]
    settings, ops_a = _operands(route, first)
    pad_to = tuple(ops_a[5].coords.shape[1:2]) + (
        ops_a[5].sh_mask.shape[1], ops_a[5].ao_mask.shape[1])
    _, ops_b = _operands(route, CALLS[1], pad_to=pad_to)
    eager = [_eager(monkeypatch, settings, ops) for ops in (ops_a, ops_b)]
    n_sp2 = sp2.calls
    steps = [0]
    real = te._anderson_step

    def counted(*args):
        steps[0] += 1
        return real(*args)

    monkeypatch.setattr(te, "_anderson_solve", _cached)
    monkeypatch.setattr(te, "_anderson_step", counted)
    for k, (ops, (q_e, r_e, its)) in enumerate(zip((ops_a, ops_b), eager)):
        steps[0] = 0
        q, resid = _solve(settings, ops)
        assert torch.equal(q, q_e) and torch.equal(resid, r_e)
        # the miss: warm-up, capture, replays after the first; the hit:
        # one replay per iteration
        assert steps[0] == its < settings.max_scf_iter
        assert scc_graph.stats["captures"] == 1
        assert scc_graph.stats["hits"] == k
    assert not torch.equal(eager[0][0], eager[1][0])
    if ROUTES[route][4]:
        assert sp2.calls - n_sp2 == eager[0][2] + eager[1][2]


def _key_variants(monkeypatch):
    """name -> (settings, operands, kT) of solves whose keys differ from
    the base's in one thing each."""
    base, ops = _operands("gfn1_exact", CALLS[0], max_scf_iter=6)
    nat, nsh, nao = (ops[5].coords.shape[1], ops[5].sh_mask.shape[1],
                     ops[5].ao_mask.shape[1])
    out = {"base": (base, ops, KT)}
    f32 = tcalc.XtbCalculator(base, dtype=torch.float32, device="cpu")
    frag = f32.make_batch(CALLS[0])
    with torch.no_grad():
        S, H0, gamma, mp = tcalc._scc_operands(frag.coords, frag, base)
    out["dtype"] = (base, (S, H0, gamma, mp, None, frag), KT)
    out["B"] = (base, _operands("gfn1_exact", CALLS[0][:2], max_scf_iter=6,
                                pad_to=(nat, nsh, nao))[1], KT)
    out["nao"] = (base, _operands("gfn1_exact", CALLS[0], max_scf_iter=6,
                                  pad_to=(nat, nsh + 2, nao + 4))[1], KT)
    out["settings"] = (base._replace(mixer_damping=0.3), ops, KT)
    out["kt"] = (base, ops, 2.0 * KT)
    out["solvation"] = (base, _operands("alpb", CALLS[0],
                                        max_scf_iter=6)[1], KT)
    # the Jacobi route and SP2 with and without an open shell, float32
    monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    fast = tsp("gfn1", use_pallas_eigh=True, max_scf_iter=6)
    calc = tcalc.XtbCalculator(fast, dtype=torch.float32, device="cpu")
    for name, frags in (("sp2_closed", [WATER, WATER]),
                        ("sp2_open", [WATER, _DOUBLET])):
        frag = calc.make_batch(frags)
        with torch.no_grad():
            S, H0, gamma, mp = tcalc._scc_operands(frag.coords, frag, fast)
        out[name] = (fast, (S, H0, gamma, mp, None, frag), KT)
    return out


#: a water with one electron fewer than its neutral count: a doublet
_DOUBLET = (WATER[0], WATER[1], 1, 2)


def test_keys_that_differ_capture_separately(monkeypatch, cached):
    """dtype, B, nao, route (exact, SP2), a settings field, kT, solvation
    and SP2's closed-shell flag each make a key of their own; the same
    solve again is a hit."""
    monkeypatch.setattr(scc_graph, "MAX_ENTRIES", 64)
    variants = _key_variants(monkeypatch)
    for n, (name, (settings, ops, kt)) in enumerate(variants.items()):
        _solve(settings, ops, kt)
        assert scc_graph.stats["misses"] == n + 1, name
    assert len(scc_graph._entries) == len(variants)
    for settings, ops, kt in variants.values():
        _solve(settings, ops, kt)
    assert scc_graph.stats["hits"] == len(variants)
    assert scc_graph.stats["misses"] == len(variants)
    assert scc_graph.stats["evictions"] == 0


def test_interleaving_and_eviction(monkeypatch, cached):
    """A-B-A: the third solve replays A's graph on other inputs; with
    the cap at 2, a third key evicts the least recently used, whose graph
    is dropped and whose next solve captures anew. SP2 counts one call
    per iteration on hits as on misses."""
    monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    monkeypatch.setattr(scc_graph, "MAX_ENTRIES", 2)
    settings, ops_a = _operands("sp2", CALLS[0])
    pad_to = (ops_a[5].coords.shape[1], ops_a[5].sh_mask.shape[1],
              ops_a[5].ao_mask.shape[1])
    ops = {"a": ops_a,
           "a2": _operands("sp2", CALLS[1], pad_to=pad_to)[1],
           "b": _operands("sp2", CALLS[0][:2], pad_to=pad_to)[1],
           "c": _operands("sp2", CALLS[0], pad_to=(pad_to[0], pad_to[1] + 2,
                                                   pad_to[2] + 4))[1]}
    ref = {}
    with monkeypatch.context() as mp:
        mp.setattr(te, "_anderson_solve", _eager_solve)
        for name, o in ops.items():
            ref[name] = _solve(settings, o)
    misses = []
    for name in ("a", "b", "a2", "c", "b", "a"):
        n_sp2, steps = sp2.calls, cached[0]
        before = scc_graph.stats["misses"]
        q, resid = _solve(settings, ops[name])
        assert torch.equal(q, ref[name][0]), name
        assert torch.equal(resid, ref[name][1]), name
        assert sp2.calls - n_sp2 == cached[0] - steps
        misses.append(scc_graph.stats["misses"] - before)
    # a, b miss; a2 hits a's entry; c evicts b; b evicts a; a evicts c
    assert misses == [1, 1, 0, 1, 1, 1]
    assert scc_graph.stats["evictions"] == 3
    assert len(scc_graph._entries) == 2
    # every entry shares its thread's and stream's one pool
    (pool,) = scc_graph._pools.values()
    assert pool.entries == 2
    for entry in scc_graph._entries.values():
        assert entry.graph.shared == pool.id != entry.graph.pool()


def _eager_solve(make_fixed_point, inputs, x0, settings, key, graph=True):
    """The loop launch by launch (`engine._anderson_solve` on the CPU)."""
    loop = te._SccLoop(make_fixed_point, inputs, x0, settings)
    for it in range(settings.max_scf_iter):
        if loop.done(it):
            break
        loop.step()
    return loop.state.x.clone(), loop.state.resid.clone()


def test_bytes_are_counted(monkeypatch, cached):
    """An entry counts its buffers, its loop's state and the bytes its
    capture added to the pool; clear() forgets them."""
    reserved = [0]

    def memory(_device):
        reserved[0] += 1000  # each query sees the pool grown
        return reserved[0], 100

    monkeypatch.setattr(scc_graph, "_memory", memory)
    settings, ops = _operands("gfn1_exact", CALLS[0], max_scf_iter=6)
    _solve(settings, ops)
    (entry,) = scc_graph._entries.values()
    (pool,) = scc_graph._pools.values()
    buffers = sum(b.numel() * b.element_size() for b, _ in entry.dsts)
    state = sum(t.numel() * t.element_size() for t in entry.loop.state)
    assert entry.nbytes >= buffers + state > 0
    assert pool.reserved == 1000 and pool.allocated == 0
    assert scc_graph.stats["held_bytes"] == entry.nbytes + 1000
    scc_graph.clear()
    assert not scc_graph._entries and not scc_graph._pools
    assert scc_graph.stats["held_bytes"] == 0


def test_broadcast_inputs_stay_broadcast(no_card):
    """GFN2's pair table is one table broadcast over the batch: the entry
    keeps one row, a hit copies one row, and the key tells a broadcast
    tensor from a full one."""
    row = torch.arange(6.0).view(1, 2, 3)
    wide = row.expand(4, 2, 3)
    dsts = []
    static = scc_graph._static({"t": wide}, dsts)
    (buf, axes), = dsts
    assert axes == (0,) and buf.shape == (1, 2, 3)
    assert static["t"].shape == (4, 2, 3) and static["t"].stride()[0] == 0
    scc_graph._copy_into(dsts, {"t": (row + 1).expand(4, 2, 3)})
    assert torch.equal(static["t"], wide + 1)
    assert (scc_graph._layout({"t": wide})
            != scc_graph._layout({"t": wide.contiguous()}))
    with pytest.raises(RuntimeError, match="hit copies"):
        scc_graph._copy_into([(buf, ())], {"t": wide})


def test_device_budget_holds_out_the_pools(monkeypatch):
    """The unused bytes of other threads' pools on the device are not
    counted as usable; the calling thread's own pool is the run's (its
    captures and replays reuse it, `make_room` gives it back), and other
    devices' pools and the allocated bytes do not enter."""
    import threading

    gib = 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 6 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: gib)
    monkeypatch.setattr(scc_graph, "_pools", {})
    before = executor_mod.device_budget("cuda:0")
    assert before == int(executor_mod.BUDGET_SHARE * 45 * gib)
    me, other = threading.get_ident(), -1
    for key, reserved, allocated in (((other, 0, 7), 3 * gib, gib // 2),
                                     ((other, 1, 7), 5 * gib, 0),
                                     ((me, 0, 7), 2 * gib, 0)):
        pool = scc_graph._Pool(key[1])
        pool.reserved, pool.allocated, pool.entries = reserved, allocated, 1
        scc_graph._pools[key] = pool
    assert scc_graph.idle_pool_bytes("cuda:0") == 5 * gib - gib // 2
    assert scc_graph.idle_pool_bytes("cuda:0", own=False) == (
        3 * gib - gib // 2)
    assert scc_graph.own_idle_bytes("cuda:0") == 2 * gib
    assert executor_mod.device_budget("cuda:0") == int(
        executor_mod.BUDGET_SHARE * (45 * gib - 3 * gib + gib // 2))
    assert executor_mod.device_budget("cuda:0", 2) == int(
        executor_mod.BUDGET_SHARE * (45 * gib - 3 * gib + gib // 2) / 2)
    # never below the free bytes
    scc_graph._pools[(other, 0, 7)].reserved = 100 * gib
    assert executor_mod.device_budget("cuda:0") == int(
        executor_mod.BUDGET_SHARE * 40 * gib)


def test_entries_since_a_mark(monkeypatch, cached):
    """held_since counts the bytes of the entries made after a mark and
    evict_since drops just those; the entry made before stays and hits."""
    monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    settings, ops_a = _operands("sp2", CALLS[0])
    pad_to = (ops_a[5].coords.shape[1], ops_a[5].sh_mask.shape[1],
              ops_a[5].ao_mask.shape[1])
    ops_b = _operands("sp2", CALLS[0][:2], pad_to=pad_to)[1]
    ops_c = _operands("sp2", CALLS[0][:1], pad_to=pad_to)[1]
    _solve(settings, ops_a)
    mark = scc_graph.mark()
    assert scc_graph.held_since(mark) == 0
    _solve(settings, ops_b)
    _solve(settings, ops_c)
    a, b, c = scc_graph._entries.values()
    assert scc_graph.held_since(mark) == b.nbytes + c.nbytes > 0
    assert scc_graph.held_since(0) == a.nbytes + b.nbytes + c.nbytes
    scc_graph.evict_since(mark)
    assert list(scc_graph._entries.values()) == [a]
    assert b.graph is None and c.graph is None
    assert scc_graph.stats["evictions"] == 2
    assert scc_graph.held_since(mark) == 0
    (pool,) = scc_graph._pools.values()
    assert pool.entries == 1
    _solve(settings, ops_a)
    assert scc_graph.stats["hits"] == 1


def test_byte_cap_evicts_all_but_the_newest(monkeypatch, cached):
    """Entries on a card beyond its byte cap go, the least recently used
    first; the newest stays even alone above the cap."""
    monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    settings, ops_a = _operands("sp2", CALLS[0])
    pad_to = (ops_a[5].coords.shape[1], ops_a[5].sh_mask.shape[1],
              ops_a[5].ao_mask.shape[1])
    ops_b = _operands("sp2", CALLS[0][:2], pad_to=pad_to)[1]
    ops_c = _operands("sp2", CALLS[0][:1], pad_to=pad_to)[1]
    cap = [float("inf")]
    real_cap = scc_graph._held_cap
    monkeypatch.setattr(scc_graph, "_held_cap", lambda device: cap[0])
    _solve(settings, ops_a)
    _solve(settings, ops_b)
    a, b = scc_graph._entries.values()
    cap[0] = b.nbytes + 1  # room for one of the two
    _solve(settings, ops_c)
    (c,) = scc_graph._entries.values()
    assert a.graph is None and b.graph is None
    assert scc_graph.stats["evictions"] == 2
    assert scc_graph.stats["held_bytes"] == c.nbytes + sum(
        p.reserved for p in scc_graph._pools.values())
    cap[0] = 0
    _solve(settings, ops_a)
    assert list(scc_graph._entries.values())[-1].nbytes > cap[0]
    assert len(scc_graph._entries) == 1
    assert real_cap(torch.device("cpu")) == float("inf")


def test_reuse_distances():
    """A solve's reuse distance is the number of other keys solved since
    its key's last solve: a cache of c entries, least recently used out
    first, hits the solves at distances below c. Keys beyond the last
    _RECENT count as new."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scc_graph, "reuse", collections.Counter())
        mp.setattr(scc_graph, "_recent", collections.OrderedDict())
        for key in "abacbaa":
            scc_graph._record_reuse(key)
        assert scc_graph.reuse == {"new": 3, 1: 1, 2: 2, 0: 1}
        mp.setattr(scc_graph, "_RECENT", 3)
        for key in "defa":
            scc_graph._record_reuse(key)
        assert scc_graph.reuse["new"] == 7
        assert list(scc_graph._recent) == ["e", "f", "a"]


class _FakeCache:
    """held_since / evict_since of a cache whose every new shape of chunk
    keeps `entry` bytes per fragment, counting the evictions."""

    def __init__(self, entry):
        self.entry, self.kept, self.evicted, self.seen = entry, {}, [], []

    def held_since(self, _mark):
        return sum(self.kept.values())

    def evict_since(self, _mark):
        self.evicted.append(len(self.seen))
        self.kept.clear()

    def ran(self, shape, n):
        self.seen.append(n)
        self.kept.setdefault(shape, n * self.entry)


@pytest.mark.parametrize("entry_share,evicted", [(0.1, []), (0.4, [2])])
def test_executor_keeps_a_runs_graphs_while_they_fit(monkeypatch,
                                                       entry_share, evicted):
    """40 trimers under a budget of 15.5 fragments run as chunks of 15,
    15 and 10. The second 15 replays the first's graphs and is let
    through; before the 10, the graphs the run made stay where they fit
    beside it (1.5 + 10 <= 15.5 fragments) and are evicted where they do
    not (6 + 10 > 15.5)."""
    from _torch_port_common import jittered_trimers

    ex = executor_mod.FragmentExecutor(tcalc.XtbCalculator(device="cpu"))
    frags = jittered_trimers()
    members = list(enumerate(frags))
    pad_to = ex._pad_shapes_for(12, members)
    per = ex.fragment_bytes(pad_to, members, "energy")
    monkeypatch.setattr(executor_mod, "device_budget",
                        lambda device, sharing=1: int(15.5 * per))
    cache = _FakeCache(entry_share * per)
    monkeypatch.setattr(scc_graph, "held_since", cache.held_since)
    monkeypatch.setattr(scc_graph, "evict_since", cache.evict_since)
    monkeypatch.setattr(ex, "_run_chunk",
                        lambda m, p, *a: cache.ran(p, len(m)))
    ex.run(frags)
    assert cache.seen == [15, 15, 10]
    assert cache.evicted == evicted


@pytest.mark.parametrize("entry_share,evicted", [(0.1, []), (0.4, [2])])
def test_mesh_worker_keeps_a_runs_graphs_while_they_fit(
        monkeypatch, entry_share, evicted):
    """A mesh worker's parts follow the same rule as the executor's chunks
    within a run, across its pieces, and a new run drops the graphs
    earlier runs cached."""
    from _torch_port_common import jittered_trimers

    calc = tcalc.XtbCalculator(device="cpu")
    ex = executor_mod.FragmentExecutor(calc)
    tuples = jittered_trimers()
    pad_to = ex._pad_shapes_for(12, list(enumerate(tuples)))
    per = ex.fragment_bytes(pad_to, list(enumerate(tuples)), "energy")
    monkeypatch.setattr(executor_mod, "device_budget",
                        lambda device, sharing=1: int(15.5 * per))
    cache = _FakeCache(entry_share * per)
    monkeypatch.setattr(scc_graph, "held_since", cache.held_since)
    monkeypatch.setattr(scc_graph, "evict_since", cache.evict_since)
    cleared = []
    monkeypatch.setattr(scc_graph, "clear", lambda: cleared.append(1))

    def piece(_calc, _polisher, _frag, part, pad, _what):
        cache.ran(pad, len(part))
        n = len(part)
        return (np.zeros(n), None, np.zeros((n, 3)), np.zeros((n, 12)),
                np.zeros(n))

    monkeypatch.setattr(slot_worker, "evaluate_piece", piece)
    slot = slot_worker._Slot("cpu", torch.get_num_threads())
    parts, stats = slot.evaluate(slot_worker.configuration(calc, None),
                                 tuples, pad_to, "energy", 1, 1)
    assert cache.seen == [15, 15, 10] and stats["parts"] == 3
    assert stats["run"] == 1 and stats["budget_bytes"] == int(15.5 * per)
    assert cache.evicted == evicted and cleared == [1]
    # the next piece of the run: 15 again, after the 10, does not fit
    # beside what the run kept
    slot.evaluate(None, tuples[:15], pad_to, "energy", 1, 1)
    assert cleared == [1] and cache.evicted == evicted + [3]
    slot.evaluate(None, tuples[:15], pad_to, "energy", 2, 1)
    assert cleared == [1, 1]


def test_worker_handle_keeps_each_runs_budget_and_peak():
    """The parent's handle of a mesh worker keeps each run's budget beside
    the worker's peak in that run, and the peak over all runs."""
    handle = slot_worker.SlotWorker(0, "cpu")
    base = dict(launches=0, fermi_launches=0, density_launches=0,
                window_launches=0, gemm_by_kind={}, sp2_calls=0,
                scc_captures=0, scc_hits=0,
                scc_eager=0, stage_captures=0, stage_hits=0, stage_eager=0,
                scc_held_bytes=0, parts=1, modules=[], build_dir="")
    for run, budget, peak in ((1, 100, 60), (2, 80, 70), (2, 80, 75)):
        handle.record(dict(base, run=run, budget_bytes=budget,
                           peak_bytes=peak))
    assert handle.run_memory == {1: (100, 60), 2: (80, 75)}
    assert handle.peak_bytes == 75 and handle.budget_bytes == 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    scc_graph.clear()
    return torch.device("cuda")


def _launches():
    return (fermi_fill.launches, fermi_fill.density_launches,
            jacobi_eigh.launches, sp2.calls, batched_eigh.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_cached_graph_equals_eager_on_the_card(cuda, monkeypatch, route):
    """On a card, A (a miss), B (a hit on other inputs), A again (a hit):
    each the eager loop's charges, residuals and launches, bit for bit;
    the hits capture nothing."""
    if ROUTES[route][4]:
        monkeypatch.setattr(te, "PALLAS_EIGH_MAX_N", 2)
    settings, ops_a = _operands(route, CALLS[0], device=cuda)
    frag = ops_a[5]
    pad_to = (frag.coords.shape[1], frag.sh_mask.shape[1],
              frag.ao_mask.shape[1])
    _, ops_b = _operands(route, CALLS[1], device=cuda,
                         pad_to=pad_to)

    def run(ops, graph):
        n = _launches()
        q, resid = _solve(settings, ops, graph=graph)
        torch.cuda.synchronize()
        return q, resid, [b - a for a, b in zip(n, _launches())]

    for k, ops in enumerate((ops_a, ops_b, ops_a)):
        captures = scc_graph.stats["captures"]
        q_e, r_e, n_e = run(ops, False)
        q_g, r_g, n_g = run(ops, True)
        assert torch.equal(q_g, q_e) and torch.equal(r_g, r_e)
        assert n_g == n_e and sum(n_e) > 0
        assert scc_graph.stats["captures"] - captures == (k == 0)
