"""The port's device mesh and sharded executor against the JAX package's.

`_resolve_groups` and the mesh layout equal the JAX package's over a grid
of device counts and topology knobs; `shard_leading_axis` cuts a batch in
mesh order; the executor's results do not depend on the device count
(meshes of 1, 2, 3 and 4 "cpu" slots, fragment counts that are no
multiple; energies and gradients 1e-12 in GFN1, where the padded chunk
converges to the digit, 1e-10 in GFN2); the water-trimer MBE(2) set of
`__graft_entry__.py` (workloads.py) through a 2D mesh with the f64 polish
lands on the float64 result (1e-9, that file's third oracle); and
`workloads.entry` gives the live JAX `entry()` value (1e-10 Ha).

Worker processes: on a mesh of several slots every piece is evaluated in
a worker process of its own (`parallel/slot_worker.py`), here on "cpu"
slots: one executor per mesh size is shared by the file's tests, and
every wait on a worker is bounded by the executor's `timeout`. The
workers' energies equal the JAX executor's on a two-device JAX mesh
(1e-10 Ha); they live across `run` calls and are gone after `close()`; a
one-slot mesh starts no process and no thread; results do not depend on
the caller's grad mode; a worker's exception (at its start, or in a
piece) and a killed worker raise in the caller with the slot's index and
device; a parameter overlay loaded at run time reaches workers started
before and after it (1e-12); the workers' SP2 calls reach the caller's
count. The Jacobi kernel's build runs nvcc and loads the library once
when four threads make the first call together, and its launch counts
are exact under four threads.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from _torch_port_common import restore_jax_overlay

from metalquicha_tpu_torch.driver import _mesh_devices, make_executor
from metalquicha_tpu_torch.io.config import parse_mqc_string
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.stubs import DFTMethod
from metalquicha_tpu_torch.methods.xtb import params_gfn1
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.methods.xtb.polish import HostPolisher
from metalquicha_tpu_torch.ops import anderson_window, batched_eigh
from metalquicha_tpu_torch.ops import fragment_gemm, fragment_reduce
from metalquicha_tpu_torch.ops import fermi_fill
from metalquicha_tpu_torch.ops import jacobi_eigh as jac
from metalquicha_tpu_torch.ops import kernel_build
from metalquicha_tpu_torch.ops import sp2
from metalquicha_tpu_torch.parallel import executor as executor_mod
from metalquicha_tpu_torch.parallel import slot_worker
from metalquicha_tpu_torch.parallel.executor import FragmentExecutor
from metalquicha_tpu_torch.parallel.mesh import (
    FRAG_AXIS,
    GROUP_AXIS,
    FragmentMesh,
    _resolve_groups,
    cut_leading_axis,
    fragment_mesh,
    replicate,
    shard_leading_axis,
)
from metalquicha_tpu_torch.workloads import (
    bench_dimers,
    entry,
    trimer_mbe2_assemble,
    trimer_mbe2_fragments,
    water_fragments,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: seconds any wait on a worker may take here (its start included)
TIMEOUT = 300


@pytest.fixture(autouse=True)
def _quiet():
    global_logger.set_level("warning")


@pytest.fixture(scope="module")
def slots():
    """slots(n, calc, polisher=None): the file's executor over n "cpu"
    worker slots (laid out with nodes_per_group=2), set to evaluate with
    `calc`; one per mesh size, since a worker's start costs seconds, all
    closed after the file."""
    made = {}

    def get(n, calc, polisher=None):
        if n not in made:
            made[n] = FragmentExecutor(
                calc, mesh=fragment_mesh(["cpu"] * n, nodes_per_group=2),
                timeout=TIMEOUT)
        ex = made[n]
        ex.calc, ex.polisher = calc, polisher
        return ex

    yield get
    for ex in made.values():
        ex.close()


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 12])
def test_resolve_groups_matches_jax(n_devices):
    from metalquicha_tpu.parallel.mesh import _resolve_groups as jax_resolve

    knobs = [None, 0, 1, 2, 3, 4, 5, 8, 16, "2"]
    for gg in knobs:
        for npg in knobs:
            assert _resolve_groups(n_devices, gg, npg) == jax_resolve(
                n_devices, gg, npg), (n_devices, gg, npg)
    assert _resolve_groups(n_devices) == 1


@pytest.mark.parametrize("n_devices,knobs", [
    (1, {}), (4, {}), (4, {"nodes_per_group": 2}), (8, {"global_groups": 2}),
    (6, {"global_groups": 4}), (3, {"nodes_per_group": 2}),
    (8, {"global_groups": 1}),
])
def test_mesh_layout_matches_jax(n_devices, knobs):
    import jax

    from metalquicha_tpu.parallel.mesh import fragment_mesh as jax_mesh

    ref = jax_mesh(jax.devices()[:n_devices], **knobs)
    mesh = fragment_mesh(["cpu"] * n_devices, **knobs)
    assert isinstance(mesh, FragmentMesh)
    assert mesh.devices.shape == ref.devices.shape
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.shape == dict(ref.shape)
    assert mesh.size == n_devices and mesh.flat == [CPU] * n_devices
    assert set(mesh.axis_names) <= {GROUP_AXIS, FRAG_AXIS}


def test_mesh_needs_a_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fragment_mesh()
    with pytest.raises(ValueError):
        fragment_mesh([])
    assert fragment_mesh(["cpu"]).flat == [CPU]
    assert _mesh_devices("cuda") is None
    assert _mesh_devices("cuda:1") == [torch.device("cuda", 1)]
    assert _mesh_devices("cpu") == [CPU]


def test_mesh_over_all_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = fragment_mesh(nodes_per_group=2)
    assert mesh.shape == {GROUP_AXIS: 2, FRAG_AXIS: 2}
    assert mesh.flat == [torch.device("cuda", i) for i in range(4)]


def test_shard_leading_axis_cuts_in_mesh_order():
    calc = XtbCalculator(device="cpu")
    frag = calc.make_batch(bench_dimers(6))
    one = shard_leading_axis(frag, fragment_mesh(["cpu"]))
    assert len(one) == 1 and all(a is b for a, b in zip(one[0], frag))
    mesh = fragment_mesh(["cpu"] * 3, global_groups=3)
    pieces = shard_leading_axis(frag, mesh)
    assert len(pieces) == 3 and type(pieces[0]) is type(frag)
    for k, piece in enumerate(pieces):
        for name in frag._fields:
            whole, part = getattr(frag, name), getattr(piece, name)
            assert part.shape[0] == 2
            assert torch.equal(part, whole[2 * k : 2 * k + 2]), name
        # the shared D3 pair table stays a broadcast view
        assert piece.d3_c6_pair.stride(0) == 0
    with pytest.raises(ValueError, match="not a multiple"):
        shard_leading_axis(frag, fragment_mesh(["cpu"] * 4))
    views = cut_leading_axis(frag, 3)
    assert all(v.coords.data_ptr() == p.coords.data_ptr()
               for v, p in zip(views, pieces))
    assert cut_leading_axis(frag, 1)[0] is frag
    copies = replicate(frag, mesh)
    assert len(copies) == 3
    assert all(torch.equal(a, b) for c in copies for a, b in zip(c, frag))


def _run(ex, frags):
    e, g, aux = ex.run(frags, what="gradient")
    return e, g, aux


@pytest.mark.parametrize("variant,tol", [("gfn1", 1e-12), ("gfn2", 1e-10)])
def test_results_do_not_depend_on_the_device_count(slots, variant, tol):
    """5 waters and 2 dimers (two buckets) over 1 slot and 2, 3 and 4
    worker slots."""
    frags = water_fragments(5) + bench_dimers(2)
    calc = XtbCalculator(variant=variant, device="cpu")
    e1, g1, aux1 = _run(FragmentExecutor(calc), frags)
    assert FragmentExecutor(calc).mesh.flat == [CPU]
    for n in (2, 3, 4):
        ex = slots(n, calc)
        assert ex.n_devices == n
        e, g, aux = _run(ex, frags)
        assert np.abs(e - e1).max() <= tol, n
        for a, b in zip(g, g1):
            assert a.shape == b.shape and np.abs(a - b).max() <= tol, n
        assert np.abs(aux["dipole"] - aux1["dipole"]).max() <= 10 * tol
        for a, b in zip(aux["charges"], aux1["charges"]):
            assert a.shape == b.shape and np.abs(a - b).max() <= 10 * tol
        assert [w.index for w in ex.workers] == list(range(n))
        assert len({w.pid for w in ex.workers}) == n


def test_energy_path_and_chunk_cap_on_a_mesh(slots, monkeypatch):
    """The cap holds per slot's piece, so a chunk is the slot count times
    a piece's cap; chunks are padded with the dummy fragment to a multiple
    of the slot count; neither shows in the results."""
    frags = water_fragments(7)
    calc = XtbCalculator(device="cpu")
    e1, _ = FragmentExecutor(calc).run(frags, what="energy")
    ex = slots(3, calc)
    # room for 4 fragments of the bucket's 11 AOs in a piece: chunks of 12
    monkeypatch.setattr(executor_mod, "MAX_CHUNK_ELEMENTS", 4 * 11 * 11 + 1)
    assert ex._max_chunk((4, 8, 11)) == 12
    assert FragmentExecutor(calc)._max_chunk((4, 8, 11)) == 4
    # room for one: chunks of 3, one fragment per piece
    monkeypatch.setattr(executor_mod, "MAX_CHUNK_ELEMENTS", 11 * 11 + 1)
    assert ex._max_chunk((4, 8, 11)) == 3
    assert FragmentExecutor(calc)._max_chunk((4, 8, 11)) == 1
    sizes = []
    run_chunk = ex._run_chunk
    monkeypatch.setattr(
        ex, "_run_chunk",
        lambda members, *a: (sizes.append(len(members)), run_chunk(members, *a)))
    e3, _ = ex.run(frags, what="energy")
    assert sizes == [3, 3, 1]
    assert np.abs(e3 - e1).max() <= 1e-12
    # the cap never falls below one fragment per device
    monkeypatch.setattr(executor_mod, "MAX_CHUNK_ELEMENTS", 1.0)
    assert ex._max_chunk((4, 8, 11)) == 3


def test_calculator_on_another_device_shares_its_state():
    calc = XtbCalculator(variant="gfn2", dtype=torch.float32, device="cpu")
    assert calc.on("cpu") is calc and calc.on(CPU) is calc
    other = calc.on(torch.device("meta"))
    assert other is not calc and other.device == torch.device("meta")
    assert (other.settings, other.variant, other.dtype, other.solvation) == (
        calc.settings, calc.variant, calc.dtype, calc.solvation)


def test_host_method_runs_on_any_mesh():
    """The placeholder methods compute on the host and take no device (and
    no worker)."""
    frags = water_fragments(3)
    ex = FragmentExecutor(DFTMethod(), mesh=fragment_mesh(["cpu"] * 2))
    e, g, _ = ex.run(frags, "gradient")
    assert e.tolist() == [-3.0, -3.0, -3.0] and g[0].shape == (3, 3)
    assert ex.workers == []
    assert FragmentExecutor(DFTMethod()).mesh.flat == [CPU]


def test_trimer_set_matches_the_dry_run_workload():
    import __graft_entry__ as graft

    ref = graft._water_fragments(3)
    frags = trimer_mbe2_fragments()
    assert len(frags) == 6
    for (z, c, q, m), (zr, cr, qr, mr) in zip(frags[:3], ref):
        assert (z == zr).all() and np.abs(c - cr).max() <= 1e-12
        assert (q, m) == (qr, mr)
    assert [len(f[0]) for f in frags[3:]] == [6, 6, 6]
    assert np.abs(frags[4][1] - np.vstack([ref[0][1], ref[2][1]])).max() == 0
    total, g_sys = trimer_mbe2_assemble(
        np.arange(6.0), [np.full((len(f[0]), 3), float(k))
                         for k, f in enumerate(frags)])
    assert total == -0.0 - 1.0 - 2.0 + 3.0 + 4.0 + 5.0
    # atom block a collects -g_a and its two dimers
    assert np.allclose(g_sys[0], -0.0 + 3.0 + 4.0)
    assert np.allclose(g_sys[4], -1.0 + 3.0 + 5.0)
    assert np.allclose(g_sys[8], -2.0 + 4.0 + 5.0)


def test_trimer_on_a_2d_mesh_with_the_polish_matches_f64(slots):
    """`__graft_entry__.dryrun_multichip`'s oracles on four worker slots:
    device count invariance in f64 (1e-12), raw f32 within 5e-3, f32 +
    polish within 1e-9 of the float64 total and gradient norm."""
    frags = trimer_mbe2_fragments()
    calc64 = XtbCalculator(device="cpu")
    mesh = slots(4, calc64).mesh
    assert mesh.shape == {GROUP_AXIS: 2, FRAG_AXIS: 2}
    e64, g64, _ = _run(FragmentExecutor(calc64), frags)
    total64, gs64 = trimer_mbe2_assemble(e64, g64)
    em, gm, _ = _run(slots(4, calc64), frags)
    total_m, gs_m = trimer_mbe2_assemble(em, gm)
    assert abs(total_m - total64) <= 1e-12
    assert np.abs(gs_m - gs64).max() <= 1e-12

    calc32 = XtbCalculator(dtype=torch.float32, device="cpu")
    e32, g32, aux32 = _run(slots(4, calc32), frags)
    total32, gs32 = trimer_mbe2_assemble(e32, g32)
    assert float(aux32["scf_residual"].max()) < 1e-4
    assert abs(total32 - total64) < 5e-3
    ep, gp, _ = _run(slots(4, calc32, HostPolisher(calc32)), frags)
    total_p, gs_p = trimer_mbe2_assemble(ep, gp)
    assert abs(total_p - total64) < 1e-9
    assert abs(np.sqrt((gs_p**2).sum()) - np.sqrt((gs64**2).sum())) < 1e-9
    assert abs(total_p - total64) < abs(total32 - total64)


def test_entry_matches_live_jax():
    import jax

    import __graft_entry__ as graft

    restore_jax_overlay()
    fn_j, args_j = graft.entry()
    ref = float(jax.jit(fn_j)(*args_j))
    fn, (coords, frag) = entry(device="cpu")
    with torch.no_grad():
        val = float(fn(coords, frag))
    assert abs(val - ref) <= 1e-10
    c = coords.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(c, frag), c)
    assert g.shape == coords.shape and bool(torch.isfinite(g).all())


PRISM_GROUPS = """
%schema
name = mqc-frag
version = 1.0
index_base = 0
units = angstrom
end

%model
method = XTB-GFN1
end

%driver
type = Energy
end

%system
{knob}
end

%structure
charge = 0
multiplicity = 1
end

%geometry
3

O 0.0 0.0 0.117
H 0.0 0.757 -0.471
H 0.0 -0.757 -0.471
end
"""


def test_make_executor_builds_the_mesh_from_the_driver_knobs(monkeypatch):
    cfg = parse_mqc_string(PRISM_GROUPS.format(knob=""))
    ex = make_executor(cfg, "cpu")
    assert ex.mesh.flat == [CPU] and ex.mesh.axis_names == (FRAG_AXIS,)
    # four visible cards, laid out by the knobs (no card is touched: the
    # calculator is only constructed)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for overrides, shape in (
        ({}, {FRAG_AXIS: 4}),
        ({"global_groups": 2}, {GROUP_AXIS: 2, FRAG_AXIS: 2}),
        ({"nodes_per_group": 1}, {GROUP_AXIS: 4, FRAG_AXIS: 1}),
        ({"global_groups": 3}, {GROUP_AXIS: 2, FRAG_AXIS: 2}),
    ):
        ex = make_executor(cfg, "cuda", overrides)
        assert ex.mesh.shape == shape, overrides
        assert ex.n_devices == 4
    one = make_executor(cfg, "cuda:2", {"global_groups": 2})
    assert one.mesh.flat == [torch.device("cuda", 2)]


def test_worker_slots_match_the_jax_executor_on_two_devices(slots):
    """The same fragments through the JAX executor on a two-device JAX CPU
    mesh and through two worker slots: energies 1e-10 Ha."""
    import jax

    from metalquicha_tpu.methods.xtb.calculator import (
        XtbCalculator as JaxCalculator,
    )
    from metalquicha_tpu.parallel.executor import (
        FragmentExecutor as JaxExecutor,
    )
    from metalquicha_tpu.parallel.mesh import fragment_mesh as jax_mesh

    restore_jax_overlay()
    frags = water_fragments(3)
    jex = JaxExecutor(JaxCalculator(), mesh=jax_mesh(jax.devices()[:2]))
    assert jex.n_devices == 2
    ref, _ = jex.run(frags, what="energy")
    e, _ = slots(2, XtbCalculator(device="cpu")).run(frags, what="energy")
    assert np.abs(e - np.asarray(ref)).max() <= 1e-10


def test_workers_persist_across_runs_and_stop_on_close(slots):
    frags = water_fragments(4)
    ex = slots(2, XtbCalculator(device="cpu"))
    e1, _ = ex.run(frags, what="energy")
    workers = list(ex.workers)
    pids = [w.pid for w in workers]
    assert len(set(pids)) == 2 and os.getpid() not in pids
    assert [w.device for w in workers] == [CPU, CPU]
    assert all(w.startup_s > 0 and w.alive() for w in workers)
    for w in workers:  # nothing of jax or of the JAX package in a worker
        assert {"torch", "metalquicha_tpu_torch"} <= set(w.modules)
        assert not {"jax", "metalquicha_tpu"} & set(w.modules)
    e2, _ = ex.run(frags, what="energy")
    assert [w.pid for w in ex.workers] == pids and np.all(e2 == e1)
    ex.close()
    assert ex.workers == []
    for w in workers:
        assert not w.alive() and w.proc.returncode == 0
        with pytest.raises(ProcessLookupError):
            os.kill(w.pid, 0)
    # a later run starts new ones
    e3, _ = ex.run(frags, what="energy")
    assert not set(pids) & {w.pid for w in ex.workers}
    assert np.all(e3 == e1)


def test_one_slot_takes_no_thread(monkeypatch):
    """A one-slot mesh starts no process and no thread."""

    def no_process(*args, **kwargs):
        raise AssertionError("a one-slot mesh started a process")

    monkeypatch.setattr(slot_worker.subprocess, "Popen", no_process)
    threads = set(threading.enumerate())
    ex = FragmentExecutor(XtbCalculator(device="cpu"))
    e, g, _ = _run(ex, water_fragments(3))
    assert ex.workers == [] and set(threading.enumerate()) == threads
    assert e.shape == (3,) and g[0].shape == (3, 3)


@pytest.mark.parametrize("n", [1, 2])
def test_gradients_do_not_depend_on_the_callers_grad_mode(slots, n):
    frags = water_fragments(2)
    calc = XtbCalculator(device="cpu")
    e1, g1, _ = _run(FragmentExecutor(calc), frags)
    ex = FragmentExecutor(calc) if n == 1 else slots(n, calc)
    with torch.no_grad():
        e, g, _ = _run(ex, frags)
    assert np.abs(e - e1).max() <= 1e-12
    for a, b in zip(g, g1):
        assert np.abs(a - b).max() <= 1e-12


def test_a_slots_exception_reaches_the_caller(monkeypatch):
    """A device only the worker refuses (the CPU has no card; a card has
    no device of the next index): the worker's start fails, and the
    caller raises with the slot's index and device. (The caller builds
    the Fermi, Anderson window, fragment product and fragment sum kernels
    and the eigh binding for a mesh with a card before any worker starts;
    the CPU has no compiler, so those builds are taken as done.)"""
    for mod in (fermi_fill, anderson_window, fragment_gemm, fragment_reduce,
                batched_eigh):
        monkeypatch.setattr(mod, "build", lambda: None)
    card = torch.device("cuda", torch.cuda.device_count())
    ex = FragmentExecutor(XtbCalculator(device="cpu"),
                          mesh=fragment_mesh(["cpu", card]), timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match=rf"mesh slot 1 \({card}\) "
                                           r"failed: ") as info:
        ex.run(water_fragments(2), what="energy")
    cause = info.value.__cause__
    assert isinstance(cause, Exception)
    assert "in the slot's worker" in cause.__notes__[0]
    if not torch.cuda.is_available():
        assert "CUDA is not available" in str(info.value)
    assert ex.workers == []


def test_a_workers_exception_in_a_piece_reaches_the_caller(slots):
    """A malformed fragment fails where its piece's batch is built, in
    slot 1's worker; every worker stops, and the next run starts anew."""
    ex = slots(2, XtbCalculator(device="cpu"))
    ex.run(water_fragments(2), what="energy")
    frags = water_fragments(4)
    frags[3] = (frags[3][0], frags[3][1][:, :2], 0, 1)
    with pytest.raises(RuntimeError, match=r"mesh slot 1 \(cpu\) failed: "
                                           r"ValueError: could not broadcast"
                       ) as info:
        ex.run(frags, what="gradient")
    assert isinstance(info.value.__cause__, ValueError)
    assert ex.workers == []
    e, _ = ex.run(water_fragments(2), what="energy")
    assert np.isfinite(e).all() and len(ex.workers) == 2


@pytest.mark.parametrize("when", ["between runs", "during a piece"])
def test_a_killed_worker_raises_in_the_caller(slots, when):
    """Slot 1's worker is killed before a run, or while it evaluates its
    piece (200 dimers take it seconds); the caller raises at once."""
    ex = slots(2, XtbCalculator(device="cpu"))
    ex.run(water_fragments(2), what="energy")
    victim = ex.workers[1]
    frags = water_fragments(2)
    if when == "between runs":
        os.kill(victim.pid, signal.SIGKILL)
        victim.proc.wait(timeout=TIMEOUT)
    else:
        frags = bench_dimers(200)
        threading.Timer(0.5, os.kill, (victim.pid, signal.SIGKILL)).start()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"mesh slot 1 \(cpu\) failed: "
                                           r"WorkerExited: .* code -9"):
        ex.run(frags, what="energy")
    assert time.monotonic() - t0 < slot_worker.GRACE + 30
    assert ex.workers == [] and not victim.alive()


@pytest.mark.parametrize("started", ["before", "after"])
def test_a_run_time_overlay_reaches_the_workers(slots, tmp_path, started):
    """The caller loads an overlay at run time (the shipped GFN1 overlay
    with one global and one element changed); workers started before it
    and after it compute with it: the one-slot energies to 1e-12."""
    with open(params_gfn1._OVERLAY_PATH) as fh:
        overlay = json.load(fh)
    overlay["globals"]["kpol"] = overlay["globals"].get("kpol", 2.85) + 0.1
    overlay["elements"]["8"]["gam"] = overlay["elements"]["8"]["gam"] * 1.01
    path = tmp_path / "overlay.json"
    path.write_text(json.dumps(overlay))
    frags = water_fragments(2) + bench_dimers(2)
    calc = XtbCalculator(device="cpu")
    ex = slots(2, calc)
    if started == "after":
        ex.close()
    else:
        ex.run(frags, what="energy")
    e_shipped, _ = FragmentExecutor(calc).run(frags, what="energy")
    try:
        params_gfn1.load_overlay(str(path))
        e1, _ = FragmentExecutor(calc).run(frags, what="energy")
        e2, _ = ex.run(frags, what="energy")
    finally:
        params_gfn1.load_overlay(params_gfn1._OVERLAY_PATH)
    assert np.abs(e1 - e_shipped).min() > 1e-6
    assert np.abs(e2 - e1).max() <= 1e-12
    # and back: the shipped tables reach the same workers again
    e3, _ = ex.run(frags, what="energy")
    assert np.abs(e3 - e_shipped).max() <= 1e-12


def test_worker_counts_reach_the_caller(slots):
    """Two 11-water clusters (66 AOs) on the float32 fast route go through
    SP2 in each worker; the workers' calls are added to the caller's
    count."""
    waters = water_fragments(11)
    cluster = (np.concatenate([w[0] for w in waters]),
               np.concatenate([w[1] for w in waters]), 0, 1)
    shifted = (cluster[0], cluster[1] + 0.01, 0, 1)
    calc = XtbCalculator(settings_from_params("gfn1", max_scf_iter=8,
                                              use_pallas_eigh=True),
                         dtype=torch.float32, device="cpu")
    # one fragment per run, as each worker's piece: float32 rounds by the
    # batch it is handed
    e1 = np.concatenate([FragmentExecutor(calc).run([f], what="energy")[0]
                         for f in (cluster, shifted)])
    ex = slots(2, calc)
    before = [w.sp2_calls for w in ex.workers] or [0, 0]
    n0 = sp2.calls
    e, _ = ex.run([cluster, shifted], what="energy")
    made = [w.sp2_calls - b for w, b in zip(ex.workers, before)]
    assert min(made) > 0 and sp2.calls - n0 == sum(made)
    assert np.abs(e - e1).max() <= 1e-10


def test_workers_load_the_callers_kernel_build(slots, monkeypatch,
                                              tmp_path):
    """A worker takes the caller's build directory (that of
    `compile_cache.enable`, a fresh temporary one with
    MQC_COMPILE_CACHE=0), and a later change reaches it too."""
    calc = XtbCalculator(device="cpu")
    ex = slots(2, calc)
    ex.close()
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    ex.run(water_fragments(2), what="energy")
    assert [w.build_dir for w in ex.workers] == [str(tmp_path)] * 2
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "later")
    ex.run(water_fragments(2), what="energy")
    assert [w.build_dir for w in ex.workers] == [str(tmp_path / "later")] * 2


def test_the_kernel_is_built_before_any_worker_starts(monkeypatch):
    """With a card among the slots and the Jacobi kernel's route on, the
    caller builds the Fermi, Anderson window, fragment product, fragment
    sum and Jacobi kernels and the eigh binding before it starts a worker,
    so the workers
    only load them
    (here the card's slot then fails to start: the CPU has no card, and a
    card no device of the next index)."""
    events = []
    monkeypatch.setattr(jac, "build", lambda: events.append("build"))
    monkeypatch.setattr(fermi_fill, "build",
                        lambda: events.append("build fermi"))
    monkeypatch.setattr(anderson_window, "build",
                        lambda: events.append("build window"))
    monkeypatch.setattr(fragment_gemm, "build",
                        lambda: events.append("build products"))
    monkeypatch.setattr(fragment_reduce, "build",
                        lambda: events.append("build sums"))
    monkeypatch.setattr(batched_eigh, "build",
                        lambda: events.append("build eigh"))
    popen = slot_worker.subprocess.Popen

    def record(*args, **kwargs):
        events.append("start")
        return popen(*args, **kwargs)

    monkeypatch.setattr(slot_worker.subprocess, "Popen", record)
    card = torch.device("cuda", torch.cuda.device_count())
    calc = XtbCalculator(settings_from_params("gfn1", use_pallas_eigh=True),
                         device="cpu")
    ex = FragmentExecutor(calc, mesh=fragment_mesh(["cpu", card]),
                          timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match=rf"mesh slot 1 \({card}\)"):
        ex.run(water_fragments(2), what="energy")
    assert events == ["build fermi", "build window", "build products",
                      "build sums", "build eigh", "build", "start", "start"]
    assert ex.workers == []


def test_kernel_build_runs_once_from_four_threads(monkeypatch, tmp_path):
    calls = {"nvcc": 0, "load": 0}
    real_run = subprocess.run

    def fake_run(argv, **kwargs):
        if argv[0] != "fake-nvcc":
            return real_run(argv, **kwargs)
        calls["nvcc"] += 1
        threading.Event().wait(0.05)  # let the other threads arrive
        with open(argv[argv.index("-o") + 1], "wb") as fh:
            fh.write(b"so")
        return subprocess.CompletedProcess(argv, 0, "", "")

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1
            self.path = path
            for name in ("mqc_jacobi_eigh_f32", "mqc_jacobi_eigh_f64",
                         "mqc_cuda_error_string"):
                setattr(self, name, types.SimpleNamespace())

    monkeypatch.setattr(jac._LIB, "lib", None)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "nvcc", lambda: "fake-nvcc")
    monkeypatch.setattr(kernel_build.subprocess, "run", fake_run)
    monkeypatch.setattr(kernel_build.ctypes, "CDLL", FakeLib)
    barrier = threading.Barrier(4)
    libs = []

    def first_call():
        barrier.wait()
        libs.append(jac.build())

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert calls == {"nvcc": 1, "load": 1}
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert jac.build() is libs[0] and calls == {"nvcc": 1, "load": 1}
    assert [p.name for p in tmp_path.iterdir()] == [
        libs[0].path.rsplit("/", 1)[1]]


def test_launch_counts_are_exact_under_four_threads(monkeypatch):
    """Four threads, two to a stream, launch at once; the count's read and
    write are pulled apart by a thread switch, so an update made without
    the lock would be lost."""

    class SwitchingDict(dict):
        def get(self, key, default=None):
            value = super().get(key, default)
            time.sleep(0)  # let another thread in between read and write
            return value

    lib = types.SimpleNamespace(mqc_jacobi_eigh_f64=lambda *args: 0)
    slot = threading.local()
    monkeypatch.setattr(jac, "build", lambda: lib)
    monkeypatch.setattr(jac, "launches", 0)
    monkeypatch.setattr(jac, "launches_by_stream", SwitchingDict())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=slot.stream))
    a = torch.eye(2, dtype=torch.float64)[None]
    per_thread = 500
    barrier = threading.Barrier(4)

    def launch_many(k):
        slot.stream = 100 + k % 2
        barrier.wait()
        for _ in range(per_thread):
            jac._launch(a, 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        threads = [threading.Thread(target=launch_many, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert jac.launches == 4 * per_thread
    assert dict(jac.launches_by_stream) == {100: 2 * per_thread,
                                            101: 2 * per_thread}
