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

Concurrent dispatch: on a mesh of several slots every piece runs in a
thread of its own, all at once (a barrier that only opens when every slot
has arrived); a one-slot mesh takes no thread; results do not depend on
the caller's grad mode; a slot's exception reaches the caller with the
slot's index and device; the Jacobi kernel's build runs nvcc and loads the
library once when four threads make the first call together, and its
launch counts are exact under four threads.
"""

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
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.polish import HostPolisher
from metalquicha_tpu_torch.ops import jacobi_eigh as jac
from metalquicha_tpu_torch.parallel import executor as executor_mod
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


@pytest.fixture(autouse=True)
def _quiet():
    global_logger.set_level("warning")


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
def test_results_do_not_depend_on_the_device_count(variant, tol):
    """5 waters and 2 dimers (two buckets) over 1, 2, 3 and 4 slots."""
    frags = water_fragments(5) + bench_dimers(2)
    calc = XtbCalculator(variant=variant, device="cpu")
    e1, g1, aux1 = _run(FragmentExecutor(calc), frags)
    assert FragmentExecutor(calc).mesh.flat == [CPU]
    for n in (2, 3, 4):
        mesh = fragment_mesh(["cpu"] * n, nodes_per_group=2)
        ex = FragmentExecutor(calc, mesh=mesh)
        assert ex.n_devices == n
        e, g, aux = _run(ex, frags)
        assert np.abs(e - e1).max() <= tol, n
        for a, b in zip(g, g1):
            assert a.shape == b.shape and np.abs(a - b).max() <= tol, n
        assert np.abs(aux["dipole"] - aux1["dipole"]).max() <= 10 * tol
        for a, b in zip(aux["charges"], aux1["charges"]):
            assert a.shape == b.shape and np.abs(a - b).max() <= 10 * tol


def test_energy_path_and_chunk_cap_on_a_mesh(monkeypatch):
    """Chunks are cut to a multiple of the device count and padded with
    the dummy fragment; neither shows in the results."""
    frags = water_fragments(7)
    calc = XtbCalculator(device="cpu")
    e1, _ = FragmentExecutor(calc).run(frags, what="energy")
    ex = FragmentExecutor(calc, mesh=fragment_mesh(["cpu"] * 3))
    # room for 4 fragments of the bucket's 11 AOs: chunks of 3
    monkeypatch.setattr(executor_mod, "MAX_CHUNK_ELEMENTS", 4 * 11 * 11 + 1)
    assert ex._max_chunk((4, 8, 11)) == 3
    assert FragmentExecutor(calc)._max_chunk((4, 8, 11)) == 4
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
    """The placeholder methods compute on the host and take no device."""
    frags = water_fragments(3)
    e, g, _ = FragmentExecutor(
        DFTMethod(), mesh=fragment_mesh(["cpu"] * 2)).run(frags, "gradient")
    assert e.tolist() == [-3.0, -3.0, -3.0] and g[0].shape == (3, 3)
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


def test_trimer_on_a_2d_mesh_with_the_polish_matches_f64():
    """`__graft_entry__.dryrun_multichip`'s oracles on four slots: device
    count invariance in f64 (1e-12), raw f32 within 5e-3, f32 + polish
    within 1e-9 of the float64 total and gradient norm."""
    frags = trimer_mbe2_fragments()
    mesh = fragment_mesh(["cpu"] * 4, nodes_per_group=2)
    assert mesh.shape == {GROUP_AXIS: 2, FRAG_AXIS: 2}
    calc64 = XtbCalculator(device="cpu")
    e64, g64, _ = _run(FragmentExecutor(calc64), frags)
    total64, gs64 = trimer_mbe2_assemble(e64, g64)
    em, gm, _ = _run(FragmentExecutor(calc64, mesh=mesh), frags)
    total_m, gs_m = trimer_mbe2_assemble(em, gm)
    assert abs(total_m - total64) <= 1e-12
    assert np.abs(gs_m - gs64).max() <= 1e-12

    calc32 = XtbCalculator(dtype=torch.float32, device="cpu")
    e32, g32, aux32 = _run(FragmentExecutor(calc32, mesh=mesh), frags)
    total32, gs32 = trimer_mbe2_assemble(e32, g32)
    assert float(aux32["scf_residual"].max()) < 1e-4
    assert abs(total32 - total64) < 5e-3
    ep, gp, _ = _run(
        FragmentExecutor(calc32, mesh=mesh, polisher=HostPolisher(calc32)),
        frags)
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


def _record_slots(monkeypatch, ex, n, fail_slot=None):
    """Wrap ex._evaluate: record each call's thread, hold every slot at a
    barrier that opens only when all n are inside (serial dispatch would
    time out there), and raise in slot `fail_slot`."""
    seen = []
    barrier = threading.Barrier(n, timeout=60)
    evaluate = ex._evaluate

    def wrapped(calc, frag, tuples, pad_to, what):
        me = threading.current_thread()
        seen.append((me.ident, me.name))
        if n > 1:
            barrier.wait()
        if fail_slot is not None and me.name.startswith(f"mqc-slot{fail_slot}"):
            raise ValueError("boom in this slot")
        return evaluate(calc, frag, tuples, pad_to, what)

    monkeypatch.setattr(ex, "_evaluate", wrapped)
    return seen


@pytest.mark.parametrize("n", [2, 4])
def test_slots_run_at_once_on_threads_of_their_own(monkeypatch, n):
    frags = water_fragments(2 * n)
    calc = XtbCalculator(device="cpu")
    e1, aux1 = FragmentExecutor(calc).run(frags, what="energy")
    ex = FragmentExecutor(calc, mesh=fragment_mesh(["cpu"] * n))
    seen = _record_slots(monkeypatch, ex, n)
    e, aux = ex.run(frags, what="energy")
    idents = {ident for ident, _ in seen}
    assert len(seen) == n and len(idents) == n
    assert threading.get_ident() not in idents
    assert sorted(name.split("_")[0] for _, name in seen) == [
        f"mqc-slot{k}" for k in range(n)]
    assert np.abs(e - e1).max() <= 1e-12
    assert np.abs(aux["dipole"] - aux1["dipole"]).max() <= 1e-11
    # slot k keeps its thread from chunk to chunk
    seen.clear()
    ex.run(frags, what="energy")
    assert {ident for ident, _ in seen} == idents
    assert [s is None for _pool, s in ex._slots] == [True] * n


def test_one_slot_takes_no_thread(monkeypatch):
    calc = XtbCalculator(device="cpu")
    ex = FragmentExecutor(calc)
    seen = _record_slots(monkeypatch, ex, 1)
    ex.run(water_fragments(3), what="energy")
    assert {ident for ident, _ in seen} == {threading.get_ident()}
    assert ex._slots is None


@pytest.mark.parametrize("n", [1, 2])
def test_gradients_do_not_depend_on_the_callers_grad_mode(n):
    frags = water_fragments(2)
    calc = XtbCalculator(device="cpu")
    e1, g1, _ = _run(FragmentExecutor(calc), frags)
    ex = FragmentExecutor(calc, mesh=fragment_mesh(["cpu"] * n))
    with torch.no_grad():
        e, g, _ = _run(ex, frags)
    assert np.abs(e - e1).max() <= 1e-12
    for a, b in zip(g, g1):
        assert np.abs(a - b).max() <= 1e-12


def test_a_slots_exception_reaches_the_caller(monkeypatch):
    calc = XtbCalculator(device="cpu")
    ex = FragmentExecutor(calc, mesh=fragment_mesh(["cpu"] * 2))
    seen = _record_slots(monkeypatch, ex, 2, fail_slot=1)
    with pytest.raises(RuntimeError, match=r"mesh slot 1 \(cpu\) failed: "
                                           r"ValueError: boom") as info:
        ex.run(water_fragments(4), what="gradient")
    assert isinstance(info.value.__cause__, ValueError)
    assert len(seen) == 2


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

    monkeypatch.setattr(jac, "_lib", None)
    monkeypatch.setattr(jac, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(jac, "_nvcc", lambda: "fake-nvcc")
    monkeypatch.setattr(jac.subprocess, "run", fake_run)
    monkeypatch.setattr(jac.ctypes, "CDLL", FakeLib)
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
