"""The Anderson window step (`ops/anderson_window.py`): the kernel's plain
versions, their dispatch, and the engine's loop through it.

On the CPU:
- `anderson_window_rowwise` (the kernel's order of elimination in
  elementwise ops) against `anderson_window_reference` (the torch algebra
  a CPU tensor runs) on seeded windows: at it = 0 and 1 (masked slots), a
  window partly and wholly filled, a near-singular G (two slots alike but
  for 1e-9) and a non-finite f_res; float64 to 1e-12, float32 to 1e-5,
  with the same step taken or rejected;
- the rowwise twin's bits for a fragment the same in batches of 1, 2 and 3
  and at another place in the batch;
- the reference's bits against the step it replaced in the engine (kept
  below as `_step_before_kernel`);
- the engine's loop calls the op once per iteration, and a GFN1 and a GFN2
  SCC of 32 iterations through it against the JAX package (1e-9);
- the dispatch: a CPU tensor never builds the kernel, another device
  raises, a CUDA tensor goes to the launch; the ctypes declarations
  against the C signatures; a window above the kernel's MAX_M raises for a
  CUDA tensor, and a CPU tensor takes any window: a GFN1 SCC at
  broyden_memory = 40 against the JAX package (1e-9).
The `gpu` cases hold the kernel to both plain versions on the card (a warp
per fragment up to nx = 32, a block above, a window streamed in tiles),
to the rowwise twin bit for bit on windows of small integers, and check
that a fragment's bits do not depend on its batch (`python3 -m pytest
--noconftest tests/test_torch_anderson_window.py -m gpu`).
"""

import re
import types

import numpy as np
import pytest
import torch
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
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.ops import anderson_window as aw
from metalquicha_tpu_torch.ops import kernel_build

torch.set_num_threads(1)
KT = 300.0 * KB_HARTREE
M = 12
#: (reg, c_lim) per dtype, as the engine passes them
LIMITS = {torch.float64: (1e-12, 1e3), torch.float32: (1e-4, 2.0)}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
#: case -> the iteration counter
CASES = {"it0": 0, "it1": 1, "partial": 5, "full": 11, "wrapped": 30,
         "near_singular": 20, "nonfinite": 7}


def _state(case, bsz=5, nx=14, dtype=torch.float64, seed=0, m=M):
    """A seeded loop state for `case`: (x, f_res, hist_x, hist_f, resid,
    active, it), window m. The windows hold a smooth sequence of states
    converging to a fixed point, as an SCC's do; slots not yet written are
    zero."""
    rng = np.random.default_rng(seed)
    it = CASES[case]
    target = rng.standard_normal((bsz, nx))
    hist_x = np.zeros((bsz, m, nx))
    hist_f = np.zeros((bsz, m, nx))
    for k in range(it):
        decay = 0.5 ** k
        xk = target + decay * rng.standard_normal((bsz, nx))
        hist_x[:, k % m] = xk
        hist_f[:, k % m] = (target - xk) * 0.7 + 1e-3 * decay * (
            rng.standard_normal((bsz, nx)))
    x = target + 0.5 ** it * rng.standard_normal((bsz, nx))
    f_res = (target - x) * 0.7
    if case == "near_singular":
        # two slots alike but for 1e-9: G near-singular
        hist_x[:, 3] = hist_x[:, 4] + 1e-9 * rng.standard_normal((bsz, nx))
        hist_f[:, 3] = hist_f[:, 4] + 1e-9 * rng.standard_normal((bsz, nx))
    if case == "nonfinite":
        f_res[0, 2] = np.nan
        f_res[1, 5] = np.inf
    resid = rng.uniform(0.0, 1.0, bsz)
    active = np.ones(bsz, dtype=bool)
    # one frozen fragment; a solve starts with every fragment active
    active[-1] = it < 1
    out = [torch.tensor(a, dtype=dtype) for a in
           (x, f_res, hist_x, hist_f, resid)]
    return (*out, torch.tensor(active), torch.tensor(it, dtype=torch.int64))


def _run(fn, state, dtype, scf_tol=1e-6):
    """fn on a copy of `state`; the updated (x, hist_x, hist_f, resid,
    active)."""
    x, f_res, hist_x, hist_f, resid, active, it = (t.clone() for t in state)
    reg, c_lim = LIMITS[dtype]
    fn(x, f_res, hist_x, hist_f, resid, active, it, beta=0.4, reg=reg,
       c_lim=c_lim, scf_tol=scf_tol)
    return x, hist_x, hist_f, resid, active


def _kw(fn):
    """A plain version called as the wrapper is (keywords)."""
    def call(*args, beta, reg, c_lim, scf_tol):
        return fn(*args, beta, reg, c_lim, scf_tol)
    return call


def _same(a, b):
    """Bit for bit, a NaN equal to a NaN."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def _close(a, b, tol):
    """Equal where both are non-finite, within tol elsewhere."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    same_nonfinite = bool(((~torch.isfinite(a)) == (~torch.isfinite(b))).all())
    return same_nonfinite and float((a - b)[fin].abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_rowwise_twin_matches_the_reference(case, dtype):
    state = _state(case, dtype=dtype)
    ref = _run(_kw(aw.anderson_window_reference), state, dtype)
    row = _run(_kw(aw.anderson_window_rowwise), state, dtype)
    for a, b in zip(ref, row):
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            assert _close(a, b, TOL[dtype])
    # the windows are written, not computed: equal bit for bit
    assert _same(ref[1], row[1]) and _same(ref[2], row[2])


@pytest.mark.parametrize("fn", ["reference", "rowwise"])
def test_first_iteration_counts_every_fragment_active(fn):
    """At it = 0 a fragment's flag is not read: a loop restarts from any
    earlier state by setting x and the counter (`engine._SccLoop.restart`),
    and the window's older slots are read only by the rejected first
    step."""
    window = _kw(getattr(aw, f"anderson_window_{fn}"))
    state = list(_state("it0"))
    fresh = _run(window, state, torch.float64)
    stale = list(state)
    stale[5] = torch.zeros_like(state[5])       # every flag off
    stale[2] = state[2] + 7.0                   # windows of another solve
    stale[3] = torch.full_like(state[3], float("nan"))
    stale[4] = torch.full_like(state[4], -3.0)  # residuals
    got = _run(window, stale, torch.float64)
    assert torch.equal(got[0], fresh[0]) and torch.equal(got[3], fresh[3])
    assert torch.equal(got[4], fresh[4])


def test_cases_take_and_reject_steps():
    """The cases reach both branches: the first step is damped, a later
    one extrapolated; a NaN residual freezes its fragment, an infinite
    one leaves it active with the damped (infinite) state."""
    dtype = torch.float64
    reg, c_lim = LIMITS[dtype]
    for case, want_damped in (("it0", True), ("full", False)):
        state = _state(case)
        x, f_res = state[0], state[1]
        got = _run(_kw(aw.anderson_window_reference), state, dtype)[0]
        damped = x + 0.4 * f_res
        assert torch.equal(got[:-1], damped[:-1]) == want_damped
    # the frozen fragment keeps its state
    assert torch.equal(got[-1], x[-1])
    state = _state("nonfinite")
    x, hist_x, hist_f, resid, active = _run(
        _kw(aw.anderson_window_rowwise), state, dtype)
    assert not bool(active[0]) and bool(active[1])
    assert torch.isnan(resid[0]) and torch.isinf(resid[1])
    assert torch.equal(x[1], state[0][1] + 0.4 * state[1][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rowwise_bits_do_not_depend_on_the_batch(dtype):
    """A fragment's results in batches of 1, 2 and 3, first and last."""
    state = _state("full", bsz=3, dtype=dtype, seed=4)
    whole = _run(_kw(aw.anderson_window_rowwise), state, dtype)
    for rows in ([0], [0, 1], [2, 0], [1, 2, 0]):
        idx = torch.tensor(rows)
        part = tuple(t.index_select(0, idx) if t.dim() else t
                     for t in state)
        got = _run(_kw(aw.anderson_window_rowwise), part, dtype)
        for a, b in zip(got, whole):
            assert _same(a, b.index_select(0, idx))


def _step_before_kernel(x, f_res, hist_x, hist_f, resid, active, it, *,
                        beta, reg, c_lim, scf_tol):
    """The window algebra of `engine._anderson_step` before the kernel
    (kept to compare with), for a fixed (B, m, nx) state."""
    m = hist_x.shape[1]
    slots = torch.arange(m)
    eye_m = torch.eye(m, dtype=x.dtype)
    it_resid = f_res.abs().amax(-1)
    slot = (it % m).view(1)
    hist_x.index_copy_(1, slot, x[:, None])
    hist_f.index_copy_(1, slot, f_res[:, None])
    prev = (it - 1) % m
    valid = ((slots <= it) & (slots != prev))[None, :, None]
    dX = torch.where(valid, hist_x - hist_x.index_select(1, prev.view(1)),
                     0.0)
    dF = torch.where(valid, hist_f - hist_f.index_select(1, prev.view(1)),
                     0.0)
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
    new_resid = torch.where(active, it_resid, resid)
    x.copy_(torch.where(active[:, None], x_next, x))
    resid.copy_(new_resid)
    active.copy_(active & (new_resid > scf_tol))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_keeps_the_bits_of_the_step_it_replaced(case, dtype):
    state = _state(case, dtype=dtype, seed=2)
    got = _run(aw.anderson_window, state, dtype)
    before = _run(_step_before_kernel, state, dtype)
    for a, b in zip(got, before):
        assert _same(a, b)


def test_engine_steps_through_the_window_op(monkeypatch):
    """One call of the op per SCC iteration, with the engine's limits."""
    calls = []
    real = te.anderson_window

    def counted(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(te, "anderson_window", counted)
    settings = tsp("gfn1", max_scf_iter=6)
    calc = tcalc.XtbCalculator(settings, device="cpu")
    frag = calc.make_batch([WATER, H3O])
    tcalc._converge_charges(frag.coords, frag, KT, settings)
    assert len(calls) == 6
    assert calls[0] == {"beta": settings.mixer_damping, "reg": 1e-12,
                        "c_lim": 1e3, "scf_tol": settings.scf_tol}


def test_scc_through_the_window_matches_jax():
    """A GFN1 and a GFN2 SCC of 32 iterations through the port's window
    op against the JAX package's while_loop, float64, 1e-9."""
    # imported here: the file's `gpu` cases run where jax is not installed
    import jax

    from metalquicha_tpu.methods.xtb import calculator as jcalc
    from metalquicha_tpu.methods.xtb import engine as je
    from metalquicha_tpu.methods.xtb.batch import build_batch
    from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp

    restore_jax_overlay()
    frags = [WATER, H3O, GLY3_FRAG]
    fixed = dict(max_scf_iter=32, scf_tol=0.0)
    jf = jax_fragment_data(frags)
    tf = port_from_jax(jf)
    settings = tsp("gfn1", **fixed)
    with torch.no_grad():
        S, H0, gamma, _ = tcalc._scc_operands(tf.coords, tf, settings)
    q, _ = te.scf_solve(H0, S, gamma, tf, KT, settings)
    jset = jsp("gfn1", **fixed)
    q_j, _ = jax.jit(jax.vmap(
        lambda h, s, g, f: je.scf_solve(h, s, g, f, KT, jset)
    ))(*(np.asarray(t.numpy()) for t in (H0, S, gamma)), jf)
    assert max_abs_diff(q, q_j) <= 1e-9

    jf2 = jcalc.fragment_data_from_batch(
        build_batch(frags, variant="gfn2"), variant="gfn2")
    tf2 = port_from_jax(jf2)
    z, _ = tcalc._converge_charges(tf2.coords, tf2, KT, tsp("gfn2", **fixed))
    jset = jsp("gfn2", **fixed)
    z_j, _ = jax.jit(jax.vmap(
        lambda c, f: jcalc._converge_charges(c, f, KT, jset)
    ))(jf2.coords, jf2)
    assert max_abs_diff(z, z_j) <= 1e-9


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    def refuse(*_args):
        raise AssertionError("the kernel was built for a CPU tensor")

    monkeypatch.setattr(aw, "build", refuse)
    monkeypatch.setattr(kernel_build, "compile_source", refuse)
    before = aw.launches
    state = _state("full")
    got = _run(aw.anderson_window, state, torch.float64)
    ref = _run(_kw(aw.anderson_window_reference), state, torch.float64)
    assert aw.launches == before
    assert all(_same(a, b) for a, b in zip(got, ref))


def test_other_devices_raise():
    state = [t.to("meta") for t in _state("full")]
    with pytest.raises(ValueError, match="device"):
        aw.anderson_window(*state, beta=0.4, reg=1e-12, c_lim=1e3,
                           scf_tol=0.0)


def test_window_above_the_kernel_raises(monkeypatch):
    """On a card a window above MAX_M raises, naming the limit, before the
    kernel is built or launched; MAX_M itself goes to the launch. A CPU
    tensor runs the same window on the plain version."""
    launched = []
    lib = types.SimpleNamespace(
        mqc_anderson_window_f64=lambda *args: launched.append(args) or 0)
    monkeypatch.setattr(aw._LIB, "lib", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    for m in (aw.MAX_M + 1, aw.MAX_M):
        state = _state("it1", bsz=2, nx=3, m=m)
        if m > aw.MAX_M:
            with pytest.raises(ValueError, match=f"MAX_M = {aw.MAX_M}"):
                aw._launch(*state, 0.4, 1e-12, 1e3, 0.0)
        else:
            aw._launch(*state, 0.4, 1e-12, 1e3, 0.0)
    assert len(launched) == 1 and launched[0][-4:-2] == (aw.MAX_M, 3)
    monkeypatch.undo()
    state = _state("wrapped", m=aw.MAX_M + 1)
    got = _run(aw.anderson_window, state, torch.float64)
    ref = _run(_kw(aw.anderson_window_reference), state, torch.float64)
    assert all(_same(a, b) for a, b in zip(got, ref))


def test_window_above_32_runs_on_the_cpu_and_matches_jax():
    """A GFN1 SCC at broyden_memory = 40 (above the first kernel's 32),
    48 iterations so the window wraps, through the port's window op on the
    CPU against the JAX package's scf_solve with the same setting (float64,
    1e-9)."""
    import jax

    from metalquicha_tpu.methods.xtb import engine as je
    from metalquicha_tpu.methods.xtb.engine import settings_from_params as jsp

    restore_jax_overlay()
    frags = [WATER, H3O, GLY3_FRAG]
    fixed = dict(max_scf_iter=48, scf_tol=0.0, broyden_memory=40)
    jf = jax_fragment_data(frags)
    tf = port_from_jax(jf)
    settings = tsp("gfn1", **fixed)
    assert settings.broyden_memory == 40
    calls = []
    real = te.anderson_window

    def counted(*args, **kw):
        calls.append(args[2].shape[1])
        return real(*args, **kw)

    te.anderson_window = counted
    try:
        with torch.no_grad():
            S, H0, gamma, _ = tcalc._scc_operands(tf.coords, tf, settings)
        q, _ = te.scf_solve(H0, S, gamma, tf, KT, settings)
    finally:
        te.anderson_window = real
    assert calls and set(calls) == {40}
    jset = jsp("gfn1", **fixed)
    q_j, _ = jax.jit(jax.vmap(
        lambda h, s, g, f: je.scf_solve(h, s, g, f, KT, jset)
    ))(*(np.asarray(t.numpy()) for t in (H0, S, gamma)), jf)
    assert max_abs_diff(q, q_j) <= 1e-9


def test_cuda_tensor_goes_to_the_kernel(monkeypatch):
    """The dispatch reads the device only: a tensor that says it lies on a
    card goes to the launch, never to the plain version."""

    def refuse(*_args, **_kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    launched = []
    monkeypatch.setattr(aw, "anderson_window_reference", refuse)
    monkeypatch.setattr(aw, "_check", lambda *args: None)
    monkeypatch.setattr(aw, "_launch",
                        lambda *args: launched.append(args) or "kernel")
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                    is_contiguous=lambda: True)
    out = aw.anderson_window(*([on_card] * 7), beta=0.4, reg=1e-12,
                             c_lim=1e3, scf_tol=0.0)
    assert out == "kernel" and len(launched) == 1


def test_failed_launch_raises(monkeypatch):
    """A launch that returns a CUDA error raises with its message and is
    not counted."""
    lib = types.SimpleNamespace(
        mqc_anderson_window_f64=lambda *args: 9,
        mqc_cuda_error_string=lambda code: b"invalid configuration argument")
    monkeypatch.setattr(aw._LIB, "lib", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    state = _state("full")
    before = aw.launches
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        aw._launch(*state, 0.4, 1e-12, 1e3, 0.0)
    assert aw.launches == before


def test_entry_points_match_the_source():
    """The ctypes declarations of the wrapper against the C signatures of
    csrc/anderson_window.cu (a mismatch shows only on a card otherwise)."""
    src = aw._LIB.source.read_text()
    declared = set(re.findall(r"^int (mqc_\w+)\(", src, re.M))
    assert declared == set(aw._LIB.entry_points) == {
        "mqc_anderson_window_f32", "mqc_anderson_window_f64"}
    kinds = {"double": "c_double", "int": "c_int"}
    for name, argtypes in aw._LIB.entry_points.items():
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
    return torch.device("cuda")


#: (B, nx) of the window on the main path: the dimer slice (GFN1 and
#: GFN2), the w20 MBE(4) chunks, a GFN2 hexamer; an odd batch of small
#: fragments, four to a block with the last block part empty; a window too
#: wide to stage whole (2 m nx above the kernel's 200 KB), streamed in
#: tiles
GPU_SHAPES = [(512, 12), (512, 62), (5985, 24), (64, 372), (7, 30),
              (8, 2500)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_matches_plain_versions(cuda, shape, case, dtype):
    state = [t.to(cuda) for t in _state(case, *shape, dtype=dtype)]
    before = aw.launches
    got = _run(aw.anderson_window, state, dtype)
    torch.cuda.synchronize()
    assert aw.launches == before + 1
    for plain in (aw.anderson_window_reference, aw.anderson_window_rowwise):
        ref = _run(_kw(plain), state, dtype)
        for a, b in zip(got, ref):
            if a.dtype == torch.bool:
                assert torch.equal(a, b)
            else:
                assert _close(a, b, TOL[dtype])
        assert _same(got[1], ref[1]) and _same(got[2], ref[2])


def _integer_state(bsz, nx, dtype, seed=2):
    """A full window (it = 11) of small integers: every dot product, and
    so G and rhs, exact in any order of summation."""
    rng = np.random.default_rng(seed)
    ints = [rng.integers(-3, 4, shape).astype(float) for shape in
            ((bsz, nx), (bsz, nx), (bsz, M, nx), (bsz, M, nx))]
    out = [torch.tensor(a, dtype=dtype) for a in ints]
    resid = torch.tensor(rng.uniform(0.0, 1.0, bsz), dtype=dtype)
    return (*out, resid, torch.ones(bsz, dtype=torch.bool),
            torch.tensor(11, dtype=torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_equals_the_twin_on_integer_windows(cuda, shape, dtype):
    """Where the dot products are exact, the kernel's x, windows, residuals
    and flags equal `anderson_window_rowwise`'s bit for bit: its
    elimination in registers and its step are the twin's arithmetic. The
    coefficient limit is lifted so that every step is taken."""
    state = [t.to(cuda) for t in _integer_state(*shape, dtype)]
    kw = dict(beta=0.4, reg=LIMITS[dtype][0], c_lim=1e30, scf_tol=1e-6)
    outs = []
    for fn in (aw.anderson_window, _kw(aw.anderson_window_rowwise)):
        x, f_res, hist_x, hist_f, resid, active, it = (
            t.clone() for t in state)
        fn(x, f_res, hist_x, hist_f, resid, active, it, **kw)
        outs.append((x, hist_x, hist_f, resid, active))
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(*outs))
    damped = state[0] + 0.4 * state[1]
    assert not torch.equal(outs[0][0], damped), "no step was taken"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_bits_do_not_depend_on_the_batch(cuda, dtype):
    state = [t.to(cuda) for t in _state("full", 600, 24, dtype=dtype)]
    whole = _run(aw.anderson_window, state, dtype)
    for rows in ([0], [5, 0], [599, 3, 0]):
        idx = torch.tensor(rows, device=cuda)
        part = [t.index_select(0, idx) if t.dim() else t for t in state]
        got = _run(aw.anderson_window, part, dtype)
        for a, b in zip(got, whole):
            assert _same(a, b.index_select(0, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(40, 186), (8, 2500)])
def test_block_kernel_bits_do_not_depend_on_the_batch(cuda, shape, dtype):
    """The same for a block per fragment, staged whole and in tiles."""
    bsz, nx = shape
    state = [t.to(cuda) for t in _state("full", bsz, nx, dtype=dtype)]
    whole = _run(aw.anderson_window, state, dtype)
    for rows in ([0], [bsz - 1, 3, 0]):
        idx = torch.tensor(rows, device=cuda)
        part = [t.index_select(0, idx) if t.dim() else t for t in state]
        got = _run(aw.anderson_window, part, dtype)
        for a, b in zip(got, whole):
            assert _same(a, b.index_select(0, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["partial", "wrapped", "near_singular",
                                  "nonfinite"])
@pytest.mark.parametrize("shape", [(64, 24), (16, 62)])
def test_wide_window_matches_plain_versions(cuda, shape, case, dtype):
    """A window of m = 20 (its solve on rows in shared memory, above the
    register solve's 16), warp and block per fragment."""
    state = [t.to(cuda) for t in _state(case, *shape, dtype=dtype, m=20)]
    got = _run(aw.anderson_window, state, dtype)
    for plain in (aw.anderson_window_reference, aw.anderson_window_rowwise):
        ref = _run(_kw(plain), state, dtype)
        for a, b in zip(got, ref):
            if a.dtype == torch.bool:
                assert torch.equal(a, b)
            else:
                assert _close(a, b, TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [40, 64, aw.MAX_M])
@pytest.mark.parametrize("shape", [(64, 12), (16, 186)])
def test_window_above_32_matches_plain_versions(cuda, shape, m, dtype):
    """Windows above the first kernel's 32 (a lane holding two or more rows
    of the system), warp and block per fragment, partly filled."""
    state = [t.to(cuda) for t in _state("full", *shape, dtype=dtype, m=m)]
    got = _run(aw.anderson_window, state, dtype)
    for plain in (aw.anderson_window_reference, aw.anderson_window_rowwise):
        ref = _run(_kw(plain), state, dtype)
        for a, b in zip(got, ref):
            if a.dtype == torch.bool:
                assert torch.equal(a, b)
            else:
                assert _close(a, b, TOL[dtype])
