"""The eigh binding (ops/batched_eigh.py, csrc/batched_eigh.cu) and the
per-library link flags of its build (ops/kernel_build.py).

On the CPU: the shape and type checks, a device that is neither CPU nor
CUDA raising, the CPU route equal to `torch.linalg.eigh` bit for bit, the
dispatch of a tensor on a card to the binding, the status read once, the
ctypes declarations against the C source, and `-l`
flags reaching nvcc's command line (a stand-in `nvcc` that records its
arguments) and the build's hash. The engine's SCC loops call the binding
with a status of their own; `eigh_safe`'s forward pass (the operand
build's orthogonalizer, the functional) goes through `eigh_folded`, which
on a card takes its status from the calling stage (`StageStatus`) or
checks one at once, and on the CPU is `torch.linalg.eigh`; a stage folds
solver infos (`fold_info`) and reads them once. The binding itself runs
on a card only: the `gpu` cases hold it to `torch.linalg.eigh`
(`python3 -m pytest --noconftest tests/test_torch_batched_eigh.py -m
gpu`).
"""

import re
import stat
import types

import numpy as np
import pytest
import torch

from metalquicha_tpu_torch.constants import KB_HARTREE
from metalquicha_tpu_torch.methods.xtb import calculator as tcalc
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params as tsp
from metalquicha_tpu_torch.ops import batched_eigh as be
from metalquicha_tpu_torch.ops import kernel_build
from metalquicha_tpu_torch.workloads import bench_dimers

torch.set_num_threads(1)


def _symmetric(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    return torch.tensor(a + np.swapaxes(a, -1, -2), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(5, 16, 16), (3, 33, 33), (1, 7, 7)])
def test_cpu_route_is_torch_linalg_eigh(shape, dtype):
    a = _symmetric(shape, dtype)
    a[:, 0, -1] += 0.25  # only the lower triangle is read
    w, v = be.eigh(a)
    w_t, v_t = torch.linalg.eigh(a)
    assert torch.equal(w, w_t) and torch.equal(v, v_t)
    assert w.dtype == dtype and v.shape == shape


def test_shape_type_and_device_checks():
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        be.eigh(torch.zeros(4, 4))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        be.eigh(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        be.eigh(torch.zeros(2, 3, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="no batched eigh for device"):
        be.eigh(torch.zeros(2, 3, 3, device="meta"))


def test_cuda_tensor_goes_to_the_binding(monkeypatch):
    """The dispatch reads the device only: a tensor that says it lies on a
    card goes to the launch, and a call without a status reads its own at
    once."""
    launched, checked = [], []
    monkeypatch.setattr(be, "_launch", lambda a, status: (
        launched.append(status) or "binding"))

    class Status:
        def __init__(self, like):
            self.device = getattr(like, "device", like)

        def check(self):
            checked.append(self.device)

    monkeypatch.setattr(be, "EighStatus", Status)

    class OnCard:
        device = torch.device("cuda", 0)
        shape = torch.Size((2, 4, 4))

        def dim(self):
            return 3

    given = Status("given")
    assert be.eigh(OnCard(), given) == "binding"
    assert launched[-1] is given and not checked
    assert be.eigh(OnCard()) == "binding"
    assert launched[-1] is not given and checked == [OnCard.device]


def test_folded_eigh_takes_the_stages_status(monkeypatch):
    """On a card `eigh_folded` gives the binding the calling stage's status
    for the matrices' shape (one per shape, all folding into the stage's
    one `worst`), or outside a stage a status of its own, checked at once;
    a (..., n, n) batch is flattened and its results shaped back. On the
    CPU it is `torch.linalg.eigh`."""
    calls = []
    monkeypatch.setattr(be, "eigh", lambda a, status=None: (
        calls.append((tuple(a.shape), status))
        or (a[..., 0], a)))
    monkeypatch.setattr(be, "EighStatus", lambda like, worst=None: (
        types.SimpleNamespace(like=tuple(like.shape), worst=worst)))
    a = torch.zeros(2, 3, 4, 4, device="meta")
    monkeypatch.setattr(type(a), "device", property(
        lambda t: torch.device("cuda", 0)))
    w, v = be.eigh_folded(a)
    assert w.shape == (2, 3, 4) and v.shape == (2, 3, 4, 4)
    assert calls[-1] == ((6, 4, 4), None)
    stage = be.StageStatus("meta")
    with be.collecting(stage):
        be.eigh_folded(a)
        be.eigh_folded(a)
        be.eigh_folded(torch.zeros(5, 2, 2, device="meta"))
    first, second, third = (s for _shape, s in calls[1:])
    assert first is second and third is not first
    assert first.worst is third.worst is stage.worst
    stage.frozen = True
    with be.collecting(stage), pytest.raises(RuntimeError,
                                             match="new shape"):
        be.eigh_folded(torch.zeros(7, 2, 2, device="meta"))


def test_cpu_folded_eigh_is_torchs():
    a = _symmetric((3, 5, 5), torch.float64)
    with be.collecting(be.StageStatus("cpu")):
        w, v = be.eigh_folded(a)
    w_t, v_t = torch.linalg.eigh(a)
    assert torch.equal(w, w_t) and torch.equal(v, v_t)


def test_stage_folds_infos_and_reads_them_once():
    """A stage folds the largest |info| on the device; outside a stage (or
    on the CPU) `fold_info` reads it at once and raises."""
    stage = be.StageStatus("cpu")
    stage.fold(torch.tensor([0, -3, 2], dtype=torch.int32))
    stage.fold(torch.tensor([1], dtype=torch.int32))
    assert int(stage.worst) == 3
    with pytest.raises(RuntimeError, match="info 3"):
        stage.check()
    # a failure read is zeroed
    stage.check()
    be.fold_info(torch.zeros(4, dtype=torch.int32), "a solve")
    with be.collecting(stage), pytest.raises(RuntimeError,
                                             match="a solve: .* info 5"):
        be.fold_info(torch.tensor([0, 5], dtype=torch.int32), "a solve")


def test_status_raises_on_a_bad_info():
    status = be.EighStatus(torch.zeros(3, 4, 4))
    assert status.work is None  # a workspace on a card only
    status.check()
    status.worst.fill_(33)
    with pytest.raises(RuntimeError, match="info 33"):
        status.check()
    status.check()  # a failure read is zeroed


def test_failed_call_raises_and_is_not_counted(monkeypatch):
    lib = types.SimpleNamespace(
        mqc_eigh=lambda *args: 10006,
        mqc_eigh_workspace=lambda *args: 0,
        mqc_cuda_error_string=lambda code: b"cusolver: execution failed")
    monkeypatch.setattr(be._LIB, "lib", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)

    a = _symmetric((2, 4, 4), torch.float64)
    status = be.EighStatus(a)
    status.work = torch.empty((64,), dtype=torch.uint8)
    before = be.launches
    with pytest.raises(RuntimeError, match="execution failed"):
        be._launch(a, status)
    assert be.launches == before
    with pytest.raises(TypeError):
        be._launch(a.half(), status)
    # a status holds the workspace of the matrices it was made for
    with pytest.raises(ValueError, match="made for other matrices"):
        be._launch(a[:1], status)


def test_call_batches_by_dtype_and_size():
    """Where XsyevBatched's eigenpairs depend on the batch count (measured
    on an H100: float64 above 128) each matrix is a call of its own; a
    batch of 1 above 32 is solved as a batch of 2; else the batch is one
    call."""
    f64, f32 = torch.float64, torch.float32
    assert be.BATCHED_MAX_N_F64 == 128 and be.SINGLE_MAX_N == 32
    assert [be._call_batch(f64, n, 8) for n in (16, 128, 129, 241)] == [
        8, 8, 1, 1]
    assert [be._call_batch(f64, n, 1) for n in (32, 33, 128, 241)] == [
        1, 2, 2, 1]
    assert [be._call_batch(f32, n, b) for n, b in (
        (241, 8), (241, 1), (256, 64), (16, 1))] == [8, 2, 64, 1]
    assert be.one_at_a_time(f64, 129) and not be.one_at_a_time(f32, 256)


@pytest.mark.parametrize("dtype, bsz, n, want", [
    (torch.float64, 3, 160, [(0, 1), (1, 1), (2, 1)]),
    (torch.float64, 1, 96, [(0, 2)]),
    (torch.float64, 4, 96, [(0, 4)]),
    (torch.float32, 3, 160, [(0, 3)]),
    (torch.float32, 1, 16, [(0, 1)])])
def test_launch_calls_by_the_rule(monkeypatch, dtype, bsz, n, want):
    """The calls `_launch` makes: one a matrix (each at its own offset of
    the column-major copy, the eigenvalues and the infos), the batch, or a
    single matrix as two; one launch counted either way, the results cut
    to the batch."""
    calls = []

    def mqc_eigh(dcode, vt, w, work, nbytes, info, worst, n_, count, *_):
        calls.append((vt, w, info, count))
        return 0

    lib = types.SimpleNamespace(mqc_eigh=mqc_eigh)
    monkeypatch.setattr(be._LIB, "lib", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    a = _symmetric((bsz, n, n), dtype)
    status = be.EighStatus(a)
    status.work = torch.empty((64,), dtype=torch.uint8)
    before = be.launches
    w, v = be._launch(a, status)
    assert be.launches == before + 1
    assert w.shape == (bsz, n) and v.shape == (bsz, n, n)
    item = a.element_size()
    base_v, base_w, base_i = calls[0][:3]
    got = [((vt - base_v) // (n * n * item), count)
           for vt, _, _, count in calls]
    assert got == want
    for (vt, wp, info, _), (i, _) in zip(calls, want):
        assert wp - base_w == i * n * item and info - base_i == i * 4


def test_entry_points_match_the_source():
    """Every `int mqc_...` entry point of csrc/batched_eigh.cu is declared,
    with as many arguments as the C signature has."""
    src = be._LIB.source.read_text()
    sigs = dict(re.findall(r"^int (mqc_\w+)\(([^)]*)\)", src, re.M))
    assert set(sigs) == set(be._LIB.entry_points)
    for name, args in sigs.items():
        n = 0 if args.strip() in ("", "void") else args.count(",") + 1
        assert len(be._LIB.entry_points[name]) == n, name
    assert "mqc_cuda_error_string" in src
    assert be._LIB.libs == ("cusolver",)


def _fake_nvcc(tmp_path):
    """A stand-in nvcc that records its arguments and writes its -o file."""
    log = tmp_path / "args.txt"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
        "  shift\n"
        "done\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), log


def test_link_flags_reach_nvcc_and_the_hash(tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(kernel_build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    src = kernel_build.CSRC / "batched_eigh.cu"
    linked = kernel_build.compile_source(src, "batched_eigh", ("cusolver",))
    plain = kernel_build.compile_source(src, "batched_eigh")
    assert linked.exists() and plain.exists() and linked != plain
    first, second = log.read_text().splitlines()
    assert first.split()[-1] == "-lcusolver"
    assert "-lcusolver" not in second.split()
    assert str(src) in first.split() and "-shared" in first.split()
    # a second call finds the build and runs no compiler
    assert kernel_build.compile_source(src, "batched_eigh",
                                       ("cusolver",)) == linked
    assert len(log.read_text().splitlines()) == 2


def test_library_build_passes_its_libraries(tmp_path, monkeypatch):
    """KernelLibrary.load compiles with the library's `libs`."""
    seen = []

    def compile_source(source, stem, libs=()):
        seen.append((stem, libs))
        raise RuntimeError("nvcc failed (stand-in)")

    monkeypatch.setattr(be._LIB, "lib", None)
    monkeypatch.setattr("metalquicha_tpu_torch.ops.kernel_build."
                        "compile_source", compile_source)
    with pytest.raises(RuntimeError, match="stand-in"):
        be.build()
    assert seen == [("batched_eigh", ("cusolver",))]


@pytest.mark.parametrize("multipoles", [False, True], ids=["gfn1", "gfn2"])
def test_scc_loops_call_the_binding_and_autograd_does_not(monkeypatch,
                                                          multipoles):
    """The SCC loop's eigh is the binding called with its loop's status
    (one call per iteration); the refine and the variational functional
    call `eigh_safe`, whose forward pass is `eigh_folded`
    (`torch.linalg.eigh` here on the CPU, a stage's status on a card)."""
    variant = "gfn2" if multipoles else "gfn1"
    calls = []
    real = be.eigh

    def counted(a, status=None):
        calls.append(status)
        return real(a, status)

    monkeypatch.setattr(te, "batched_eigh", counted)
    settings = tsp(variant, max_scf_iter=5)
    calc = tcalc.XtbCalculator(settings, variant=variant, device="cpu")
    frag = calc.make_batch(bench_dimers(3, seed=2))
    with torch.no_grad():
        tcalc._converge_charges(frag.coords, frag, 300.0 * KB_HARTREE,
                                settings)
    assert len(calls) == 5 and all(isinstance(s, be.EighStatus)
                                   for s in calls)
    calls.clear()
    calc.gradients(frag)
    assert len(calls) == 5  # the gradient's SCC; the functional takes none


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the binding has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(512, 16, 16), (2581, 32, 32),
                                   (128, 64, 64)])
def test_binding_matches_torch_on_the_card(cuda, shape, dtype):
    """Bit for bit where torch calls the same routine (a batch of matrices
    up to 32); within 1e-12 in float64 above (torch's syevd / syevj there
    cannot be captured)."""
    a = _symmetric(shape, dtype, seed=shape[0]).to(cuda)
    status = be.EighStatus(a)
    before = be.launches
    w, v = be.eigh(a, status)
    w_t, v_t = torch.linalg.eigh(a)
    torch.cuda.synchronize()
    status.check()
    assert be.launches == before + 1 and v.stride() == v_t.stride()
    if shape[-1] <= 32:
        assert torch.equal(w, w_t) and torch.equal(v, v_t)
    elif dtype == torch.float64:
        sign = torch.sign((v * v_t).sum(-2, keepdim=True))
        assert float((w - w_t).abs().max()) <= 1e-12
        assert float((v * sign - v_t).abs().max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [16, 48, 96, 128, 160, 241])
def test_a_matrix_gets_its_bits_in_any_batch(cuda, n, dtype):
    """A matrix's eigenpairs through the binding are the same bits alone,
    in its batch and in either half of it, at sizes on both sides of the
    rule's bounds (ROADMAP C17)."""
    a = _symmetric((6, n, n), dtype, seed=n).to(cuda)
    w, v = be.eigh(a)
    for rows in ([0], [5], [0, 1, 2], [3, 4, 5], [4, 1]):
        idx = torch.tensor(rows, device=cuda)
        wp, vp = be.eigh(a.index_select(0, idx).contiguous())
        assert torch.equal(wp, w.index_select(0, idx))
        assert torch.equal(vp, v.index_select(0, idx))


def test_cpu_solve_is_torchs_and_raises_on_a_singular_system():
    a = _symmetric((3, 6, 6), torch.float64) + 8.0 * torch.eye(6)
    b = _symmetric((3, 6, 6), torch.float64)[:, :, :2]
    assert torch.equal(be.solve(a, b), torch.linalg.solve(a, b))
    with pytest.raises(RuntimeError, match="info"):
        be.solve(torch.zeros(2, 3, 3, dtype=torch.float64),
                 torch.ones(2, 3, 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        be.solve(a.to("meta"), b.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(3, 208, 12), (64, 660, 6), (1, 40, 3)])
def test_lu_binding_matches_torch_on_the_card(cuda, shape, dtype):
    """The LU binding's solve and its gradient against torch.linalg.solve
    (CPCM's shapes: points x atoms), and a singular system's info folded
    into a stage and read once."""
    bsz, n, k = shape
    a = _symmetric((bsz, n, n), torch.float64) + n * torch.eye(n)
    b = _symmetric((bsz, n, n), torch.float64)[:, :, :k]
    a, b = (t.to(device=cuda, dtype=dtype).requires_grad_(True)
            for t in (a, b))
    w = torch.randn(bsz, n, k, dtype=dtype, device=cuda)
    x = be.solve(a, b)
    ga, gb = torch.autograd.grad((x * w).sum(), (a, b))
    x_t = torch.linalg.solve(a, b)
    ga_t, gb_t = torch.autograd.grad((x_t * w).sum(), (a, b))
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for got, ref in ((x, x_t), (ga, ga_t), (gb, gb_t)):
        assert float((got - ref).abs().max()) <= tol * float(
            ref.abs().max())
    stage = be.StageStatus(cuda)
    with be.collecting(stage):
        be.solve(torch.zeros(2, 4, 4, dtype=dtype, device=cuda),
                 torch.ones(2, 4, 1, dtype=dtype, device=cuda))
    with pytest.raises(RuntimeError, match="info"):
        stage.check()
