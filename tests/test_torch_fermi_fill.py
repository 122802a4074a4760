"""The Fermi-level fill of the torch port (ops/fermi_fill.py).

On the CPU the engine's `occupations` runs the plain torch version; it is
held against the JAX package's `occupations` under `jax.vmap`, in float64
to 1e-12 (fixed and Fermi filling) and in float32 to `TOL_F32`. The CUDA
kernel itself is tested by the `gpu` cases, which skip without a card
(run them on one with `python3 -m pytest --noconftest
tests/test_torch_fermi_fill.py -m gpu`).
"""

import re
import types

import numpy as np
import pytest
import torch

from metalquicha_tpu_torch.constants import KB_HARTREE
from metalquicha_tpu_torch.methods.xtb import engine as te
from metalquicha_tpu_torch.ops import fermi_fill as ff
from metalquicha_tpu_torch.ops import kernel_build

torch.set_num_threads(1)
TOL = 1e-12
#: float32 against float32: the two packages sum a row in other orders, so
#: the bisection's last decisions, and so mu, may differ by a few ulp of
#: the row's electron count (1.2e-7 relative); an occupation moves by at
#: most that, an entropy by that times |log(f / (1 - f))| <= 60 per orbital
TOL_F32 = 1e-5
TOL_F32_ENTROPY = 1e-4
KT_300 = 300.0 * KB_HARTREE
KT_5000 = 5000.0 * KB_HARTREE
ANGSTROM = 1.0 / 0.52917721067

OH = (np.array([8, 1]), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.97]])
      * ANGSTROM, 0, 2)
O2 = (np.array([8, 8]), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.21]])
      * ANGSTROM, 0, 3)


def _levels(rng, mask, nelec, gap=0.3, split=None):
    """Orbital energies (B, nao) in a random order: of each row's real
    AOs, the lowest ceil(nelec / 2) in [-0.6, 0] Ha and the others at
    least `gap` above them (the lowest of those `split` Ha above the
    highest occupied one instead, where given); the padded AOs at +10
    Ha."""
    bsz, nao = mask.shape
    eps = np.full((bsz, nao), 10.0)
    for b in range(bsz):
        real = np.flatnonzero(mask[b] > 0.5)
        n_occ = int(np.ceil(nelec[b] / 2.0))
        occ = -rng.uniform(0.0, 0.6, size=n_occ)
        vir = gap + rng.uniform(0.0, 0.6, size=len(real) - n_occ)
        if split is not None and n_occ and len(vir):
            vir[np.argmin(vir)] = occ.max() + split
        eps[b, rng.permutation(real)] = np.concatenate([occ, vir]) - 0.5
    return eps


def _real_batch(rng, **kw):
    """Water (closed shell, padded), H3O+ (charged), OH (nuhf 1) and O2
    (nuhf 2) as the JAX package batches them."""
    from _torch_port_common import H3O, WATER, jax_fragment_data

    jf = jax_fragment_data([WATER, H3O, OH, O2, WATER])
    mask = np.asarray(jf.ao_mask)
    nelec, nuhf = np.asarray(jf.nelec), np.asarray(jf.nuhf)
    assert (mask < 0.5).any() and set(nuhf) == {0.0, 1.0, 2.0}
    return _levels(rng, mask, nelec, **kw), nelec, nuhf, mask


def _wide_rows(rng):
    """nao 241 with most of each row masked (20, 35 and 60 real AOs)."""
    mask = np.zeros((3, 241))
    for b, n in enumerate((20, 35, 60)):
        mask[b, rng.permutation(241)[:n]] = 1.0
    nelec = np.array([16.0, 31.0, 50.0])
    nuhf = np.array([0.0, 1.0, 2.0])
    return _levels(rng, mask, nelec), nelec, nuhf, mask


#: name -> (inputs from a seed, kt, whether closed shells have entropy)
CASES = {
    "real_batch_300K": (lambda r: _real_batch(r), KT_300, False),
    "real_batch_5000K": (lambda r: _real_batch(r, gap=0.01), KT_5000, True),
    "near_degenerate_300K": (lambda r: _real_batch(r, split=1e-4), KT_300,
                             True),
    "near_degenerate_5000K": (lambda r: _real_batch(r, split=1e-3), KT_5000,
                              True),
    "wide_nao241": (_wide_rows, KT_300, False),
}


def _inputs(name):
    make, kt, hot = CASES[name]
    return make(np.random.default_rng(sum(map(ord, name)))), kt, hot


def _jax_occupations(eps, nelec, nuhf, kt, mask, fixed):
    import jax
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb import engine as je

    f, s = jax.jit(jax.vmap(
        lambda e, ne, nu, m: je.occupations(e, ne, nu, kt, m, fixed)
    ))(*(jnp.asarray(x) for x in (eps, nelec, nuhf, mask)))
    return np.asarray(f), np.asarray(s)


def _torch(arrays, dtype=torch.float64, device="cpu"):
    return [torch.tensor(x, dtype=dtype, device=device) for x in arrays]


@pytest.mark.parametrize("fixed", [False, True], ids=["fermi", "aufbau"])
@pytest.mark.parametrize("name", list(CASES))
def test_occupations_match_jax(name, fixed):
    (eps, nelec, nuhf, mask), kt, hot = _inputs(name)
    f_j, s_j = _jax_occupations(eps, nelec, nuhf, kt, mask, fixed)
    f_t, s_t = te.occupations(*_torch((eps, nelec, nuhf)), kt,
                              *_torch((mask,)), fixed)
    assert np.abs(f_t.numpy() - f_j).max() <= TOL
    assert np.abs(s_t.numpy() - s_j).max() <= TOL
    np.testing.assert_allclose(f_t.numpy().sum(1), nelec, rtol=0, atol=1e-9)
    if hot and not fixed:
        # the closed-shell rows' HOMO and LUMO share their electrons
        assert (s_t.numpy()[nuhf == 0] > 1e-3).all()
        assert ((f_t.numpy() > 1e-3) & (f_t.numpy() < 2 - 1e-3)
                & (np.abs(f_t.numpy() - 1) > 1e-3)).any()


@pytest.mark.parametrize("name", list(CASES))
def test_float32_matches_jax_float32(name):
    (eps, nelec, nuhf, mask), kt, _hot = _inputs(name)
    f32 = [x.astype(np.float32) for x in (eps, nelec, nuhf, mask)]
    f_j, s_j = _jax_occupations(*f32[:3], kt, f32[3], False)
    assert f_j.dtype == np.float32
    f_t, s_t = te.occupations(*_torch(f32[:3], torch.float32), kt,
                              *_torch(f32[3:], torch.float32), False)
    assert f_t.dtype == torch.float32
    assert np.abs(f_t.numpy() - f_j).max() <= TOL_F32
    assert np.abs(s_t.numpy() - s_j).max() <= TOL_F32_ENTROPY


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the kernel was built for a CPU tensor")

    monkeypatch.setattr(ff, "build", refuse)
    monkeypatch.setattr(kernel_build, "compile_source", refuse)
    (eps, nelec, nuhf, mask), kt, _hot = _inputs("real_batch_300K")
    args = _torch((eps, nelec, nuhf)) + [kt] + _torch((mask,))
    before = ff.launches
    f, s = ff.fermi_occupations(*args)
    f_p, s_p = ff.fermi_occupations_reference(*args)
    assert ff.launches == before
    assert torch.equal(f, f_p) and torch.equal(s, s_p)
    f_e, s_e = te.occupations(*args, False)
    assert torch.equal(f_e, f_p) and torch.equal(s_e, s_p)


def test_other_devices_raise():
    eps = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        ff.fermi_occupations(eps, torch.zeros(2, device="meta"),
                             torch.zeros(2, device="meta"), KT_300,
                             torch.ones(2, 4, device="meta"))


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="nao"):
        ff.fermi_occupations(torch.zeros(2, 4), torch.zeros(2),
                             torch.zeros(2), KT_300, torch.ones(2, 5))
    with pytest.raises(ValueError, match="nelec"):
        ff.fermi_occupations(torch.zeros(2, 4), torch.zeros(3),
                             torch.zeros(2), KT_300, torch.ones(2, 4))


def test_cuda_tensor_goes_to_the_kernel(monkeypatch):
    """The dispatch reads the device only: a tensor that says it lies on a
    card goes to the launch, never to the plain version."""

    def refuse(*_args):
        raise AssertionError("a CUDA tensor reached the plain version")

    launched = []
    monkeypatch.setattr(ff, "fermi_occupations_reference", refuse)
    monkeypatch.setattr(ff, "_launch",
                        lambda *args: launched.append(args) or "kernel")

    class OnCard:
        device = torch.device("cuda", 0)
        shape = torch.Size((2, 4))

        def dim(self):
            return 2

    eps = OnCard()
    nelec = types.SimpleNamespace(shape=torch.Size((2,)))
    out = ff.fermi_occupations(eps, nelec, nelec, KT_300, eps)
    assert out == "kernel" and len(launched) == 1


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(ff._LIB, "lib", None)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    # a compiler that fails
    monkeypatch.setattr(kernel_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ff.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_launch_raises(monkeypatch):
    """A launch that returns a CUDA error raises with its message and is
    not counted."""
    lib = types.SimpleNamespace(
        mqc_fermi_fill_f64=lambda *args: 9,
        mqc_cuda_error_string=lambda code: b"invalid configuration argument")
    monkeypatch.setattr(ff._LIB, "lib", lib)
    monkeypatch.setattr(ff, "_stream", lambda index: 7)
    (eps, nelec, nuhf, mask), kt, _hot = _inputs("real_batch_300K")
    before = ff.launches
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        ff._launch(*_torch((eps, nelec, nuhf)), kt, *_torch((mask,)))
    assert ff.launches == before


def test_entry_points_match_the_source():
    """The ctypes declarations of the wrapper against the C signatures of
    csrc/fermi_fill.cu: every `int mqc_...` entry point of the source is
    declared (the fill and the fused density, f32 and f64), with a pointer
    for each pointer, a double for kt, an int for each int (a mismatch
    shows only on a card otherwise)."""
    src = ff._LIB.source.read_text()
    declared = set(re.findall(r"^int (mqc_\w+)\(", src, re.M))
    assert declared == set(ff._LIB.entry_points) == {
        "mqc_fermi_fill_f32", "mqc_fermi_fill_f64",
        "mqc_fermi_density_f32", "mqc_fermi_density_f64"}
    kinds = {"double": "c_double", "int": "c_int", "void*": "c_void_p"}
    for name, argtypes in ff._LIB.entry_points.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        want = []
        for p in params.split(","):
            words = p.replace("*", " * ").split()
            want.append("c_void_p" if "*" in words else kinds[words[-2]])
        assert [t.__name__ for t in argtypes] == want, name


def _with_nan_rows(eps, nelec, nuhf, mask):
    """The inputs with a NaN level in the first row and a NaN electron count
    in the last (the bisection of such rows never settles)."""
    eps, nelec = eps.copy(), nelec.copy()
    eps[0, np.flatnonzero(mask[0] > 0.5)[0]] = np.nan
    nelec[-1] = np.nan
    return eps, nelec, nuhf, mask


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(CASES))
def test_fixed_point_stop_is_exact(name, dtype):
    """On the plain arithmetic, the bracket after the first step that
    leaves (lo, hi) unchanged (the kernel's stop) is the 80-step bracket,
    for every row, NaN rows included (a NaN never compares equal, so they
    take all 80 steps); every other row stops earlier (its step count is
    printed)."""
    (eps, nelec, nuhf, mask), kt, _hot = _inputs(name)
    eps, nelec, nuhf, mask = _torch(_with_nan_rows(eps, nelec, nuhf, mask),
                                    dtype)
    e2, n_ch, mask2 = ff._channels(eps, nelec, nuhf, mask)
    e2 = torch.where(mask2 > 0.5, e2, 1.0e3)
    lo, hi, lo_stop, hi_stop, steps = ff._bisect(e2, n_ch, kt, mask2,
                                                 trace=True)
    nan = torch.isnan(lo) | torch.isnan(hi)
    assert bool(nan.any())
    for a, b in ((lo, lo_stop), (hi, hi_stop)):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        assert bool(same.all())
    assert bool((steps[nan] == ff.STEPS).all())
    assert bool((steps[~nan] < ff.STEPS).all())
    print(f"{name} {dtype}: steps {int(steps[~nan].min())}-"
          f"{int(steps[~nan].max())} of {ff.STEPS}")
    # the kernel's convention: a closed shell's beta channel is not filled
    counts = ff.fermi_steps_reference(eps, nelec, nuhf, kt, mask)
    bsz = eps.shape[0]
    assert torch.equal(counts[:, 0], steps[:bsz])
    assert torch.equal(counts[:, 1],
                       torch.where(nuhf == 0, 0, steps[bsz:]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(CASES))
def test_closed_shell_filled_once_equals_two_fills(name, dtype):
    """With nuhf 0 both channels fill the same row to the same electron
    count, so f_alpha + f_beta = 2 f_alpha and s_alpha + s_beta = 2
    s_alpha bit for bit: the kernel fills a closed shell once."""
    (eps, nelec, nuhf, mask), kt, _hot = _inputs(name)
    eps, nelec, nuhf, mask = _torch((eps, nelec, nuhf, mask), dtype)
    closed = nuhf == 0
    assert bool(closed.any())
    f, s = ff.fermi_occupations_reference(eps, nelec, nuhf, kt, mask)
    f_a, s_a = ff._fermi_fill(eps, 0.5 * (nelec + nuhf), kt, mask)
    assert torch.equal(f[closed], 2 * f_a[closed])
    assert torch.equal(s[closed], 2 * s_a[closed])


def _eigenvectors(rng, bsz, nao):
    """Seeded orthogonal (B, nao, nao) matrices, eigenvectors in columns."""
    return np.stack([np.linalg.qr(rng.normal(size=(nao, nao)))[0]
                     for _ in range(bsz)])


@pytest.mark.parametrize("name", list(CASES))
def test_density_reference_matches_jax(name):
    """`fermi_density_reference` against the JAX package's `occupations`
    and its SCC's product `(C * f) @ C.T` on the same inputs."""
    import jax
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb import engine as je

    (eps, nelec, nuhf, mask), kt, _hot = _inputs(name)
    C = _eigenvectors(np.random.default_rng(len(name)), *eps.shape)

    def jax_density(e, c, ne, nu, m):
        f, _ = je.occupations(e, ne, nu, kt, m, False)
        return (c * f[None, :]) @ c.T

    p_j = np.asarray(jax.jit(jax.vmap(jax_density))(
        *(jnp.asarray(x) for x in (eps, C, nelec, nuhf, mask))))
    args = _torch((eps, C, nelec, nuhf)) + [kt] + _torch((mask,))
    p = ff.fermi_density_reference(*args)
    assert np.abs(p.numpy() - p_j).max() <= TOL
    # a CPU tensor takes the plain version (up to the kernel's nao)
    if eps.shape[1] <= ff.DENSITY_MAX_N:
        before = ff.launches
        assert torch.equal(ff.fermi_density(*args), p)
        assert ff.launches == before


def test_density_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="C of shape"):
        ff.fermi_density(torch.zeros(2, 4), torch.zeros(2, 4, 5),
                         torch.zeros(2), torch.zeros(2), KT_300,
                         torch.ones(2, 4))
    n = ff.DENSITY_MAX_N + 1
    with pytest.raises(ValueError, match="DENSITY_MAX_N"):
        ff.fermi_density(torch.zeros(1, n), torch.zeros(1, n, n),
                         torch.zeros(1), torch.zeros(1), KT_300,
                         torch.ones(1, n))


def test_cuda_tensor_goes_to_the_density_kernel(monkeypatch):
    def refuse(*_args):
        raise AssertionError("a CUDA tensor reached the plain version")

    launched = []
    monkeypatch.setattr(ff, "fermi_density_reference", refuse)
    monkeypatch.setattr(ff, "_launch_density",
                        lambda *args: launched.append(args) or "kernel")

    class OnCard:
        device = torch.device("cuda", 0)

        def __init__(self, *shape):
            self.shape = torch.Size(shape)

        def dim(self):
            return len(self.shape)

    eps, C, rows = OnCard(2, 4), OnCard(2, 4, 4), OnCard(2)
    out = ff.fermi_density(eps, C, rows, rows, KT_300, eps)
    assert out == "kernel" and len(launched) == 1


def test_steps_on_the_cpu_are_the_plain_counts():
    (eps, nelec, nuhf, mask), kt, _hot = _inputs("near_degenerate_300K")
    args = _torch((eps, nelec, nuhf)) + [kt] + _torch((mask,))
    f, s, steps = ff.fermi_occupations_steps(*args)
    f_p, s_p = ff.fermi_occupations_reference(*args)
    assert torch.equal(f, f_p) and torch.equal(s, s_p)
    assert torch.equal(steps, ff.fermi_steps_reference(*args))
    assert steps.shape == (eps.shape[0], 2)
    assert bool((steps[:, 1][args[2] == 0] == 0).all())


class _FillCounts:
    """Counts the engine's calls of the fused density and of the fill."""

    def __init__(self, monkeypatch):
        self.density = self.fill = 0
        density, fill = te.fermi_density, te.fermi_occupations

        def counted_density(*args):
            self.density += 1
            return density(*args)

        def counted_fill(*args):
            self.fill += 1
            return fill(*args)

        monkeypatch.setattr(te, "fermi_density", counted_density)
        monkeypatch.setattr(te, "fermi_occupations", counted_fill)


def _scc_operands(calc, frag):
    from metalquicha_tpu_torch.methods.xtb.calculator import _scc_operands

    kt = calc.settings.electronic_temp * KB_HARTREE
    return kt, _scc_operands(frag.coords, frag, calc.settings)


@pytest.mark.parametrize("variant", ["gfn1", "gfn2"])
def test_scc_loop_fuses_the_density_and_refine_does_not(monkeypatch,
                                                        variant):
    """Under no_grad the SCC loops (`scf_solve`, `scf_solve_multipole`)
    take one `fermi_density` per iteration and no separate fill; the
    differentiable refinement records the fill and the product through
    C instead."""
    from _torch_port_common import WATER

    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator

    iters = 3
    calc = XtbCalculator(te.settings_from_params(
        variant, max_scf_iter=iters, scf_tol=0.0), variant=variant,
        device="cpu")
    frag = calc.make_batch([WATER, WATER])
    kt, (S, H0, gamma, mp) = _scc_operands(calc, frag)
    counts = _FillCounts(monkeypatch)
    with torch.no_grad():
        if variant == "gfn2":
            z, _ = te.scf_solve_multipole(H0, S, frag.coords, gamma, frag, kt,
                                          calc.settings, None, mp)
        else:
            z, _ = te.scf_solve(H0, S, gamma, frag, kt, calc.settings)
    assert (counts.density, counts.fill) == (iters, 0)
    if variant == "gfn2":
        te.scf_refine_multipole(H0, S, frag.coords, gamma, frag, kt,
                                calc.settings, None, mp, z, 2)
    else:
        te.scf_refine(H0, S, gamma, frag, kt, calc.settings, z, 2)
    assert (counts.density, counts.fill) == (iters, 2)


def test_scc_above_64_aos_fills_and_multiplies(monkeypatch):
    """Above DENSITY_MAX_N the SCC fills (`fermi_occupations`) and takes a
    plain product, once per iteration."""
    from _torch_port_common import WATER

    from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator

    iters = 2
    calc = XtbCalculator(te.settings_from_params(
        "gfn1", max_scf_iter=iters, scf_tol=0.0), device="cpu")
    n = ff.DENSITY_MAX_N + 1
    frag = calc.make_batch([WATER], pad_to=(3, 6, n))
    kt, (S, H0, gamma, _mp) = _scc_operands(calc, frag)
    counts = _FillCounts(monkeypatch)
    with torch.no_grad():
        q, _ = te.scf_solve(H0, S, gamma, frag, kt, calc.settings)
    assert (counts.density, counts.fill) == (0, iters)
    small = calc.make_batch([WATER])
    kt, (S, H0, gamma, _mp) = _scc_operands(calc, small)
    with torch.no_grad():
        q_small, _ = te.scf_solve(H0, S, gamma, small, kt, calc.settings)
    # the same water: padding changes nothing beyond rounding
    assert float((q[:, :q_small.shape[1]] - q_small).abs().max()) <= 1e-12


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

#: (B, nao) of the main path: the dimer slice, the w20 MBE(2) buckets, the
#: w20 MBE(4) gradient and energy chunks, a chunk of the 73-atom FD
#: Hessian; then a row longer than the kernel keeps in registers
GPU_SHAPES = [(512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
              (41, 241), (3, 300)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(shape, seed):
    """A batch of rows at `shape`: every third row padded to two thirds of
    its AOs, nuhf 0, 1 or 2 in turn, a gap of 0.3 Ha."""
    rng = np.random.default_rng(seed)
    bsz, nao = shape
    mask = np.ones((bsz, nao))
    mask[::3, (2 * nao) // 3:] = 0.0
    nuhf = np.arange(bsz) % 3.0
    n_real = mask.sum(1)
    nelec = 2.0 * np.floor(n_real / 3.0) + nuhf
    return _levels(rng, mask, nelec), nelec, nuhf, mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kt", [KT_300, KT_5000], ids=["300K", "5000K"])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_matches_plain_version(cuda, shape, kt, dtype):
    eps, nelec, nuhf, mask = _torch(_card_inputs(shape, shape[1]), dtype,
                                    cuda)
    before = ff.launches
    f, s = ff.fermi_occupations(eps, nelec, nuhf, kt, mask)
    torch.cuda.synchronize()
    assert ff.launches == before + 1
    f_p, s_p = ff.fermi_occupations_reference(eps, nelec, nuhf, kt, mask)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((f - f_p).abs().max()) <= tol
    assert float((s - s_p).abs().max()) <= (
        tol if dtype == torch.float64 else TOL_F32_ENTROPY)
    with pytest.raises(TypeError):
        ff.fermi_occupations(eps.half(), nelec, nuhf, kt, mask)


@pytest.mark.gpu
def test_cuda_tensor_never_reaches_the_plain_version(cuda, monkeypatch):
    def refuse(*_args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ff, "fermi_occupations_reference", refuse)
    eps, nelec, nuhf, mask = _torch(_card_inputs((8, 16), 0), device=cuda)
    before = ff.launches
    f, s = te.occupations(eps.requires_grad_(True), nelec, nuhf, KT_300,
                          mask, False)
    torch.cuda.synchronize()
    assert ff.launches == before + 1
    assert not f.requires_grad and not s.requires_grad
    assert f.device.type == "cuda" and bool(torch.isfinite(f).all())


#: (B, nao) of the fused density on the main path: the dimer slice, the
#: w20 MBE(2) buckets, the w20 MBE(4) gradient and energy chunks, and the
#: largest nao it takes
DENSITY_SHAPES = [(512, 16), (190, 16), (20, 11), (2581, 32), (5985, 32),
                  (128, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", DENSITY_SHAPES)
def test_density_kernel_matches_plain_version(cuda, shape, dtype):
    eps, nelec, nuhf, mask = _torch(_card_inputs(shape, shape[1]), dtype,
                                    cuda)
    C = torch.tensor(_eigenvectors(np.random.default_rng(shape[0]), *shape),
                     dtype=dtype, device=cuda)
    before, fused = ff.launches, ff.density_launches
    p = ff.fermi_density(eps, C, nelec, nuhf, KT_300, mask)
    torch.cuda.synchronize()
    assert ff.launches == before + 1 and ff.density_launches == fused + 1
    p_p = ff.fermi_density_reference(eps, C, nelec, nuhf, KT_300, mask)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((p - p_p).abs().max()) <= tol


@pytest.mark.gpu
def test_cuda_tensor_never_reaches_the_density_plain_version(cuda,
                                                             monkeypatch):
    def refuse(*_args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ff, "fermi_density_reference", refuse)
    monkeypatch.setattr(ff, "fermi_occupations_reference", refuse)
    eps, nelec, nuhf, mask = _torch(_card_inputs((8, 16), 0), device=cuda)
    C = torch.tensor(_eigenvectors(np.random.default_rng(0), 8, 16),
                     device=cuda)
    p = ff.fermi_density(eps, C, nelec, nuhf, KT_300, mask)
    torch.cuda.synchronize()
    assert p.device.type == "cuda" and bool(torch.isfinite(p).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_steps(cuda, dtype):
    """The kernel's own step counts: every filled row stops within 80
    steps, a closed shell's beta channel is not filled."""
    eps, nelec, nuhf, mask = _torch(_card_inputs((512, 16), 16), dtype, cuda)
    f, s, steps = ff.fermi_occupations_steps(eps, nelec, nuhf, KT_300, mask)
    f_k, s_k = ff.fermi_occupations(eps, nelec, nuhf, KT_300, mask)
    assert torch.equal(f, f_k) and torch.equal(s, s_k)
    closed = nuhf == 0
    assert bool((steps[closed, 1] == 0).all())
    filled = torch.cat([steps[:, 0], steps[~closed, 1]])
    assert bool(((filled > 0) & (filled <= ff.STEPS)).all())
