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
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    (eps, nelec, nuhf, mask), kt, _hot = _inputs("real_batch_300K")
    before = ff.launches
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        ff._launch(*_torch((eps, nelec, nuhf)), kt, *_torch((mask,)))
    assert ff.launches == before


def test_entry_points_match_the_source():
    """The ctypes declarations of the wrapper against the C signatures of
    csrc/fermi_fill.cu: a pointer for each pointer, a double for kt, an
    int for each int (a mismatch shows only on a card otherwise)."""
    src = ff._LIB.source.read_text()
    kinds = {"double": "c_double", "int": "c_int", "void*": "c_void_p"}
    for name, argtypes in ff._LIB.entry_points.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        want = []
        for p in params.split(","):
            words = p.replace("*", " * ").split()
            want.append("c_void_p" if "*" in words else kinds[words[-2]])
        assert [t.__name__ for t in argtypes] == want, name


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
