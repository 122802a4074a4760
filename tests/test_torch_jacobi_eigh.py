"""The Jacobi eigensolver of the torch port (ops/jacobi_eigh.py).

On the CPU the wrapper runs the plain torch version; it is held against
the JAX package's Pallas kernel (interpret mode) and against LAPACK. The
CUDA kernel itself is tested by the `gpu` case, which skips without a
card (run it on one with `python -m pytest tests/test_torch_jacobi_eigh.py
-m gpu`).
"""

import itertools

import numpy as np
import pytest
import torch

from metalquicha_tpu_torch.ops import jacobi_eigh as jac
from metalquicha_tpu_torch.ops import kernel_build

torch.set_num_threads(1)


def _sym(rng, b, n, scale=1.0):
    x = rng.normal(size=(b, n, n))
    return scale * (x + x.transpose(0, 2, 1)) / (2.0 * np.sqrt(n))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 16])
def test_round_robin_covers_every_pair_once(n):
    rounds = jac.round_robin_pairs(n)
    assert len(rounds) == n - 1 + (n & 1)
    seen = [tuple(p) for r in rounds for p in r.tolist()]
    assert sorted(seen) == list(itertools.combinations(range(n), 2))
    for r in rounds:  # disjoint within a round
        assert len(set(r.ravel().tolist())) == r.size


def test_plain_matches_pallas_interpret():
    import jax.numpy as jnp

    from metalquicha_tpu.ops.jacobi_eigh import batched_jacobi_eigh

    rng = np.random.default_rng(0)
    a = _sym(rng, 2, 8, scale=4.0)
    w_j, _ = batched_jacobi_eigh(jnp.asarray(a), sweeps=10, interpret=True)
    w_t, _ = jac.jacobi_eigh_reference(torch.tensor(a), 10)
    np.testing.assert_allclose(
        np.sort(w_t.numpy(), 1), np.sort(np.asarray(w_j), 1), rtol=0,
        atol=1e-12,
    )


def test_equal_diagonal_pairs_rotate_unlike_the_pallas_kernel():
    """A pair with a_pp == a_qq and a_pq != 0 has tau = 0. The port takes
    sgn(0) = +1 and rotates it by pi/4; the Pallas kernel's jnp.sign(0) = 0
    leaves it unrotated, so on a block-diagonal matrix of [[d, b], [b, d]]
    blocks its eigenvalues stay at d (a fault of the reference, ROADMAP
    C6)."""
    import jax.numpy as jnp

    from metalquicha_tpu.ops.jacobi_eigh import batched_jacobi_eigh

    d = np.array([1.0, -0.5, 2.0, 0.25])
    b = np.array([0.5, 0.3, -0.7, 1e-3])
    a = np.zeros((1, 8, 8))
    for k in range(4):
        a[0, 2 * k : 2 * k + 2, 2 * k : 2 * k + 2] = [[d[k], b[k]], [b[k], d[k]]]
    w_lapack = np.linalg.eigvalsh(a)

    w, v = jac.jacobi_eigh_reference(torch.tensor(a), 10)
    w, v = w.numpy(), v.numpy()
    np.testing.assert_allclose(np.sort(w, 1), w_lapack, rtol=0, atol=1e-14)
    assert np.abs(a @ v - v * w[:, None, :]).max() < 1e-14
    assert np.abs(v.transpose(0, 2, 1) @ v - np.eye(8)).max() < 1e-14

    w_j, _ = batched_jacobi_eigh(jnp.asarray(a), sweeps=10, interpret=True)
    w_j = np.sort(np.asarray(w_j), 1)
    np.testing.assert_array_equal(w_j, np.sort(np.repeat(d, 2))[None])
    assert np.abs(w_j - w_lapack).max() > 0.5


@pytest.mark.parametrize("n", [8, 16, 64])
def test_plain_matches_lapack(n):
    rng = np.random.default_rng(n)
    a = _sym(rng, 3, n)
    w, v = jac.jacobi_eigh_reference(torch.tensor(a), 10)
    w, v = w.numpy(), v.numpy()
    np.testing.assert_allclose(np.sort(w, 1), np.linalg.eigvalsh(a), rtol=0,
                               atol=1e-12)
    assert np.abs(a @ v - v * w[:, None, :]).max() < 1e-10
    assert np.abs(v.transpose(0, 2, 1) @ v - np.eye(n)).max() < 1e-12


def test_cpu_tensor_takes_the_plain_version():
    a = torch.tensor(_sym(np.random.default_rng(1), 4, 6))
    before = jac.launches
    w, v = jac.jacobi_eigh(a)
    w_p, v_p = jac.jacobi_eigh_reference(a, 10)
    assert jac.launches == before
    assert torch.equal(w, w_p) and torch.equal(v, v_p)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="MAX_N"):
        jac.jacobi_eigh(torch.zeros(1, jac.MAX_N + 1, jac.MAX_N + 1))
    with pytest.raises(ValueError, match="B, N, N"):
        jac.jacobi_eigh(torch.zeros(4, 4))
    with pytest.raises(ValueError, match="device"):
        jac.jacobi_eigh(torch.zeros(1, 4, 4, device="meta"))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cu"
    bad.write_text("not cuda\n")
    monkeypatch.setattr(jac._LIB, "lib", None)
    monkeypatch.setattr(jac._LIB, "source", bad)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    # a compiler that fails
    monkeypatch.setattr(kernel_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        jac.build()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "shape",
    [(512, 16), (128, 64), (7, 13), (3, 1), (20, 11), (190, 16), (5985, 32),
     (5, 33), (6000, 16)],
)
def test_kernel_matches_plain_version(cuda, dtype, shape):
    b, n = shape
    a = torch.tensor(_sym(np.random.default_rng(n), b, n), dtype=dtype,
                     device=cuda)
    before = jac.launches
    w, v = jac.jacobi_eigh(a)
    torch.cuda.synchronize()
    assert jac.launches == before + 1
    w_p, _ = jac.jacobi_eigh_reference(a, 10)
    tol = 1e-10 if dtype == torch.float64 else 5e-5
    ws = torch.sort(w, -1).values
    assert float((ws - torch.sort(w_p, -1).values).abs().max()) <= tol
    eye = torch.eye(n, dtype=dtype, device=cuda)
    assert float((a @ v - v * w[:, None, :]).abs().max()) <= tol
    assert float((v.mT @ v - eye).abs().max()) <= tol
    with pytest.raises(ValueError, match="contiguous"):
        jac.jacobi_eigh(torch.zeros(2, 8, 8, dtype=dtype, device=cuda).mT)
    with pytest.raises(TypeError):
        jac.jacobi_eigh(a.half())
