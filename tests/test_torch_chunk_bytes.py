"""The port's executor chunk guard in bytes, against the JAX package.

`overlap_matrix` shares its 1D Obara-Saika factors per dimension (as
`multipole._sdim_tables` does): its values are bitwise those of the
version that rebuilt them per (i, j) (kept here as the reference), and
they match the JAX package's to 1e-13 at nao 16 and 32 with s, p and d
shells. The executor's byte model (`fragment_bytes`) grows with the padded
shape and is larger for a gradient than for an energy; on a CPU tensor no
byte budget is taken and chunks are cut exactly as the JAX executor cuts
them. With the budget forced small (the module's `device_budget`
monkeypatched) a bucket of 40 jittered water trimers is cut into at least
3 chunks with the same energies (1e-12; the JAX executor's frozen ones
1e-10) and gradients within C17's size (1e-9); an FD Hessian through the
driver equals the unforced one (1e-8) and the JAX Hessian norm (1e-5); a
fragment the budget cannot hold raises, naming its shape. Two slots on one
device each plan for half of it. The model's cache entries
(`scc_entry_bytes`) hold what one call's entries allocate (the loop's and
the operand build's and the functional's stages, run through the cache
with the stand-ins of `_torch_scc_standins.py`), and on a card the eigh
workspace on every route. Frozen JAX values:
tests/data/port_golden_memory.json, port_golden_gfn1_full.json
(tools/gen_port_golden.py).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from _torch_scc_standins import no_card, staged  # noqa: F401 (fixtures)
from _torch_port_common import (
    HALOGEN,
    REPO,
    WATER,
    jax_fragment_data,
    jittered_trimers,
    max_abs_diff,
    port_from_jax,
    restore_jax_overlay,
)
from metalquicha_tpu_torch.driver import read_mqc_file, run_calculation
from metalquicha_tpu_torch.logging_ import global_logger
from metalquicha_tpu_torch.methods.xtb import overlap as tov
from metalquicha_tpu_torch.methods.xtb import scc_graph
from metalquicha_tpu_torch.methods.xtb.calculator import XtbCalculator
from metalquicha_tpu_torch.methods.xtb.engine import settings_from_params
from metalquicha_tpu_torch.parallel import executor as executor_mod
from metalquicha_tpu_torch.parallel.executor import (
    DeviceMemoryError,
    FragmentExecutor,
    byte_cap,
    fragment_bytes,
    scc_entry_bytes,
)

torch.set_num_threads(1)
DATA = os.path.join(REPO, "tests", "data")
ANG = 1.0 / 0.52917721067

H2S = (np.array([16, 1, 1]),
       np.array([[0.0, 0.0, 0.0], [0.0, 0.96, 0.93], [0.0, -0.96, 0.93]])
       * ANG, 0, 1)
HCL = (np.array([17, 1]), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.27]])
       * ANG, 0, 1)
SIH4_WATER = (
    np.array([14, 1, 1, 1, 1, 8, 1, 1]),
    np.vstack([
        np.array([[0, 0, 0], [0.87, 0.87, 0.87], [-0.87, -0.87, 0.87],
                  [0.87, -0.87, -0.87], [-0.87, 0.87, -0.87]]) * ANG,
        WATER[1] + np.array([6.5, 0.3, -0.2]),
    ]), 0, 1)
#: (fragments, padded (nat, nsh, nao)): s, p and d shells (S, Cl, Si, Br)
OVERLAP_CASES = {
    16: ([H2S, HCL, WATER], (4, 8, 16)),
    32: ([SIH4_WATER, HALOGEN, H2S], (12, 24, 32)),
}


def overlap_rebuilt(coords, ao_atom, ao_lxyz, prim_alpha, prim_coeff):
    """`overlap_matrix` as it was: each (i, j) 1D factor rebuilt from its
    recursion on its own, no cache."""
    bsz, nao = ao_atom.shape
    bidx = torch.arange(bsz, device=ao_atom.device)[:, None]
    A = coords[bidx, ao_atom]
    AB = A[:, :, None, :] - A[:, None, :, :]
    rab2 = (AB**2).sum(-1)
    ai = prim_alpha[:, :, None, :, None]
    aj = prim_alpha[:, None, :, None, :]
    p = ai + aj
    p = torch.where(p > 0, p, 1.0)
    inv2p = 0.5 / p
    mu = ai * aj / p
    pref = (math.pi / p) ** 1.5 * torch.exp(-mu * rab2[..., None, None])
    sdim = None
    for d in range(3):
        li = ao_lxyz[:, :, None, :, None, d]
        lj = ao_lxyz[:, None, :, None, :, d]
        ab_d = AB[..., d][..., None, None]
        xpa = -aj * ab_d / p
        xpb = ai * ab_d / p
        s_d = torch.zeros_like(pref)
        for i in range(tov.MAX_L + 1):
            for j in range(tov.MAX_L + 1):
                mask = (li == i) & (lj == j)
                s_d = torch.where(mask, tov._s1d(i, j, xpa, xpb, inv2p), s_d)
        sdim = s_d if sdim is None else sdim * s_d
    prim_s = pref * sdim
    cc = prim_coeff[:, :, None, :, None] * prim_coeff[:, None, :, None, :]
    S = (prim_s * cc).sum((3, 4))
    same_atom = ao_atom[:, :, None] == ao_atom[:, None, :]
    S = torch.where((rab2 < 1e-10) & ~same_atom, 0.0, S)
    eye = torch.eye(nao, dtype=S.dtype, device=S.device)
    return torch.where(same_atom, eye, S)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(DATA, "port_golden_memory.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def overlap_batches():
    restore_jax_overlay()
    return {nao: jax_fragment_data(frags, pad_to=pad_to)
            for nao, (frags, pad_to) in OVERLAP_CASES.items()}


def _args(f):
    return (f.ao_atom, f.ao_lxyz, f.prim_alpha, f.prim_coeff)


@pytest.mark.parametrize("nao", sorted(OVERLAP_CASES))
def test_shared_factors_overlap_is_bitwise_the_rebuilt_one(overlap_batches,
                                                           nao):
    import jax

    from metalquicha_tpu.methods.xtb import overlap as jov

    jf = overlap_batches[nao]
    tf = port_from_jax(jf)
    assert tf.ao_mask.shape[-1] == nao
    assert int(tf.ao_lxyz.max()) == 2  # d shells present
    S = tov.overlap_matrix(tf.coords, *_args(tf))
    assert torch.equal(S, overlap_rebuilt(tf.coords, *_args(tf)))
    S_j = jax.vmap(lambda c, f: jov.overlap_matrix(c, *_args(f)))(
        jf.coords, jf)
    assert max_abs_diff(S, S_j) <= 1e-13


def _energy_and_gradient(overlap, frags, pad_to, monkeypatch):
    """GFN1 energies and gradients with `overlap` as the engine's and the
    calculator's overlap builder."""
    from metalquicha_tpu_torch.methods.xtb import calculator, engine

    monkeypatch.setattr(calculator, "overlap_matrix", overlap)
    monkeypatch.setattr(engine, "overlap_matrix", overlap)
    calc = XtbCalculator(device="cpu")
    frag = calc.make_batch(frags, pad_to=pad_to)
    e, _aux = calc.energies(frag)
    e_g, g, _aux = calc.gradients(frag)
    return e, e_g, g


@pytest.mark.parametrize("nao", sorted(OVERLAP_CASES))
def test_shared_factors_energies_bitwise_gradients_to_the_last_bits(
        nao, monkeypatch):
    """Energies are bitwise those of the rebuilt factors; gradients too
    where every AO is s or p. Where a d shell selects a higher factor, a
    shared factor sums its backward contributions before passing them on,
    in another order than its rebuilt copies: the last bits move."""
    frags, pad_to = OVERLAP_CASES[nao]
    e0, eg0, g0 = _energy_and_gradient(overlap_rebuilt, frags, pad_to,
                                       monkeypatch)
    e1, eg1, g1 = _energy_and_gradient(tov.overlap_matrix, frags, pad_to,
                                       monkeypatch)
    assert torch.equal(e0, e1) and torch.equal(eg0, eg1)
    assert max_abs_diff(g0, g1) <= 4 * torch.finfo(torch.float64).eps
    sp = [WATER, (np.tile(WATER[0], 2),
                  np.vstack([WATER[1], WATER[1] + 5.0]), 0, 1)]
    _e, _eg, g0 = _energy_and_gradient(overlap_rebuilt, sp, (6, 12, 16),
                                       monkeypatch)
    _e, _eg, g1 = _energy_and_gradient(tov.overlap_matrix, sp, (6, 12, 16),
                                       monkeypatch)
    assert torch.equal(g0, g1)


@pytest.mark.parametrize("variant,solvation", [
    ("gfn1", None), ("gfn1", "alpb"), ("gfn1", "cpcm"), ("gfn2", None)])
def test_byte_model_grows_with_the_shape(variant, solvation):
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )
    from metalquicha_tpu_torch.methods.xtb.solvation.cpcm import (
        CpcmSolvation,
    )

    solv = {None: None, "alpb": BornSolvation(78.4, alpb=True),
            "cpcm": CpcmSolvation(78.4, nang=110)}[solvation]
    calc = XtbCalculator(settings_from_params(variant), variant,
                         torch.float64, "cpu", solv)
    shapes = [(4, 8, 11, 6), (6, 12, 16, 6), (6, 12, 16, 7), (12, 24, 32, 7),
              (24, 48, 61, 9), (96, 192, 241, 9)]
    for what in ("energy", "gradient"):
        sizes = [fragment_bytes(calc, s[:3], s[3], what) for s in shapes]
        # non-decreasing (an energy holds its largest phase: CPCM's matrix
        # may hide the overlap's growth), and strictly over the range
        assert all(b >= a for a, b in zip(sizes, sizes[1:]))
        assert sizes[-1] > sizes[0]
        # a chunk of B fragments: its bytes grow with B, so the cap falls
        # as a fragment's bytes grow
        per = sizes[1]
        assert [b * per for b in (1, 2, 3)] == sorted(
            b * per for b in (1, 2, 3))
        caps = [byte_cap(1e12, s, (1, 1, 1), 1, what) for s in sizes]
        assert caps == sorted(caps, reverse=True)
    for s in shapes:
        assert (fragment_bytes(calc, s[:3], s[3], "gradient")
                > fragment_bytes(calc, s[:3], s[3], "energy"))


def _chunks(ex):
    """Wrap ex._run_chunk to record (chunk size, padded shape) without
    evaluating anything."""
    seen = []

    def record(members, pad_to, *_args):
        seen.append((len(members), tuple(pad_to)))

    ex._run_chunk = record
    return seen


def test_cpu_chunks_are_the_jax_executors():
    """3500 copies of no_frag.json's 73-atom peptide (nao 241): the JAX
    executor on one device cuts them at its element cap (2e8 / 241^2 =
    3443) into two chunks, and the port's one-slot executor, with no byte
    budget on the CPU, into the same two."""
    import jax

    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator as JaxC
    from metalquicha_tpu.parallel.executor import FragmentExecutor as JaxEx
    from metalquicha_tpu.parallel.mesh import fragment_mesh as jax_mesh

    with open(os.path.join(REPO, "validation", "inputs",
                           "no_frag.json")) as fh:
        mol = json.load(fh)["molecules"][0]
    z = {"H": 1, "C": 6, "N": 7, "O": 8}
    pep = (np.array([z[s] for s in mol["symbols"]]),
           np.array(mol["geometry"]).reshape(-1, 3) * ANG, 0, 1)
    frags = [pep] * 3500
    port = FragmentExecutor(XtbCalculator(device="cpu"))
    jax_ex = JaxEx(JaxC(), mesh=jax_mesh(jax.devices()[:1]))
    seen_port, seen_jax = _chunks(port), _chunks(jax_ex)
    port.run(frags)
    jax_ex.run(frags)
    assert port.last_budget is None
    assert seen_port == seen_jax == [(3443, (96, 192, 241)),
                                     (57, (96, 192, 241))]


def _force_budget(monkeypatch, budget):
    monkeypatch.setattr(executor_mod, "device_budget",
                        lambda device, sharing=1: budget)


@pytest.fixture(scope="module")
def trimers_one_chunk():
    ex = FragmentExecutor(XtbCalculator(device="cpu"))
    seen = []
    run_chunk = ex._run_chunk
    ex._run_chunk = lambda m, *a: seen.append(len(m)) or run_chunk(m, *a)
    e, g, _aux = ex.run(jittered_trimers(), what="gradient")
    assert seen == [40]
    return e, g


def test_forced_budget_cuts_the_bucket(trimers_one_chunk, golden,
                                       monkeypatch):
    frags = jittered_trimers()
    calc = XtbCalculator(device="cpu")
    ex = FragmentExecutor(calc)
    members = list(enumerate(frags))
    pad_to = ex._pad_shapes_for(12, members)
    per = ex.fragment_bytes(pad_to, members, "gradient")
    _force_budget(monkeypatch, int(15.5 * per))
    seen = []
    run_chunk = ex._run_chunk
    ex._run_chunk = lambda m, *a: seen.append(len(m)) or run_chunk(m, *a)
    e, g, _aux = ex.run(frags, what="gradient")
    assert seen == [15, 15, 10]
    assert ex.last_budget == int(15.5 * per)
    e1, g1 = trimers_one_chunk
    assert max_abs_diff(e, e1) <= 1e-12
    assert max_abs_diff(np.stack(g), np.stack(g1)) <= 1e-9  # C17
    gold = golden["trimers"]
    assert max_abs_diff(e, gold["energies"]) <= 1e-10
    assert max_abs_diff(np.stack(g), np.asarray(gold["gradients"])) <= 1e-9


def test_forced_budget_fd_hessian_through_the_driver(monkeypatch):
    with open(os.path.join(DATA, "port_golden_gfn1_full.json")) as fh:
        gold = json.load(fh)["driver"]["hess_h3o"]
    cfg = read_mqc_file(os.path.join(REPO, gold["mqc"]))
    level = global_logger.level
    global_logger.set_level("warning")
    try:
        free = run_calculation(cfg, write_json=False, device="cpu")[""]
        ex = FragmentExecutor(XtbCalculator(device="cpu"))
        h3o = [(np.array([8, 1, 1, 1]), np.zeros((4, 3)), 1, 1)]
        per = ex.fragment_bytes((4, 8, 11), list(enumerate(h3o)),
                                "gradient")
        _force_budget(monkeypatch, int(5 * per))
        cut = run_calculation(cfg, write_json=False, device="cpu")[""]
    finally:
        global_logger.level = level
    h_free = np.asarray(free.result.hessian)
    h_cut = np.asarray(cut.result.hessian)
    assert max_abs_diff(h_cut, h_free) <= 1e-8
    assert abs(np.linalg.norm(h_cut) - gold["hessian_frobenius_norm"]) <= 1e-5


def test_unfittable_fragment_raises_with_its_shape(monkeypatch):
    _force_budget(monkeypatch, 1000)
    ex = FragmentExecutor(XtbCalculator(device="cpu"))
    with pytest.raises(DeviceMemoryError,
                       match=r"\(nat, nsh, nao, nprim\) = \(4, 8, 11, 7\)"):
        ex.run([WATER], what="gradient")


def test_slots_on_one_card_split_its_budget(monkeypatch):
    """device_budget splits a card's free bytes between the slots that
    share it, and the caller tells each worker how many share its device."""
    from metalquicha_tpu_torch.parallel import slot_worker
    from metalquicha_tpu_torch.parallel.mesh import fragment_mesh

    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40 * 2**30, 80 * 2**30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 3 * 2**30)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 2**30)
    one = executor_mod.device_budget("cuda:0")
    assert one == int(executor_mod.BUDGET_SHARE * 42 * 2**30)
    assert executor_mod.device_budget("cuda:0", 2) == int(one / 2)
    assert executor_mod.device_budget("cpu") is None

    sent = []

    def exchange(workers, messages, timeout=None):
        sent.extend(messages)
        raise RuntimeError("stop")

    monkeypatch.setattr(slot_worker, "exchange", exchange)
    ex = FragmentExecutor(XtbCalculator(device="cpu"),
                          mesh=fragment_mesh(["cpu", "cpu", "cpu"]))
    monkeypatch.setattr(ex, "_start_workers", lambda config: None)
    ex.workers[:] = [type("W", (), {"device": d})() for d in ex.mesh.flat]
    with pytest.raises(RuntimeError, match="stop"):
        ex.run([WATER] * 3)
    assert [m[0] for m in sent] == ["piece"] * 3
    assert [m[-1] for m in sent] == [3, 3, 3]
    assert [m[-2] for m in sent] == [ex.runs] * 3
    ex.workers.clear()


@pytest.mark.parametrize("grad", [False, True], ids=["energy", "gradient"])
@pytest.mark.parametrize("variant,solvation", [
    ("gfn1", None), ("gfn1", "alpb"), ("gfn2", None)])
def test_entry_bytes_hold_a_calls_entries(staged, variant, solvation, grad):
    """One call's cache entries (the loop and the operand build's and the
    functional's stages: their buffers, the loop's state, the statuses),
    per fragment, within [0.5, 1] of `scc_entry_bytes` (no workspace off a
    card; D3's pair table, one broadcast copy per entry whatever the
    batch, left out as the model leaves it)."""
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )

    solv = BornSolvation(78.4) if solvation else None
    calc = XtbCalculator(settings_from_params(variant, max_scf_iter=4),
                         variant, torch.float64, "cpu", solv)
    frags = jittered_trimers(6)
    frag = calc.make_batch(frags)
    pad_to = (frag.coords.shape[1], frag.sh_mask.shape[1],
              frag.ao_mask.shape[1])
    if grad:
        calc.gradients(frag)
    else:
        calc.energies(frag)
    assert len(scc_graph._entries) == 3
    table = sum(b.numel() * b.element_size()
                for e in scc_graph._entries.values()
                for b, axes in e.dsts if axes)
    held = (sum(e.nbytes for e in scc_graph._entries.values())
            - table) / len(frags)
    model = scc_entry_bytes(calc, pad_to, frag.prim_alpha.shape[-1])
    assert 0.5 * model <= held <= model


def test_entry_bytes_count_the_workspace_on_every_route(monkeypatch):
    """On a card the orthogonalizer's and the functional's eighs need
    cuSOLVER's workspace on every route (the Jacobi route's loop has
    none, its operand build and functional do), once per dtype; ALPB's
    covariances one more."""
    from metalquicha_tpu_torch.ops import batched_eigh

    monkeypatch.setattr(batched_eigh, "workspace_bytes",
                        lambda dtype, n, device: 1000.0 * (
                            2 if dtype == torch.float64 else 1))
    pad_to = (6, 12, 16)
    for jacobi, dtype in ((False, torch.float64), (True, torch.float32)):
        calc = XtbCalculator(settings_from_params(
            "gfn1", use_pallas_eigh=jacobi), dtype=dtype, device="cpu")
        off_card = scc_entry_bytes(calc, pad_to, 6)
        calc.device = torch.device("cuda", 0)
        size = 2 if dtype == torch.float64 else 1
        assert scc_entry_bytes(calc, pad_to, 6) == off_card + 1000.0 * size
    # the float32 route's polish keeps a float64 entry beside its own
    polished = scc_entry_bytes(calc, pad_to, 6, polished=True)
    assert polished == 3 * off_card + 1000.0 + 2000.0
    # ALPB adds the workspace of its 3x3 covariances' eigenvalues
    from metalquicha_tpu_torch.methods.xtb.solvation.born import (
        BornSolvation,
    )

    for alpb, extra in ((True, 2000.0), (False, 0.0)):
        calc = XtbCalculator(device="cpu", solvation=BornSolvation(
            78.4, alpb=alpb))
        off_card = scc_entry_bytes(calc, pad_to, 6)
        calc.device = torch.device("cuda", 0)
        assert scc_entry_bytes(calc, pad_to, 6) == off_card + 2000.0 + extra
