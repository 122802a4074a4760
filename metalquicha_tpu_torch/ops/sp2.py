"""SP2 density-matrix purification: a diagonalization-free in-loop SCC solver.

Counterpart of metalquicha_tpu's `ops/sp2.py` (plain matrix products there,
no hand-written kernel). Here the products, the traces and the Gershgorin
row sums run on the batch-invariant ops (`fragment_bmm`,
`ops/fragment_gemm.py`, up to its MAX_N, torch.matmul above as XLA's
there; `fragment_sum`, `ops/fragment_reduce.py`): on a card each
fragment's projector is the same bits whatever its batch; on the CPU each
op is the torch expression it replaced. Inside the
non-differentiated SCC fixed-point loop (engine.scf_solve) eigenpairs are
never needed, only the density matrix that generates the shell
populations. The second-order spectral projection (SP2) recursion of
Niklasson [PRB 66, 155115 (2002)] builds the zero-temperature density
projector from a fixed number of batched matrix products:

    X_0     = (emax I - F) / (emax - emin)          # spectrum -> [0, 1]
    X_{n+1} = X_n^2             if tr(X_n^2) closer to Nocc
            = 2 X_n - X_n^2     otherwise

Each iteration is one (B, N, N) product plus elementwise selects. The
engine takes this route for AO dimensions above the Jacobi kernel's
ceiling (engine.PALLAS_EIGH_MAX_N).

Validity: SP2 yields the T=0 projector (integer occupations). The
production SCC runs Fermi smearing at 300 K, where kT ~ 9.5e-4 Ha; for
closed-shell fragments with a HOMO-LUMO gap above ~1 eV the smeared and
T=0 fixed points agree to <1e-10 Ha. The final variational energy
evaluation always goes through the true eigh; SP2 only drives the charge
self-consistency iterations, and the calculator keeps open-shell and
d-block batches off it (`XtbCalculator._settings_for`).
"""

from __future__ import annotations

import threading

import torch

from . import replay_counts
from .fragment_gemm import fragment_bmm, takes
from .fragment_reduce import fragment_sum

#: `sp2_density` calls so far (a caller may reset it to 0): shows that a run
#: went through this route
calls = 0
_calls_lock = threading.Lock()


def add_calls(n: int) -> None:
    """Add calls made in another process (a mesh slot's worker) to the
    count."""
    global calls
    with _calls_lock:
        calls += n


def _count(_stream, n: int = 1) -> None:
    """Count n calls (under capture, hand them to the capture's tally: each
    replay of the graph runs the call's products again)."""
    if not replay_counts.record(_count):
        add_calls(n)


def sp2_projector(Fo, nocc, ao_mask, iters: int = 48):
    """T=0 density projector of symmetric (orthogonalized) Fock matrices.

    Fo:      (B, N, N) symmetric, in an orthonormal basis.
    nocc:    (B,) number of occupied states (float).
    ao_mask: (B, N) 1.0 for real AOs, 0.0 for padding. Padded states are
             pinned at the top of the spectrum (never occupied).
    Returns (B, N, N) projectors P with P^2 = P, tr(P) = nocc, spanning the
    nocc lowest eigenvectors of Fo.
    """
    n = Fo.shape[-1]
    eye = torch.eye(n, dtype=Fo.dtype, device=Fo.device)
    pair = ao_mask[..., :, None] * ao_mask[..., None, :]
    Fo = Fo * pair

    # Gershgorin bounds over the REAL block only (padded rows are zeroed;
    # padding at +100 Ha would otherwise stretch the [0,1] map ~50x and
    # stall convergence, which is gap/(emax-emin)-limited).
    diag = torch.diagonal(Fo, dim1=-2, dim2=-1)
    # the row sums as (B N) rows of N: their bits fixed by N alone
    offsum = fragment_sum(Fo.abs(), -1) - diag.abs()
    big = 1e30
    real = ao_mask > 0
    lo = torch.where(real, diag - offsum, big).amin(-1)
    hi = torch.where(real, diag + offsum, -big).amax(-1)
    width = torch.clamp(hi - lo, min=1e-6)

    # map spectrum to [0, 1] (occupied -> near 1); padded diagonal -> 0
    X = (hi[..., None, None] * eye - Fo) / width[..., None, None]
    X = torch.where(pair > 0, X, 0.0)

    square = fragment_bmm if takes(n, n) else torch.matmul
    for _ in range(iters):
        X2 = square(X, X)
        tr2 = fragment_sum(torch.diagonal(X2, dim1=-2, dim2=-1))
        tr = fragment_sum(torch.diagonal(X, dim1=-2, dim2=-1))
        # branch-free Niklasson criterion: pick whichever recursion moves
        # the trace toward nocc
        take_sq = (tr2 - nocc).abs() < (2.0 * tr - tr2 - nocc).abs()
        X = torch.where(take_sq[..., None, None], X2, 2.0 * X - X2)
    return X


def sp2_density(Fo, nelec, nuhf, ao_mask, iters: int = 48, closed_shell=None):
    """Spin-summed T=0 density matrices (B, N, N) in the orthonormal basis.

    Closed shell (nuhf == 0): P = 2 * proj(nelec / 2). Open shell: the
    spin-restricted fractional-occupation convention the engine uses
    (na/nb split) maps to proj(na) + proj(nb).

    closed_shell: whether every fragment of the batch has nuhf == 0 (then
    the second recursion is skipped: same projector). None reads it from
    `nuhf`, which costs a device-to-host sync; a caller inside a loop
    decides once and passes it.
    """
    _count(None)
    if closed_shell is None:
        closed_shell = bool((nuhf == 0).all())
    na = (nelec + nuhf) * 0.5
    Pa = sp2_projector(Fo, na, ao_mask, iters=iters)
    if closed_shell:
        return 2.0 * Pa
    nb = (nelec - nuhf) * 0.5
    return Pa + sp2_projector(Fo, nb, ao_mask, iters=iters)
