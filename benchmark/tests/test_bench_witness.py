"""The reference against a second witness: the JAX package, from which the
program was ported and from which the reference's copied modules descend,
on the CPU in a process of its own (`_jax_witness.py`), so that neither the
benchmark's run nor its reference loads JAX. A defect that the copies share
with the program, in the basis, the overlap integrals, D3 or the tables,
shows here unless the JAX package has it too."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from benchmark.harness import spec, system
from benchmark.reference import xtb as reference

#: both sides stop their SCC at 1e-10: what is left is rounding of a
#: 20-40 Ha energy in sums of other orders
TOL = 1e-9
GRAD_TOL = 1e-7


def _jax(frags, tmp_path):
    src, dst = tmp_path / "in.json", tmp_path / "out.json"
    src.write_text(json.dumps([[z.tolist(), x.tolist(), c, m]
                               for z, x, c, m in frags]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=spec.ROOT)
    env.pop("MQC_NO_OVERLAY", None)
    subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "tests",
                                                 "_jax_witness.py"),
                    str(src), str(dst)], env=env, cwd=spec.ROOT, check=True,
                   timeout=900)
    out = json.loads(dst.read_text())
    return (np.asarray(out["e"]), np.asarray(out["g"]),
            np.asarray(out["resid"]))


def test_reference_matches_the_jax_package(tmp_path):
    cell = spec.load_cell("w20-gfn1.mbe4-energy")
    _cfg, cluster = system.read_input(cell.config, spec.ROOT)
    cluster = cluster._replace(monomers=cluster.monomers[:5])
    coords = cluster.coords + np.random.default_rng(11).normal(
        0.0, 0.05, cluster.coords.shape)
    settings = reference.settings_for("gfn1")
    for n, batch in enumerate(system.batches(
            cluster, {"batches": [[1, 5], [2, 10]]})):
        frags = system.fragments(cluster, batch, coords)
        tables = reference.build(frags, "gfn1", "cpu")
        e_ref, g_ref, resid = reference.energies_at(tables, tables.coords,
                                                    settings, grad=True)
        assert float(resid.max()) <= 1e-10
        sub = tmp_path / str(n)
        sub.mkdir()
        e_jax, g_jax, r_jax = _jax(frags, sub)
        assert r_jax.max() <= 1e-10
        assert np.abs(e_ref.numpy() - e_jax).max() < TOL
        assert np.abs(g_ref.numpy() - g_jax).max() < GRAD_TOL
        assert torch.isfinite(e_ref).all()
