"""The system a cell runs: the cluster read from the upstream input, its MBE
fragments grouped into batches as the traffic file says, their weights in
the MBE total, and the seeded geometries of the steps.

A configuration file names the upstream input (`input`, a path under the
benchmark's folder, whose `xyz` path resolves relative to it) and what the
cell changes in it (`model_overrides`); the program's own input layer
(`io/prep.emit_mqc`, `io/config.parse_mqc_string`, `io/adapter`) reads it,
as `run_calculation` would, so the calculator is the one the input makes.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import NamedTuple

import numpy as np

#: CODATA 2010, as the program and tblite
ANGSTROM_TO_BOHR = 1.0 / 0.52917721092


class Cluster(NamedTuple):
    numbers: np.ndarray        # (natoms,)
    coords: np.ndarray         # (natoms, 3) Bohr
    monomers: list             # [(atom indices, charge, multiplicity)]


def read_input(config: dict, root: str):
    """(the program's parsed input, the cluster) of a configuration."""
    from metalquicha_tpu_torch.io.config import parse_mqc_string
    from metalquicha_tpu_torch.io.prep import emit_mqc

    path = os.path.join(root, config["input"])
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    data["model"].update(config.get("model_overrides", {}))
    cfg = parse_mqc_string(emit_mqc(data, os.path.dirname(path)))
    geom = cfg.geometry
    monomers = [(list(f.indices), int(f.charge), int(f.multiplicity))
                for f in cfg.fragments]
    return cfg, Cluster(np.asarray(geom.numbers, dtype=np.int64),
                        np.asarray(geom.coords_angstrom) * ANGSTROM_TO_BOHR,
                        monomers)


def mbe_weight(k: int, n: int, level: int) -> int:
    """The coefficient of a k-body fragment's energy in the MBE(level)
    total of n monomers with every subset kept: sum over j = k..level of
    (-1)^(j-k) C(n-k, j-k)."""
    return sum((-1) ** (j - k) * math.comb(n - k, j - k)
               for j in range(k, level + 1))


class Batch(NamedTuple):
    name: str
    k: int                     # monomers per fragment
    subsets: list              # [tuple of monomer indices]
    atoms: np.ndarray          # (B, nat) the cluster's atom of each slot
    charges: np.ndarray        # (B,)
    mults: np.ndarray          # (B,)


def _fragment(cluster: Cluster, subset):
    atoms = [a for m in subset for a in cluster.monomers[m][0]]
    charge = sum(cluster.monomers[m][1] for m in subset)
    # high spin: the monomers' unpaired electrons add
    mult = 1 + sum(cluster.monomers[m][2] - 1 for m in subset)
    return atoms, charge, mult


def batches(cluster: Cluster, traffic: dict) -> list:
    """The step's batches in the traffic file's order: `batches` lists
    [k, count] pairs; the k-body subsets of the monomers, in
    lexicographic order, fill the batches of size k in turn."""
    n = len(cluster.monomers)
    pending = {}
    out = []
    for k, count in traffic["batches"]:
        it = pending.setdefault(k, itertools.combinations(range(n), k))
        subsets = list(itertools.islice(it, count))
        if len(subsets) != count:
            raise ValueError(f"{count} fragments of {k} asked, "
                             f"{len(subsets)} left")
        frags = [_fragment(cluster, s) for s in subsets]
        nat = max(len(a) for a, _c, _m in frags)
        atoms = np.full((count, nat), -1, dtype=np.int64)
        for b, (a, _c, _m) in enumerate(frags):
            atoms[b, :len(a)] = a
        name = f"{k}x{count}"
        while name in {b.name for b in out}:
            name += "'"
        out.append(Batch(name, k, subsets, atoms,
                         np.array([c for _a, c, _m in frags]),
                         np.array([m for _a, _c, m in frags])))
    for k, it in pending.items():
        if next(it, None) is not None:
            raise ValueError(f"the traffic leaves {k}-body fragments out")
    return out


def weights(batch_list: list, n: int, level: int) -> np.ndarray:
    """Each fragment's MBE weight, in the batches' order."""
    return np.concatenate([np.full(len(b.subsets), mbe_weight(b.k, n, level),
                                   dtype=np.float64) for b in batch_list])


def fragments(cluster: Cluster, batch: Batch, coords: np.ndarray) -> list:
    """(numbers, coords_bohr, charge, multiplicity) tuples of a batch at
    the cluster's coordinates `coords` (natoms, 3)."""
    out = []
    for b in range(len(batch.subsets)):
        atoms = batch.atoms[b][batch.atoms[b] >= 0]
        out.append((cluster.numbers[atoms], coords[atoms],
                    int(batch.charges[b]), int(batch.mults[b])))
    return out
