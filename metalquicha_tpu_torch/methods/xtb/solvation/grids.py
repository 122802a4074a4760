"""Angular quadrature grids for solvation surfaces.

The reference stack uses Lebedev-Laikov grids for CPCM cavities (cpcm_nang
selects the order, upstream metalquicha src/methods/mqc_method_xtb.f90:557-671)
and for GBSA surface integrals. Here:

- The classical small Lebedev rules (6, 14, 26, 38, 50 points; octahedral
  orbits with exact rational weights) are tabulated exactly.
- Larger rules (74, 86, 110 = the reference's CPCM default, 146, 170, 194,
  230, 302) are RECONSTRUCTED to machine precision by solving the Lebedev
  moment equations offline (tools/gen_lebedev.py; the rule of a given
  orbit composition + degree is the unique such solution, so this equals
  the published tables). They load from data/lebedev.json.
- Any other requested order falls back to a Gauss-Legendre x equispaced-phi
  product grid, which integrates spherical harmonics exactly up to degree
  min(2*ntheta-1, nphi-1) at ~2x the points.

All grids return (points (n,3) unit vectors, weights (n,) summing to 1).
"""

from __future__ import annotations

import numpy as np


def _orbit_a1():
    """6 octahedron vertices (+-1,0,0)."""
    pts = []
    for d in range(3):
        for s in (1.0, -1.0):
            v = [0.0, 0.0, 0.0]
            v[d] = s
            pts.append(v)
    return np.array(pts)


def _orbit_a2():
    """12 edge midpoints (+-1,+-1,0)/sqrt(2)."""
    pts = []
    for d in range(3):
        for s1 in (1.0, -1.0):
            for s2 in (1.0, -1.0):
                v = [0.0, 0.0, 0.0]
                v[d] = s1 / np.sqrt(2.0)
                v[(d + 1) % 3] = s2 / np.sqrt(2.0)
                pts.append(v)
    return np.array(pts)


def _orbit_a3():
    """8 cube corners (+-1,+-1,+-1)/sqrt(3)."""
    pts = []
    for s1 in (1.0, -1.0):
        for s2 in (1.0, -1.0):
            for s3 in (1.0, -1.0):
                pts.append([s1, s2, s3])
    return np.array(pts) / np.sqrt(3.0)


def _orbit_b(l):
    """24 points (+-l, +-l, +-m) and permutations, m = sqrt(1-2l^2)."""
    m = np.sqrt(max(1.0 - 2.0 * l * l, 0.0))
    pts = []
    for perm in ((0, 1, 2), (0, 2, 1), (2, 0, 1)):
        for s1 in (1.0, -1.0):
            for s2 in (1.0, -1.0):
                for s3 in (1.0, -1.0):
                    v = np.array([l * s1, l * s2, m * s3])
                    pts.append(v[list(perm)])
    return np.array(pts)


def _orbit_c(p):
    """24 points (+-p, +-q, 0) and permutations, q = sqrt(1-p^2)."""
    q = np.sqrt(max(1.0 - p * p, 0.0))
    pts = []
    for (i, j) in ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1)):
        for s1 in (1.0, -1.0):
            for s2 in (1.0, -1.0):
                v = [0.0, 0.0, 0.0]
                v[i] = s1 * p
                v[j] = s2 * q
                pts.append(v)
    return np.array(pts)


def _lebedev_6():
    return _orbit_a1(), np.full(6, 1.0 / 6.0)


def _lebedev_14():
    pts = np.concatenate([_orbit_a1(), _orbit_a3()])
    w = np.concatenate([np.full(6, 1.0 / 15.0), np.full(8, 3.0 / 40.0)])
    return pts, w


def _lebedev_26():
    pts = np.concatenate([_orbit_a1(), _orbit_a2(), _orbit_a3()])
    w = np.concatenate(
        [np.full(6, 1.0 / 21.0), np.full(12, 4.0 / 105.0), np.full(8, 27.0 / 840.0)]
    )
    return pts, w


def _lebedev_38():
    pts = np.concatenate([_orbit_a1(), _orbit_a3(), _orbit_c(0.459700843380983)])
    w = np.concatenate(
        [np.full(6, 1.0 / 105.0), np.full(8, 9.0 / 280.0), np.full(24, 1.0 / 35.0)]
    )
    return pts, w


def _lebedev_50():
    pts = np.concatenate(
        [_orbit_a1(), _orbit_a2(), _orbit_a3(), _orbit_b(1.0 / np.sqrt(11.0))]
    )
    wb = (1.0 - (6 * 4.0 / 315.0 + 12 * 64.0 / 2835.0 + 8 * 27.0 / 1280.0)) / 24.0
    w = np.concatenate(
        [
            np.full(6, 4.0 / 315.0),
            np.full(12, 64.0 / 2835.0),
            np.full(8, 27.0 / 1280.0),
            np.full(24, wb),
        ]
    )
    return pts, w


_LEBEDEV = {6: _lebedev_6, 14: _lebedev_14, 26: _lebedev_26,
            38: _lebedev_38, 50: _lebedev_50}


def _orbit_d(r, s):
    """48 points: all sign/permutation images of (r, s, w), w=sqrt(1-r2-s2)."""
    import itertools

    w = np.sqrt(max(1.0 - r * r - s * s, 0.0))
    base = (r, s, w)
    pts = []
    for perm in itertools.permutations(range(3)):
        v = np.array([base[perm[0]], base[perm[1]], base[perm[2]]])
        for signs in itertools.product((1.0, -1.0), repeat=3):
            pts.append(v * np.array(signs))
    return np.array(pts)


_ORBIT_BUILDERS = {
    "a1": lambda: _orbit_a1(),
    "a2": lambda: _orbit_a2(),
    "a3": lambda: _orbit_a3(),
    "b": _orbit_b,
    "c": _orbit_c,
    "d": _orbit_d,
}


def _load_reconstructed():
    """Reconstructed Lebedev rules (tools/gen_lebedev.py) -> {order: fn}."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "lebedev.json")
    rules = {}
    if not os.path.exists(path):
        return rules
    with open(path) as fh:
        data = json.load(fh)
    for order_s, rule in data.items():
        def build(rule=rule):
            pts, w = [], []
            for orb in rule["orbits"]:
                p = _ORBIT_BUILDERS[orb["type"]](*orb["params"])
                pts.append(p)
                w.append(np.full(len(p), orb["weight"]))
            return np.concatenate(pts), np.concatenate(w)
        rules[int(order_s)] = build
    return rules


_LEBEDEV.update(_load_reconstructed())


def gauss_product_grid(n_target: int):
    """Gauss-Legendre (cos theta) x equispaced (phi) product grid with at
    least n_target points; exact for spherical harmonics of degree
    <= min(2*ntheta-1, nphi-1)."""
    ntheta = max(2, int(np.ceil(np.sqrt(n_target / 2.0))))
    nphi = 2 * ntheta
    while ntheta * nphi < n_target:
        ntheta += 1
        nphi = 2 * ntheta
    x, wx = np.polynomial.legendre.leggauss(ntheta)
    phi = 2.0 * np.pi * (np.arange(nphi) + 0.5) / nphi
    ct = x[:, None]
    st = np.sqrt(1.0 - ct**2)
    pts = np.stack(
        [
            (st * np.cos(phi)[None, :]).ravel(),
            (st * np.sin(phi)[None, :]).ravel(),
            np.broadcast_to(ct, (ntheta, nphi)).ravel(),
        ],
        axis=1,
    )
    w = np.broadcast_to((wx / 2.0)[:, None] / nphi, (ntheta, nphi)).ravel()
    return pts, w.copy()


def angular_grid(nang: int):
    """(points, weights) for a requested angular order.

    Exact Lebedev rule when `nang` matches a tabulated order; otherwise the
    Gauss-Legendre product grid with >= nang points.
    """
    if nang in _LEBEDEV:
        return _LEBEDEV[nang]()
    return gauss_product_grid(nang)
