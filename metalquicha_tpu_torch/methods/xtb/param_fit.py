"""Differentiable parameterization: xTB energies as functions of the
parameter vector theta.

Counterpart of metalquicha_tpu's `methods/xtb/param_fit.py`. The engine's
variational energy functional is stationary in the converged charges, so
one backward pass through it gives EXACT parameter derivatives
d(energy)/d(theta): the machinery used to reconstruct the GFN1/GFN2
element tables against reference energies (inverse parameterization), and
generally useful for refitting xTB to new data.

theta is a nested dict of float64 tensors on one explicit device:
`elements[z]` (per fitted element: levels (eV), slater, kcn (eV), shpoly,
gam, lgam, gam3, alpha, zeff, en, e0, aes, rad, rcov, r4r2), `d3_pairs`,
`kpair` and `globals`. `theta_leaves` lists its tensors in
`ravel_pytree`'s order and `theta_map` applies a function to each, which
is all of a pytree that a fit needs: mark the leaves `requires_grad_`,
build the loss and take `torch.autograd.grad(loss, theta_leaves(theta))`.

Structure arrays (masks, indices, refocc, D3 reference grids) stay fixed
from the host-side batch (`batch.build_batch`); theta-dependent arrays are
rebuilt with VECTORIZED gathers from small per-(element, shell) tables so
the recorded graph stays small even for 70+ atom fragments. The engine is batch-first,
so where the JAX package vmaps one rebuilt fragment over a batch of
coordinates, `FragmentSpec.rebuild(theta, coords)` returns the fragment
broadcast (views, no copies) along the leading axis of `coords`.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from ...constants import BOHR_TO_ANGSTROM
from . import dispersion_d3, params_gfn1
from .basis import CARTESIAN_COMPONENTS, STO_NG
from .batch import GLB_FIELDS, build_batch, element_basis, global_vector
from .calculator import FragmentData, check_device, fragment_data_from_batch
from .params_gfn1 import EV2AU

FITTED_Z = (1, 6, 7, 8)
_Z_INDEX = {z: i for i, z in enumerate(FITTED_Z)}
MAX_SHELLS = 2

#: padding values of the per-atom AES block (mrad, dkernel, qkernel, d4ga,
#: d4zref), as `batch.build_batch` pads it
_AES_PAD = (3.0, 1.0, 0.1, 3.0, 4.0)


def _params_module(variant: str):
    if variant == "gfn2":
        from . import params_gfn2

        return params_gfn2
    return params_gfn1


def theta_map(fn, theta: dict, *rest) -> dict:
    """A theta of the same layout with fn applied to each tensor (and to
    the tensors at the same place in the other thetas)."""
    if isinstance(theta, dict):
        return {k: theta_map(fn, v, *(r[k] for r in rest))
                for k, v in theta.items()}
    return fn(theta, *rest)


def theta_leaves(theta: dict) -> list:
    """The tensors of theta, depth first in sorted key order (element keys
    by ascending Z): the order of `jax.flatten_util.ravel_pytree` on the
    JAX package's theta."""
    if isinstance(theta, dict):
        return [leaf for k in sorted(theta)
                for leaf in theta_leaves(theta[k])]
    return [theta]


def theta_init(variant: str = "gfn1", device="cuda") -> dict:
    """Current parameter tables as a theta dict on `device`.

    Includes the uncertain tabulated data (electronegativity, H0 polynomial
    radii, CN covalent radii, D3 r4r2 and reference pair C6) so the
    inverse parameterization can absorb table-reconstruction error.
    """
    device = check_device(device)

    def f64(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), device=device)

    # GFN2 thetas seed from the pristine dispersion state: the overlaid
    # values are GFN1 fit state (see dispersion_d3.build_d3_tables).
    r4r2_src = (dispersion_d3.R4R2 if variant != "gfn2"
                else dispersion_d3.PRISTINE_R4R2)
    params = _params_module(variant)
    theta = {"elements": {}}
    for z in FITTED_Z:
        rec = params.get_element(z)
        eb = element_basis(z, variant)
        theta["elements"][z] = {
            "levels": f64(rec.levels),
            "slater": f64(rec.slater),
            "kcn": f64(rec.kcn),
            "shpoly": f64(rec.shpoly),
            "lgam": f64(rec.lgam),
            "gam": f64(rec.gam),
            "gam3": f64(rec.gam3),
            "alpha": f64(rec.alpha),
            "zeff": f64(rec.zeff),
            "en": f64(rec.en),
            "e0": f64(getattr(rec, "e0", 0.0)),
            "aes": f64(
                [getattr(rec, "mrad", 3.0), getattr(rec, "dkernel", 1.0),
                 getattr(rec, "qkernel", 0.1), getattr(rec, "d4ga", 3.0),
                 getattr(rec, "d4zref", 4.0)]),
            "rad": f64(eb.rad_bohr),
            "rcov": f64(eb.rcov_bohr),
            "r4r2": f64(r4r2_src[z]),
        }
    # D3 reference PAIR C6 grids over the fitted elements (the dominant
    # parameter-table unknown: geometric-mean seeds refined by the fit).
    # GFN2 thetas seed from the PRISTINE table: the fitted grids are
    # GFN1 state (see dispersion_d3.full_pair_table).
    full = dispersion_d3.full_pair_table(fitted=(variant != "gfn2"))
    gidx = np.array([dispersion_d3._Z_TO_IDX[z] for z in FITTED_Z])
    theta["d3_pairs"] = f64(full[np.ix_(gidx, gidx)])
    # element-pair H0 scaling K_AB over the fitted elements (tblite gfn1
    # kpair analog; identity by default)
    nz = len(FITTED_Z)
    kp = np.ones((nz, nz))
    if hasattr(params, "kpair_value"):
        for i, zi in enumerate(FITTED_Z):
            for j, zj in enumerate(FITTED_Z):
                kp[i, j] = params.kpair_value(zi, zj)
    theta["kpair"] = f64(kp)
    # global constants (kss..disp_rs9) ride FragmentData.glb
    theta["globals"] = f64(global_vector(variant))
    return theta


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def theta_to_tables(theta: dict, variant: str = "gfn1") -> None:
    """Write theta values back into the port's parameter modules
    (host-side): `params_gfn1` / `params_gfn2`, `dispersion_d3`, and the
    `batch.element_basis` cache.

    NOTE: en/rad/rcov/r4r2/d3_pairs are applied to the shared radii/D3
    tables (variant-global)."""
    params = _params_module(variant)
    for z in FITTED_Z:
        el = theta["elements"][z]
        if "rad" in el:
            params.ATOMIC_RADII_A[z] = float(el["rad"]) * BOHR_TO_ANGSTROM
        if "rcov" in el:
            params.COVALENT_RADII_A[z] = float(el["rcov"]) * BOHR_TO_ANGSTROM
        if "r4r2" in el and variant != "gfn2":
            # the shared R4R2 / pair-override tables are GFN1 state; a GFN2
            # fit must not clobber them (GFN2 reads the pristine snapshots)
            dispersion_d3.R4R2[z] = float(el["r4r2"])
        if "en" in el:
            object.__setattr__(params.ELEMENTS[z], "en", float(el["en"]))
    if "d3_pairs" in theta and variant != "gfn2":
        pairs = _np(theta["d3_pairs"])
        pairs = 0.5 * (pairs + pairs.transpose(1, 0, 3, 2))
        overlay = {}
        for i, zi in enumerate(FITTED_Z):
            for j, zj in enumerate(FITTED_Z):
                if zi > zj:
                    continue
                ni = len(dispersion_d3.REF_CN[zi])
                nj = len(dispersion_d3.REF_CN[zj])
                overlay[f"{zi}-{zj}"] = pairs[i, j, :ni, :nj].tolist()
        dispersion_d3.set_pair_table_overlay(overlay)
    dispersion_d3.invalidate_caches()
    element_basis.cache_clear()
    for z in FITTED_Z:
        rec = params.ELEMENTS[z]
        el = theta["elements"][z]
        for name in ("levels", "slater", "kcn", "shpoly", "lgam"):
            object.__setattr__(rec, name, tuple(_np(el[name])))
        for name in ("gam", "gam3", "alpha", "zeff"):
            object.__setattr__(rec, name, float(el[name]))
        if "e0" in el:
            object.__setattr__(rec, "e0", float(el["e0"]))
        if "aes" in el:
            aes = _np(el["aes"])
            for k, name in enumerate(
                ("mrad", "dkernel", "qkernel", "d4ga", "d4zref")
            ):
                object.__setattr__(rec, name, float(aes[k]))
    if "globals" in theta:
        gvec = _np(theta["globals"])
        for k, name in enumerate(GLB_FIELDS):
            setattr(params.GLOBALS, name, float(gvec[k]))


def theta_from_overlay(path: str, variant: str = "gfn1",
                       device="cuda") -> dict:
    """Load a fitted theta from a fit tool's JSON output."""
    with open(path) as fh:
        data = json.load(fh)
    theta = theta_init(variant, device)
    device = theta["globals"].device

    def f64(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), device=device)

    for z_str, el in data.get("elements", {}).items():
        z = int(z_str)
        if z not in theta["elements"]:
            continue
        for k, v in el.items():
            if k == "d3_c6":  # legacy diagonal-only field: superseded
                continue
            theta["elements"][z][k] = f64(v)
    if "d3_pairs" in data:
        theta["d3_pairs"] = f64(data["d3_pairs"])
    if "kpair" in data and "kpair" in theta:
        kp = _np(theta["kpair"]).copy()
        for key_str, val in data["kpair"].items():
            zi, zj = (int(t) for t in key_str.split("-"))
            if zi in _Z_INDEX and zj in _Z_INDEX:
                kp[_Z_INDEX[zi], _Z_INDEX[zj]] = float(val)
                kp[_Z_INDEX[zj], _Z_INDEX[zi]] = float(val)
        theta["kpair"] = f64(kp)
    if "globals" in data and "globals" in theta:
        # without this, fitted global constants (kss/ksp/.../disp_*) would
        # be replaced by the params-module values whenever a fit is seeded
        # from another fit's output: a lossy warm start
        vec = _np(theta["globals"]).copy()
        for k, name in enumerate(GLB_FIELDS):
            if name in data["globals"]:
                vec[k] = float(data["globals"][name])
        theta["globals"] = f64(vec)
    return theta


# ---------------------------------------------------------------------------
# torch basis rebuild (differentiable in the slater exponents)
# ---------------------------------------------------------------------------


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def _pair_overlap(alphas_a, alphas_b, l: int):
    return (
        2.0
        * torch.sqrt(alphas_a[:, None] * alphas_b[None, :])
        / (alphas_a[:, None] + alphas_b[None, :])
    ) ** (l + 1.5)


def _self_overlap(alphas, coeffs, l: int):
    return coeffs @ _pair_overlap(alphas, alphas, l) @ coeffs


def _cgto_from_zeta(ngauss: int, n: int, l: int, zeta):
    a_tab, c_tab = STO_NG[(ngauss, n, l)]
    a_tab = torch.tensor(a_tab, dtype=zeta.dtype, device=zeta.device)
    c_tab = torch.tensor(c_tab, dtype=zeta.dtype, device=zeta.device)
    alphas = a_tab * zeta * zeta
    return alphas, c_tab / torch.sqrt(_self_overlap(alphas, c_tab, l))


def _ortho(alphas_v, coeffs_v, alphas_p, coeffs_p, l: int):
    ovlp = coeffs_v @ _pair_overlap(alphas_v, alphas_p, l) @ coeffs_p
    alphas = torch.cat([alphas_p, alphas_v])
    coeffs = torch.cat([coeffs_p, -ovlp * coeffs_v])
    return alphas, coeffs / torch.sqrt(_self_overlap(alphas, coeffs, l))


def _element_shell_tables(theta, variant: str, nprim: int, needed_z=None):
    """Small per-(element, shell) tables rebuilt from theta.

    Returns a dict of tensors indexed by flat (z_idx * MAX_SHELLS + slot):
    level, kcn, shpoly, eta (Hartree), prim_alpha (nprim), prim_coeff
    (nprim, radial part; cartesian norms applied per AO later), plus
    per-element gam3/alpha/zeff/... tables indexed by z_idx.
    """
    params = _params_module(variant)
    like = theta["globals"]

    def const(x):
        return torch.tensor(x, dtype=torch.float64, device=like.device)

    rows = len(FITTED_Z) * MAX_SHELLS
    level = [const(100.0)] * rows
    kcn = [const(0.0)] * rows
    shpoly = [const(0.0)] * rows
    eta = [const(1.0)] * rows
    pa = [like.new_zeros(nprim)] * rows
    pc = [like.new_zeros(nprim)] * rows

    for z in FITTED_Z:
        if needed_z is not None and z not in needed_z:
            continue  # element absent from this fragment (and its nprim
            # budget may be too small for e.g. H's orthogonalized 2s)
        el = theta["elements"][z]
        rec = params.get_element(z)
        shells = []
        for si, shell in enumerate(rec.shells):
            n, l = params.shell_n_l(shell)
            a, c = _cgto_from_zeta(rec.ngauss[si], n, l, el["slater"][si])
            shells.append([a, c, l])
        for i in range(len(shells)):
            for j in range(i + 1, len(shells)):
                if shells[i][2] == shells[j][2]:
                    shells[j][0], shells[j][1] = _ortho(
                        shells[i][0], shells[i][1],
                        shells[j][0], shells[j][1], shells[i][2],
                    )
        for si in range(len(rec.shells)):
            row = _Z_INDEX[z] * MAX_SHELLS + si
            level[row] = el["levels"][si] * EV2AU
            kcn[row] = el["kcn"][si] * EV2AU
            shpoly[row] = el["shpoly"][si]
            eta[row] = el["gam"] * el["lgam"][si]
            a, c = shells[si][0], shells[si][1]
            pa[row] = torch.cat([a, a.new_zeros(nprim - a.shape[0])])
            pc[row] = torch.cat([c, c.new_zeros(nprim - c.shape[0])])

    def atvec(key):
        return torch.stack([theta["elements"][z][key] for z in FITTED_Z])

    return {
        "level": torch.stack(level),
        "kcn": torch.stack(kcn),
        "shpoly": torch.stack(shpoly),
        "eta": torch.stack(eta),
        "prim_alpha": torch.stack(pa),
        "prim_coeff": torch.stack(pc),
        "gam3": atvec("gam3"),
        "alpha": atvec("alpha"),
        "zeff": atvec("zeff"),
        "en": atvec("en"),
        "e0": atvec("e0"),
        "aes": atvec("aes"),
        "rad": atvec("rad"),
        "rcov": atvec("rcov"),
        "r4r2": atvec("r4r2"),
    }


class FragmentSpec:
    """Static structure of one fragment + a theta -> FragmentData
    map, on one device.

    Coordinates are NOT baked in: energies are evaluated at
    `rebuild(theta, coords)`, so geometries sharing (numbers, charge, mult)
    go through the engine as one batch.
    """

    def __init__(self, numbers, coords, charge, mult, variant="gfn1",
                 pad_to=None, device="cuda"):
        self.numbers = np.asarray(numbers, dtype=np.int64)
        self.variant = variant
        self.device = check_device(device)
        #: `batch.build_batch`'s batch of this one fragment (leading axis 1)
        self.base = fragment_data_from_batch(
            build_batch([(self.numbers, coords, charge, mult)],
                        variant=variant, pad_to=pad_to),
            self.device, torch.float64, variant=variant,
        )
        params = _params_module(variant)

        nsh = self.base.sh_mask.shape[1]
        nao = self.base.ao_mask.shape[1]
        nat = self.base.atom_mask.shape[1]
        self.nprim = int(self.base.prim_alpha.shape[2])

        # static gather indices: shell -> (z_idx * MAX_SHELLS + slot)
        sh_row = np.zeros(nsh, dtype=np.int64)
        ao_row = np.zeros(nao, dtype=np.int64)
        ao_l = np.zeros(nao, dtype=np.int64)
        ao_df = np.ones(nao)
        at_row = np.zeros(nat, dtype=np.int64)
        isx = iao = 0
        for ia, z in enumerate(self.numbers):
            rec = params.get_element(int(z))
            at_row[ia] = _Z_INDEX[int(z)]
            for si, shell in enumerate(rec.shells):
                _n, l = params.shell_n_l(shell)
                sh_row[isx] = _Z_INDEX[int(z)] * MAX_SHELLS + si
                for lxyz in CARTESIAN_COMPONENTS[l]:
                    ao_row[iao] = sh_row[isx]
                    ao_l[iao] = l
                    ao_df[iao] = (
                        _double_factorial(2 * lxyz[0] - 1)
                        * _double_factorial(2 * lxyz[1] - 1)
                        * _double_factorial(2 * lxyz[2] - 1)
                    )
                    iao += 1
                isx += 1
        self.n_real_sh = isx
        self.n_real_ao = iao
        self.n_real_at = len(self.numbers)
        self.sh_row = torch.tensor(sh_row, device=self.device)
        self.ao_row = torch.tensor(ao_row, device=self.device)
        self.ao_l = torch.tensor(ao_l, device=self.device)
        self.ao_df = torch.tensor(ao_df, device=self.device)
        self.at_row = torch.tensor(at_row, device=self.device)
        self._gidx = torch.tensor(
            [dispersion_d3._Z_TO_IDX[z] for z in FITTED_Z],
            device=self.device)

    def rebuild(self, theta, coords=None) -> FragmentData:
        """The fragment with every theta-dependent field rebuilt from
        theta (differentiably).

        coords: optional (B, n, 3) tensor of geometries of this fragment
        (n its real or its padded atom count; padded atoms keep their
        parking positions). The result then has leading axis B, every
        other field a broadcast view; without it the leading axis is 1 and
        the coordinates are the ones the spec was built with."""
        base = self.base
        tabs = _element_shell_tables(
            theta, self.variant, self.nprim,
            needed_z=set(int(z) for z in self.numbers),
        )
        sh_real = base.sh_mask[0] > 0.5
        at_real = base.atom_mask[0] > 0.5

        sh_level = torch.where(sh_real, tabs["level"][self.sh_row], 100.0)
        sh_kcn = torch.where(sh_real, tabs["kcn"][self.sh_row], 0.0)
        sh_poly = torch.where(sh_real, tabs["shpoly"][self.sh_row], 0.0)
        sh_eta = torch.where(sh_real, tabs["eta"][self.sh_row], 1.0)

        # (nao, nprim) primitive tables with per-AO cartesian norms
        a = tabs["prim_alpha"][self.ao_row]
        c = tabs["prim_coeff"][self.ao_row]
        l = self.ao_l[:, None].to(a.dtype)
        norm = (
            (2.0 * a / math.pi) ** 0.75
            * (4.0 * a) ** (l / 2.0)
            / torch.sqrt(self.ao_df)[:, None]
        )
        mask_ao = (base.ao_mask[0] > 0.5)[:, None] & (a > 0)
        prim_alpha = torch.where(mask_ao, a, 0.0)
        prim_coeff = torch.where(mask_ao, c * norm, 0.0)

        def at(key, pad):
            return torch.where(at_real, tabs[key][self.at_row], pad)

        at_aes = torch.where(
            at_real[:, None], tabs["aes"][self.at_row],
            torch.tensor(_AES_PAD, dtype=a.dtype, device=a.device),
        )

        if "kpair" in theta:
            kth = 0.5 * (theta["kpair"] + theta["kpair"].T)
            kp_at = kth[self.at_row[:, None], self.at_row[None, :]]
            at_kpair = torch.where(
                at_real[:, None] & at_real[None, :], kp_at, 1.0)
        else:
            at_kpair = base.at_kpair[0]

        # D3 pair C6 table: global geometric-mean table with the fitted
        # element block substituted (symmetrized in the fit parameters),
        # out of place: the table the batches share is left as it is
        pairs = theta["d3_pairs"]
        pairs = 0.5 * (pairs + pairs.permute(1, 0, 3, 2))
        table = torch.tensor(
            dispersion_d3.full_pair_table(fitted=(self.variant != "gfn2")),
            dtype=pairs.dtype, device=pairs.device,
        )
        table = table.index_put(
            (self._gidx[:, None], self._gidx[None, :]), pairs)

        fields = dict(
            glb=theta["globals"] if "globals" in theta else base.glb[0],
            d3_c6_pair=table,
            sh_level=sh_level,
            sh_kcn=sh_kcn,
            sh_poly=sh_poly,
            sh_eta=sh_eta,
            prim_alpha=prim_alpha,
            prim_coeff=prim_coeff,
            at_gam3=at("gam3", 0.0),
            at_alpha=at("alpha", 1.0),
            at_zeff=at("zeff", 0.0),
            at_en=at("en", 0.0),
            at_e0=at("e0", 0.0),
            at_aes=at_aes,
            at_rad=at("rad", 1.0),
            at_rcov=at("rcov", 0.0),
            at_kpair=at_kpair,
            d3_r4r2=at("r4r2", 0.0),
        )
        frag = base._replace(**{k: v[None] for k, v in fields.items()})
        if coords is None:
            return frag
        bsz, n = coords.shape[0], coords.shape[1]
        if n < base.coords.shape[1]:
            coords = torch.cat(
                [coords, base.coords[:, n:].expand(bsz, -1, -1)], 1)
        frag = FragmentData(*(x.expand(bsz, *x.shape[1:]) for x in frag))
        return frag._replace(coords=coords)
