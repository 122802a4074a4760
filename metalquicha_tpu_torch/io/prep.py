"""JSON -> .mqc preprocessor (the `mqc_prep` workflow).

Reads the user-facing JSON schema (molecules with xyz file or inline
geometry, fragments/charges/multiplicities, model, keywords, driver) and
emits the section-based `.mqc` text format. Format parity with the reference
emitters (upstream metalquicha utils/emitters.py behavior and mqc_prep.py:16-33),
re-implemented for this framework.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..errors import InputError

#: Solvents accepted by the xTB solvation models (superset of tblite's list).
def _known_solvents():
    """The driver-side dielectric lookup is the source of truth
    (solvation/__init__.py, mirroring mqc_method_xtb.f90:557-671)."""
    from ..methods.xtb.solvation import SOLVENT_DIELECTRICS

    return set(SOLVENT_DIELECTRICS) | {
        # names tblite's own parameter files accept for ALPB/GBSA
        "benzaldehyde", "furane", "dichloromethane", "dcm",
    }


KNOWN_SOLVENTS = _known_solvents()


def _fmt_float(x) -> str:
    """Compact float formatting (no trailing zeros) like the reference tool."""
    s = repr(float(x))
    if s.endswith(".0"):
        s = s[:-2]
    return s


class _Buf:
    def __init__(self):
        self.parts = []

    def write(self, s: str):
        self.parts.append(s)

    def text(self) -> str:
        return "".join(self.parts)


def _load_molecule_geometry(mol: dict, base_dir: str):
    """Return (symbols, coords) from an xyz path or inline arrays (Angstrom)."""
    if "xyz" in mol:
        path = mol["xyz"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        natoms = int(lines[0].split()[0])
        symbols, coords = [], []
        for raw in lines[2: 2 + natoms]:
            parts = raw.split()
            symbols.append(parts[0])
            coords.append((float(parts[1]), float(parts[2]), float(parts[3])))
        return symbols, coords
    if "symbols" in mol and "geometry" in mol:
        symbols = list(mol["symbols"])
        flat = [float(x) for x in mol["geometry"]]
        if len(flat) != 3 * len(symbols):
            raise InputError("inline geometry length != 3 * n(symbols)")
        coords = [tuple(flat[3 * i: 3 * i + 3]) for i in range(len(symbols))]
        return symbols, coords
    raise InputError("molecule needs either 'xyz' or 'symbols'+'geometry'")


def _emit_structure(buf: _Buf, mol: dict):
    buf.write("%structure\n")
    buf.write(f"charge = {int(mol.get('molecular_charge', 0))}\n")
    buf.write(f"multiplicity = {int(mol.get('molecular_multiplicity', 1))}\n")
    buf.write("end  ! structure\n\n")


def _emit_geometry(buf: _Buf, symbols, coords):
    buf.write("%geometry\n")
    buf.write(f"{len(symbols)}\n\n")
    for sym, (x, y, z) in zip(symbols, coords):
        buf.write(f"{sym} {_fmt_float(x)} {_fmt_float(y)} {_fmt_float(z)}\n")
    buf.write("end  ! geometry\n\n")


def _emit_fragments(buf: _Buf, mol: dict):
    frags = mol.get("fragments")
    if not frags:
        return
    charges = mol.get("fragment_charges", [0] * len(frags))
    mults = mol.get("fragment_multiplicities", [1] * len(frags))
    if len(charges) != len(frags) or len(mults) != len(frags):
        raise InputError("fragment charges/multiplicities length mismatch")
    buf.write("%fragments\n")
    buf.write(f"nfrag = {len(frags)}\n\n")
    for frag, q, m in zip(frags, charges, mults):
        buf.write("%fragment\n")
        buf.write(f"charge = {int(q)}\n")
        buf.write(f"multiplicity = {int(m)}\n")
        buf.write("%indices\n")
        buf.write(" ".join(str(int(i)) for i in frag) + "\n")
        buf.write("end  ! indices\n")
        buf.write("end  ! fragment\n\n")
    buf.write("end  ! fragments\n\n")


def _emit_connectivity(buf: _Buf, mol: dict):
    conn = mol.get("connectivity")
    if not conn:
        return
    bonds = conn.get("bonds", conn) if isinstance(conn, dict) else conn
    fragments = mol.get("fragments") or []

    def frag_sets_of(atom: int) -> frozenset:
        return frozenset(
            fi for fi, frag in enumerate(fragments) if atom in frag
        )

    buf.write("%connectivity\n")
    buf.write(f"nbonds = {len(bonds)}\n\n")
    nbroken = 0
    for bond in bonds:
        i, j = int(bond[0]), int(bond[1])
        order = int(bond[2]) if len(bond) > 2 else 1
        # a bond is broken when its endpoints belong to different fragment
        # sets — the capping trigger (matches the upstream prep semantics)
        if len(bond) > 3:
            is_broken = str(bond[3]).lower() in ("broken", "true", "1")
        else:
            is_broken = bool(fragments) and frag_sets_of(i) != frag_sets_of(j)
        if is_broken:
            nbroken += 1
            buf.write(f"{i} {j} {order} broken\n")
        else:
            buf.write(f"{i} {j} {order} preserved\n")
    buf.write(f"\nnbroken = {nbroken}\n")
    buf.write("end  ! connectivity\n\n")


def _emit_molecule_sections(buf: _Buf, mol: dict, base_dir: str):
    _emit_structure(buf, mol)
    symbols, coords = _load_molecule_geometry(mol, base_dir)
    _emit_geometry(buf, symbols, coords)
    _emit_fragments(buf, mol)
    _emit_connectivity(buf, mol)


def emit_mqc(data: dict, base_dir: str = ".") -> str:
    buf = _Buf()
    schema = data.get("schema", {})
    buf.write("%schema\n")
    buf.write(f"name = {schema.get('name', 'mqc-frag')}\n")
    buf.write(f"version = {schema.get('version', '1.0')}\n")
    buf.write(f"index_base = {int(schema.get('index_base', 0))}\n")
    buf.write(f"units = {schema.get('units', 'angstrom')}\n")
    buf.write("end  ! schema\n\n")

    model = data.get("model", {})
    buf.write("%model\n")
    buf.write(f"method = {model.get('method', 'XTB-GFN1')}\n")
    if model.get("basis"):
        buf.write(f"basis = {model['basis']}\n")
    if model.get("aux_basis"):
        buf.write(f"aux_basis = {model['aux_basis']}\n")
    buf.write("end  ! model\n\n")

    buf.write("%driver\n")
    buf.write(f"type = {data.get('driver', 'Energy')}\n")
    buf.write("end  ! driver\n\n")

    system = data.get("system", {})
    logger = system.get("logger", {})
    buf.write("%system\n")
    buf.write(f"log_level = {logger.get('level', 'Info')}\n")
    if system.get("skip_json_output"):
        buf.write("skip_json_output = true\n")
    buf.write("end  ! system\n\n")

    molecules = data.get("molecules", [])
    if not molecules:
        raise InputError("JSON input has no molecules")
    if len(molecules) == 1:
        _emit_molecule_sections(buf, molecules[0], base_dir)
    else:
        buf.write("%molecules\n")
        buf.write(f"nmol = {len(molecules)}\n\n")
        for mol in molecules:
            buf.write("%molecule\n")
            if mol.get("name"):
                buf.write(f"name = {mol['name']}\n")
            _emit_molecule_sections(buf, mol, base_dir)
            buf.write("end  ! molecule\n\n")
        buf.write("end  ! molecules\n\n")

    keywords = data.get("keywords", {})
    scf = keywords.get("scf")
    if scf:
        buf.write("%scf\n")
        buf.write(f"maxiter = {int(scf.get('maxiter', 100))}\n")
        buf.write(f"tolerance = {_fmt_float(scf.get('tolerance', 1e-6))}\n")
        buf.write("end  ! scf\n\n")

    xtb = keywords.get("xtb")
    if xtb:
        solvent = xtb.get("solvent")
        if solvent and solvent.lower() not in KNOWN_SOLVENTS:
            raise InputError(f"unknown solvent: {solvent!r}")
        buf.write("%xtb\n")
        for key in ("solvent", "solvation_model"):
            if xtb.get(key) is not None:
                buf.write(f"{key} = {xtb[key]}\n")
        if xtb.get("dielectric") is not None:
            buf.write(f"dielectric = {_fmt_float(xtb['dielectric'])}\n")
        if xtb.get("cpcm_nang") is not None:
            buf.write(f"cpcm_nang = {int(xtb['cpcm_nang'])}\n")
        if xtb.get("cpcm_rscale") is not None:
            buf.write(f"cpcm_rscale = {_fmt_float(xtb['cpcm_rscale'])}\n")
        for key in ("use_cds", "use_shift"):
            if xtb.get(key) is not None:
                buf.write(f"{key} = {str(bool(xtb[key])).lower()}\n")
        buf.write("end  ! xtb\n\n")

    hessian = keywords.get("hessian")
    if hessian:
        buf.write("%hessian\n")
        buf.write(
            "finite_difference_displacement = "
            f"{_fmt_float(hessian.get('finite_difference_displacement', 0.005))}\n"
        )
        buf.write(f"temperature = {_fmt_float(hessian.get('temperature', 298.15))}\n")
        buf.write(f"pressure = {_fmt_float(hessian.get('pressure', 1.0))}\n")
        buf.write("end  ! hessian\n\n")

    aimd = keywords.get("aimd")
    if aimd:
        buf.write("%aimd\n")
        buf.write(f"dt = {_fmt_float(aimd.get('dt', 1.0))}\n")
        buf.write(f"nsteps = {int(aimd.get('nsteps', 100))}\n")
        buf.write(
            "initial_temperature = "
            f"{_fmt_float(aimd.get('initial_temperature', 298.15))}\n"
        )
        buf.write(f"output_frequency = {int(aimd.get('output_frequency', 1))}\n")
        buf.write("end  ! aimd\n\n")

    frag = keywords.get("fragmentation")
    if frag:
        buf.write("%fragmentation\n")
        buf.write(f"method = {frag.get('method', 'MBE')}\n")
        buf.write(
            "allow_overlapping_fragments = "
            f"{str(bool(frag.get('allow_overlapping_fragments', False))).lower()}\n"
        )
        buf.write(f"level = {int(frag.get('level', 2))}\n")
        buf.write(f"embedding = {frag.get('embedding', 'none')}\n")
        buf.write(f"cutoff_method = {frag.get('cutoff_method', 'distance')}\n")
        buf.write(f"distance_metric = {frag.get('distance_metric', 'min')}\n")
        if frag.get("global_groups") is not None:
            buf.write(f"global_groups = {int(frag['global_groups'])}\n")
        if frag.get("nodes_per_group") is not None:
            buf.write(f"nodes_per_group = {int(frag['nodes_per_group'])}\n")
        if frag.get("max_intersection_level") is not None:
            buf.write(
                f"max_intersection_level = {int(frag['max_intersection_level'])}\n"
            )
        cutoffs = frag.get("cutoffs")
        if cutoffs:
            buf.write("\n%cutoffs\n")
            for lvl in sorted(int(k) for k in cutoffs):
                buf.write(f"{lvl} = {_fmt_float(cutoffs[str(lvl)] if str(lvl) in cutoffs else cutoffs[lvl])}\n")
            buf.write("end  ! cutoffs\n")
        buf.write("end  ! fragmentation\n\n")

    return buf.text()


def prep_file(json_path: str, out_path: Optional[str] = None) -> str:
    """Convert a JSON input file to .mqc; returns the output path."""
    with open(json_path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    base_dir = os.path.dirname(os.path.abspath(json_path))
    text = emit_mqc(data, base_dir=base_dir)
    if out_path is None:
        out_path = os.path.splitext(json_path)[0] + ".mqc"
    with open(out_path, "w", encoding="utf-8") as fh:
        fh.write(text)
    return out_path


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="mqc-prep", description="Convert JSON input to .mqc format"
    )
    ap.add_argument("json_file")
    args = ap.parse_args(argv)
    out = prep_file(args.json_file)
    with open(out, "r", encoding="utf-8") as fh:
        text = fh.read()
    print(f"Generated: {out}")
    print(f"  Lines: {text.count(chr(10))}")
    print(f"  Size: {len(text.encode())} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
