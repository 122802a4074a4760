"""A cell of the benchmark cut to a size the CPU holds: the first waters of
the isomer at MBE(2), written as an upstream input of their own."""

from __future__ import annotations

import json
import os

from benchmark.harness import spec


#: limits for a gradient cell at this size (Ha/Bohr): the program's SCC
#: stop at 1e-7 enters a gradient linearly
GRADIENT_LIMITS = {"frag_grad_gap": {"limit": 1e-6},
                   "total_grad_gap": {"limit": 1e-5}}


def small_cell(tmp_path, name="w20-gfn1.mbe4-energy", waters=6,
               method=None, sigma=None, driver="energy"):
    """The cell `name` with its input cut to `waters` waters and its
    traffic to their MBE(2); `method` switches the input's method and
    `driver` the traffic's."""
    cell = spec.load_cell(name)
    src = os.path.join(spec.ROOT, cell.config["input"])
    with open(src, encoding="utf-8") as fh:
        data = json.load(fh)
    xyz = os.path.join(os.path.dirname(src), data["molecules"][0]["xyz"])
    with open(xyz, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    (tmp_path / "w.xyz").write_text(
        "\n".join([str(3 * waters), lines[1]] + lines[2:2 + 3 * waters])
        + "\n")
    mol = data["molecules"][0]
    mol["xyz"] = "w.xyz"
    for key in ("fragments", "fragment_charges", "fragment_multiplicities"):
        mol[key] = mol[key][:waters]
    if method:
        data["model"]["method"] = method
    (tmp_path / "w.json").write_text(json.dumps(data))
    traffic = dict(cell.traffic, level=2, driver=driver,
                   batches=[[1, waters], [2, waters * (waters - 1) // 2]],
                   ref_block=8)
    if sigma is not None:
        traffic["sigma_bohr"] = sigma
    config = dict(cell.config, input=str(tmp_path / "w.json"))
    limits = dict(cell.limits)
    if driver == "gradient":
        limits.update(GRADIENT_LIMITS)
    return cell._replace(config=config, traffic=traffic, limits=limits)
