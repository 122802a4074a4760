"""The control on the card, at each cell's own size: the program's float32
path fails the check's limits on every seed where the program as
configured (float64) passes them. Skips without a card."""

import pytest
import torch

from benchmark.harness import spec

SEEDS = [3300000001, 3300000002, 3300000003]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["w20-gfn1.mbe4-energy",
                                  "w20-gfn1.mbe3-gradient"])
def test_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import control
    from benchmark.harness import env

    env.prepare()
    cell = spec.load_cell(name)
    lim = {k: v["limit"] for k, v in cell.limits.items()}
    for dtype, passes in ((None, True), ("f32", False)):
        for seed, r in control.readings(cell, SEEDS, dtype).items():
            within = all(r[k] <= lim[k] for k in lim) and r["failed"] == 0
            assert within == passes, (dtype, seed, r)
