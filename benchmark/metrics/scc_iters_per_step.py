"""scc_iters_per_step (iter/step): SCC loop iterations a step, summed over
its batches (every fragment of a batch iterates until the last stops).

Counted by the program's launch tally of the fused Fermi fill and density
(`ops/fermi_fill.density_launches`, replays of captured graphs counted by
`ops/replay_counts`): one launch per iteration of a batch's loop, and
nowhere else on the energies path, for batches of at most 64 AOs (the
kernel's `DENSITY_MAX_N`, copied here). The loop's graph replays
(`scc_graph.stats["replays"]`) are not used: they count the stages'
replays too. Nothing is returned where a batch is wider."""

#: the fused kernel's widest batch (ops/fermi_fill.py DENSITY_MAX_N)
DENSITY_MAX_N = 64


def read(run):
    if any(ch["nao"] > DENSITY_MAX_N for ch in run.chunks) or not run.steps:
        return None
    return run.counters["density_launches"] / run.steps
