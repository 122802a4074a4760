"""graph_miss_share (%): the share of the window's SCC loop solves and
calculator stage calls that did not replay a cached CUDA graph (a miss
that captured one, or a run launch by launch), from the deltas of the
program's counters `methods/xtb/scc_graph.stats` over the window. A miss
re-captures (0.07-0.66 s a capture), so it shows in `p90_step_s`."""


def read(run):
    c = run.counters
    missed = (c["misses"] + c["stage_captures"] + c["eager"]
              + c["stage_eager"])
    calls = missed + c["hits"] + c["stage_hits"]
    return 100.0 * missed / calls if calls else None
