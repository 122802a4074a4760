"""Stand-ins for torch.cuda's streams and graphs, so that the SCC graph
cache (`methods/xtb/scc_graph.py`) runs its control flow on the CPU.

A capture runs the step once, its launch counts going to the capture's
tally as under a real capture; that run is the work of the graph's next
replay. Every other replay runs the step again without counting, as a
replay launches with no Python involved: a hit's replays rerun the cached
step on the entry's buffers.
"""

import collections
import contextlib
import threading

import pytest
import torch

from metalquicha_tpu_torch.methods.xtb import scc_graph
from metalquicha_tpu_torch.ops import replay_counts


class Stream:
    cuda_stream = 77
    device_index = 0
    device = None

    def __init__(self, *_args):
        pass

    def wait_stream(self, _other):
        pass


class Graph:
    """torch.cuda.CUDAGraph's stand-in (see the module's docstring)."""

    def __init__(self):
        self.step = None
        self.shared = None
        self.pending = False
        self.replays = 0

    def pool(self):
        return id(self)

    def replay(self):
        self.replays += 1
        if self.pending:
            self.pending = False
            return
        with replay_counts.capturing():
            self.step()


def fake_capture(graph, step, pool=None):
    graph.step, graph.shared, graph.pending = step, pool, True
    step()
    return 0.0


@pytest.fixture
def no_card(monkeypatch):
    """torch.cuda's streams and graphs replaced by stand-ins, and an empty
    cache of graphs."""
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda _s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(scc_graph, "_capture", fake_capture)
    monkeypatch.setattr(scc_graph, "_side_streams", {})
    monkeypatch.setattr(scc_graph, "_entries", type(scc_graph._entries)())
    monkeypatch.setattr(scc_graph, "_pools", {})
    monkeypatch.setattr(scc_graph, "stats", dict(scc_graph.stats))
    monkeypatch.setattr(scc_graph, "reuse", collections.Counter())
    monkeypatch.setattr(scc_graph, "_recent", collections.OrderedDict())
    # the fixture's thread may be new: no entry of another test's matches
    monkeypatch.setattr(threading, "get_ident", lambda: 1)
