"""Stand-ins for torch.cuda's streams and graphs, so that the SCC graph
cache (`methods/xtb/scc_graph.py`) runs its control flow on the CPU.

A capture runs the step once, its launch counts going to the capture's
tally as under a real capture; that run is the work of the graph's next
replay. Every other replay runs the step again without counting, as a
replay launches with no Python involved: a hit's replays rerun the cached
step on the entry's buffers.

`staged` also sends a calculator's calls (`scc_graph.Call`) through the
cache on the CPU: their stages and their SCC loop.
"""

import collections
import contextlib
import itertools
import threading

import pytest
import torch

from metalquicha_tpu_torch.methods.xtb import engine as te
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


_serials = itertools.count(1)


class Graph:
    """torch.cuda.CUDAGraph's stand-in (see the module's docstring)."""

    def __init__(self):
        self.step = None
        self.shared = None
        self.pending = False
        self.replays = 0
        # a serial, not id(self): a freed graph's id is reused
        self.serial = next(_serials)

    def pool(self):
        return self.serial

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


class _CpuCall(scc_graph.Call):
    """A call that takes the graph route off a card (the stand-ins)."""

    def __init__(self, device, graph=True):
        super().__init__(device, graph)
        self.on_card = True
        self.graph = graph


def _loop_cached(make_fixed_point, inputs, x0, settings, key, graph=True):
    """`engine._anderson_solve`'s card branch for CPU tensors (graph=False
    the eager loop); the status is read in the call's `finish`."""
    build = (lambda inp: te._SccLoop(make_fixed_point, inp, x0, settings))
    if graph:
        loop = scc_graph.solve((key, settings), inputs, x0, build,
                               settings.max_scf_iter)
    else:
        loop = build(inputs)
        for it in range(settings.max_scf_iter):
            if loop.done(it):
                break
            loop.step()
    scc_graph.current_call().defer(loop.status)
    return loop.state.x.clone(), loop.state.resid.clone()


@pytest.fixture
def staged(monkeypatch, no_card):
    """Every call's stages and loop through the cache with the stand-ins;
    yields a one-element list of the SCC steps taken so far."""
    steps = [0]
    real = te._anderson_step

    def counted(*args):
        steps[0] += 1
        return real(*args)

    real_capture = scc_graph._capture_stage

    def capture_stage(*args):
        # the stand-in's capture runs the stage, as a replay would; a
        # stage's capture comes after its call's results, and its next
        # replay is the next hit's
        real_capture(*args)
        args[1].graph.pending = False

    monkeypatch.setattr(scc_graph, "Call", _CpuCall)
    monkeypatch.setattr(scc_graph, "_capture_stage", capture_stage)
    monkeypatch.setattr(te, "_anderson_solve", _loop_cached)
    monkeypatch.setattr(te, "_anderson_step", counted)
    return steps
