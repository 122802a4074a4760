"""Launch counts under CUDA graph capture and replay.

Each wrapper of `ops/` counts its launches on the host, where it makes
them (`fermi_fill`, `jacobi_eigh`, `batched_eigh`; `sp2` its calls).
Under stream capture nothing launches: the launch is recorded into the
graph, and every replay of the graph launches it again with no Python
involved. So while a thread captures (`capturing`), each wrapper hands
its count to that capture's `Tally` (`record`) instead of adding it, and
each replay adds the tally (`Tally.replayed`). A launch made on the
captured stream from another thread (autograd runs a backward pass on a
device thread of its own) reaches the tally through its stream.
"""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()
#: stream handle -> the tally of the capture on that stream
_by_stream: dict = {}


class Tally:
    """The counts one capture recorded: (count function, its arguments) ->
    launches per replay."""

    def __init__(self):
        self.counts = collections.Counter()

    def replayed(self, stream: int) -> None:
        """Add one replay's launches, made on `stream`."""
        for (add, args), n in self.counts.items():
            add(stream, n, *args)


@contextlib.contextmanager
def capturing(stream: int = None):
    """Within the block, this thread's wrapper counts go to the yielded
    Tally instead of the module counters, and so do those of launches on
    `stream` (the captured stream's handle, where given) from any
    thread."""
    prev = getattr(_local, "tally", None)
    tally = _local.tally = Tally()
    if stream is not None:
        _by_stream[stream] = tally
    try:
        yield tally
    finally:
        _local.tally = prev
        if stream is not None:
            _by_stream.pop(stream, None)


def record(add, *args, stream: int = None) -> bool:
    """If this thread is capturing, or `stream` (the launch's stream
    handle, where given) is being captured, note one launch that each
    replay makes (`add(stream, n, *args)` adds n of them) and return True;
    else False: the caller counts its launch itself."""
    tally = getattr(_local, "tally", None)
    if tally is None and stream is not None:
        tally = _by_stream.get(stream)
    if tally is None:
        return False
    tally.counts[(add, args)] += 1
    return True
