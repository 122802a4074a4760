"""Launch counts under CUDA graph capture and replay.

Each wrapper of `ops/` counts its launches on the host, where it makes
them (`fermi_fill`, `jacobi_eigh`, `batched_eigh`; `sp2` its calls).
Under stream capture nothing launches: the launch is recorded into the
graph, and every replay of the graph launches it again with no Python
involved. So while a thread captures (`capturing`), each wrapper hands
its count to that capture's `Tally` (`record`) instead of adding it, and
each replay adds the tally (`Tally.replayed`).
"""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()


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
def capturing():
    """Within the block, this thread's wrapper counts go to the yielded
    Tally instead of the module counters."""
    prev = getattr(_local, "tally", None)
    tally = _local.tally = Tally()
    try:
        yield tally
    finally:
        _local.tally = prev


def record(add, *args) -> bool:
    """If this thread is capturing, note one launch that each replay makes
    (`add(stream, n, *args)` adds n of them) and return True; else False:
    the caller counts its launch itself."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        return False
    tally.counts[(add, args)] += 1
    return True
