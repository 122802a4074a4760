"""What a `torch.profiler` trace of the window says: the device's busy time,
its idle gaps and what the host was doing in each, and the time of each
kernel by name.

The profiler records the CPU (the harness's own spans, `record_function`)
and the device (CUPTI: kernels, copies and sets, those a CUDA graph replays
among them) on one clock; the harness exports it as a Chrome trace and
reads it here. Busy time is the union of the device's intervals; the idle
share is the rest of the traced window, the span from the first traced
step's start to the last's end (as `tools/scc_probe_torch.py` takes busy
and idle time from the profiler).
"""

from __future__ import annotations

import collections
import json
from typing import NamedTuple

#: the trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness's spans in the trace
SPAN_CAT = "user_annotation"
#: the name of the span around one step
STEP = "step"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    #: (name, start us, duration us) of every device operation in the window
    ops: list
    #: (name, start us, end us) of the harness's spans
    spans: list
    #: (start us, end us) of the idle gaps in the window
    gaps: list


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def read(path: str) -> Trace:
    """The trace exported by `profile.export_chrome_trace(path)`."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    ops, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            ops.append((ev["name"], float(ev["ts"]), float(ev["dur"])))
        elif cat == SPAN_CAT:
            ts = float(ev["ts"])
            spans.append((ev["name"], ts, ts + float(ev["dur"])))
    steps = [s for s in spans if s[0] == STEP]
    if not steps:
        raise RuntimeError("the trace holds no step span")
    lo = min(s[1] for s in steps)
    hi = max(s[2] for s in steps)
    ops = [op for op in ops if op[1] < hi and op[1] + op[2] > lo]
    busy = _union((max(lo, t), min(hi, t + d)) for _n, t, d in ops)
    gaps, at = [], lo
    for b0, b1 in busy:
        if b0 > at:
            gaps.append((at, b0))
        at = max(at, b1)
    if hi > at:
        gaps.append((at, hi))
    busy_us = sum(b1 - b0 for b0, b1 in busy)
    return Trace((hi - lo) * 1e-6, busy_us * 1e-6, ops, spans, gaps)


def kernel_seconds(trace: Trace, match) -> float:
    """Seconds of the device operations whose name `match` accepts."""
    return 1e-6 * sum(d for name, _t, d in trace.ops if match(name))


def top_ops(trace: Trace, count: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    by_name = collections.Counter()
    for name, _t, d in trace.ops:
        by_name[name] += d * 1e-6
    return [[n, s] for n, s in by_name.most_common(count)]


def idle_by_span(trace: Trace, count: int = 10) -> list:
    """[[span, seconds]]: the idle gaps summed by the innermost harness
    span the host was in at each gap's middle ("between spans" outside
    every span but the step's)."""
    by_span = collections.Counter()
    for g0, g1 in trace.gaps:
        mid = 0.5 * (g0 + g1)
        inner = None
        for name, s0, s1 in trace.spans:
            if s0 <= mid < s1 and (inner is None or s1 - s0 < inner[1]):
                inner = (name, s1 - s0)
        name = "between spans" if inner is None or inner[0] == STEP \
            else inner[0]
        by_span[name] += (g1 - g0) * 1e-6
    return [[n, s] for n, s in by_span.most_common(count)]
