"""device_idle_share (%): the share of the traced steps' window in which no
operation (kernel, copy or set) ran on the card: 1 - the union of the
device's intervals over the span from the first traced step's start to the
last's end, from the torch.profiler trace (`harness/trace.py`)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
