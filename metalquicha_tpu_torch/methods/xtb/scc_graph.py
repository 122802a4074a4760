"""The SCC loop as one replayed device program: CUDA graph capture of an
Anderson iteration.

The JAX package compiles its whole SCC solve into one XLA program
(`lax.while_loop`, metalquicha_tpu/methods/xtb/engine.py:853; GFN2's at
:651 with its `jax.grad` inside). The port's counterpart captures one
iteration of `engine._anderson_step` (the Fock build, the in-loop solve,
the fill and density, GFN2's autograd pass for the potentials, the
Anderson step) as a CUDA graph and replays it once per later iteration:
one launch from the host instead of one per kernel.

`run_replayed`:
- runs iteration 0 eagerly on a side stream. It is the warm-up that
  creates what must exist before a capture (the cuBLAS and cuSOLVER
  handles and workspaces, the kernels' libraries and their occupancy
  queries), and it is the loop's first iteration, the damped step;
- captures iteration 1 on the same stream and replays it for iterations
  1 to max_scf_iter - 1 on the caller's stream. The capture takes its
  memory from the pool of the graph this thread last captured for the
  same stream, which it then replaces: the pool is reused from one solve
  to the next and holds the largest iteration captured so far. (A pool
  of its own per solve stays reserved after the graph is gone, until an
  out-of-memory retry frees it: in the worker processes that share a card
  those pools piled up and cut the other workers' byte budgets, PERF.md.)
  The replaced graph was replayed only on that stream, before the new
  one's replays, so the two never use the memory at once;
- asks the host's all-done check before each iteration, outside the
  graph, at the iterations the eager loop asks it, so the graph stops
  where the eager loop stops.
The step's state lives in tensors made before the capture and updated in
place, its iteration counter among them (a 0-d tensor on the device), so
each replay reads and writes the same buffers and the results equal the
eager loop's bit for bit. A capture that fails raises: there is no
eager fallback.

Launch counts: a capture launches nothing; the wrappers' counts go to a
`replay_counts.Tally`, and each replay adds them (`ops/replay_counts.py`).
`stats` holds what the last captures cost, for the probes.
"""

from __future__ import annotations

import threading
import time

import torch

from ...ops import replay_counts

#: the SCC solves of this process on a card: those captured ("captures",
#: with their "replays") and those run launch by launch ("eager", asked
#: for by a caller that compares); and what the last capture cost, host
#: ms of its warm-up iteration, its recording and its instantiation
#: (`capture_end`)
stats = {"captures": 0, "replays": 0, "eager": 0, "warmup_ms": 0.0,
         "record_ms": 0.0, "instantiate_ms": 0.0}
#: one capture at a time in this process (other threads may run)
_capture_lock = threading.Lock()
#: device index -> the side stream warm-ups and captures run on: one per
#: device, so the caching allocator's blocks for it are reused from one
#: solve to the next
_side_streams: dict = {}
#: per thread, `graphs`: (device index, stream handle) -> the graph last
#: captured for replay there, whose memory pool the next capture shares
_held = threading.local()


def _capture(graph, step, pool=None):
    """Record step() into `graph` on the current (side) stream, its memory
    from `pool` (None: a new pool)."""
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        step()
    except BaseException:
        try:
            graph.capture_end()
        except Exception:  # the capture is already broken; report step's
            pass
        raise
    t = time.perf_counter()
    graph.capture_end()
    return time.perf_counter() - t


def run_replayed(step, done, n_iter: int, device) -> None:
    """Run iterations 0 .. n_iter - 1 of `step` (which updates the loop's
    state in place): the first eagerly, every later one as a replay of
    one captured iteration; `done(it)` is asked before iteration it and
    ends the loop when true."""
    if n_iter < 1:
        return
    cur = torch.cuda.current_stream(device)
    stream = cur.cuda_stream
    held = getattr(_held, "graphs", None)
    if held is None:
        held = _held.graphs = {}
    key = (cur.device_index, stream)
    prev = held.get(key)
    graph = torch.cuda.CUDAGraph()
    with _capture_lock:
        side = _side_streams.get(cur.device_index)
        if side is None:
            side = _side_streams[cur.device_index] = torch.cuda.Stream(
                cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            tally = _warm_up_and_capture(
                graph, step, n_iter, None if prev is None else prev.pool())
    cur.wait_stream(side)
    if n_iter > 1:
        held[key] = graph
    for it in range(1, n_iter):
        if done(it):
            break
        graph.replay()
        tally.replayed(stream)
        stats["replays"] += 1


def _warm_up_and_capture(graph, step, n_iter: int, pool):
    """Iteration 0 eagerly, then (if a later one runs) one captured into
    `graph` from `pool`; returns the tally of the launches each replay
    makes."""
    t0 = time.perf_counter()
    step()
    t1 = time.perf_counter()
    with replay_counts.capturing() as tally:
        if n_iter > 1:
            inst = _capture(graph, step, pool)
            t2 = time.perf_counter()
            stats.update(captures=stats["captures"] + 1,
                         warmup_ms=1e3 * (t1 - t0),
                         record_ms=1e3 * (t2 - t1 - inst),
                         instantiate_ms=1e3 * inst)
    return tally
