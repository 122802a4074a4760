"""The SCC loop as one replayed device program, kept across calls: a cache
of captured Anderson iterations keyed by shape, route and settings; and in
the same cache the other stages of a calculator's call (`Call`: the
operand build and the functional), so that `XtbCalculator.energies` and
`.gradients` run on a card as three replayed programs.

The JAX package compiles its whole SCC solve into one XLA program
(`lax.while_loop`, metalquicha_tpu/methods/xtb/engine.py:853; GFN2's at
:651 with its `jax.grad` inside), once per settings (the calculator's
`_jits`, metalquicha_tpu/methods/xtb/calculator.py:481) and input shape
(`jax.jit`'s own cache): every later call of that shape runs the compiled
program. The port's counterpart captures one iteration of
`engine._anderson_step` (the Fock build, the in-loop solve, the fill and
density, GFN2's autograd pass for the potentials, the Anderson step) as a
CUDA graph, keeps it with the buffers it reads and writes, and replays it
once per iteration of every later solve of the same key.

`solve(key, inputs, x0, build, n_iter)`:
- the cache's key is the caller's `key` (the route, its settings and
  whatever else it freezes into the launches, such as kT and SP2's
  closed-shell flag), the thread, the device, the caller's stream, the
  grad mode, the TF32 switch, and the layout of every input tensor and of
  x0 (shape, dtype, broadcast axes) and the value of every other input;
- a miss copies `inputs` (a dict of tensors, nested dicts, None and plain
  values) into buffers the new entry owns, allocated outside any capture,
  and builds the loop over them (`build(static)`: the state, the in-loop
  eigh's status and workspace). It runs iteration 0 eagerly on a side
  stream: the warm-up that creates what must exist before a capture (the
  cuBLAS and cuSOLVER handles and workspaces, the kernels' libraries and
  their occupancy queries), and the loop's first iteration, the damped
  step. It captures iteration 1 on that stream and replays it for
  iterations 1 to n_iter - 1 on the caller's stream;
- a hit copies the call's inputs into the entry's buffers and restarts
  the loop (`loop.restart_state()`: x0 into the state's x, the counter
  0), all in one multi-tensor copy per dtype, and replays the graph from
  iteration 0: the
  counter lives on the device, so iteration 0's damped step is the
  captured step with it == 0. A hit runs no eager iteration
  and records nothing; the graph's kernels are the eager loop's, so the
  results are its bits and the loop stops where it stops;
- `loop.done(it)`, asked before iteration it outside the graph at the
  iterations the eager loop asks it, ends the loop.
The loop with n_iter < 2 captures nothing and is not kept: its one
iteration runs eagerly. A capture that fails raises: there is no eager
fallback, and no hit is ever recaptured.

Memory. An entry holds its input buffers, the loop's state, the in-loop
eigh's cuSOLVER workspace (4.46 GB at (5985, 32) in float64) and its
graph. The graphs of one thread on one stream of one device share one
memory pool: they are replayed on that stream only, one at a time, and
nothing a replay computes outlives it in the pool (the step writes its
results into the state, which was allocated outside the capture), so one
graph's replay may reuse the blocks another's left. A pool lives while
one of its graphs is in the cache; then the allocator frees its blocks at
its next release (`torch.cuda.empty_cache`, or an out-of-memory retry).
At most MAX_ENTRIES entries are kept, and on a card entries holding at
most MAX_HELD_SHARE of its memory but the newest, the least recently used
evicted first; an evicted entry is never replayed again. The bytes are counted
when an entry is made: `stats["held_bytes"]` (buffers, state, workspace
and pools), and `idle_pool_bytes(device)`, the pools' blocks that the
allocator holds reserved but not allocated: no other allocation can use
them, so `parallel/executor.device_budget` holds them out (the buffers
and workspaces are allocated, and so never counted free). A caller that
plans its memory for a span of work (the executor's run, a mesh worker's
run) takes `mark()` at its start; `held_since(mark)` is what the entries
made since then allocated, and `evict_since(mark)` drops them
(`parallel/executor.make_room`).

A stage entry (`Call.stage`) holds its input and output buffers and its
`batched_eigh.StageStatus`; its graph shares the pool of its thread and
stream with the loops', under the same invariant: its outputs are copied
into buffers allocated outside the capture. A gradient's functional is a
chunk's peak, so a captured one leaves its pool that many idle blocks.
Within a run that plans its memory (`planned`: the executor's run, a mesh
worker's parts) the planner decides: `parallel/executor.make_room` gives
the calling thread's pools back (`evict_own_pool`) before a piece of a new
shape whose eager warm-up would not fit beside their idle blocks, and the
pieces of one shape replay the graphs the first captured; a run whose
chunks its budget cut gives them back at its end, as their graphs were
sized to the card. A call outside such a run gives them back where their
idle blocks exceed what the card has beside them (`give_back_pool`).

Launch counts: a capture launches nothing; the wrappers' counts go to the
entry's `replay_counts.Tally`, and each replay, a hit's included, adds
them (`ops/replay_counts.py`). `stats` holds the cache's counts and what
the last miss's capture and the last hit's setup cost, for the probes;
`reuse` counts the solves by reuse distance, the hits a cache of any cap
would have had.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

from ...ops import batched_eigh, replay_counts

#: entries kept at most, loops and a call's stages together. The working
#: set measured on `chip_smoke.py`'s main path (`reuse`, NVIDIA H100 80GB
#: HBM3): of its 1214 solves, 786 repeat a key, and a cache of 40 entries
#: would hit 743 of them, of 64 764, of 128 and of 160 775, of 256 all;
#: the 11 beyond 128 reuse a key of an earlier phase (distances 165-196).
#: One LM step of the fits (fit_tools) cycles through 39 loop keys
MAX_ENTRIES = 128
#: share of its card's memory the entries on one card may hold together
#: (their buffers, states and cuSOLVER workspaces, up to 4.46 GB at
#: (5985, 32) in float64), the least recently used evicted first, the
#: newest always kept: what the cache keeps out of every later byte
#: budget stays a few GiB however large the solves
MAX_HELD_SHARE = 0.05
#: keys the reuse record remembers (`reuse`)
_RECENT = 256

#: the SCC solves of this process on a card: those that replayed a graph
#: ("captures", the misses that recorded one, and "hits"), the replays
#: (the stages' included), and those run launch by launch ("eager", asked
#: for by a caller that compares); the cache's "misses" and "evictions"
#: and the bytes it holds ("held_bytes"); what the last miss cost, host ms
#: of its warm-up iteration, its recording and its instantiation
#: (`capture_end`), and the last hit's host ms from the lookup to its
#: first replay ("hit_setup_ms"); the same of a call's other stages
#: ("stage_captures", "stage_hits", "stage_eager", "stage_warmup_ms",
#: "stage_record_ms" with its instantiation, "stage_hit_setup_ms"), the
#: host ms of the last call's release of its warm-ups' blocks
#: ("stage_release_ms") and the times a thread gave its pools back
#: ("pool_releases", `evict_own_pool`)
stats = {"captures": 0, "replays": 0, "eager": 0, "hits": 0, "misses": 0,
         "evictions": 0, "held_bytes": 0, "warmup_ms": 0.0,
         "record_ms": 0.0, "instantiate_ms": 0.0, "hit_setup_ms": 0.0,
         "stage_captures": 0, "stage_hits": 0, "stage_eager": 0,
         "stage_warmup_ms": 0.0, "stage_release_ms": 0.0,
         "stage_record_ms": 0.0, "stage_hit_setup_ms": 0.0,
         "pool_releases": 0}
#: one capture at a time in this process (other threads may run)
_capture_lock = threading.Lock()
#: guards `_entries`, `_pools` and `stats`' cache counts
_lock = threading.Lock()
#: device index -> the side stream warm-ups and captures run on: one per
#: device, so the caching allocator's blocks for it are reused from one
#: solve to the next
_side_streams: dict = {}
#: full key -> _Entry, least recently used first
_entries: collections.OrderedDict = collections.OrderedDict()
#: the serial of the last entry made (`mark`)
_made = 0
#: the solves of this process on a card by reuse distance: for a key used
#: before, how many other keys were used since its last solve (a cache of
#: c entries, least recently used out first, hits the solves at distances
#: below c); "new" for a key not seen among the last _RECENT keys
reuse: collections.Counter = collections.Counter()
#: the last _RECENT keys solved, least recently used first
_recent: collections.OrderedDict = collections.OrderedDict()
#: (thread, device index, stream) -> _Pool shared by that key's graphs
_pools: dict = {}


class _Pool:
    """A graph memory pool: its id, its entries in the cache, and the bytes
    its captures added (reserved, and of those still allocated)."""

    def __init__(self, device_index: int):
        self.device_index = device_index
        self.id = None
        self.entries = 0
        self.reserved = 0
        self.allocated = 0


class _Entry:
    """A cached loop: its input buffers, as the views a hit copies into
    (`dsts`, with the broadcast axes of each), the loop built over them,
    its graph and the launches one replay makes."""

    def __init__(self, dsts, loop, pool_key, nbytes, device):
        self.dsts, self.loop = dsts, loop
        self.pool_key, self.nbytes = pool_key, nbytes
        self.device = device
        self.serial = 0
        self.graph = None
        self.tally = None
        #: a hit's copies (`_plan`), and for a loop the 0 it copies into
        #: the loop's counter
        self.plan = None
        self.zero = None


def _axes(t: torch.Tensor) -> tuple:
    """The broadcast axes of t (stride 0, more than one element)."""
    return tuple(i for i, (st, n) in enumerate(zip(t.stride(), t.shape))
                 if st == 0 and n > 1)


def _layout(x):
    """What of an input tree the cache keys on."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.dtype, x.device,
                _axes(x) if 0 in x.stride() else ())
    if isinstance(x, dict):
        return tuple((k, _layout(v)) for k, v in x.items())
    if x is None or isinstance(x, (bool, int, float, str)):
        return (type(x), x)
    raise TypeError(f"an SCC input of type {type(x).__name__}")


def _leaves(x, out: list) -> list:
    """The tensors of an input tree, in the order `_layout` reads them."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    return out


def _narrowed(t: torch.Tensor, axes: tuple) -> torch.Tensor:
    for a in axes:
        t = t.narrow(a, 0, 1)
    return t


def _static(x, dsts: list):
    """Buffers of its own for an input tree, a broadcast tensor kept
    broadcast (one row in memory), left to `_copy_into` to fill; `dsts`
    gets each buffer's view a hit copies into and its broadcast axes."""
    if isinstance(x, torch.Tensor):
        axes = _axes(x)
        buf = torch.empty(_narrowed(x, axes).shape, dtype=x.dtype,
                          device=x.device)
        dsts.append((buf, axes))
        return buf.expand(x.shape) if axes else buf
    if isinstance(x, dict):
        return {k: _static(v, dsts) for k, v in x.items()}
    return x


def _plan(dsts: list) -> list:
    """A hit's copies into `dsts`, grouped by dtype (one multi-tensor copy
    each): [(buffers, [(leaf index, broadcast axes), ...]), ...]."""
    groups = {}
    for i, (dst, axes) in enumerate(dsts):
        group = groups.setdefault(dst.dtype, ([], []))
        group[0].append(dst)
        group[1].append((i, axes))
    return list(groups.values())


def _copy_into(dsts: list, inputs) -> None:
    """The call's input tensors into `dsts` (one multi-tensor copy per
    dtype)."""
    _copy_plan(_plan(dsts), inputs)


def _copy_plan(plan: list, inputs) -> None:
    """A hit: the call's input tensors into the entry's buffers by its
    `_plan`, made once."""
    srcs = _leaves(inputs, [])
    if len(srcs) != sum(len(picks) for _bufs, picks in plan):
        raise RuntimeError("SCC graph cache: a hit with other inputs than "
                           "its key's")
    for bufs, picks in plan:
        group = []
        for dst, (i, axes) in zip(bufs, picks):
            src = _narrowed(srcs[i], axes) if axes else srcs[i]
            if src.shape != dst.shape:
                raise RuntimeError(
                    f"SCC graph cache: a hit copies {tuple(src.shape)} into "
                    f"{tuple(dst.shape)}")
            group.append(src)
        torch._foreach_copy_(bufs, group)


def _memory(device):
    """(reserved, allocated) bytes of the caching allocator on `device`."""
    if getattr(device, "type", "cuda") != "cuda":
        return 0, 0
    return (torch.cuda.memory_reserved(device),
            torch.cuda.memory_allocated(device))


def _capture(graph, step, pool=None):
    """Record step() into `graph` on the current (side) stream, its memory
    from `pool` (None: a new pool); returns the seconds capture_end took
    (the instantiation)."""
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


def solve(key, inputs: dict, x0: torch.Tensor, build, n_iter: int):
    """Run the SCC loop `build(static inputs)` makes (an object with
    `step()`, `done(it)`, `restart_state()` and `owned()`, the tensors it
    allocated) for up to n_iter iterations from x0, on the cached graph of
    the key if there is one, else on a new one; returns the loop, whose
    state holds the result until the next solve of the same key."""
    cur = torch.cuda.current_stream(x0.device)
    stream = cur.cuda_stream
    pool_key = (threading.get_ident(), cur.device_index, stream)
    if n_iter < 2:
        loop = build(inputs)
        if n_iter == 1:
            loop.step()
        return loop
    full = (pool_key, key, torch.is_grad_enabled(),
            torch.backends.cuda.matmul.allow_tf32, _layout(inputs),
            _layout(x0))
    t0 = time.perf_counter()
    with _lock:
        _record_reuse(full)
        entry = _entries.get(full)
        if entry is not None:
            _entries.move_to_end(full)
            stats["hits"] += 1
    if entry is None:
        entry = _miss(full, pool_key, inputs, x0, build, cur)
        first = 1
    else:
        # the inputs, and the loop's restart (x0 and the counter 0) with
        # them
        _copy_plan(entry.plan, {"inputs": inputs, "x0": x0,
                                "it": entry.zero})
        stats["hit_setup_ms"] = 1e3 * (time.perf_counter() - t0)
        first = 0
    graph, tally, loop = entry.graph, entry.tally, entry.loop
    for it in range(first, n_iter):
        if loop.done(it):
            break
        graph.replay()
        tally.replayed(stream)
        stats["replays"] += 1
    return loop


def _miss(full, pool_key, inputs, x0, build, cur) -> _Entry:
    """A new entry: buffers, loop, iteration 0 eagerly and iteration 1
    captured on the side stream; kept in the cache, which evicts its least
    recently used entries beyond MAX_ENTRIES."""
    dsts = []
    static = _static(inputs, dsts)
    # the hit's copies: their kernels loaded here, not in a hit
    _copy_into(dsts, inputs)
    loop = build(static)
    nbytes = sum(t.numel() * t.element_size()
                 for t in [b for b, _ in dsts] + list(loop.owned()))
    entry = _Entry(dsts, loop, pool_key, nbytes, x0.device)
    # a hit restarts the loop (`loop.restart_state()`: x and the counter)
    # with the inputs' copies
    entry.zero = torch.zeros((), dtype=torch.int64, device=x0.device)
    entry.plan = _plan(dsts + [(t, ()) for t in loop.restart_state()])
    entry.graph = torch.cuda.CUDAGraph()
    pool = _hold_pool(pool_key, cur.device_index)
    try:
        with _capture_lock:
            side = _side_stream(cur)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                entry.tally = _warm_up_and_capture(entry.graph, loop.step,
                                                   pool, x0.device)
        cur.wait_stream(side)
    except BaseException:
        with _lock:
            _release(pool_key)
        raise
    _keep(full, entry, pool, "misses")
    return entry


def _hold_pool(pool_key, device_index: int) -> _Pool:
    """The pool of `pool_key` (made if new), held for one more entry from
    here: no eviction frees it while the entry is captured."""
    with _lock:
        pool = _pools.get(pool_key)
        if pool is None:
            pool = _pools[pool_key] = _Pool(device_index)
        pool.entries += 1
    return pool


def _keep(full, entry: _Entry, pool: _Pool, count: str) -> None:
    """Keep a captured entry under `full` (stats[count] + 1), evicting the
    least recently used beyond the caps."""
    global _made
    with _lock:
        if pool.id is None:
            pool.id = entry.graph.pool()
        _made += 1
        entry.serial = _made
        _entries[full] = entry
        stats[count] += 1
        _trim(entry.device)
        stats["held_bytes"] = _held_bytes()


def _held_cap(device) -> float:
    """Bytes the entries on `device` may hold together: MAX_HELD_SHARE of
    its memory; no cap off a card."""
    if device.type != "cuda":
        return float("inf")
    return MAX_HELD_SHARE * torch.cuda.get_device_properties(
        device).total_memory


def _trim(device) -> None:
    """Evict (under `_lock`) the least recently used entries beyond
    MAX_ENTRIES, then those on `device` beyond its byte cap but the
    newest."""
    while len(_entries) > MAX_ENTRIES:
        _evict(next(iter(_entries)))
    cap = _held_cap(device)
    mine = [k for k, e in _entries.items() if e.device == device]
    held = sum(_entries[k].nbytes for k in mine)
    while len(mine) > 1 and held > cap:
        held -= _entries[mine[0]].nbytes
        _evict(mine.pop(0))


def _record_reuse(full) -> None:
    """Count the solve of `full` in `reuse` (under `_lock`)."""
    if full in _recent:
        # the keys used since, newest first: a hit of the last key compares
        # one key, not all of them
        for distance, key in enumerate(reversed(_recent)):
            if key == full:
                break
        reuse[distance] += 1
        _recent.move_to_end(full)
    else:
        reuse["new"] += 1
        _recent[full] = None
        if len(_recent) > _RECENT:
            _recent.popitem(last=False)


def _evict(full) -> None:
    """Drop the entry of `full` (under `_lock`): its graph is never
    replayed again."""
    old = _entries.pop(full)
    old.graph = None
    _release(old.pool_key)
    stats["evictions"] += 1


def mark() -> int:
    """The serial of the last entry made: the entries made after it are
    those `held_since` and `evict_since` see."""
    return _made


def held_since(serial: int) -> int:
    """Bytes the cached entries made after `serial` allocated (their input
    buffers, state and workspace)."""
    with _lock:
        return sum(e.nbytes for e in _entries.values() if e.serial > serial)


def evict_since(serial: int) -> None:
    """Evict the cached entries made after `serial`."""
    with _lock:
        for full in [k for k, e in _entries.items() if e.serial > serial]:
            _evict(full)
        stats["held_bytes"] = _held_bytes()


def _release(pool_key) -> None:
    """One entry of the pool gone (under `_lock`): the pool is forgotten
    with its last entry, and its next capture starts a new one."""
    pool = _pools[pool_key]
    pool.entries -= 1
    if pool.entries == 0:
        del _pools[pool_key]


def _held_bytes() -> int:
    return (sum(e.nbytes for e in _entries.values())
            + sum(p.reserved for p in _pools.values()))


def _warm_up_and_capture(graph, step, pool: _Pool, device):
    """Iteration 0 eagerly, then iteration 1 captured into `graph` from
    `pool`; returns the tally of the launches each replay makes."""
    t0 = time.perf_counter()
    step()
    t1 = time.perf_counter()
    reserved, allocated = _memory(device)
    with replay_counts.capturing(
            torch.cuda.current_stream(device).cuda_stream) as tally:
        inst = _capture(graph, step, pool.id)
    t2 = time.perf_counter()
    reserved2, allocated2 = _memory(device)
    pool.reserved += reserved2 - reserved
    pool.allocated += allocated2 - allocated
    stats.update(captures=stats["captures"] + 1, warmup_ms=1e3 * (t1 - t0),
                 record_ms=1e3 * (t2 - t1 - inst), instantiate_ms=1e3 * inst)
    return tally


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def _own(key, index: int) -> bool:
    """Whether pool `key` is the calling thread's on device `index`."""
    return key[0] == threading.get_ident() and key[1] == index


def idle_pool_bytes(device, own: bool = True) -> int:
    """Bytes the cache's graph pools hold on `device` that the caching
    allocator counts as reserved and not allocated, as counted when each
    capture was made; with own=False the calling thread's pools left
    out."""
    index = _index(device)
    with _lock:
        return sum(max(p.reserved - p.allocated, 0)
                   for k, p in _pools.items()
                   if p.device_index == index and (own or not _own(k, index)))


def own_idle_bytes(device) -> int:
    """`idle_pool_bytes` of the calling thread's pools on `device`: blocks
    its captures and replays reuse, and its eager runs cannot (0 off a
    card)."""
    if torch.device(device).type != "cuda":
        return 0
    return idle_pool_bytes(device) - idle_pool_bytes(device, own=False)


def _room_beside(device) -> int:
    """Bytes an eager allocation on `device` could find beside the graph
    pools: the card's free bytes and the caching allocator's unused blocks
    outside every pool."""
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device)
              - idle_pool_bytes(device))
    return free + max(cached, 0)


def give_back_pool(device) -> bool:
    """Evict every entry on the calling thread's pools on `device` and give
    their blocks back (`evict_own_pool`) where their idle blocks exceed the
    room beside them (`_room_beside`): an eager warm-up as large as the
    captures those blocks served would no longer fit. Returns whether it
    did (nothing off a card)."""
    idle = own_idle_bytes(device)
    if not idle or idle <= _room_beside(device):
        return False
    evict_own_pool(device)
    return True


@contextlib.contextmanager
def planned():
    """Within the block the calling thread's calls leave its graph pools to
    a caller that plans its memory for a run of pieces
    (`parallel/executor.make_room`, before every piece of a new shape, and
    the run's end): a piece of the last one's shape replays the graphs
    that piece captured."""
    before = getattr(_calls, "planned", False)
    _calls.planned = True
    try:
        yield
    finally:
        _calls.planned = before


def evict_own_pool(device) -> None:
    """Evict every entry on the calling thread's pools on `device`, and
    give their blocks back to the card (one empty_cache); nothing off a
    card (no pool there)."""
    if torch.device(device).type != "cuda":
        return
    index = _index(device)
    with _lock:
        for full in [k for k, e in _entries.items() if _own(e.pool_key,
                                                            index)]:
            _evict(full)
        stats["held_bytes"] = _held_bytes()
        stats["pool_releases"] += 1
    torch.cuda.empty_cache()


def clear() -> None:
    """Forget every entry (their graphs are freed with the last reference;
    the pools' blocks at the allocator's next release)."""
    with _lock:
        for entry in _entries.values():
            entry.graph = None
        _entries.clear()
        _pools.clear()
        stats["held_bytes"] = 0


# ---------------------------------------------------------------------------
# The stages of a calculator's call
# ---------------------------------------------------------------------------


class Call:
    """The stages of one call of `XtbCalculator.energies` or `.gradients`
    on `device` (`calculator.evaluate`), the counterpart of the JAX
    calculator's compiled program (metalquicha_tpu/methods/xtb/
    calculator.py:483-505): the operand build, the SCC loop (`solve`) and
    the functional, each a replayed CUDA graph kept in this cache.

    `stage(key, inputs, fn)` runs fn(inputs), a flat dict of output
    tensors (or None), on the stage's cached graph:
    - a hit copies the inputs into the entry's buffers and replays the
      graph (its status is 0: a failure read zeroes it); the outputs are
      cloned out of the entry's buffers (nothing returned aliases the
      cache);
    - a miss copies the inputs into new buffers and runs fn on them once
      eagerly on the side stream: its warm-up, whose results are the
      call's (copied into the entry's output buffers, allocated outside any
      capture). The capture waits for `finish`, at the end of the call:
      every stage's warm-up runs before any capture, and one empty_cache
      between them gives the warm-ups' blocks back, so that the captures,
      which take theirs from the graph pool, do not hold the same bytes
      twice. No stage's output lives in the pool: each capture copies its
      results into the output buffers, so nothing a replay computes
      outlives it in the pool, as for the loops;
    - with graph=False (a caller that compares) or off a card, fn runs on
      the inputs as they are, launch by launch.
    The key is the caller's (the stage, route, settings, kT, the solvation
    model, every Python value fn bakes into its launches), the thread,
    device and stream, the grad mode, the TF32 switch and the inputs'
    layout. Each stage's eighs and solver infos fold into its
    `batched_eigh.StageStatus` on the device; `finish` reads them, and the
    loop's (`defer`), once. A failed capture raises.
    """

    def __init__(self, device, graph: bool = True):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.graph = graph and self.on_card
        self.pending = []   # (full key, entry, fn, static inputs)
        self.worst = []     # the stages' and the loop's status tensors
        self._prev = None

    def __enter__(self) -> "Call":
        """The calling thread's current call (`current_call`) within the
        block."""
        self._prev = getattr(_calls, "call", None)
        _calls.call = self
        return self

    def __exit__(self, exc_type, *exc) -> None:
        _calls.call = self._prev
        if exc_type is not None and self.worst:
            # the statuses this call did not read: a cached entry's is
            # its next call's
            torch._foreach_zero_(self.worst)

    def defer(self, status) -> None:
        """A status (anything with `worst`) read in `finish`."""
        if status is not None:
            self.worst.append(status.worst)

    def stage(self, key, inputs: dict, fn) -> dict:
        if not self.on_card:
            return fn(inputs)
        if not self.graph:
            stats["stage_eager"] += 1
            status = batched_eigh.StageStatus(self.device)
            with batched_eigh.collecting(status):
                out = fn(inputs)
            self.defer(status)
            return out
        cur = torch.cuda.current_stream(self.device)
        pool_key = (threading.get_ident(), cur.device_index, cur.cuda_stream)
        full = (pool_key, ("stage", key), torch.is_grad_enabled(),
                torch.backends.cuda.matmul.allow_tf32, _layout(inputs))
        t0 = time.perf_counter()
        with _lock:
            _record_reuse(full)
            entry = _entries.get(full)
            if entry is not None:
                _entries.move_to_end(full)
                stats["stage_hits"] += 1
        if entry is None:
            entry = self._warm_up(full, pool_key, inputs, fn, cur)
        else:
            _copy_plan(entry.plan, inputs)
            stats["stage_hit_setup_ms"] = 1e3 * (time.perf_counter() - t0)
            entry.graph.replay()
            entry.tally.replayed(cur.cuda_stream)
            stats["replays"] += 1
        self.defer(entry.status)
        return {k: (None if b is None else b.clone())
                for k, b in entry.outs.items()}

    def _warm_up(self, full, pool_key, inputs, fn, cur) -> _Entry:
        dsts = []
        static = _static(inputs, dsts)
        _copy_into(dsts, inputs)
        status = batched_eigh.StageStatus(self.device)
        entry = _Entry(dsts, None, pool_key, 0, self.device)
        entry.plan = _plan(dsts)
        entry.status = status
        t0 = time.perf_counter()
        with _capture_lock:
            side = _side_stream(cur)
            side.wait_stream(cur)
            with torch.cuda.stream(side), batched_eigh.collecting(status):
                out = fn(static)
        cur.wait_stream(side)
        # the output buffers, outside any capture and on the caller's
        # stream: the capture writes into them, the hits clone them
        entry.outs = {k: None if t is None else t.detach().clone()
                      for k, t in out.items()}
        del out
        status.frozen = True
        entry.nbytes = sum(t.numel() * t.element_size() for t in (
            [b for b, _ in dsts] + [t for t in entry.outs.values()
                                     if t is not None]
            + status.owned()))
        stats["stage_warmup_ms"] = 1e3 * (time.perf_counter() - t0)
        self.pending.append((full, entry, fn, static))
        return entry

    def finish(self) -> None:
        """Capture the stages that missed (after one release of the
        warm-ups' cached blocks) and keep them, outside a planned run
        giving the thread's pools back where they outgrow the card
        (`give_back_pool`); read every status once; raises if a solver
        failed."""
        if self.pending:
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            stats["stage_release_ms"] = 1e3 * (time.perf_counter() - t0)
            for item in self.pending:
                _capture_stage(*item)
            self.pending = []
            if not getattr(_calls, "planned", False):
                give_back_pool(self.device)
        if self.worst:
            worst = self.worst[0] if len(self.worst) == 1 else torch.stack(
                self.worst).abs().amax()
            bad = int(worst)
            if bad:
                # zeroed, as a status read: a cached entry's is its next
                # call's
                torch._foreach_zero_(self.worst)
                self.worst = []
                raise RuntimeError(
                    f"a solver of the call reported info {bad} (an "
                    f"eigensolve that did not converge, a singular system, "
                    f"or a wrong argument)")


#: the calling thread's `Call` (`current_call`)
_calls = threading.local()


def current_call():
    """The `Call` the calling thread is in, or None."""
    return getattr(_calls, "call", None)


def _side_stream(cur):
    """The side stream of `cur`'s device (under `_capture_lock`)."""
    side = _side_streams.get(cur.device_index)
    if side is None:
        side = _side_streams[cur.device_index] = torch.cuda.Stream(
            cur.device)
    return side


def _capture_stage(full, entry: _Entry, fn, static) -> None:
    """Record fn(static), its outputs copied into the entry's buffers, on
    the side stream from the entry's pool; keep the entry."""
    cur = torch.cuda.current_stream(entry.device)
    bufs = entry.outs

    def body():
        out = fn(static)
        for k, b in bufs.items():
            if b is not None:
                b.copy_(out[k])

    entry.graph = torch.cuda.CUDAGraph()
    pool = _hold_pool(entry.pool_key, cur.device_index)
    try:
        with _capture_lock:
            side = _side_stream(cur)
            side.wait_stream(cur)
            reserved, allocated = _memory(entry.device)
            t0 = time.perf_counter()
            with (torch.cuda.stream(side),
                  batched_eigh.collecting(entry.status),
                  replay_counts.capturing(side.cuda_stream) as tally):
                _capture(entry.graph, body, pool.id)
            t1 = time.perf_counter()
            reserved2, allocated2 = _memory(entry.device)
        cur.wait_stream(side)
    except BaseException:
        with _lock:
            _release(entry.pool_key)
        raise
    entry.tally = tally
    with _lock:
        pool.reserved += reserved2 - reserved
        pool.allocated += allocated2 - allocated
    stats["stage_record_ms"] = 1e3 * (t1 - t0)
    _keep(full, entry, pool, "stage_captures")
