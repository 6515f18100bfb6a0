"""Runtime (device) observability plane: the port's counterpart of
``client_tpu/server/runtime_stats.py``.

The serving stack's two hardware-facing invariants, observed:

- **"one compile per bucket, ever"** — in the reference a compile is
  ``jax.jit`` building an XLA executable the first time it sees an
  (entry point, signature) pair. The port's executable is a **CUDA
  graph**: the first call of a watched entry point with a novel signature
  runs it eagerly once on a capture stream (which builds and loads the
  K1/K2 libraries and is the call's result), then captures it into a
  ``torch.cuda.CUDAGraph`` over static input buffers; every later call
  copies its inputs into those buffers and replays. A mid-serving capture
  stalls the caller for the capture's latency, as a recompile does.
- **"everything fits in card memory"** — weights, the KV state or pool
  and the draft must leave headroom.

The instruments:

- :class:`CompileWatch` wraps every watched entry point and tracks its
  compiles by shape signature (:func:`signature_key` for the per-call
  novelty check, :func:`describe_signature` for the table). Once warmup
  calls :meth:`CompileWatch.seal`, the compile set is closed and any
  further compile is a serving-phase violation: counted, WARNING-logged,
  and stamped as a COMPILE trace span when a request trace is in scope.
  An entry point watched with a :class:`GraphCapture` is captured as a
  CUDA graph on the card; on the CPU, under a mesh, or in a watch made
  inside :func:`capture_disabled`, it runs eagerly and the watch records
  its first call per signature, the counterpart of a JAX compile on the
  CPU. A failed capture or replay raises: nothing falls back to eager.
- :func:`device_memory_stats` / :func:`pytree_nbytes` — card memory
  accounting from the CUDA caching allocator (an empty result when CUDA
  is unavailable or this process never initialised it: a ``/metrics``
  scrape must not create a CUDA context) plus per-model attribution of
  the big device residents (weights, the KV state or pool, the draft).
- :class:`FlightRecorder` — a fixed-size ring buffer of per-iteration
  engine snapshots, dumped as structured JSON into the failure log when
  the engine thread dies and readable live via the debug endpoints.

Exported to /metrics as the ``client_tpu_runtime_*`` families
(server/metrics.py), surfaced raw at ``GET /v2/debug/runtime``
(server/http_server.py), scraped per measurement window by the perf
profiler (compile count must be 0 in-window), and linted by
scripts/check_metrics_names.py.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from bisect import bisect_right
from collections import deque
from typing import Callable, Optional

import torch

from client_tpu_torch.ops import _build

log = logging.getLogger(__name__)

# Compile-duration histogram bucket upper bounds, in seconds (the
# reference's grid; the goodput plane's per-kind device-time histogram,
# server/goodput.py, shares it).
COMPILE_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0, 60.0)

# Ring sizes: the compile table is bounded so a pathological recompile
# storm cannot grow host memory without bound (the total counter keeps
# the true count); the flight recorder keeps the last N engine
# iterations — enough to reconstruct the seconds before a crash.
COMPILE_TABLE_CAP = 256
FLIGHT_RECORDER_CAP = 256

# serving-phase compiles of every watch in this process (a plain count, as
# the kernels' launch counters are), so a run can show that no phase of it
# compiled after its models sealed their sets
unexpected_compiles = 0
_unexpected_lock = threading.Lock()


def describe_signature(args: tuple, kwargs: Optional[dict] = None) -> str:
    """Human-readable signature of a watched call's arguments: shapes and
    dtypes for tensor and array leaves (a torch dtype renders as the
    reference renders the jnp one: ``bfloat16[16,12,64]``), values for
    int/bool/str scalars (they select executables too), type names for
    everything else. Built only on the rare novel-signature path; the
    per-call novelty check uses the cheaper hashable
    :func:`signature_key`."""
    sig = _describe(args)
    if kwargs:
        sig += _describe(kwargs)
    return sig


def signature_key(args: tuple, kwargs: Optional[dict] = None):
    """Hashable novelty key over the same axes ``describe_signature``
    names, with no string building: every watched call on the engine's
    dispatch loop pays it."""
    return (_key(args), _key(kwargs) if kwargs else None)


def _key(x):
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (dtype, shape if isinstance(shape, tuple) else tuple(shape))
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, (bool, int, str)):
        return x
    return type(x).__name__


def _describe(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        dims = ",".join(str(int(d)) for d in shape)
        return f"{str(dtype).removeprefix('torch.')}[{dims}]"
    if isinstance(x, dict):
        inner = ",".join(f"{k}:{_describe(v)}" for k, v in sorted(x.items()))
        return "{" + inner + "}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_describe(v) for v in x) + ")"
    if isinstance(x, (bool, int, str)):
        return repr(x)
    return type(x).__name__


# ----------------------------------------------------------------------
# CUDA-graph capture
# ----------------------------------------------------------------------

_capture_off = 0
_capture_off_lock = threading.Lock()
# one capture stream per card for the whole process, and one capture at a
# time on it: every stream a capture runs on keeps a cuBLAS workspace for
# the life of the process, so a stream per watch would leave one behind
# for every engine a supervisor rebuilds
_capture_streams: dict = {}
_capture_lock = threading.Lock()
# held around every graph launch in the process, and around the
# profiler's start and stop (``graph_launches_paused``): turning CUPTI's
# activity on or off while another thread launches a CUDA graph can hang
# the process (seen on an H100 under POST /v2/debug/profile while an
# engine replayed its chunk graphs)
_launch_gate = threading.Lock()


@contextlib.contextmanager
def capture_disabled():
    """Every CompileWatch made inside the block runs its entry points
    eagerly for its whole life (the counterpart of ``jax.disable_jit()``):
    for tests and the smoke test's graphs-against-eager arms. No serving
    flag or config reaches it."""
    global _capture_off
    with _capture_off_lock:
        _capture_off += 1
    try:
        yield
    finally:
        with _capture_off_lock:
            _capture_off -= 1


@contextlib.contextmanager
def graph_launches_paused():
    """No CUDA graph of this process launches during the block (the
    profiler's start and stop, ``server/core.py``)."""
    with _launch_gate:
        yield


def capture_enabled() -> bool:
    """False inside :func:`capture_disabled`."""
    return _capture_off == 0


def _tensor_leaves(tree) -> list:
    return [leaf for leaf in _flatten(tree) if isinstance(leaf, torch.Tensor)]


def _static_like(tree, device):
    """``tree`` with every tensor leaf replaced by an uninitialised buffer
    of its shape and dtype on ``device`` (the graph's static input)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _static_like(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_static_like(v, device) for v in tree)
    return tree


def _recorded_launches() -> dict:
    """{kernel counter: launches this thread recorded into captures}."""
    return {c: c.recorded() for c in _build.COUNTERS}


class GraphCapture:
    """How a watched entry point is captured as a CUDA graph.

    ``bind(*args, **kwargs) -> (run, feed)`` is called once per signature
    with that signature's first call: ``run()`` computes the call on
    static buffers (the eager warm-up run and the capture both call it),
    ``feed(*args, **kwargs)`` copies a call's per-call inputs into those
    buffers (tensors the graph reads by identity, such as weights or the
    KV state, are not copied: they must never be rebound). ``out(static)``
    makes a replay's result from the graph's static outputs while the
    watch's graph lock is held (the copy-out); None returns them as they
    are.
    ``device`` is the card the graph runs on."""

    def __init__(self, bind: Callable, device, out: Optional[Callable] = None):
        self.bind = bind
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.out = out


def capture_inputs(fn: Callable, positions: tuple, device,
                   out: Optional[Callable] = None) -> GraphCapture:
    """The common :class:`GraphCapture`: the arguments at ``positions``
    are per-call inputs (each tensor leaf gets a static buffer, and every
    call copies into it, host tensors by a non-blocking H2D copy); every
    other argument is read by identity: a call that passes another tensor
    or dict there raises (a rebound tensor would leave the graph reading
    freed memory)."""
    def bind(*args):
        static = list(args)
        for i in positions:
            static[i] = _static_like(args[i], device)
        dst = [leaf for i in positions for leaf in _tensor_leaves(static[i])]
        kept = [(j, a) for j, a in enumerate(args) if j not in positions
                and isinstance(a, (torch.Tensor, dict))]

        def feed(*call):
            for j, a in kept:
                if call[j] is not a:
                    raise RuntimeError(
                        f"argument {j} of a captured graph was replaced; "
                        f"the graph reads it by identity")
            src = [leaf for i in positions for leaf in _tensor_leaves(call[i])]
            for d, s in zip(dst, src):
                d.copy_(s, non_blocking=True)

        return (lambda: fn(*static)), feed

    return GraphCapture(bind, device, out)


def clone_outputs(tree):
    """The copy-out of a graph whose static outputs the next replay
    overwrites: a fresh copy of every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_outputs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_outputs(v) for v in tree)
    return tree


class _Graph:
    """One captured signature of a watched entry point: the graph, its
    feed and static outputs, and the kernel launches one replay makes
    (``[(counter, n)]``). The watch's graph lock is held around every
    capture and replay."""

    __slots__ = ("graph", "feed", "static_out", "launches")

    def __init__(self):
        self.graph = None
        self.feed = None
        self.static_out = None
        self.launches = []

    def capture(self, cap: GraphCapture, pool, args, kwargs):
        """Bind, feed the first call's inputs, run eagerly once on the
        card's capture stream (the call's result), then capture, one
        capture at a time in the process."""
        run, self.feed = cap.bind(*args, **kwargs)
        self.feed(*args, **kwargs)
        cur = torch.cuda.current_stream(cap.device)
        with _capture_lock:
            stream = _capture_streams.get(cap.device)
            if stream is None:
                stream = _capture_streams[cap.device] = torch.cuda.Stream(
                    device=cap.device)
            stream.wait_stream(cur)
            with torch.cuda.device(cap.device), torch.cuda.stream(stream):
                out = run()
                graph = torch.cuda.CUDAGraph()
                before = _recorded_launches()
                # the raw capture calls: torch.cuda.graph() would also
                # synchronize the whole card and empty the allocator's
                # caches before every capture, stalling whatever else
                # serves on the card
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    self.static_out = run()
                except Exception:
                    try:
                        graph.capture_end()
                    except Exception:  # noqa: BLE001 — the run's error
                        pass           # is the one to raise
                    raise
                graph.capture_end()
                after = _recorded_launches()
            cur.wait_stream(stream)
        # the eager result was made on the capture stream: the caller's
        # stream uses it next
        for leaf in _tensor_leaves(out):
            if leaf.is_cuda:
                leaf.record_stream(cur)
        self.launches = [(c, n - before.get(c, 0)) for c, n in after.items()
                         if n > before.get(c, 0)]
        self.graph = graph
        return out

    def replay(self, cap: GraphCapture, args, kwargs):
        if self.graph is None:
            raise RuntimeError("the CUDA graph of this signature failed to "
                               "capture; it has no executable to replay")
        self.feed(*args, **kwargs)
        with _launch_gate:
            self.graph.replay()
        for counter, n in self.launches:
            counter.add(n)
        return (self.static_out if cap.out is None
                else cap.out(self.static_out))


class CompileWatch:
    """Per-model compile tracker over a set of watched entry points.

    :meth:`watch` wraps a callable; the first call with a novel signature
    is timed as a compile and recorded into the compile table. After
    :meth:`seal` (warmup complete), a novel signature is a serving-phase
    violation: ``unexpected`` increments, a WARNING names the kernel and
    signature, and — when :attr:`current_trace` holds a sampled request
    trace — a COMPILE span carrying the signature is stamped on it.
    Violations are observed, never raised: a recompile is a latency bug,
    not a correctness one, and the call must proceed.

    ``graphs`` (decided when the watch is made: False inside
    :func:`capture_disabled`) lets the entry points watched with a
    :class:`GraphCapture` run as CUDA graphs; their graphs share one
    memory pool per watch (and the process's capture stream per card).
    A graph captured later may place its static outputs where an earlier
    graph keeps its intermediates, so one lock per watch is held across
    every capture and every replay's copy-in, replay and copy-out: with
    every caller on the card's default stream, the next replay of any
    graph of the watch is queued after the copy-out. (The lock costs
    nothing: the one stream serialises the device work anyway.)
    :meth:`release` frees the graphs.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self.graphs = capture_enabled()
        self._lock = threading.Lock()
        # held around every capture and replay of this watch's graphs,
        # taken before _lock where both are held
        self._graph_lock = threading.Lock()
        self._seen: set = set()
        self._captured: dict = {}
        self._pool = None
        self._table: deque = deque(maxlen=COMPILE_TABLE_CAP)
        # cumulative per-kind duration histograms on the COMPILE_BUCKETS_S
        # grid: {kind: [bucket_counts (last = +Inf), sum_s, count]}: the
        # /metrics feed, which, unlike the capped table, never drops an
        # observation
        self._hist: dict = {}
        self._sealed = False
        self.total_compiles = 0
        self.unexpected = 0
        # compiles (and their wall seconds) observed before seal(): the
        # warmup cost the bucket grids multiply
        self.warmup_compiles = 0
        self.warmup_seconds = 0.0
        # best-effort span target for serving-phase violations: the
        # engine points this at the first traced active request before
        # each dispatch round. Read racily; never required.
        self.current_trace = None

    def watch(self, kind: str, fn: Callable,
              capture: Optional[GraphCapture] = None,
              graph: Optional[str] = None) -> Callable:
        """Wrap ``fn`` as entry point ``kind``, keyed on every argument.
        ``capture`` runs it as a CUDA graph per signature when this watch
        has ``graphs``; entry points watched under one ``graph`` name
        (default: the kind) share their graphs, and each kind's first
        call per signature is recorded as its own compile."""
        if capture is None or not self.graphs:
            def eager(*args, **kwargs):
                with self.note(kind, *args, **kwargs):
                    return fn(*args, **kwargs)

            eager.__wrapped__ = fn
            return eager
        name = graph or kind

        def wrapped(*args, **kwargs):
            key = signature_key(args, kwargs)
            t0 = time.perf_counter()
            with self._graph_lock:
                with self._lock:
                    novel = (kind, key) not in self._seen
                    if novel:
                        self._seen.add((kind, key))
                    entry = self._captured.get((name, key))
                    fresh = entry is None
                    if fresh:
                        entry = self._captured[(name, key)] = _Graph()
                if fresh:
                    out = entry.capture(capture, self._graph_pool(), args,
                                        kwargs)
                else:
                    out = entry.replay(capture, args, kwargs)
            if novel:
                self._record(kind, describe_signature(args, kwargs),
                             time.perf_counter() - t0)
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    @contextlib.contextmanager
    def note(self, kind: str, *args, **kwargs):
        """Run the block as an eager call of entry point ``kind`` whose
        executable ``args``/``kwargs`` select (the shapes that select it,
        never a host int that is data): the block's first run per
        signature is timed and recorded as a compile."""
        key = (kind, signature_key(args, kwargs))
        with self._lock:
            novel = key not in self._seen
            if novel:
                self._seen.add(key)
        if not novel:
            yield
            return
        t0 = time.perf_counter()
        yield
        self._record(kind, describe_signature(args, kwargs),
                     time.perf_counter() - t0)

    def _graph_pool(self):
        with self._lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            return self._pool

    def captured(self) -> int:
        """CUDA graphs this watch holds."""
        with self._lock:
            return sum(1 for e in self._captured.values()
                       if e.graph is not None)

    def release(self) -> None:
        """Free every captured graph, its static buffers and the memory
        pool they share (a stopped engine or an unloaded model)."""
        with self._graph_lock, self._lock:
            captured, self._captured = self._captured, {}
            self._pool = None
            for entry in captured.values():
                entry.graph = entry.feed = entry.static_out = None

    def seal(self) -> None:
        """Warmup is complete: the compile set is closed, every further
        compile is a serving-phase violation."""
        with self._lock:
            self._sealed = True

    def reset(self) -> None:
        """Back to an open compile set with no graph (model unload: a
        reload warms and seals again; its warmup compiles must not count
        as violations)."""
        self.release()
        with self._lock:
            self._seen.clear()
            self._table.clear()
            self._hist.clear()
            self._sealed = False
            self.total_compiles = 0
            self.unexpected = 0
            self.warmup_compiles = 0
            self.warmup_seconds = 0.0
            self.current_trace = None

    @property
    def sealed(self) -> bool:
        return self._sealed

    def _record(self, kind: str, sig: str, seconds: float) -> None:
        global unexpected_compiles
        with self._lock:
            sealed = self._sealed
            self.total_compiles += 1
            if sealed:
                self.unexpected += 1
                with _unexpected_lock:
                    unexpected_compiles += 1
            else:
                self.warmup_compiles += 1
                self.warmup_seconds += seconds
            hist = self._hist.setdefault(
                kind, [[0] * (len(COMPILE_BUCKETS_S) + 1), 0.0, 0])
            hist[0][bisect_right(COMPILE_BUCKETS_S, seconds)] += 1
            hist[1] += seconds
            hist[2] += 1
            self._table.append({
                "kind": kind,
                "signature": sig,
                "seconds": round(seconds, 6),
                "phase": "serving" if sealed else "warmup",
            })
        if not sealed:
            return
        log.warning(
            "unexpected serving-phase XLA compile in '%s': kernel %s, "
            "signature %s (%.3fs) — every in-flight stream stalled "
            "behind it (the warmup compile set was declared closed)",
            self.name, kind, sig, seconds)
        trace = self.current_trace
        if trace is not None:
            try:
                from client_tpu_torch.server import trace as trace_mod

                trace.event(trace_mod.COMPILE, kernel=kind, signature=sig,
                            seconds=round(seconds, 6))
            except Exception:  # noqa: BLE001 — observability is best-effort
                pass

    def snapshot(self) -> dict:
        """Point-in-time compile state. ``compiles`` (the capped table,
        oldest-evicted) feeds the debug endpoints; ``hist`` (cumulative
        per-kind duration histograms, never capped) feeds /metrics."""
        with self._lock:
            return {
                "sealed": self._sealed,
                "total_compiles": self.total_compiles,
                "unexpected_compiles": self.unexpected,
                "warmup_compiles": self.warmup_compiles,
                "warmup_compile_seconds": round(self.warmup_seconds, 6),
                "compiles": list(self._table),
                "hist": {kind: (list(counts), sum_s, count)
                         for kind, (counts, sum_s, count)
                         in self._hist.items()},
            }


class FlightRecorder:
    """Fixed-size ring buffer of per-iteration engine snapshots.

    The engine thread records one small dict per loop iteration (phase,
    active slots, queue depth, tokens emitted, token-ring fetch lag —
    dispatches riding ahead of the last retired D2H fetch —, spec
    acceptance, pool occupancy), built from host counters only. When the
    thread dies on an unexpected error the buffer is dumped as structured
    JSON into the failure log, and it is readable live via
    ``GET /v2/debug/models/{name}/engine``.
    """

    def __init__(self, capacity: int = FLIGHT_RECORDER_CAP):
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._iterations = 0

    def record(self, **entry) -> None:
        with self._lock:
            self._iterations += 1
            entry["iteration"] = self._iterations
            self._buf.append(entry)

    def tail(self, n: int = 64) -> list:
        with self._lock:
            buf = list(self._buf)
        return buf[-max(0, int(n)):]

    def dump(self) -> list:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


# ----------------------------------------------------------------------
# card memory accounting
# ----------------------------------------------------------------------

def device_memory_stats() -> list:
    """Per-card memory from the CUDA caching allocator: ``[{device,
    platform, bytes_in_use, peak_bytes_in_use, bytes_limit}]``, one row
    per card this process holds memory on (``bytes_in_use`` is
    ``memory_allocated``, the peak ``max_memory_allocated``, the limit
    the card's total from ``mem_get_info``). Returns [] when CUDA is
    unavailable or was never initialised in this process, so a scrape
    creates no CUDA context."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    out = []
    for d in range(torch.cuda.device_count()):
        # a card without reserved memory may have no context here, and
        # mem_get_info would create one
        if torch.cuda.memory_reserved(d) == 0:
            continue
        out.append({
            "device": str(d),
            "platform": "gpu",
            "bytes_in_use": int(torch.cuda.memory_allocated(d)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
            "bytes_limit": int(torch.cuda.mem_get_info(d)[1]),
        })
    return out


def pytree_nbytes(tree) -> int:
    """Total bytes across the tensors of a nested dict/list/tuple
    (weights, KV pools) — the per-model side of the memory ledger. Leaves
    without ``nbytes`` (positions kept as ints, None) count 0."""
    return sum(int(getattr(leaf, "nbytes", 0) or 0)
               for leaf in _flatten(tree))


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]
