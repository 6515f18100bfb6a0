"""Runtime (device) observability plane: the port's counterpart of
``client_tpu/server/runtime_stats.py``.

Two dependency-free instruments:

- :func:`device_memory_stats` / :func:`pytree_nbytes` — card memory
  accounting from the CUDA caching allocator (an empty result when CUDA
  is unavailable or this process never initialised it: a ``/metrics``
  scrape must not create a CUDA context) plus per-model attribution of
  the big device residents (weights, the KV state or pool, the draft).
- :class:`FlightRecorder` — a fixed-size ring buffer of per-iteration
  engine snapshots, dumped as structured JSON into the failure log when
  the engine thread dies and readable live via the debug endpoints.

The reference's ``CompileWatch`` has no counterpart here: PyTorch runs
the kernels eagerly, so the port has no compile set to seal until the
chunk steps are captured as CUDA graphs, and it registers no compile
families until then.

Exported to /metrics as ``client_tpu_runtime_device_memory_bytes`` and
``client_tpu_runtime_model_memory_bytes`` (server/metrics.py) and
surfaced raw at ``GET /v2/debug/runtime`` (server/http_server.py).
"""

from __future__ import annotations

import threading
from collections import deque

import torch

# the reference's compile-duration grid (seconds), shared by the goodput
# plane's per-kind device-time histogram (server/goodput.py); the compile
# histogram that will render on it comes with the CUDA-graph compile set
COMPILE_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0, 60.0)

# the flight recorder keeps the last N engine iterations — enough to
# reconstruct the seconds before a crash
FLIGHT_RECORDER_CAP = 256


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
