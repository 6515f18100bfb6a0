"""Response cache (v2 response_cache extension) with hit/miss statistics.

The port's own copy of ``client_tpu/server/cache.py``. The perf analyzer
reads cache_hit/cache_miss counters out of model statistics; this is the
server side of them. Keys hash host arrays only: the core never keys a
request with an input on the device (a CUDA shared-memory region or a
tensor handed in by an in-process caller).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np


class ResponseCache:
    def __init__(self, max_entries: int = 4096,
                 max_bytes: int = 256 * 1024 * 1024):
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, dict] = OrderedDict()
        self._bytes = 0
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        # lifetime counters (the /metrics feed)
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    @staticmethod
    def key(model_name: str, version: str, inputs: dict) -> str:
        h = hashlib.sha256()
        h.update(model_name.encode())
        h.update(version.encode())
        for name in sorted(inputs):
            arr = np.asarray(inputs[name])
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(np.asarray(arr.shape, np.int64).tobytes())
            if arr.dtype == np.object_:
                for item in arr.reshape(-1):
                    b = bytes(item) if isinstance(item, (bytes, bytearray)) \
                        else str(item).encode()
                    h.update(len(b).to_bytes(4, "little"))
                    h.update(b)
            else:
                h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    def lookup(self, key: str):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._hits += 1
            else:
                self._misses += 1
            return entry

    def insert(self, key: str, outputs: dict) -> None:
        size = sum(np.asarray(v).nbytes for v in outputs.values()
                   if np.asarray(v).dtype != np.object_)
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = outputs
            self._bytes += size
            while (len(self._entries) > self.max_entries
                   or self._bytes > self.max_bytes):
                _, old = self._entries.popitem(last=False)
                self._evictions += 1
                self._bytes -= sum(
                    np.asarray(v).nbytes for v in old.values()
                    if np.asarray(v).dtype != np.object_)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "entries": len(self._entries), "bytes": self._bytes}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
