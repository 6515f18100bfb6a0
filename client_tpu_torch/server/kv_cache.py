"""The paged KV data plane's host allocator and device pool: the port's
counterpart of the paged half of ``client_tpu/server/kv_cache.py``.

Under ``kv_layout="paged"`` the block pool is the only home of a stream's
K/V rows. A stream RESERVES its worst-case block count at admission,
ALLOCATES lazily as its position grows, and FREES its blocks on retire.
Block 0 is the reserved scratch block: table padding and inactive slots
write there, and it is never allocated.

Of the reference's ``RadixBlockIndex`` this keeps the allocator API
(``usable_blocks``, ``reserve``, ``unreserve``, ``alloc``, ``free``,
``occupancy``); the radix trie of committed prompt prefixes, its
eviction, commit and host-tier parts wait for the prefix-cache slice, so
nothing here is ever evictable and the ``prefix`` count stays 0.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class RadixBlockIndex:
    """Host-side block allocator over a pool of ``n_blocks`` device blocks
    of ``block_len`` tokens (block 0 is scratch and never allocated)."""

    def __init__(self, n_blocks: int, block_len: int):
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        if n_blocks < 2:
            raise ValueError(
                "n_blocks must be >= 2 (block 0 is reserved scratch)")
        self.block_len = block_len
        self.n_blocks = n_blocks
        self._lock = threading.Lock()
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> low ids
        # blocks promised to admitted streams but not yet popped from the
        # free list: growth within a reservation never fails
        self._reserved = 0

    @property
    def usable_blocks(self) -> int:
        """Allocatable pool capacity (block 0 is reserved scratch)."""
        return self.n_blocks - 1

    def reserve(self, n: int) -> bool:
        """Reserve ``n`` blocks for one stream. False when the free list
        cannot cover it beside the existing reservations (the caller keeps
        the request queued); a successful reserve guarantees every later
        ``alloc`` within it."""
        if n <= 0:
            return True
        with self._lock:
            if len(self._free) - self._reserved < n:
                return False
            self._reserved += n
            return True

    def unreserve(self, n: int) -> None:
        """Return an unused reservation remainder (a stream retired before
        growing to its worst case)."""
        if n <= 0:
            return
        with self._lock:
            self._reserved = max(0, self._reserved - n)

    def alloc(self, n: int) -> list:
        """Pop ``n`` reserved blocks off the free list."""
        if n <= 0:
            return []
        with self._lock:
            if n > len(self._free):
                raise RuntimeError(
                    f"paged pool alloc({n}) beyond the free list "
                    f"({len(self._free)} free): allocation outside a "
                    f"reservation")
            self._reserved = max(0, self._reserved - n)
            return [self._free.pop() for _ in range(n)]

    def free(self, block_ids) -> None:
        """Return a stream's private blocks to the free list."""
        if not block_ids:
            return
        with self._lock:
            self._free.extend(int(b) for b in block_ids)

    def occupancy(self) -> dict:
        """Block occupancy: ``stream`` blocks are held by live streams,
        ``free`` includes the outstanding ``reserved`` promises, and
        ``prefix`` (trie-owned blocks) is 0 until the prefix cache is
        ported."""
        with self._lock:
            free = len(self._free)
            return {
                "usable": self.n_blocks - 1,
                "free": free,
                "prefix": 0,
                "stream": self.n_blocks - 1 - free,
                "reserved": self._reserved,
            }


def init_paged_pool(cfg, n_blocks: int, block_len: int, device) -> dict:
    """Layer-major pool tensors ``{"k", "v"}``, each
    ``[layers, n_blocks, block_len, Hkv, Dh]`` in ``cfg.dtype``, zeroed on
    ``device`` (named explicitly: the engine places it)."""
    shape = (cfg.n_layers, n_blocks, block_len, cfg.kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for name in ("k", "v")}


def block_count_buckets(max_blocks: int, start: int = 1,
                        skip_upto: int = 0) -> tuple:
    """Power-of-two buckets from ``start`` up to ``max_blocks`` (which is
    always the last bucket); ``skip_upto`` drops buckets <= that bound.
    The engine pads its per-dispatch block-table width to one of these,
    so the tensors it builds come in a few shapes only."""
    buckets = []
    b = start
    while b < max_blocks:
        if b > skip_upto:
            buckets.append(b)
        b *= 2
    buckets.append(max_blocks)
    return tuple(buckets)


def pad_block_ids(block_ids: list, bucket: int) -> np.ndarray:
    """Pad a block-id vector to its bucket width with the scratch block
    (id 0): padded reads see rows nobody attends, padded writes land on
    rows nobody reads."""
    ids = np.zeros(bucket, np.int32)
    ids[:len(block_ids)] = block_ids
    return ids
