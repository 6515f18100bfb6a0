"""Prefix-aware KV block pool of the continuous-batching engine: the port
of ``client_tpu/server/kv_cache.py`` without its host-RAM tier.

A host-side radix index over token-id prefixes at block granularity
(``RadixBlockIndex``): a trie whose edges are ``block_len``-token tuples,
with per-node ref counts (a live request pins its matched chain) and LRU
leaf eviction under pool pressure. Divergence inside a block is a miss
for that block, so only full, exactly equal blocks are shared and reuse
is exact. Block 0 of every pool is the reserved scratch block: block-id
vectors are padded with it, padded reads see rows nobody attends and
padded writes land on rows nobody reads.

The engine uses the index in two ways:

- under ``kv_layout="slot"`` with ``prefix_cache`` the pool is a cache in
  front of the slot rows (``init_block_pool``, block-major). On admission
  ``acquire`` returns the longest full-block match and ``pool_to_slot``
  copies it into the slot's rows; on retire ``plan_commit`` hands out
  blocks for the prompt's uncovered full blocks, ``slot_to_pool`` copies
  the slot's rows into them and ``finish_commit`` unpins them;
- under ``kv_layout="paged"`` the pool is the only home of K/V rows
  (``init_paged_pool``, layer-major) and the index is also the block
  allocator: a stream RESERVES its worst case at admission (evicting
  unpinned LRU leaves), ALLOCATES lazily, and on retire DONATES its full
  prompt blocks to the trie with no copy (``commit_stream``) and FREES
  the rest. A hit is a block-table edit.

Every host-side structure is under one lock (the engine thread and a
consumer's cancel both reach it). The reference's host tier and
preemption pins (``attach_tier``, ``commit_stream_pinned``) wait for
their slices (ROADMAP A10f, A10g).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

COMMIT_POLICIES = ("all", "no-evict", "none")


class _Node:
    """One radix-trie edge: ``key`` (a block_len token tuple) maps the
    parent's prefix to this node's pool block ``block_id``."""

    __slots__ = ("key", "block_id", "parent", "children", "refs",
                 "last_used")

    def __init__(self, key: tuple, block_id: int, parent):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: dict = {}
        self.refs = 0
        self.last_used = 0


class PrefixHandle:
    """A request's pinned match: the node chain whose refs it holds.
    ``matched_tokens`` is the prefix length covered by ``block_ids``."""

    __slots__ = ("chain", "block_ids", "matched_tokens", "released")

    def __init__(self, chain: list, block_len: int):
        self.chain = chain
        self.block_ids = [n.block_id for n in chain]
        self.matched_tokens = len(chain) * block_len
        self.released = False


class RadixBlockIndex:
    """Host-side radix index and block allocator over a pool of
    ``n_blocks`` device blocks of ``block_len`` tokens (block 0 is scratch
    and never allocated)."""

    def __init__(self, n_blocks: int, block_len: int):
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        if n_blocks < 2:
            raise ValueError(
                "n_blocks must be >= 2 (block 0 is reserved scratch)")
        self.block_len = block_len
        self.n_blocks = n_blocks
        self._lock = threading.Lock()
        self._root = _Node((), 0, None)   # sentinel; block_id unused
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> low ids
        self._nodes = 0
        self._clock = 0
        # blocks promised to admitted streams but not yet popped from the
        # free list: growth within a reservation never fails
        self._reserved = 0
        # the allocator's own counters; hits, misses and saved tokens are
        # the engine's (GenerationStats)
        self.evictions = 0
        self.commits = 0

    @property
    def usable_blocks(self) -> int:
        """Allocatable pool capacity (block 0 is reserved scratch)."""
        return self.n_blocks - 1

    # ---- internal (the caller holds self._lock) ----

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks_of(self, tokens) -> list:
        bl = self.block_len
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + bl])
                for i in range(0, len(toks) - bl + 1, bl)]

    def _evict_one(self, exclude=frozenset()) -> Optional[int]:
        """Free the least recently used unpinned leaf. ``exclude`` holds
        the nodes a commit is walking: evicting the node it is about to
        insert under would hang the new child off a detached subtree and
        leak its block. An O(n) walk, n bounded by the pool; eviction is
        off the per-token path."""
        victim = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.refs > 0 or node.children \
                    or node in exclude:
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return None
        del victim.parent.children[victim.key]
        self._nodes -= 1
        self.evictions += 1
        self._free.append(victim.block_id)
        return victim.block_id

    # ---- prefix matching and commits ----

    def acquire(self, tokens) -> Optional[PrefixHandle]:
        """Longest full-block match over ``tokens``, capped one token short
        of the prompt (one real token must run to give the next-token
        logits); pins the chain so eviction cannot take its blocks. None
        when nothing matches (the caller counts the hit or miss)."""
        with self._lock:
            blocks = self._blocks_of(tokens)
            if blocks and len(blocks) * self.block_len == len(tokens):
                blocks = blocks[:-1]
            chain = []
            node = self._root
            for key in blocks:
                child = node.children.get(key)
                if child is None:
                    break
                chain.append(child)
                node = child
            if not chain:
                return None
            now = self._tick()
            for n in chain:
                n.refs += 1
                n.last_used = now
            return PrefixHandle(chain, self.block_len)

    def release(self, handle: Optional[PrefixHandle]) -> None:
        """Unpin a handle's chain (idempotent; survives nodes evicted after
        the handle was taken)."""
        if handle is None or handle.released:
            return
        with self._lock:
            handle.released = True
            for n in handle.chain:
                if n.refs > 0:
                    n.refs -= 1

    def plan_commit(self, tokens, policy: str = "all",
                    max_blocks: int = 0) -> list:
        """Allocate pool blocks for every full prompt block of ``tokens``
        not indexed yet. Returns ``[(block_id, token_offset, node)]``, a
        contiguous tail run of the prompt's blocks (a trie child cannot
        exist without its parent). The inserted nodes stay pinned until
        :meth:`finish_commit`, so an eviction cannot free a block whose
        copy is not enqueued yet. ``"all"`` evicts LRU leaves for room,
        ``"no-evict"`` takes free blocks only, ``"none"`` commits
        nothing."""
        if policy not in COMMIT_POLICIES:
            raise ValueError(f"unknown commit policy '{policy}'")
        if policy == "none":
            return []
        with self._lock:
            blocks = self._blocks_of(tokens)
            plan = []
            node = self._root
            walked = {node}  # never evict the walk's own path
            now = self._tick()
            for i, key in enumerate(blocks):
                child = node.children.get(key)
                if child is None:
                    if max_blocks and len(plan) >= max_blocks:
                        break
                    if not self._free:
                        if policy == "no-evict" \
                                or self._evict_one(walked) is None:
                            break  # pool exhausted under this policy
                    block_id = self._free.pop()
                    child = _Node(key, block_id, node)
                    child.refs = 1          # pinned until finish_commit
                    child.last_used = now
                    node.children[key] = child
                    self._nodes += 1
                    plan.append((block_id, i * self.block_len, child))
                else:
                    child.last_used = now
                node = child
                walked.add(node)
            if plan:
                self.commits += 1
            return plan

    def finish_commit(self, plan: list) -> None:
        """Unpin the nodes a commit plan inserted (their copies are
        enqueued, in stream order before any later use of those ids)."""
        with self._lock:
            for _bid, _off, node in plan:
                if node.refs > 0:
                    node.refs -= 1

    # ---- the paged layout's allocator ----

    def reserve(self, n: int) -> bool:
        """Reserve ``n`` blocks for one stream, evicting unpinned LRU
        leaves as needed. False when the pool cannot cover it (the caller
        keeps the request queued); a successful reserve guarantees every
        later ``alloc`` within it."""
        if n <= 0:
            return True
        with self._lock:
            while len(self._free) - self._reserved < n:
                if self._evict_one() is None:
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

    def commit_stream(self, tokens, block_ids, policy: str = "all") -> set:
        """The paged layout's commit: index the stream's OWN blocks under
        the prompt's full-block prefixes (``block_ids[i]`` holds the rows
        of tokens ``[i*block_len, (i+1)*block_len)``); the trie takes
        every block whose node did not exist yet, with no copy. Returns
        the donated ids; the rest of ``block_ids`` (the shared chain,
        blocks another stream committed first, decode blocks) stays the
        caller's. Nothing is allocated, so ``"all"`` and ``"no-evict"``
        are the same; ``"none"`` keeps the trie read-only."""
        if policy not in COMMIT_POLICIES:
            raise ValueError(f"unknown commit policy '{policy}'")
        donated: set = set()
        if policy == "none":
            return donated
        with self._lock:
            blocks = self._blocks_of(tokens)
            node = self._root
            now = self._tick()
            for i, key in enumerate(blocks):
                if i >= len(block_ids):
                    break
                child = node.children.get(key)
                if child is None:
                    child = _Node(key, int(block_ids[i]), node)
                    child.last_used = now
                    node.children[key] = child
                    self._nodes += 1
                    donated.add(int(block_ids[i]))
                else:
                    child.last_used = now
                node = child
            if donated:
                self.commits += 1
        return donated

    # ---- introspection ----

    def occupancy(self) -> dict:
        """Block occupancy: ``prefix`` blocks are trie-owned (evictable
        unless pinned), ``stream`` blocks are held by live streams,
        ``free`` includes the outstanding ``reserved`` promises."""
        with self._lock:
            free = len(self._free)
            return {
                "usable": self.n_blocks - 1,
                "free": free,
                "prefix": self._nodes,
                "stream": self.n_blocks - 1 - free - self._nodes,
                "reserved": self._reserved,
            }

    def pinned_nodes(self) -> int:
        """Trie nodes that hold a ref (0 once every request is closed)."""
        with self._lock:
            stack, pinned = list(self._root.children.values()), 0
            while stack:
                node = stack.pop()
                pinned += node.refs > 0
                stack.extend(node.children.values())
            return pinned

    def snapshot(self) -> dict:
        """Point-in-time counters for the stats endpoint."""
        with self._lock:
            return {
                "evictions": self.evictions,
                "commits": self.commits,
                "blocks": self.n_blocks - 1,     # usable (block 0 scratch)
                "blocks_used": self.n_blocks - 1 - len(self._free),
                "nodes": self._nodes,
            }


# ----------------------------------------------------------- device pools

def init_block_pool(cfg, n_blocks: int, block_len: int, device) -> dict:
    """The slot layout's prefix pool: block-major ``{"k", "v"}``, each
    ``[n_blocks, layers, block_len, Hkv, Dh]`` in ``cfg.dtype``, zeroed on
    ``device``."""
    shape = (n_blocks, cfg.n_layers, block_len, cfg.kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for name in ("k", "v")}


def init_paged_pool(cfg, n_blocks: int, block_len: int, device) -> dict:
    """Layer-major pool tensors ``{"k", "v"}``, each
    ``[layers, n_blocks, block_len, Hkv, Dh]`` in ``cfg.dtype``, zeroed on
    ``device`` (named explicitly: the engine places it)."""
    shape = (cfg.n_layers, n_blocks, block_len, cfg.kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for name in ("k", "v")}


def pool_to_slot(pool: dict, cache: dict, pos, idx: int, ids,
                 n_tok: int) -> None:
    """Gather blocks ``ids`` ([B] integer tensor on the pool's device,
    scratch-padded) into rows ``[0, B*block_len)`` of slot ``idx`` of the
    slot-layout ``cache`` and set ``pos[idx] = n_tok`` (the real matched
    length: padded rows past it are never attended), IN PLACE. The
    reference's ``pool_to_slot`` copy kernel (an XLA gather)."""
    for name, parr in pool.items():
        blocks = parr[ids.long()]                 # [B, L, bl, Hkv, Dh]
        b, layers, bl = blocks.shape[:3]
        cache[name][idx, :, :b * bl] = blocks.transpose(0, 1).reshape(
            layers, b * bl, *blocks.shape[3:])
    pos[idx] = n_tok


def slot_to_pool(pool: dict, cache: dict, idx: int, ids, offs) -> None:
    """For each block ``j`` copy rows ``[offs[j], offs[j] + block_len)`` of
    slot ``idx`` into pool block ``ids[j]``, IN PLACE (``ids``/``offs``
    [B] integer tensors on the pool's device; padded entries copy rows
    from offset 0 into the scratch block). Per-block offsets, as the
    reference's ``slot_to_pool`` copy kernel keeps them: one contiguous
    run padded to the bucket could pass ``max_seq``."""
    for name, parr in pool.items():
        bl = parr.shape[2]
        rows = offs.long()[:, None] + torch.arange(bl, device=offs.device)
        slot = cache[name][idx]                   # [L, max_seq, Hkv, Dh]
        blocks = slot[:, rows]                    # [L, B, bl, Hkv, Dh]
        parr[ids.long()] = blocks.transpose(0, 1).to(parr.dtype)


def block_count_buckets(max_blocks: int, start: int = 1,
                        skip_upto: int = 0) -> tuple:
    """Power-of-two buckets from ``start`` up to ``max_blocks`` (which is
    always the last bucket); ``skip_upto`` drops buckets <= that bound.
    The engine pads its block-id vectors and per-dispatch table widths to
    one of these, so the tensors it builds come in a few shapes only."""
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
