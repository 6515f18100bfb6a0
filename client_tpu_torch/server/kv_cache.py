"""Prefix-aware KV block pool of the continuous-batching engine: the port
of ``client_tpu/server/kv_cache.py``.

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

The pool can be tiered below the card (``HostTierStore``): an LRU-evicted
prefix block SPILLS its rows to a bounded store in pinned host memory
instead of being dropped, its trie node staying in place as a
``SPILLED`` marker, and a later hit whose chain crosses spilled nodes
re-provisions device blocks and RESTORES the rows (``acquire`` counts them
on the handle). The index owns the bookkeeping; the engine supplies the
two movers (``attach_tier``), built on :func:`tier_spill` and
:func:`tier_restore`. The pool is written in place, so order is explicit:
both movers enqueue their copies on the engine's stream, a spill before
its block id returns to the free list (every later writer of that block
is enqueued behind it) and a restore before the first kernel that reads
the block.

A preempted stream commits its extended context and pins the chain until
its resume re-acquires it (``commit_stream_pinned``).

Every host-side structure is under one lock (the engine thread and a
consumer's cancel both reach it).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

COMMIT_POLICIES = ("all", "no-evict", "none")

# block_id of a trie node whose rows live in the host tier, not the
# device pool (the node stays matchable; a hit restores it to a freshly
# provisioned block)
SPILLED = -1


# ----------------------------------------------------------------- host tier

class HostTierStore:
    """Bounded host-RAM store of spilled prefix blocks.

    One entry per spilled trie node: what the engine's spill mover
    returned, the block's rows as ``{tensor name: host tensor}`` in the
    layout-free ``[layers, block_len, ...]`` shape (both pool layouts
    slice to it), or under a sharded engine ``(key, rows)``, the key its
    followers file their heads of the block under. A spill's
    device-to-host copy may still be in flight when its entry arrives:
    ``put`` takes the copy's CUDA event as ``ready``, and :meth:`drain`
    (once per engine iteration) retires the events that have completed,
    without waiting on any: an entry whose event is still pending must
    not be read on the host. A restore needs no wait: its host-to-device
    copy is enqueued on the stream that carries the spill's copy.
    Capacity is ``budget_bytes`` worth of blocks; :meth:`put` makes room
    by dropping the least recently spilled CHILDLESS, unpinned entries
    (dropping one that still anchors children would orphan their
    prefixes) and refuses when it cannot, and the caller then evicts the
    block outright. The owning index's lock is held by every caller.

    ``on_drop(arrays)``, when given, is called with every entry that
    leaves the store other than by :meth:`take`: dropped for room, by
    :meth:`drop`, or refused by :meth:`put` (a sharded engine's driver
    tells its followers to let go of their part of the block)."""

    def __init__(self, budget_bytes: int, block_nbytes: int, on_drop=None):
        if budget_bytes < 1:
            raise ValueError("host tier budget must be >= 1 byte")
        if block_nbytes < 1:
            raise ValueError("block_nbytes must be >= 1")
        self.budget_bytes = int(budget_bytes)
        self.block_nbytes = int(block_nbytes)
        self.capacity_blocks = max(1, self.budget_bytes
                                   // self.block_nbytes)
        self._entries: dict = {}      # node -> rows (insertion = LRU)
        self._pending: dict = {}      # node -> event of its copy
        self.dropped = 0              # entries LRU-dropped to make room
        self._on_drop = on_drop or (lambda arrays: None)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def used_bytes(self) -> int:
        return len(self._entries) * self.block_nbytes

    def put(self, node, arrays: dict, protect=frozenset(),
            ready=None) -> bool:
        """Admit one spilled block; False when no room can be made (every
        droppable entry is pinned, anchors children or is protected).
        ``protect`` holds the nodes an in-flight restore depends on (the
        eviction a restore triggers must not drop the entry being
        restored). ``ready`` is the event of the entry's copy (None: the
        rows are already on the host)."""
        while len(self._entries) >= self.capacity_blocks:
            victim = next(
                (n for n in self._entries
                 if not n.children and n.refs == 0 and n is not node
                 and n not in protect),
                None)
            if victim is None:
                self._on_drop(arrays)
                return False
            self._on_drop(self._entries.pop(victim))
            self._pending.pop(victim, None)
            self.dropped += 1
            # the victim's rows are gone from every tier: the caller
            # unlinks it from the trie (see RadixBlockIndex._evict_one)
            victim.block_id = None
        self._entries[node] = arrays
        if ready is not None:
            self._pending[node] = ready
        return True

    def take(self, node) -> Optional[dict]:
        """Remove and return one entry's rows (the restore path)."""
        self._pending.pop(node, None)
        return self._entries.pop(node, None)

    def drop(self, node) -> None:
        """Discard one entry without restoring it (node deletion)."""
        self._pending.pop(node, None)
        arrays = self._entries.pop(node, None)
        if arrays is not None:
            self._on_drop(arrays)

    def drain(self) -> None:
        """Retire the events of the copies that have landed (never
        waits)."""
        for node, ev in list(self._pending.items()):
            if ev.query():
                del self._pending[node]

    def snapshot(self) -> dict:
        return {
            "blocks": len(self._entries),
            "capacity_blocks": self.capacity_blocks,
            "used_bytes": self.used_bytes,
            "budget_bytes": self.budget_bytes,
            "dropped": self.dropped,
        }


class _Node:
    """One radix-trie edge: ``key`` (a block_len token tuple) maps the
    parent's prefix to this node's pool block ``block_id`` (``SPILLED``
    while its rows live in the host tier, None once it is detached)."""

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
    ``matched_tokens`` is the prefix length covered by ``block_ids``;
    ``restored_blocks`` counts the chain's blocks this acquire restored
    from the host tier (nonzero: a tier hit)."""

    __slots__ = ("chain", "block_ids", "matched_tokens", "released",
                 "restored_blocks")

    def __init__(self, chain: list, block_len: int,
                 restored_blocks: int = 0):
        self.chain = chain
        self.block_ids = [n.block_id for n in chain]
        self.matched_tokens = len(chain) * block_len
        self.released = False
        self.restored_blocks = restored_blocks


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
        # the host tier (attach_tier): spilled nodes stay in the trie with
        # block_id SPILLED; _spilled counts them, apart from _nodes (the
        # device-resident prefix blocks)
        self.tier: Optional[HostTierStore] = None
        self._spill_fn = None
        self._restore_fn = None
        self._spilled = 0
        # the allocator's own counters; hits, misses and saved tokens are
        # the engine's (GenerationStats)
        self.evictions = 0
        self.commits = 0
        self.tier_spills = 0
        self.tier_restores = 0

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

    def attach_tier(self, tier: HostTierStore, spill_fn,
                    restore_fn) -> None:
        """Arm the host tier. ``spill_fn(block_id) -> (rows, ready)``
        enqueues one block's device-to-host copy (called BEFORE the id
        returns to the free list, so every later writer of the block is
        enqueued behind it) and returns the host rows and the copy's
        event; ``restore_fn(block_id, rows)`` enqueues the copy back into
        a freshly provisioned block. Both run on the engine thread: every
        eviction and acquire that can spill or restore starts there."""
        self.tier = tier
        self._spill_fn = spill_fn
        self._restore_fn = restore_fn

    def _evict_one(self, exclude=frozenset()) -> Optional[int]:
        """Free the least recently used unpinned node with no
        device-resident children (already spilled children are fine:
        leaf-first order spills a subtree bottom up, and a hit restores it
        top down). ``exclude`` holds the nodes a caller is walking:
        evicting the node a commit is about to insert under would hang
        the new child off a detached subtree and leak its block. With a
        tier attached the victim's rows SPILL to it (the node stays
        matchable) instead of being dropped. An O(n) walk, n bounded by
        the pool; eviction is off the per-token path."""
        victim = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.refs > 0 \
                    or node.block_id == SPILLED or node in exclude \
                    or any(c.block_id != SPILLED
                           for c in node.children.values()):
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return None
        bid = victim.block_id
        self._nodes -= 1
        self.evictions += 1
        spilled = False
        if self.tier is not None and self._spill_fn is not None:
            rows, ready = self._spill_fn(bid)
            spilled = self.tier.put(victim, rows, protect=exclude,
                                    ready=ready)
        if spilled:
            # the rows live on in the tier and the node stays matchable;
            # entries the tier dropped for room (block_id None) leave
            victim.block_id = SPILLED
            self._spilled += 1
            self.tier_spills += 1
            self._unlink_dropped(self._root)
        else:
            # a hard eviction: the victim leaves the trie, and its spilled
            # descendants with it, so their tier entries go too
            del victim.parent.children[victim.key]
            if victim.children and self.tier is not None:
                stack = list(victim.children.values())
                while stack:
                    child = stack.pop()
                    stack.extend(child.children.values())
                    if child.block_id == SPILLED:
                        self.tier.drop(child)
                        self._spilled -= 1
        self._free.append(bid)
        return bid

    def _unlink_dropped(self, node) -> None:
        """Detach the trie nodes whose tier entry was dropped (block_id
        None; childless by the tier's drop rule)."""
        for key, child in list(node.children.items()):
            if child.block_id is None:
                del node.children[key]
                self._spilled -= 1
            else:
                self._unlink_dropped(child)

    def _restore_node(self, node, exclude) -> bool:
        """Provision a device block for one spilled node and enqueue its
        restore (the caller holds the lock). False when no block can be
        freed: the caller's match stops there."""
        if self._restore_fn is None or self.tier is None:
            return False
        while len(self._free) - self._reserved < 1:
            if self._evict_one(exclude) is None:
                return False
        arrays = self.tier.take(node)
        if arrays is None:
            return False
        bid = self._free.pop()
        self._restore_fn(bid, arrays)
        node.block_id = bid
        self._nodes += 1
        self._spilled -= 1
        self.tier_restores += 1
        return True

    # ---- prefix matching and commits ----

    def acquire(self, tokens) -> Optional[PrefixHandle]:
        """Longest full-block match over ``tokens``, capped one token short
        of the prompt (one real token must run to give the next-token
        logits); pins the chain so eviction cannot take its blocks. A
        chain that crosses SPILLED nodes restores them onto freshly
        provisioned blocks (enqueued ahead of any kernel that reads
        them); where no block can be freed the match stops. None when
        nothing matches (the caller counts the hit or miss)."""
        with self._lock:
            blocks = self._blocks_of(tokens)
            if blocks and len(blocks) * self.block_len == len(tokens):
                blocks = blocks[:-1]
            chain = []
            restored = 0
            node = self._root
            for key in blocks:
                child = node.children.get(key)
                if child is None:
                    break
                if child.block_id == SPILLED:
                    # the walk's path, the chain so far and the node being
                    # restored are not pinned yet: the eviction a restore
                    # may trigger must not take them
                    if not self._restore_node(
                            child,
                            frozenset(chain) | {node, child, self._root}):
                        break
                    restored += 1
                chain.append(child)
                node = child
            if not chain:
                return None
            now = self._tick()
            for n in chain:
                n.refs += 1
                n.last_used = now
            return PrefixHandle(chain, self.block_len, restored)

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

    def commit_stream_pinned(self, tokens, block_ids,
                             policy: str = "all") -> tuple:
        """The preemption's commit: donate a preempted stream's blocks as
        :meth:`commit_stream` does (``tokens`` is its extended context,
        the prompt and the tokens it generated, whose rows it has
        written) and PIN the matched chain, so pool pressure (a spill
        included) cannot take the rows its resume counts on. Returns
        ``(donated_ids, PrefixHandle or None)``; the engine releases the
        handle when the resume has acquired its own match or the request
        closes."""
        donated = self.commit_stream(tokens, block_ids, policy=policy)
        return donated, self.acquire(tokens)

    # ---- introspection ----

    def occupancy(self) -> dict:
        """Block occupancy: ``prefix`` blocks are trie-owned (evictable
        unless pinned), ``stream`` blocks are held by live streams,
        ``free`` includes the outstanding ``reserved`` promises;
        ``spilled`` counts the trie nodes whose rows are in the host
        tier."""
        with self._lock:
            free = len(self._free)
            return {
                "usable": self.n_blocks - 1,
                "free": free,
                "prefix": self._nodes,
                "stream": self.n_blocks - 1 - free - self._nodes,
                "reserved": self._reserved,
                "spilled": self._spilled,
            }

    def tier_snapshot(self) -> Optional[dict]:
        """The host tier's state with the spill and restore counts; None
        without a tier."""
        with self._lock:
            if self.tier is None:
                return None
            snap = self.tier.snapshot()
            snap.update({
                "spilled_nodes": self._spilled,
                "spills": self.tier_spills,
                "restores": self.tier_restores,
            })
            return snap

    def drain_tier(self) -> None:
        """Retire the tier's landed copies (once per engine
        iteration)."""
        with self._lock:
            if self.tier is not None:
                self.tier.drain()

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
                "spilled": self._spilled,
            }


# ----------------------------------------------------------- device pools

def _slot_proto(cfg, device, mesh=None) -> dict:
    """Every KV tensor of ``transformer.init_decode_state`` (``pos``
    left out) for zero slots: each ``[0, layers, max_seq] + tail`` in its
    dtype (k/v 5-D, the int8 scale tables 4-D), which the pools mirror;
    under ``mesh`` with this rank's KV heads (Hkv/tp)."""
    from client_tpu_torch.models import transformer as t

    proto = t.init_decode_state(cfg, 0, device, mesh)
    return {name: arr for name, arr in proto.items() if name != "pos"}


def init_block_pool(cfg, n_blocks: int, block_len: int, device,
                    mesh=None) -> dict:
    """The slot layout's prefix pool, block-major: every KV tensor of
    ``transformer.init_decode_state`` becomes ``[n_blocks, layers,
    block_len] + tail`` in its dtype (``k``/``v`` 5-D, and under
    ``kv_quant`` int8 with 4-D f32 scale tables), zeroed on ``device``.
    Under ``mesh`` the pool's layout is ``init_paged_pool``'s: this
    rank's KV heads of every block."""
    return {name: torch.zeros((n_blocks, arr.shape[1], block_len)
                              + arr.shape[3:], dtype=arr.dtype,
                              device=device)
            for name, arr in _slot_proto(cfg, device, mesh).items()}


def init_paged_pool(cfg, n_blocks: int, block_len: int, device,
                    mesh=None) -> dict:
    """Layer-major pool tensors: every KV tensor of
    ``transformer.init_decode_state`` becomes ``[layers, n_blocks,
    block_len] + tail`` in its dtype (``k``/``v`` 5-D, and under
    ``kv_quant`` int8 with 4-D f32 scale tables), zeroed on ``device``
    (named explicitly: the engine places it).

    Under an engine ``mesh`` (the port of ``pool_sharding_constraint``)
    the heads split over tp, as the slot rows' do, so a block copy stays
    on the rank's own heads; the blocks are REPLICATED over dp, since a
    pool block must be readable by a slot of any dp rank. The reference
    lets XLA keep the replicas equal; here every write reaches every
    replica: a decode step all-gathers its rows over dp
    (``transformer.paged_decode_steps``), a prefill chunk runs on every
    dp rank, and a slot-to-pool commit is broadcast from the slot's dp
    rank (``slot_to_pool``'s ``group``)."""
    return {name: torch.zeros((arr.shape[1], n_blocks, block_len)
                              + arr.shape[3:], dtype=arr.dtype,
                              device=device)
            for name, arr in _slot_proto(cfg, device, mesh).items()}


def pool_to_slot(pool: dict, cache: dict, pos, idx: int, ids,
                 n_tok: int) -> None:
    """Gather blocks ``ids`` ([B] integer tensor on the pool's device,
    scratch-padded) of every pool tensor (the scale tables too) into rows
    ``[0, B*block_len)`` of slot ``idx`` of the slot-layout ``cache`` and
    set ``pos[idx] = n_tok`` (the real matched length: padded rows past
    it are never attended), IN PLACE. The reference's ``pool_to_slot``
    copy kernel (an XLA gather)."""
    for name, parr in pool.items():
        blocks = parr[ids.long()]                 # [B, L, bl, Hkv, Dh]
        b, layers, bl = blocks.shape[:3]
        cache[name][idx, :, :b * bl] = blocks.transpose(0, 1).reshape(
            layers, b * bl, *blocks.shape[3:])
    pos[idx] = n_tok


def slot_to_pool(pool: dict, cache: Optional[dict], idx: Optional[int],
                 ids, offs, group=None, src: Optional[int] = None) -> None:
    """For each block ``j`` copy rows ``[offs[j], offs[j] + block_len)`` of
    slot ``idx`` into pool block ``ids[j]`` for every pool tensor, IN
    PLACE (``ids``/``offs`` [B] integer tensors on the pool's device;
    padded entries copy rows from offset 0 into the scratch block).
    Per-block offsets, as the reference's ``slot_to_pool`` copy kernel
    keeps them: one contiguous run padded to the bucket could pass
    ``max_seq``.

    With ``group``, the pool is replicated over the dp ranks of
    ``group``: the slot's dp rank (global rank ``src``) passes its
    ``cache`` and local ``idx``, the others pass None for both; the rows
    are broadcast from ``src`` and every rank writes its own replica."""
    import torch.distributed as dist

    for name, parr in pool.items():
        bl = parr.shape[2]
        if cache is not None:
            rows = offs.long()[:, None] + torch.arange(bl, device=offs.device)
            slot = cache[name][idx]               # [L, max_seq, Hkv, Dh]
            blocks = slot[:, rows]                # [L, B, bl, Hkv, Dh]
            blocks = blocks.transpose(0, 1).to(parr.dtype)
        else:
            blocks = torch.empty((ids.shape[0],) + tuple(parr.shape[1:]),
                                 dtype=parr.dtype, device=parr.device)
        if group is not None:
            blocks = blocks.contiguous()
            dist.broadcast(blocks, src=src, group=group)
        parr[ids.long()] = blocks


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


def pool_block_nbytes(pool: dict, layer_major: bool) -> int:
    """Bytes of one block's rows across every pool tensor: the host cost
    of one spilled block (the tier's sizing)."""
    total = 0
    for arr in pool.values():
        n_blocks = arr.shape[1] if layer_major else arr.shape[0]
        total += arr.numel() * arr.element_size() // max(1, n_blocks)
    return total


def tier_spill(pool: dict, bid: int, layer_major: bool) -> tuple:
    """Copy block ``bid`` of every pool tensor to the host: the rows
    ``[layers, block_len, Hkv, Dh]`` (``pool[name][:, bid]`` of the
    layer-major paged pool, ``pool[name][bid]`` of the block-major slot
    prefix pool). On the card into pinned memory with a non-blocking copy
    on the current stream, returning ``(rows, event)``: the event is
    recorded behind the copy, and the host reads the rows only once it
    has completed. On the CPU a plain copy, ``(rows, None)``."""
    rows, cuda = {}, False
    for name, parr in pool.items():
        src = parr[:, bid] if layer_major else parr[bid]
        if parr.is_cuda:
            cuda = True
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
        else:
            host = src.clone()
        rows[name] = host
    if not cuda:
        return rows, None
    ready = torch.cuda.Event()
    ready.record()
    return rows, ready


def tier_restore(pool: dict, bid: int, rows: dict,
                 layer_major: bool) -> None:
    """Copy a tier entry's rows back into pool block ``bid``, IN PLACE: on
    the card a non-blocking host-to-device copy on the current stream,
    behind the spill's copy of the same rows and ahead of every kernel
    enqueued later."""
    for name, parr in pool.items():
        dst = parr[:, bid] if layer_major else parr[bid]
        dst.copy_(rows[name], non_blocking=parr.is_cuda)


def pad_block_ids(block_ids: list, bucket: int) -> np.ndarray:
    """Pad a block-id vector to its bucket width with the scratch block
    (id 0): padded reads see rows nobody attends, padded writes land on
    rows nobody reads."""
    ids = np.zeros(bucket, np.int32)
    ids[:len(block_ids)] = block_ids
    return ids
