"""Continuous (in-flight) batching engine for autoregressive generation:
the port of ``client_tpu/server/generation.py``: its core, the prefix
cache with its host-RAM tier, speculative decoding, the closed-loop SLO
scheduler, the dedicated prefill lanes and the int8 KV cache.

Ragged concurrent streams share one fixed batch of S slots at token
granularity: every engine step feeds each active slot exactly one token,
the next prompt token while it is ingesting its prompt and its own
selected successor once it is decoding, so prefill and decode are one
uniform computation. Steps run in CHUNKS of ``chunk`` tokens per dispatch
(``chunk_kernel`` / ``paged_chunk_kernel``), and chunks are dispatched
ahead (``dispatch_depth``): the next chunk's inputs depend only on host
cursors, never on the previous chunk's token values, because the KV state
stays on the card.

Two KV data planes (``kv_layout``). ``"slot"`` (the default, as in the
reference) backs every slot with static ``[layers, max_seq, Hkv, Dh]``
rows of one ``[S, ...]`` state; a freed slot is recycled by resetting its
position, and attention is the einsum over all max_seq rows, masked at
the position. ``"paged"`` keeps K/V rows only in a layer-major block pool
(``kv_cache.init_paged_pool``), each slot addressing its sequence through
a host-side block table. A request reserves its worst-case block count at
admission, grows lazily, and frees its blocks on retire; admission and
retirement are table edits, never device copies. Attention reads the pool
through the tables: with ``attn_impl="flash"`` that is the paged decode
kernel (K2, ``ops/paged_attention.py``), once per layer per step.

Prefix cache (``prefix_cache``). A radix index over token-id blocks
(``kv_cache.RadixBlockIndex``) shares the K/V rows of prompt prefixes
across requests. On admission the longest full-block match is pinned and
the prompt resumes from its end; on retire the prompt's full blocks are
committed. Under the slot layout the committed rows live in a block pool
in front of the slots, reached through two copies (``pool_to_slot``,
``slot_to_pool``); under the paged layout the pool already holds them, so
a hit puts the shared blocks at the head of the slot's table and a commit
hands the stream's own blocks to the trie, with no copy either way.

Three ways to take in a prompt (``prefill_mode``). ``"token"`` feeds it
through the chunk kernel. ``"batched"`` (slot layout only) runs one
forward over the bucket-padded prompt at admission and writes the slot's
rows (``prefill_into_slot``). ``"chunked"`` ingests prompts longer than a
chunk through resumable bucketed chunks (``prefill_chunk_into_slot``,
``paged_prefill_chunk_into_slot``) dispatched ahead of each decode chunk,
at most ``prefill_token_budget`` prompt tokens per round, round robin over
the slots; while a slot's prompt rides that lane it is frozen in the
decode chunk. Greedy output is the same in all three.

Emitted tokens land in a device-resident token ring ([entries, S, chunk]
int32): each dispatch writes its entry, and the host fetches one ring
segment per ``fetch_stride`` dispatches with a non-blocking copy into
pinned memory plus a CUDA event, ENQUEUED ON THE SAME STREAM as the
kernels. Stream order is what keeps a later in-place ring write from
racing an outstanding copy (the reference had the ring's immutability for
that). A fetch is issued early before the ring could wrap an unfetched
entry. A stream whose every remaining token is already in flight frees
its slot at dispatch time, not when the fetch lands.

Nothing on the dispatch path reads a device value on the host (no
``.item()``, ``.cpu()`` or ``.tolist()``): one sync per dispatch would
undo the dispatch-ahead. Greedy output does not depend on
``fetch_stride`` or ``overlap``.

Speculative decoding (``speculative_draft``): once a slot's prompt is fully
dispatched it decodes in verify rounds (``spec_round``,
``paged_spec_round``) instead of chunk steps. A small draft model, with
slot-layout rows of its own on both layouts, proposes gamma tokens; ONE
target forward (``transformer.verify_steps`` / ``paged_verify_steps``,
the einsum attention, never K2) scores them; the accepted prefix plus one
token lands in a ring entry of its own with its count, and position
rollback is a rewrite of ``pos``. A round runs behind the same
iteration's chunk, in which its slot rides frozen, and touches no other
slot's rows. The host learns each advance only from the fetched counts
(``_retire_spec``), where it also corrects ``pos_hi``. A stream whose
rolling acceptance falls below ``speculative_min_acceptance``, or that
nears max_seq, latches to plain chunk decode.

Streaming context: a request may carry SLO labels, a deadline and a
cancel Event (``submit``). A deadline that passes or an Event that is set
ends the stream with a 504 or a 499; the slot, its paged blocks and its
prefix pins are freed at the next dispatch boundary (``_reap_slots``),
and a queued request is settled where it leaves the queue
(``_admissible``).

SLO statistics and scheduling: every engine resolves each request's
(tenant, slo_class) labels through its ``SloStats`` cardinality cap and
records its lifecycle per label (``server/slo_stats.py``). The pending
queue is a ``FairQueue``: one FIFO flow without a ``scheduler``, weighted
fair queuing across flows with one. A scheduler may preempt a running
lower-weight stream for a burning higher-weight head (``_maybe_preempt``:
every in-flight fetch is delivered first, the stream's extended context
is committed to the prefix cache and pinned, and it re-queues with its
generated tokens folded into its prompt), and its ``EngineController``
steers the live knobs (lane budget, fetch stride, duty, speculation) from
the classes' burn. ``dispatch_duty`` < 1 sleeps after each dispatch round
to cede the card ("pace").

Host tier (``host_tier_bytes``): evicted prefix blocks spill to pinned host
memory and a hit restores them (``kv_cache.HostTierStore``), both copies
enqueued on the engine's stream.

Dedicated prefill lanes (``prefill_slots`` > 0, chunked prefill only): a
second set of slots with its own device state (positions and pending first
tokens; under the slot layout its own KV rows) ingests prompts longer than
one decode chunk in ``prefill_lane_width``-token resumable chunks
(``prefill_lane_batch`` >= 2 packs several lane slots' chunks into one
``[B, Lc]`` dispatch, ``lane_batch_kernel`` / ``paged_lane_batch``), so the
decode chunk never carries a frozen prompt. A finished prompt hands off to
a free decode slot at the next admission pass: under the paged layout its
block table moves on the host and ``lane_handoff`` copies the position and
the first token on the engine's stream (no KV copy); under the slot layout
its full blocks commit from the lane's rows to the prefix pool, the chain
is acquired pinned, the lane's handle released, and ``pool_to_slot``
restores it into the decode slot, whose sub-block tail feeds token by
token.

int8 KV (``cfg.kv_quant``): every state, pool and tier entry carries the
scale tables beside the int8 rows; the paged decode step then takes the
dequantising einsum, never K2, as in the reference.

Observability: a request submitted with a sampled ``Trace`` gets the
reference's engine spans where the reference stamps them (enqueue, queue
wait, prefix hit, lane chunks and handoff, prefill end, verify rounds,
preemption, sampled ring deliveries, decode, a watchdog INCIDENT, an
ENGINE_RESTART when the engine dies under it); an untraced request costs
one ``is None`` test at each site. ``generation_snapshot`` is the
``/metrics`` feed (the counters, with the slot-busy integral and the
traced observations' exemplars, the live gauges, and the supervisor and
watchdog blocks), and ``healthy`` reads False once the engine thread died
on an unexpected error.

Runtime planes: every loop iteration records one host-counter snapshot in
the flight recorder (``server/runtime_stats.py``), dumped into the
failure log when the thread dies, and the watchdog (``server/watchdog.py``,
on by default as in the reference) evaluates its detectors over the same
host counters, recording evidence bundles into an incident store that a
supervised restart hands to the next engine. Neither reads a tensor: the
loop gains no synchronisation with the card. The reference's fault points
(``server/faultinject.py``) sit at its sites: ``engine_loop`` in the
loop, ``kernel_delay`` before a dispatch, ``ring_fetch`` at the ring's
D2H collect and ``queue_full`` at the submit door. A dead engine answers
a submit with the reference's three 503s (restarting, with
``Retry-After``; breaker tripped; unsupervised), and notifies its
``EngineSupervisor`` (``server/supervision.py``) last. The one signal the
port cannot read yet is None: ``unexpected_compiles`` (no compile set).

Goodput plane (``server/goodput.py``): every dispatch site notes its kind
and its useful and wasted FLOPs (the closed forms of
``models/transformer.py``) with the reference's kind labels and waste
reasons, a verify round's accepted and rejected rows at its retire; each
ring drain splits the wall since the previous one over the dispatches
issued in between, and an idle loop drops the mark. With
``device_time_sample_every=N`` every Nth dispatch of a kind also waits on
a CUDA event recorded behind its kernels. The tracker's snapshot is the
``goodput`` block of the snapshots, and its two shares are watchdog
signals and flight-record fields.

Placement: ``engine_devices`` (the reference's explicit-placement knob)
pins every tensor of the engine to one device, named by a CUDA index or a
``torch.device``; a replica fleet (``server/fleet.py``) builds one engine
per replica and reads ``load_depth`` to route. A subset of more than one
device, and ``mesh``, shard one engine over devices: they raise
``NotImplementedError`` naming ROADMAP item 9b (A15). An unknown
knob raises ``TypeError``; none is silently ignored.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from client_tpu_torch.device import resolve_device
from client_tpu_torch.models import transformer as t
from client_tpu_torch.models.sampling import (
    MAX_TOP_K,
    filtered_probs,
    select_token,
    step_gumbel,
    step_uniform,
)
from client_tpu_torch.server import faultinject
from client_tpu_torch.server import trace as trace_mod
from client_tpu_torch.server.goodput import (
    FlopModel,
    GoodputTracker,
    device_peak_flops,
)
from client_tpu_torch.server.kv_cache import (
    COMMIT_POLICIES,
    HostTierStore,
    RadixBlockIndex,
    block_count_buckets,
    init_block_pool,
    init_paged_pool,
    pad_block_ids,
    pool_block_nbytes,
    pool_to_slot,
    slot_to_pool,
    tier_restore,
    tier_spill,
)
from client_tpu_torch.server.model import (
    finish_host_copies,
    start_host_copies,
)
from client_tpu_torch.server.runtime_stats import (
    FlightRecorder,
    pytree_nbytes,
)
from client_tpu_torch.server.scheduling import (
    EngineController,
    FairQueue,
    SchedStats,
    resolve_scheduler,
)
from client_tpu_torch.server.slo_stats import (
    SloStats,
    objectives_from_configs,
)
from client_tpu_torch.server.speculation import (
    ACCEPT_SALT,
    DRAFT_SALT,
    RESIDUAL_SALT,
    RequestSpeculation,
    SpeculationController,
    spec_select,
)
from client_tpu_torch.server.stats import GenerationStats
from client_tpu_torch.server.types import (
    DEFAULT_SLO_CLASS,
    DEFAULT_TENANT,
    TENANT_ID_RE,
    ServerError,
    now_ns,
)
from client_tpu_torch.server.watchdog import (
    EVIDENCE_FLIGHT_TAIL,
    IncidentStore,
    Watchdog,
)

log = logging.getLogger(__name__)

# the ROADMAP item that shards one engine over devices (``mesh``, an
# ``engine_devices`` subset of more than one device); the mesh itself, the
# tensor-parallel layers and training are item 9a
MESH_REMAINDER = "item 9b (A15), the engine's mesh: sharding one engine " \
    "over devices"


def reject_unknown_knobs(knobs: dict) -> None:
    """Raise for the first knob of ``knobs``: none is the reference's."""
    for name in knobs:
        raise TypeError(f"unknown generation engine knob '{name}'")


# ---------------------------------------------------------------- device side

def _chunk_steps(step, pos, last, ring, ring_cnt, entry: int, feed, rem,
                 active, freeze, seeds, temps, topks, topps,
                 sample: bool) -> tuple:
    """The C uniform steps both chunk kernels share (the reference's
    ``lax.scan`` body, a Python loop here). ``step(tok, pos)`` feeds one
    token per slot at ``pos`` and returns the logits [S, vocab]. A slot
    advances (new ``last``, ``pos + 1``) while it is active and either
    feeds a prompt column or is not frozen; a frozen slot holds ``pos``
    and ``last`` once its prompt columns are consumed, and free slots park
    at position 0 (``freeze`` None: no slot is frozen). Writes the
    consumed tokens [S, C] into ring entry ``entry``; returns (new last,
    new pos)."""
    c = feed.shape[1]
    cols = []
    for i in range(c):
        prompt_col = rem > i
        tok = torch.where(prompt_col, feed[:, i], last)
        logits = step(tok, pos)
        if sample:
            nxt = select_token(logits, seeds, pos, temps, topks, topps)
        else:
            nxt = logits.argmax(dim=-1).to(torch.int32)
        if freeze is None:
            last = torch.where(active, nxt, last)
            nxt_pos = pos + 1
        else:
            advance = active & (prompt_col | ~freeze)
            last = torch.where(advance, nxt, last)
            nxt_pos = torch.where(advance, pos + 1, pos)
        pos = torch.where(active, nxt_pos, torch.zeros_like(pos))
        cols.append(tok)
    toks = torch.stack(cols, dim=1)
    n_emit = torch.where(active, c, 0).to(torch.int32)
    t.emit_into_ring(ring, ring_cnt, entry, toks, n_emit)
    return last, pos


def chunk_kernel(cfg, params: dict, cache: dict, pos, last, ring, ring_cnt,
                 entry: int, feed, rem, active, reset, freeze, seeds, temps,
                 topks, topps, sample: bool) -> tuple:
    """One engine chunk under the slot layout: C uniform steps over all S
    slots (the reference's ``chunk_kernel``), each a batched
    ``transformer.decode_step`` over the slots' own KV rows.

    cache {``k``, ``v``} [S, layers, max_seq, Hkv, Dh], written IN PLACE;
    pos [S] int32 device positions; last [S] int32 each slot's pending
    selected token; feed [S, C] int32 prompt tokens, of which the first
    rem[s] columns are real; active [S] bool; reset [S] bool: a
    (re)admitted slot's position is set to 0 first; freeze [S] bool or
    None (no slot frozen): a slot whose prompt ingestion rides the
    chunked-prefill lane holds its pos and last (its frozen steps write
    K/V at the held position, which its next lane chunk overwrites before
    attending); seeds/temps/topks/
    topps [S] per-slot sampling parameters; ``sample`` (host bool) False
    takes the argmax without the sampling machinery. Returns (new last,
    new pos)."""
    pos = torch.where(reset, torch.zeros_like(pos), pos)

    def step(tok, p):
        return t.decode_step(cfg, params, tok, {**cache, "pos": p})[0]

    return _chunk_steps(step, pos, last, ring, ring_cnt, entry, feed, rem,
                        active, freeze, seeds, temps, topks, topps, sample)


def paged_chunk_kernel(cfg, params: dict, pool: dict, pos, last, ring,
                       ring_cnt, entry: int, tables, feed, rem, active,
                       reset, reset_to, freeze, seeds, temps, topks, topps,
                       sample: bool, attention=None) -> tuple:
    """One engine chunk under the paged layout (the reference's
    ``paged_chunk_kernel``): ``chunk_kernel``'s steps with every KV write
    going through the block tables [S, Bw] int32 into the pool, IN PLACE,
    and attention reading them back (``transformer.paged_decode_steps``:
    the paged decode kernel K2 under ``attn_impl="flash"``, once per layer
    per step for every slot, frozen or free ones included).
    reset/reset_to [S]: a (re)admitted slot's position is set to reset_to
    first. ``attention`` overrides the attention function (the plain K2,
    for example). Free slots write scratch. Returns (new last, new
    pos)."""
    pos = torch.where(reset, reset_to, pos)

    def step(tok, p):
        return t.paged_decode_steps(cfg, params, tok, p, tables, pool,
                                    attention=attention)[0]

    return _chunk_steps(step, pos, last, ring, ring_cnt, entry, feed, rem,
                        active, freeze, seeds, temps, topks, topps, sample)


def _select_first(logits, pos, idx: int, sampling: tuple):
    """The first generated token after a prompt, by the engine's rule, at
    the prompt's last position ``pos[idx] - 1`` (read on the device: a
    host scalar would be copied to the card with a wait). ``sampling`` =
    (seed, temperature, top_k, top_p) as 0-d device tensors."""
    seed, temp, top_k, top_p = sampling
    return select_token(logits, seed, pos[idx] - 1, temp, top_k, top_p)


def prefill_into_slot(cfg, params: dict, cache: dict, pos, last, idx: int,
                      toks, plen: int, sampling: tuple) -> None:
    """``prefill_mode="batched"`` admission, one forward: the
    bucket-padded prompt ``toks`` through ``transformer.prefill``, the
    first token selected at ``plen - 1`` into ``last[idx]``, the bucket's
    K/V rows written into slot ``idx`` and its position set to ``plen``,
    all IN PLACE (the reference donates the state). Rows past the bucket
    keep stale K/V that decode overwrites before attending."""
    st, logits = t.prefill(cfg, params, toks, plen, pad_to_max=False)
    bucket = toks.shape[0]
    for name in cache:
        cache[name][idx, :, :bucket] = st[name]
    pos[idx] = plen
    last[idx] = _select_first(logits, pos, idx, sampling)


def prefill_chunk_into_slot(cfg, params: dict, cache: dict, pos, last,
                            idx: int, toks, pos0: int, clen: int,
                            final: bool, sampling: tuple) -> None:
    """One chunked-prefill lane dispatch under the slot layout: slot
    ``idx`` resumes its prompt at ``pos0`` with ``clen`` real tokens of the
    bucket-padded chunk ``toks`` (``transformer.prefill_chunk``, writing
    the chunk's rows into the slot's own rows), and its position becomes
    ``pos0 + clen``. The prompt's ``final`` chunk also selects the first
    generated token into ``last[idx]``, which the next decode chunk
    consumes."""
    slot_rows = {name: arr[idx] for name, arr in cache.items()}
    _, logits = t.prefill_chunk(cfg, params, toks, slot_rows, pos0, clen)
    pos[idx] = pos0 + clen
    if final:
        last[idx] = _select_first(logits, pos, idx, sampling)


def paged_prefill_chunk_into_slot(cfg, params: dict, pool: dict, pos, last,
                                  idx: int, table, toks, pos0: int,
                                  clen: int, final: bool,
                                  sampling: tuple) -> None:
    """``prefill_chunk_into_slot`` under the paged layout: the chunk's
    rows go through the slot's full-width block table ``table`` [B] into
    the pool (``transformer.paged_prefill_chunk``)."""
    _, logits = t.paged_prefill_chunk(cfg, params, toks, table, pos0, pool,
                                      clen)
    pos[idx] = pos0 + clen
    if final:
        last[idx] = _select_first(logits, pos, idx, sampling)


def _lane_batch_finish(logits, pos, last, rows, pos0s, clens, finals,
                       sampling: tuple) -> None:
    """The batched lane's bookkeeping on its state, IN PLACE: each row's
    lane slot ``rows[b]`` moves to position pos0s[b] + clens[b], and a
    row whose chunk ends its prompt (``finals``) selects the first
    generated token at its last position into ``last``. Padding rows
    point at the lane state's scratch entry."""
    seeds, temps, topks, topps = sampling
    end = pos0s + clens
    tok = select_token(logits, seeds, end - 1, temps, topks, topps)
    pos.index_put_((rows,), end.to(pos.dtype))
    last.index_put_((rows,), torch.where(finals, tok.to(last.dtype),
                                         last[rows]))


def lane_batch_kernel(cfg, params: dict, cache: dict, pos, last, rows, toks,
                      pos0s, clens, finals, sampling: tuple) -> None:
    """One batched dedicated-lane dispatch under the slot layout (the
    reference's ``lane_batch_kernel``): B lane slots' next chunks toks
    [B, Lc] through ``transformer.prefill_chunk_batch`` into their rows
    ``rows`` [B] of the lane state ``cache``, IN PLACE, at per-row
    offsets pos0s and real lengths clens, each final row selecting its
    stream's first token (``_lane_batch_finish``). Bucket padding rows
    carry the lane state's scratch row, whose writes nothing reads (the
    reference drops them with ``mode="drop"``; torch has no dropping
    scatter, and an out-of-range index is a device-side assert on the
    card)."""
    logits = t.prefill_chunk_batch(cfg, params, toks, cache, pos0s, clens,
                                   rows)
    _lane_batch_finish(logits, pos, last, rows, pos0s, clens, finals,
                       sampling)


def paged_lane_batch(cfg, params: dict, pool: dict, pos, last, rows, tables,
                     toks, pos0s, clens, finals, sampling: tuple) -> None:
    """``lane_batch_kernel`` under the paged layout (the reference's
    ``paged_lane_batch``): the rows' chunks go through their full-width
    block tables [B, b_max] into the shared pool
    (``transformer.paged_prefill_chunk_batch``), IN PLACE. Padding rows
    carry all-zero tables, so their writes land on scratch block 0, and
    the lane state's scratch entry for their position and token."""
    _, logits = t.paged_prefill_chunk_batch(cfg, params, toks, tables,
                                            pos0s, pool, clens)
    _lane_batch_finish(logits, pos, last, rows, pos0s, clens, finals,
                       sampling)


def lane_handoff(pos, last, lane_pos, lane_last, d: int, p: int) -> None:
    """The paged handoff's only device work (the reference's
    ``lane_handoff``): the finished prompt's position and selected first
    token move from lane slot ``p`` to decode slot ``d``, IN PLACE, on the
    engine's stream, behind the lane chunk that selected the token and
    ahead of the decode chunk that consumes it. The KV stays where it is
    in the pool; the block table moves on the host."""
    pos[d] = lane_pos[p]
    last[d] = lane_last[p]


def draft_prefill(dcfg, dparams: dict, dcache: dict, dpos, idx: int, toks,
                  plen: int) -> None:
    """The draft's catch-up on slot ``idx`` (the reference's
    ``draft_prefill``): the bucket-padded prompt ``toks`` through the
    draft's ``transformer.prefill``, the bucket's K/V rows written into the
    draft's slot rows and its position set to ``plen``, IN PLACE. Rows past
    ``plen`` keep K/V the position mask never attends."""
    st, _ = t.prefill(dcfg, dparams, toks, plen, pad_to_max=False)
    bucket = toks.shape[0]
    for name in dcache:
        dcache[name][idx, :, :bucket] = st[name]
    dpos[idx] = plen


def _propose(dcfg, dparams: dict, dstate: dict, rows, last, pos0,
             sampling: tuple, g: int, sample: bool) -> tuple:
    """The draft's G + 1 serial steps over the round's slots (the last one
    ingests the last proposal, so the draft's rows stay complete when every
    proposal is accepted), from each slot's pending token ``last``.
    Greedy proposals are the draft's argmax; sampled ones are drawn from
    its ``filtered_probs`` q with the noise of (seed, pos0 + i,
    DRAFT_SALT). Returns (proposals [N, G+1] int32, q [N, G+1, vocab] or
    None when greedy)."""
    seeds, temps, topks, topps = sampling
    tok, props, qs = last, [], []
    for i in range(g + 1):
        logits, dstate = t.decode_step(dcfg, dparams, tok, dstate, rows)
        if sample:
            q = filtered_probs(logits, temps, topks, topps)
            noise = step_gumbel(seeds, pos0 + i, q.shape[-1], DRAFT_SALT)
            logq = torch.where(q > 0, q.log(),
                               torch.full((), float("-inf"),
                                          device=q.device))
            tok = (logq + noise).argmax(dim=-1).to(torch.int32)
            qs.append(q)
        else:
            tok = logits.argmax(dim=-1).to(torch.int32)
        props.append(tok)
    return torch.stack(props, dim=1), (torch.stack(qs, dim=1) if sample
                                       else None)


def _accept(logits, props, qdist, pos0, sampling: tuple, g: int,
            sample: bool) -> tuple:
    """The round's acceptance over its N slots: greedy by exact argmax
    agreement of the leading proposals (the bonus or corrected token is
    the target's argmax after them); sampled by ``spec_select`` on the
    target's ``filtered_probs`` with the uniforms of (seed, pos0 + 1 + i,
    ACCEPT_SALT) and the residual noise of (seed, pos0, RESIDUAL_SALT).
    Returns (n_accepted [N] int64, next token [N] int32)."""
    if not sample:
        tgt = logits.argmax(dim=-1)                            # [N, G+1]
        match = (props[:, :g].long() == tgt[:, :g]).long()
        n_acc = match.cumprod(dim=-1).sum(dim=-1)
        return n_acc, tgt.gather(1, n_acc[:, None])[:, 0].to(torch.int32)
    seeds, temps, topks, topps = sampling
    pdist = filtered_probs(logits, temps[:, None], topks[:, None],
                           topps[:, None])
    steps = torch.arange(g, device=logits.device)
    accept_u = step_uniform(seeds[:, None], pos0[:, None] + 1 + steps,
                            ACCEPT_SALT)
    residual = step_gumbel(seeds, pos0, logits.shape[-1], RESIDUAL_SALT)
    return spec_select(pdist, qdist[:, :g], props[:, :g], accept_u,
                       residual)


def _finish_round(pos, dpos, last, ring, ring_cnt, entry: int, rows, pos0,
                  toks_in, n_acc, nxt) -> tuple:
    """Rollback and emission: the round's slots move to pos0 + 1 + n_acc
    (target and draft alike; the rejected rows beyond are un-attended and
    overwritten before they are read), take ``nxt`` as their pending
    token, and ring entry ``entry`` gets each slot's [pending, proposals]
    row with 1 + n_acc tokens counted (0 for the other slots, whose pos,
    last and draft pos are left as they were). Returns (last, pos, draft
    pos), new tensors: none aliases another, since the admission paths
    write them in place."""
    new_pos = (pos0 + 1 + n_acc).to(torch.int32)
    n_out = (1 + n_acc).to(torch.int32)
    if rows is None:
        toks, counts = toks_in, n_out
        pos, dpos, last = new_pos, new_pos.clone(), nxt
    else:
        toks = torch.zeros((pos.shape[0], toks_in.shape[1]),
                           dtype=torch.int32, device=pos.device)
        toks[rows] = toks_in
        counts = torch.zeros_like(pos).index_put((rows,), n_out)
        pos = pos.index_put((rows,), new_pos)
        dpos = dpos.index_put((rows,), new_pos)
        last = last.index_put((rows,), nxt)
    t.emit_into_ring(ring, ring_cnt, entry, toks, counts)
    return last, pos, dpos


def _round(verify, dcfg, dparams: dict, pos, dcache: dict, dpos, last,
           ring, ring_cnt, entry: int, rows, sampling: tuple, g: int,
           sample: bool) -> tuple:
    """The round both layouts share: the draft proposes G tokens per slot
    (``_propose``), ``verify(toks [N, G+1], pos0 [N])`` scores the G + 1
    tokens [pending, proposals] in ONE target forward, and ``_accept`` and
    ``_finish_round`` keep the accepted prefix plus one token."""
    pos0 = pos if rows is None else pos[rows]
    lst = last if rows is None else last[rows]
    props, qdist = _propose(dcfg, dparams, {**dcache, "pos": dpos}, rows,
                            lst, pos0, sampling, g, sample)
    toks_in = torch.cat([lst[:, None], props[:, :g]], dim=1)
    logits = verify(toks_in, pos0)
    n_acc, nxt = _accept(logits, props, qdist, pos0, sampling, g, sample)
    return _finish_round(pos, dpos, last, ring, ring_cnt, entry, rows, pos0,
                         toks_in, n_acc, nxt)


def spec_round(cfg, dcfg, params: dict, dparams: dict, cache: dict, pos,
               dcache: dict, dpos, last, ring, ring_cnt, entry: int, rows,
               sampling: tuple, g: int, sample: bool) -> tuple:
    """One speculative round at verify depth ``g`` under the slot layout
    (the reference's ``spec_round``): ``_round`` with the verify
    ``transformer.verify_steps`` against the slots' own rows.

    ``rows`` [N] int64 the round's slots (None: all S); every other slot's
    target and draft K/V rows, pos and last stay bit-unchanged, including
    rows the same iteration's chunk just wrote. ``sampling`` = (seeds,
    temps, top_ks, top_ps) [N] of the round's slots; ``sample`` (a host
    bool) False takes the greedy rule with no distribution machinery.
    cache/dcache {k, v} and the ring are written IN PLACE. Returns (last,
    pos, draft pos)."""
    def verify(toks, _pos0):
        return t.verify_steps(cfg, params, toks, {**cache, "pos": pos},
                              rows)[0]

    return _round(verify, dcfg, dparams, pos, dcache, dpos, last, ring,
                  ring_cnt, entry, rows, sampling, g, sample)


def paged_spec_round(cfg, dcfg, params: dict, dparams: dict, pool: dict,
                     pos, dcache: dict, dpos, last, ring, ring_cnt,
                     entry: int, tables, rows, sampling: tuple, g: int,
                     sample: bool) -> tuple:
    """``spec_round`` under the paged layout (the reference's
    ``paged_spec_round``): the draft is a slot-layout pool as there, and
    the verify is ONE ``transformer.paged_verify_steps`` of ALL S slots
    through their tables [S, Bw] into the pool, IN PLACE, with ``write``
    the round's mask. As in the reference, the slots outside the round
    (``rows`` [N] the round's, None: all S) feed [pending, the draft's
    greedy proposals] and send their slab writes to scratch block 0:
    their proposals come from a gathered copy of their draft rows (the
    reference's vmapped draft runs them and keeps nothing), so their own
    rows stay bit-unchanged, and a round that runs past its stream's
    reservation reads the scratch rows the reference's reads. Returns
    (last, pos, draft pos)."""
    def verify(toks, pos0):
        if rows is None:
            return t.paged_verify_steps(cfg, params, toks, pos0, tables,
                                        pool)[0]
        write = torch.zeros_like(pos, dtype=torch.bool)
        write[rows] = True
        # the outside slots in ascending order, with no host sync
        other = torch.argsort(write.to(torch.int8), stable=True)[
            :pos.shape[0] - toks.shape[0]]
        dcopy = {name: arr[other] for name, arr in dcache.items()}
        props, _ = _propose(dcfg, dparams, {**dcopy, "pos": dpos[other]},
                            None, last[other], pos[other], sampling, g,
                            False)
        full = torch.empty((pos.shape[0], toks.shape[1]), dtype=toks.dtype,
                           device=toks.device)
        full[other] = torch.cat([last[other, None], props[:, :g]], dim=1)
        full[rows] = toks
        return t.paged_verify_steps(cfg, params, full, pos, tables, pool,
                                    write)[0][rows]

    return _round(verify, dcfg, dparams, pos, dcache, dpos, last, ring,
                  ring_cnt, entry, rows, sampling, g, sample)


# ---------------------------------------------------------------- host side

class _Request:
    __slots__ = ("prompt", "budget", "eos_id", "temperature", "top_k",
                 "top_p", "seed", "out", "emitted", "finished",
                 "enqueue_ns", "first_token_ns", "last_emit_ns",
                 "queue_wait_ns", "base_plen", "cap_tokens", "gen_tokens",
                 "preempt_count", "resume_pending", "resume_pin",
                 "park_bypasses", "parked", "prefix", "spec", "tenant",
                 "slo_class", "deadline_ns", "cancel_ev", "outcome",
                 "trace")

    def __init__(self, prompt: np.ndarray, budget: int, eos_id: int,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0, trace=None,
                 tenant: str = DEFAULT_TENANT,
                 slo_class: str = DEFAULT_SLO_CLASS,
                 deadline_ns: int = 0, cancel_ev=None):
        self.prompt = prompt
        self.budget = budget
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.trace = trace          # the sampled Trace or None (the core's)
        self.out: queue.Queue = queue.Queue()
        self.emitted = 0
        self.finished = False
        self.enqueue_ns = 0
        self.first_token_ns = 0
        self.last_emit_ns = 0
        self.queue_wait_ns = 0    # set at slot admission
        # a preemption folds the generated tokens into ``prompt``:
        # base_plen keeps the wire prompt's length for the budget, and
        # cap_tokens (the paged reservation bound) stays the stream's
        # worst case, the wire prompt plus the budget
        self.base_plen = len(prompt)
        self.cap_tokens = len(prompt) + budget
        # emitted token values not folded yet (kept only on engines that
        # preempt), the preemptions so far (bounded by max_preemptions),
        # whether the next admission resumes, and the pin on the chain
        # the preemption committed (released at that admission or close)
        self.gen_tokens = None
        self.preempt_count = 0
        self.resume_pending = False
        self.resume_pin = None
        # a parked paged reservation (waiting at its flow's head for
        # blocks) and how many admissions of other flows passed it
        self.parked = False
        self.park_bypasses = 0
        self.prefix = None        # the pinned PrefixHandle of a cache hit
        self.spec = None          # RequestSpeculation when speculating
        # the RESOLVED SLO labels (after the SloStats cardinality cap), so
        # every record of this stream lands under one key
        self.tenant = tenant
        self.slo_class = slo_class
        # bounded lifetime: the absolute monotonic-ns deadline from the
        # wire ``timeout`` (0 = none) and an optional Event a front end
        # sets when the caller goes away; ``outcome`` records how the
        # stream ended: completed, failed, cancelled or deadline
        self.deadline_ns = deadline_ns
        self.cancel_ev = cancel_ev
        self.outcome = None


class _Slot:
    __slots__ = ("req", "cursor", "pos_hi", "decode_dispatched", "blocks",
                 "n_shared", "reserved_left", "pos_pending", "draft_ready",
                 "adm_seq")

    def __init__(self):
        self.req: Optional[_Request] = None
        # a lane slot's admission order: handoffs go oldest first
        self.adm_seq = 0
        self.cursor = 0           # prompt tokens already dispatched
        # upper bound of the slot's device position over everything
        # dispatched so far (+chunk per dispatch, +rung + 1 per verify
        # round, corrected to the real advance when the round retires);
        # it gates speculation near max_seq
        self.pos_hi = 0
        # the draft model's rows hold this request's prompt (its catch-up
        # was dispatched)
        self.draft_ready = False
        # generated-token columns dispatched: once they cover the budget
        # every token the stream may still emit is in flight
        self.decode_dispatched = 0
        # pool block ids in position order (entry i covers rows
        # [i*block_len, (i+1)*block_len)), of which the first n_shared are
        # the trie's (a prefix hit's chain, read-only and pinned through
        # the request), the admission reservation not yet drawn, and the
        # position the next dispatch resets the slot to (admission is a
        # table edit; the reset rides the next kernel)
        self.blocks: list = []
        self.n_shared = 0
        self.reserved_left = 0
        self.pos_pending: Optional[int] = None


class ContinuousBatchingEngine:
    """Multiplexes ragged generation requests onto a fixed slot batch.

    ``submit`` returns an iterator of generated token ids, greedy by
    default or sampled per request (temperature / top-k / top-p / seed,
    ``models/sampling.py``); the stream ends at EOS or after
    ``max_new_tokens``. Thread-safe: any number of threads may submit.

    ``device`` places the weights, the pool and the ring; None means CUDA
    and raises without it (the CPU is used only when asked for). The
    knobs are the reference's: ``n_slots``, ``chunk``, ``dispatch_depth``
    (fetches issued ahead of delivery), ``queue_depth`` and
    ``shed_on_full`` (503 instead of blocking when the queue is full),
    ``fetch_stride``/``overlap``/``ring_entries`` (the ring fetch
    cadence), ``kv_layout`` (``"slot"`` or ``"paged"``),
    ``kv_block_len``/``kv_pool_blocks``/``kv_max_blocks_per_slot`` (the
    paged pool), ``prefill_mode`` (``"token"``, ``"batched"`` or
    ``"chunked"``; the legacy ``prefill`` bool maps True to
    ``"batched"``, and ``prefill_mode`` wins when both are given),
    ``prefill_chunk`` (the largest lane chunk; buckets of powers of two
    from 8 up to it), ``prefill_token_budget`` (lane tokens per round,
    0 = one ``prefill_chunk``; a budget below the chunk dispatches
    budget-sized chunks), and the prefix cache: ``prefix_cache``,
    ``prefix_blocks`` (the slot layout's pool; the paged pool is the
    prefix pool), ``prefix_block_len`` (the reuse granularity; under the
    paged layout it must equal ``kv_block_len``) and
    ``prefix_commit_policy`` (``"all"`` evicts LRU leaves for room,
    ``"no-evict"`` takes free blocks only, ``"none"`` keeps the pool
    read-only).

    Speculative decoding: with a ``speculative_draft``
    (``speculation.DraftModel``) and ``speculative_gamma`` >= 1, a slot
    whose prompt is fully dispatched runs verify rounds instead of chunk
    steps: the draft proposes gamma tokens, one target forward scores
    them, and the accepted prefix plus one token is emitted (greedy
    streams are token-identical; sampled ones keep the target
    distribution). ``speculative_min_acceptance`` latches a stream whose
    rolling acceptance falls below it to plain decode (0: never), as is a
    stream within gamma + 1 positions of max_seq;
    ``speculative_gamma_ladder`` runs each stream at a rung of {1, 2, 4,
    8} up to gamma (plus gamma) picked from its acceptance. Gamma 0 or no
    draft is plain decode.

    SLO statistics and scheduling: ``slo_classes`` (a {name:
    ``SloObjective``} dict or a list of ``SloClassConfig``/dicts) declares
    the objectives each class's windowed burn is judged against,
    ``slo_window_s`` sizes the window and ``slo_max_tenants`` caps the
    distinct tenant labels (later ones collapse into ``__other__``).
    ``scheduler`` (a ``SchedulerConfig``, its dict form or True; None is
    the FIFO engine) orders admission by weighted fair queuing, sheds the
    lowest-weight newest queued request before a higher-weight arrival
    when ``shed_on_full`` finds the queue full, may preempt running
    streams (``preemption``, which needs ``prefix_cache`` with a writable
    commit policy) and runs the burn controller (``controller``).
    ``dispatch_duty`` in (0, 1] is the share of wall time the engine may
    keep the card busy: below 1 it sleeps ``(1/duty - 1)`` of a round's
    time after each round. ``host_tier_bytes`` > 0 (with ``prefix_cache``)
    spills evicted prefix blocks to a host-RAM store of that size and
    restores them on a hit.

    Dedicated prefill lanes: ``prefill_slots`` > 0 (with
    ``prefill_mode="chunked"``; under the slot layout also the prefix cache
    with a writable commit policy, whose pool carries the handoff) adds
    that many lane slots, which ingest prompts longer than one chunk in
    ``prefill_lane_width``-token chunks (0: ``prefill_chunk``) within the
    round's ``prefill_token_budget`` and hand them to decode slots;
    ``prefill_lane_batch`` >= 2 packs up to that many lane slots' chunks
    into one dispatch. Greedy output is the same as the piggyback lane's.
    int8 KV comes with the config (``cfg.kv_quant``).

    The watchdog: ``watchdog`` (on by default) samples the loop's host
    counters every ``watchdog_interval_s`` and runs the reference's
    detectors with ``watchdog_thresholds`` over the defaults, recording
    into ``incident_store`` (a fresh store when None; the generator
    passes one store shared across restarts)."""

    PREFILL_MODES = ("token", "batched", "chunked")
    KV_LAYOUTS = ("slot", "paged")

    def __init__(self, cfg, params, n_slots: int = 8, chunk: int = 8,
                 dispatch_depth: int = 2, queue_depth: int = 256,
                 prefill: bool = False, prefill_mode: Optional[str] = None,
                 prefill_chunk: int = 64, prefill_token_budget: int = 0,
                 prefill_slots: int = 0, prefill_lane_width: int = 0,
                 prefill_lane_batch: int = 0, fetch_stride: int = 4,
                 overlap: bool = True, ring_entries: int = 0,
                 kv_layout: str = "slot",
                 kv_block_len: int = 16, kv_pool_blocks: int = 0,
                 kv_max_blocks_per_slot: int = 0,
                 prefix_cache: bool = False, prefix_blocks: int = 256,
                 prefix_block_len: int = 16,
                 prefix_commit_policy: str = "all",
                 speculative_draft=None, speculative_gamma: int = 4,
                 speculative_min_acceptance: float = 0.0,
                 speculative_gamma_ladder: bool = False,
                 host_tier_bytes: int = 0, dispatch_duty: float = 1.0,
                 slo_classes=None, slo_window_s: float = 30.0,
                 slo_max_tenants: int = 32, scheduler=None,
                 shed_on_full: bool = False, watchdog: bool = True,
                 watchdog_interval_s: float = 0.25,
                 watchdog_thresholds: Optional[dict] = None,
                 incident_store: Optional[IncidentStore] = None,
                 device_time_sample_every: int = 0,
                 device=None, name: str = "generation-engine",
                 engine_devices=None, mesh=None, **unknown):
        reject_unknown_knobs(unknown)
        pinned = self.resolve_engine_devices(engine_devices, mesh)
        if chunk < 1 or n_slots < 1:
            raise ValueError("n_slots and chunk must be >= 1")
        if fetch_stride < 1:
            raise ValueError("fetch_stride must be >= 1")
        if ring_entries < 0:
            raise ValueError("ring_entries must be >= 0 (0 = auto)")
        if ring_entries == 1:
            raise ValueError("ring_entries must be >= 2 (0 = auto)")
        if not 0.0 < dispatch_duty <= 1.0:
            raise ValueError("dispatch_duty must be in (0, 1]")
        if speculative_draft is not None and speculative_gamma > 0:
            speculative_draft.assert_compatible(cfg)
            if speculative_gamma + 1 >= cfg.max_seq:
                raise ValueError(
                    f"speculative_gamma {speculative_gamma} leaves no "
                    f"room for a verify round within max_seq "
                    f"{cfg.max_seq}")
            self._draft = speculative_draft
            self._spec: Optional[SpeculationController] = \
                SpeculationController(speculative_gamma,
                                      speculative_min_acceptance)
            self._gamma = int(speculative_gamma)
        else:
            # gamma 0 or no draft: plain decode (the knobs still validate)
            SpeculationController(speculative_gamma,
                                  speculative_min_acceptance)
            self._draft = None
            self._spec = None
            self._gamma = 0
        # the verify depths rounds may run at; the live ceiling bounds the
        # rungs a stream may pick (0: speculation off), and a re-enable
        # restores the last nonzero one
        self._spec_ladder = self.resolve_gamma_ladder(
            self._gamma, speculative_gamma_ladder)
        self._gamma_ceiling = self._gamma
        self._gamma_restore = self._gamma
        # the boolean gate of a draftless engine (nothing to ladder)
        self._spec_enabled_flag = True
        mode = self.resolve_prefill_mode(prefill, prefill_mode)
        (self._kv_layout, self._kv_block_len, self._kv_pool_blocks,
         self._kv_max_blocks) = self.resolve_kv_layout(
            cfg, n_slots, kv_layout, kv_block_len, kv_pool_blocks,
            kv_max_blocks_per_slot, mode, prefix_cache, prefix_block_len)
        self._paged = self._kv_layout == "paged"
        self.resolve_prefix(cfg, self._kv_layout, prefix_cache,
                            prefix_block_len, prefix_commit_policy)
        # _kv_index is the paged layout's block allocator and the prefix
        # cache's trie, one object when both are on (they share the paged
        # pool at kv_block_len); _prefix_index marks prefix matching on
        if prefix_cache or self._paged:
            self._kv_index: Optional[RadixBlockIndex] = RadixBlockIndex(
                self._kv_pool_blocks if self._paged else prefix_blocks,
                self._kv_block_len if self._paged else prefix_block_len)
        else:
            self._kv_index = None
        self._prefix_index = self._kv_index if prefix_cache else None
        self._prefix_blocks = prefix_blocks
        self._prefix_block_len = (self._kv_block_len if self._paged
                                  else prefix_block_len)
        self._prefix_policy = prefix_commit_policy
        # the scheduler (None: the FIFO engine), resolved by the rule the
        # generator's config block uses
        self._sched = resolve_scheduler(scheduler, prefix_cache,
                                        prefix_commit_policy)
        self._preempt_on = bool(self._sched and self._sched.preemption)
        # a live override of the configured preempt threshold (None: the
        # configured value)
        self._preempt_threshold_override: Optional[float] = None
        self._sched_stats = SchedStats() if self._sched else None
        self._controller = (
            EngineController(self._sched.burn_high, self._sched.burn_low,
                             self._sched.controller_hold_rounds,
                             self._sched.min_prefill_token_budget)
            if self._sched is not None and self._sched.controller
            else None)
        # the host tier's budget (0: none); the store is built with the
        # pool in _ensure_ready
        self._host_tier_bytes = self.resolve_host_tier(host_tier_bytes,
                                                       prefix_cache)
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if prefill_token_budget < 0:
            raise ValueError("prefill_token_budget must be >= 0 "
                             "(0 = one prefill_chunk per round)")
        if mode == "chunked" and prefill_chunk > cfg.max_seq:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} exceeds max_seq "
                f"{cfg.max_seq}")
        self._prefill_mode = mode
        self._prefill_enabled = mode == "batched"
        self._chunked_prefill = mode == "chunked"
        self._prefill_chunk_len = int(prefill_chunk)
        self._prefill_budget = self.resolve_prefill_budget(
            mode, prefill_chunk, prefill_token_budget)
        self._prefill_chunks_dispatched = 0
        self._prefill_tokens_dispatched = 0
        self._lane_rr = 0         # rotating lane scan start (engine thread)
        # the dedicated prefill lane (0 slots: the piggyback lane): its own
        # slots and device state, its own chunk ladder, and the batched
        # dispatch width (0: one lane slot per dispatch)
        self._lane_n, self._lane_width = self.resolve_disagg(
            cfg, mode, prefill_slots, prefill_lane_width, prefill_chunk,
            self._kv_layout, prefix_cache, prefix_commit_policy)
        self._lane_on = self._lane_n > 0
        self._lane_slots = [_Slot() for _ in range(self._lane_n)]
        self._lane_adm_seq = 0
        self._lane_handoffs = 0
        self._lane_batch = self.resolve_lane_batch(self._lane_n,
                                                   prefill_lane_batch)
        self._device = (pinned if pinned is not None
                        else resolve_device(device))
        if self._device.type == "cuda" and self._device.index is None:
            # the engine thread sets its current device, which needs an
            # index: the caller's current card
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._cfg = cfg
        self._params_host = params
        self._n_slots = n_slots
        self._chunk = chunk
        self._depth = max(1, dispatch_depth)
        self._overlap = bool(overlap)
        # an iteration appends a chunk entry and one verify entry per
        # ladder rung; a verify entry is gamma + 1 tokens wide
        self._entries_per_iter = self.ring_entries_per_iter(
            self._spec_ladder)
        self._ring_width = max(chunk, self._gamma + 1)
        self._stride, self._ring_entries = self.ring_shape(
            fetch_stride, overlap, dispatch_depth, ring_entries,
            self._entries_per_iter)
        # the ring is sized for the configured stride; the live stride
        # (set_fetch_stride, the controller) may only go below it
        self._stride_cfg = self._stride
        # how many issued (async) fetches may ride ahead of delivery
        self._fetch_depth = self._depth if self._overlap else 0
        self._ring_seq = 0        # next ring entry to write
        self._retired_seq = 0     # first entry not yet delivered
        # emit stamps: an EWMA of one dispatch's wall time from fetch
        # arrivals back-dates each delivered entry, so stride-k fetching
        # does not inflate TTFT/ITL
        self._chunk_ns_ewma = 0.0
        self._last_drain: Optional[tuple] = None   # (newest seq, ns)
        self._deliver_ns = 0
        # dispatched entries no fetch covers yet / issued fetches
        self._unfetched: list = []
        self._fetches: collections.deque = collections.deque()
        self._held: Optional[_Request] = None   # popped, not yet admitted
        # one FIFO flow without a scheduler; weighted fair queuing across
        # (tenant, slo_class) flows with one
        self._pending = FairQueue(
            maxsize=queue_depth, fair=self._sched is not None,
            weight_fn=lambda key: self._class_weight(key[1]))
        self._queue_depth = queue_depth
        self._shed_on_full = bool(shed_on_full)
        self._slots = [_Slot() for _ in range(n_slots)]
        self._lock = threading.Lock()
        self._started = False
        self._stopping = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._dev: dict = {}
        self._duty = float(dispatch_duty)
        self._loop_ewma_s = 0.0   # EWMA of a busy loop iteration
        # engine-thread wall time by phase (seconds): admit (slot fill,
        # batched prefill included), dispatch (host batch build + kernel
        # enqueue), prefill (the chunked lane's dispatches), retire_fetch
        # (blocking on the ring D2H), retire_deliver (token distribution),
        # pace (duty sleeps) and, on tier-armed engines only, tier (the
        # host time of enqueuing spills and restores)
        self._phase_s = {"admit": 0.0, "dispatch": 0.0, "prefill": 0.0,
                         "retire_fetch": 0.0, "retire_deliver": 0.0,
                         "pace": 0.0}
        if self._host_tier_bytes:
            self._phase_s["tier"] = 0.0
        # stream time between CUDA events around each dispatch's kernels
        # (with a host-bound loop this is the enqueue time, not busy time)
        self._dispatch_event_ms = 0.0
        self._timed_dispatches = 0
        # every dispatch (chunk and verify round), as the reference counts
        self._chunks_dispatched = 0
        # engine-thread host seconds and count of each dispatch kind (the
        # dedicated lane's per-slot and batched chunks and its handoffs
        # beside the chunks, verify rounds and draft catch-ups)
        kinds = ("chunk", "spec", "draft_prefill", "lane", "lane_batch",
                 "handoff")
        self._kind_s = dict.fromkeys(kinds, 0.0)
        self._kind_n = dict.fromkeys(kinds, 0)
        self._tokens_emitted = 0
        self._requests_completed = 0
        # accepted == closed (under _lock) is drain()'s idleness criterion
        self._requests_accepted = 0
        self._requests_closed = 0
        self._failed: Optional[BaseException] = None
        self.name = name
        self.gen_stats = GenerationStats()
        # per-(tenant, slo_class) windowed quantiles, burn and outcome
        # counts, fed from the same lifecycle stamps as gen_stats
        objectives = (dict(slo_classes) if isinstance(slo_classes, dict)
                      else objectives_from_configs(slo_classes))
        self.slo_stats = SloStats(objectives, window_s=slo_window_s,
                                  max_tenants=slo_max_tenants)
        # slot admissions (a watchdog signal) and the verify depths the
        # last round dispatched (a flight-record field)
        self._admissions = 0
        self._rungs_last: list = []
        # the runtime plane: the last iterations' host counters, dumped
        # when the thread dies, and the card-memory ledger of what this
        # engine placed (filled once its state is built)
        self.flight = FlightRecorder()
        self._mem_attr: dict = {}
        # the goodput plane: per-kind device time by the ring-fetch
        # cadence (plus the opt-in synchronous sample every Nth dispatch)
        # and the useful-against-wasted FLOPs of every dispatch; the MFU
        # denominator is this engine's card's peak (None on the CPU, and
        # the MFU pair stays unregistered)
        self.goodput = GoodputTracker(
            sample_every=device_time_sample_every,
            peak_flops=device_peak_flops(self._device))
        self._flop_model = FlopModel(cfg)
        self._draft_flop_model = (FlopModel(speculative_draft.cfg)
                                  if speculative_draft is not None else None)
        # in-flight verify rounds' FLOP context (engine thread only): ring
        # seq -> (kind, [(slot, pos0)]); the useful and rejected rows are
        # known at the retire, when the accepted counts arrive
        self._spec_gp: dict = {}
        # set by an EngineSupervisor that owns this engine: a dying
        # engine notifies it last (server/supervision.py)
        self.supervisor = None
        # the watchdog: detectors over the loop's host counters, firing
        # evidence bundles into a store that outlives this engine (the
        # generator hands one store to every engine it builds)
        self.incidents = incident_store
        self._watchdog: Optional[Watchdog] = None
        if watchdog:
            if self.incidents is None:
                self.incidents = IncidentStore()
            self._watchdog = Watchdog(
                engine=name, store=self.incidents,
                interval_s=watchdog_interval_s,
                thresholds=watchdog_thresholds)

    # ---------------------------------------------------------- resolution

    @staticmethod
    def resolve_kv_layout(cfg, n_slots: int, kv_layout: str,
                          kv_block_len: int, kv_pool_blocks: int,
                          kv_max_blocks_per_slot: int,
                          prefill_mode: str, prefix_cache: bool = False,
                          prefix_block_len: int = 16) -> tuple:
        """Validate the KV layout knobs; returns ``(layout, block_len,
        pool_blocks, max_blocks_per_slot)``, the paged knobs 0 under the
        slot layout. ``kv_block_len`` must divide ``max_seq``;
        ``prefill_mode="batched"`` is refused under the paged layout (the
        monolithic prefill writes whole slot rows, and a paged engine has
        none); with ``prefix_cache`` on, ``prefix_block_len`` must equal
        ``kv_block_len`` there (decode and the cache share one pool);
        ``kv_pool_blocks`` 0 sizes the pool for n_slots x max_seq tokens
        plus the scratch block; ``kv_max_blocks_per_slot`` 0 covers
        max_seq."""
        if kv_layout not in ContinuousBatchingEngine.KV_LAYOUTS:
            raise ValueError(
                f"unknown kv_layout {kv_layout!r} (expected one of "
                f"{ContinuousBatchingEngine.KV_LAYOUTS})")
        if kv_layout == "slot":
            return ("slot", 0, 0, 0)
        bl = int(kv_block_len)
        if bl < 1 or cfg.max_seq % bl:
            raise ValueError(
                f"kv_block_len {bl} must be >= 1 and divide max_seq "
                f"{cfg.max_seq} (paged block tables must cover the "
                f"context exactly)")
        if prefill_mode == "batched":
            raise ValueError(
                'prefill_mode="batched" is unsupported under '
                'kv_layout="paged": the monolithic prefill writes whole '
                'slot rows and a paged engine has no slot arrays; use '
                'prefill_mode="chunked" (the lane writes through the block '
                'tables) or "token"')
        if prefix_cache and int(prefix_block_len) != bl:
            raise ValueError(
                f'kv_layout="paged" shares one block pool between decode '
                f'and the prefix cache: prefix_block_len {prefix_block_len} '
                f'must equal kv_block_len {bl}')
        b_max = cfg.max_seq // bl
        mb = int(kv_max_blocks_per_slot) or b_max
        if not 0 < mb <= b_max:
            raise ValueError(
                f"kv_max_blocks_per_slot {mb} must be in (0, "
                f"max_seq/kv_block_len={b_max}]")
        pool = int(kv_pool_blocks) or n_slots * b_max + 1
        if pool < 2:
            raise ValueError(
                "kv_pool_blocks must be >= 2 (block 0 is reserved scratch)")
        return ("paged", bl, pool, mb)

    @staticmethod
    def resolve_prefix(cfg, kv_layout: str, prefix_cache: bool,
                       prefix_block_len: int,
                       prefix_commit_policy: str) -> None:
        """Validate the prefix-cache knobs wherever the engine builds an
        index (``prefix_cache`` on, or the paged layout, whose allocator
        is the index): the commit policy must be known, and under the
        slot layout ``0 < prefix_block_len < max_seq`` (the paged rule is
        ``resolve_kv_layout``'s)."""
        if not (prefix_cache or kv_layout == "paged"):
            return
        if prefix_commit_policy not in COMMIT_POLICIES:
            raise ValueError(
                f"unknown prefix_commit_policy {prefix_commit_policy!r} "
                f"(expected one of {COMMIT_POLICIES})")
        if kv_layout == "slot" and not 0 < prefix_block_len < cfg.max_seq:
            raise ValueError(
                f"prefix_block_len {prefix_block_len} must be in "
                f"(0, max_seq={cfg.max_seq})")

    @staticmethod
    def resolve_host_tier(host_tier_bytes: int, prefix_cache: bool) -> int:
        """Validate the host tier's budget in bytes (0: no tier): > 0 needs
        ``prefix_cache``, whose blocks are what the tier holds."""
        b = int(host_tier_bytes)
        if b < 0:
            raise ValueError("host_tier_bytes must be >= 0 (0 = no "
                             "host tier)")
        if b and not prefix_cache:
            raise ValueError(
                "host_tier_bytes requires prefix_cache: the tier "
                "spills radix-indexed prefix blocks, which only "
                "exist when the prefix cache is enabled")
        return b

    @staticmethod
    def resolve_prefill_mode(prefill: bool,
                             prefill_mode: Optional[str]) -> str:
        """The prompt-ingestion mode from the legacy ``prefill`` bool and
        ``prefill_mode``: the mode wins when given; the bool maps True to
        ``"batched"`` and False to ``"token"``."""
        if prefill_mode is None:
            return "batched" if prefill else "token"
        if prefill_mode not in ContinuousBatchingEngine.PREFILL_MODES:
            raise ValueError(
                f"unknown prefill_mode {prefill_mode!r} (expected one of "
                f"{ContinuousBatchingEngine.PREFILL_MODES})")
        return prefill_mode

    @staticmethod
    def resolve_prefill_budget(mode: str, prefill_chunk: int,
                               prefill_token_budget: int) -> int:
        """The lane's tokens per round: under ``"chunked"`` 0 means one
        ``prefill_chunk``, and the budget is at least 1, so a waiting lane
        slot always makes progress; other modes pass the value
        through."""
        if mode != "chunked":
            return int(prefill_token_budget)
        return max(1, int(prefill_token_budget) or int(prefill_chunk))

    @staticmethod
    def resolve_disagg(cfg, prefill_mode: str, prefill_slots: int,
                       prefill_lane_width: int, prefill_chunk: int,
                       kv_layout: str, prefix_cache: bool,
                       prefix_commit_policy: str) -> tuple:
        """Validate the dedicated-lane knobs; returns ``(prefill_slots,
        prefill_lane_width)``, both 0 with the lane off. A lane needs
        ``prefill_mode="chunked"``; under the slot layout its handoff
        rides the prefix pool's commit and restore, so ``prefix_cache``
        must be on with a writable commit policy (the paged handoff is a
        table move and needs neither); the width defaults to
        ``prefill_chunk`` (0) and must lie in [1, max_seq]."""
        n = int(prefill_slots)
        if n < 0:
            raise ValueError("prefill_slots must be >= 0 (0 = the "
                             "piggyback lane)")
        if n == 0:
            return 0, 0
        if prefill_mode != "chunked":
            raise ValueError(
                f'prefill_slots {n} requires prefill_mode="chunked" '
                f'(the dedicated lane is resumable chunked prompt '
                f'ingestion in its own slot set), got '
                f'{prefill_mode!r}')
        width = int(prefill_lane_width) or int(prefill_chunk)
        if width < 1 or width > cfg.max_seq:
            raise ValueError(
                f"prefill_lane_width {width} must be in [1, max_seq="
                f"{cfg.max_seq}]")
        if kv_layout != "paged" and (
                not prefix_cache or prefix_commit_policy == "none"):
            raise ValueError(
                'prefill_slots under kv_layout="slot" hands finished '
                'KV to the decode lane through the prefix pool: '
                'prefix_cache must be enabled with a writable '
                'prefix_commit_policy ("all"/"no-evict"), or use '
                'kv_layout="paged" (zero-copy block-table handoff)')
        return n, width

    @staticmethod
    def resolve_lane_batch(prefill_slots: int,
                           prefill_lane_batch: int) -> int:
        """The batched lane's width: 0 and 1 resolve to 0 (one lane slot
        per dispatch); >= 2 needs a dedicated lane and clamps to its slot
        count."""
        b = int(prefill_lane_batch)
        if b < 0:
            raise ValueError("prefill_lane_batch must be >= 0 (0 = "
                             "one lane slot per dispatch)")
        if b <= 1:
            return 0
        if prefill_slots <= 0:
            raise ValueError(
                f"prefill_lane_batch {b} requires a dedicated prefill "
                f"lane (prefill_slots > 0): batched lane dispatch "
                f"packs prefill-lane slots, and the piggyback lane "
                f"has none")
        return min(b, int(prefill_slots))

    @staticmethod
    def ring_shape(fetch_stride: int, overlap: bool, dispatch_depth: int,
                   ring_entries: int, entries_per_iter: int = 2) -> tuple:
        """Effective ``(stride, ring_entries)``: overlap off clamps the
        stride to 1; an auto (0) ring holds a full stride of unfetched
        entries plus what one iteration adds plus the dispatch depth; an
        explicit size below ``entries_per_iter`` would let one iteration
        wrap its own unfetched entries and raises."""
        stride = int(fetch_stride) if overlap else 1
        k = max(2, int(entries_per_iter))
        if 0 < int(ring_entries) < k:
            raise ValueError(
                f"ring_entries {ring_entries} is below the {k} entries one "
                f"dispatch iteration can append")
        entries = int(ring_entries) or max(
            4, k * stride + max(1, dispatch_depth))
        return stride, entries

    @staticmethod
    def resolve_gamma_ladder(gamma: int, gamma_ladder: bool) -> tuple:
        """The verify depths rounds run at: () without speculation (gamma
        0); (gamma,) with the ladder off; with it on, the rungs {1, 2, 4,
        8} below gamma and gamma itself."""
        g = int(gamma)
        if g <= 0:
            return ()
        if not gamma_ladder:
            return (g,)
        return tuple(sorted({r for r in (1, 2, 4, 8) if r < g} | {g}))

    @staticmethod
    def ring_entries_per_iter(spec_ladder: tuple) -> int:
        """The ring entries one dispatch iteration may append: a chunk
        entry and one verify entry per ladder rung (at least 2, the
        reference's ladder-less bound)."""
        return max(2, 1 + len(spec_ladder))

    @staticmethod
    def resolve_engine_devices(engine_devices, mesh=None):
        """The reference's explicit-placement rule, for one device:
        ``engine_devices`` is a sequence of CUDA device indices or
        ``torch.device``s; a one-device subset is the device every tensor
        of the engine lives on (returned), None the default placement.
        Loud errors, never silent fallbacks: an index out of range, a
        device listed twice, an empty subset and a conflict with
        ``mesh`` raise ``ValueError``; ``mesh`` alone and a subset of more
        than one device shard one engine over devices, which raises
        ``NotImplementedError`` naming ROADMAP item 9b (A15)."""
        if engine_devices is None:
            if mesh is not None:
                raise NotImplementedError(
                    f"generation engine knob 'mesh' is not ported yet: "
                    f"ROADMAP {MESH_REMAINDER}")
            return None
        if mesh is not None:
            raise ValueError(
                "engine_devices and mesh are mutually exclusive — an "
                "explicit mesh already IS a device placement")
        n_cuda = torch.cuda.device_count()
        devs, seen = [], set()
        for d in engine_devices:
            if isinstance(d, (int, np.integer)):
                idx = int(d)
                if not 0 <= idx < n_cuda:
                    raise ValueError(
                        f"engine_devices index {idx} out of range "
                        f"(backend has {n_cuda} devices)")
                d = torch.device("cuda", idx)
            else:
                d = torch.device(d)
            if d in seen:
                raise ValueError(f"engine_devices lists device {d} twice")
            seen.add(d)
            devs.append(d)
        if not devs:
            raise ValueError(
                "engine_devices must name at least one device "
                "(None = default placement)")
        if len(devs) > 1:
            raise NotImplementedError(
                f"engine_devices over {len(devs)} devices shards one "
                f"engine: not ported yet, ROADMAP {MESH_REMAINDER}")
        return devs[0]

    # ---------------------------------------------------------- introspection

    def active_slots(self) -> int:
        """Occupied decode slots."""
        return sum(1 for s in self._slots if s.req is not None)

    def load_depth(self) -> int:
        """The fleet router's load signal: queued requests plus occupied
        decode and dedicated-lane slots, everything this engine has
        committed to serve and not finished."""
        return (self._pending.qsize() + self.active_slots()
                + self.active_lane_slots())

    def active_lane_slots(self) -> int:
        """Occupied dedicated-lane slots (0 without the lane)."""
        return sum(1 for s in self._lane_slots if s.req is not None)

    def _prefill_backlog(self) -> int:
        """Prompt tokens of occupied decode and lane slots not dispatched
        yet (read from any thread: each slot's request is read once)."""
        total = 0
        for slot in self._slots + self._lane_slots:
            req = slot.req
            if req is not None:
                total += max(0, len(req.prompt) - slot.cursor)
        return total

    def _prefill_lane_snapshot(self) -> Optional[dict]:
        """The chunked-prefill lane's state, with the dedicated lane's
        slots, width, occupancy, handoffs and batch width when it has one;
        None unless ``prefill_mode="chunked"``."""
        if not self._chunked_prefill:
            return None
        snap = {"mode": self._prefill_mode,
                "chunk": self._prefill_chunk_len,
                "token_budget": self._prefill_budget,
                "chunks": self._prefill_chunks_dispatched,
                "tokens": self._prefill_tokens_dispatched,
                "backlog_tokens": self._prefill_backlog(),
                "dedicated": self._lane_on}
        if self._lane_on:
            # the batched dispatches and the slots they packed are
            # gen_stats' lane_batch pair
            snap.update({"slots": self._lane_n,
                         "lane_width": self._lane_width,
                         "active": self.active_lane_slots(),
                         "handoffs": self._lane_handoffs,
                         "lane_batch": self._lane_batch})
        return snap

    def _live_tokens(self) -> int:
        """KV rows resident for live streams: per occupied decode or lane
        slot, its dispatched position bound clamped to the stream's worst
        case (each slot's request is read once: any thread reads this)."""
        total = 0
        for slot in self._slots + self._lane_slots:
            req = slot.req
            if req is not None:
                total += min(slot.pos_hi, req.cap_tokens)
        return total

    def _paged_snapshot(self) -> Optional[dict]:
        """The paged pool's occupancy (blocks of live streams, of the
        prefix index and free, and the live rows); None under the slot
        layout."""
        if not self._paged:
            return None
        occ = self._kv_index.occupancy()
        return {"layout": self._kv_layout,
                "block_len": self._kv_block_len,
                "max_blocks_per_slot": self._kv_max_blocks,
                "blocks": occ["usable"],
                "blocks_live": occ["stream"],
                "blocks_pinned": occ["prefix"],
                "blocks_free": occ["free"],
                "blocks_reserved": occ["reserved"],
                "live_tokens": self._live_tokens(),
                "blocked_requests": self._pending.parked}

    def _ring_snapshot(self) -> dict:
        """The token ring: its entries, the live fetch stride, overlap,
        the dispatches enqueued ahead of the last retired fetch, and the
        fetch counts."""
        return {"entries": self._ring_entries,
                "fetch_stride": self._stride,
                "overlap": self._overlap,
                "lag_chunks": self._ring_seq - self._retired_seq,
                "fetches": self.gen_stats.ring_fetches,
                "forced_fetches": self.gen_stats.ring_forced_fetches}

    def _speculation_snapshot(self) -> Optional[dict]:
        """The speculation counters with the ladder and the live gamma
        ceiling; None on an engine without a draft."""
        if self._spec is None:
            return None
        snap = self._spec.snapshot()
        snap["ladder"] = list(self._spec_ladder)
        snap["gamma_ceiling"] = self._gamma_ceiling
        return snap

    def _tier_snapshot(self) -> Optional[dict]:
        """The host tier's state and counts; None without a tier."""
        if self._kv_index is None:
            return None
        return self._kv_index.tier_snapshot()

    def slo_snapshot(self) -> dict:
        """Per-(tenant, slo_class) windowed quantiles, error-budget burn
        and outcome counts (``core.debug_slo``)."""
        return self.slo_stats.snapshot()

    def healthy(self) -> bool:
        """False once the engine thread died on an unexpected error:
        model readiness and the ``client_tpu_engine_up`` gauge read it. A
        cleanly stopped engine stays healthy (an unload stages a fresh
        one)."""
        return self._failed is None

    # ------------------------------------------------------ watchdog plane

    def _watchdog_signals(self) -> dict:
        """One watchdog history sample: host counters the loop already
        keeps (dict reads and one walk of the slot tables), so a sample
        reads no tensor and adds no synchronisation with the card. Runs
        on the engine thread at an iteration boundary, where the slot
        tables are consistent. ``unexpected_compiles`` is None: the port
        has no compile set yet (a None signal never breaches)."""
        pool_orphan = None
        if self._paged and self._kv_index is not None:
            # blocks the allocator says live streams own, minus the blocks
            # every live slot table (decode and lane) accounts for: a
            # positive, non-decreasing residue is a leak
            expected = sum(len(s.blocks) for s in self._slots
                           if s.req is not None)
            expected += sum(len(s.blocks) for s in self._lane_slots
                            if s.req is not None)
            pool_orphan = self._kv_index.occupancy()["stream"] - expected
        tier = self._tier_snapshot()
        spec = None if self._spec is None else self._spec.snapshot()
        gp_device_share, gp_waste_share = self.goodput.shares()
        return {
            "slots_active": self.active_slots(),
            "queue_depth": self._pending.qsize(),
            "admissions": self._admissions,
            "chunks_dispatched": self._chunks_dispatched,
            "tokens_emitted": self._tokens_emitted,
            "requests_completed": self._requests_completed,
            "ring_lag": self._ring_seq - self._retired_seq,
            "pool_orphan_blocks": pool_orphan,
            "max_class_burn": self.slo_stats.max_class_burn(),
            "unexpected_compiles": None,
            "spec_acceptance": (None if spec is None
                                else spec["acceptance_rate"]),
            "spec_rounds": None if spec is None else spec["rounds"],
            "tier_spills": None if tier is None else tier["spills"],
            "tier_restores": None if tier is None else tier["restores"],
            "device_time_share": round(gp_device_share, 4),
            "wasted_flop_share": round(gp_waste_share, 4),
        }

    def _incident_evidence(self, detector: str, breach: dict) -> dict:
        """The bundle a firing detector records: the flight-recorder tail
        and the scheduler, goodput, SLO, paged-pool, tier, ring, lane and
        speculation snapshots — host values only, so a bundle pins no
        device memory of this engine in the store that outlives it.
        ``compile`` is None (no compile set)."""
        return {
            "flight_tail": self.flight.tail(EVIDENCE_FLIGHT_TAIL),
            "scheduler": self.scheduler_snapshot(),
            "goodput": self.goodput.snapshot(),
            "slo": self.slo_stats.snapshot(),
            "kv_paged": self._paged_snapshot(),
            "kv_tier": self._tier_snapshot(),
            "ring": self._ring_snapshot(),
            "prefill_lane": self._prefill_lane_snapshot(),
            "speculation": self._speculation_snapshot(),
            "compile": None,
        }

    def _watchdog_tick(self) -> None:
        """One detector evaluation per loop iteration (downsampled to the
        history interval inside ``observe``); a fired incident is stamped
        as an INCIDENT span on every traced request holding a slot."""
        fired = self._watchdog.observe(
            now_ns(), self._watchdog_signals(),
            evidence_fn=self._incident_evidence)
        for f in fired:
            for s in self._slots + self._lane_slots:
                req = s.req
                if req is not None and req.trace is not None:
                    req.trace.event(
                        trace_mod.INCIDENT, detector=f["detector"],
                        incident_id=f["id"])

    def watchdog_snapshot(self) -> Optional[dict]:
        """The watchdog block (detector episodes, history depth, store
        counters); None with the watchdog off."""
        return (None if self._watchdog is None
                else self._watchdog.snapshot())

    def watchdog_suppress(self, detector: str, on: bool = True) -> None:
        """Gate one detector from outside (a no-op with the watchdog
        off)."""
        if self._watchdog is not None:
            self._watchdog.suppress(detector, on)

    def incident_snapshot(self) -> Optional[dict]:
        """The incident store's ring and counters with the watchdog block
        (``GET /v2/debug/incidents``); None with the watchdog off. The
        store outlives this engine: a supervised restart hands it to the
        fresh one."""
        if self.incidents is None:
            return None
        snap = self.incidents.snapshot()
        snap["watchdog"] = self.watchdog_snapshot()
        return snap

    def runtime_snapshot(self) -> dict:
        """The runtime plane's block (``GET /v2/debug/runtime``): the
        card-memory ledger of what this engine placed, by component, and
        liveness. A paged engine's pool
        row is split at read time into the live-stream, pinned-prefix and
        free shares of the allocator's occupancy, and the goodput
        tracker's snapshot. There is no compile table."""
        mem = dict(self._mem_attr)
        if self._paged and self._kv_index is not None and "kv_pool" in mem:
            occ = self._kv_index.occupancy()
            per_block = mem["kv_pool"] / max(1, self._kv_pool_blocks)
            mem["kv_pool_live"] = int(per_block * occ["stream"])
            mem["kv_pool_prefix"] = int(per_block * occ["prefix"])
            mem["kv_pool_free"] = int(per_block * occ["free"])
        return {"memory": mem, "engine_up": self.healthy(),
                "goodput": self.goodput.snapshot()}

    def debug_snapshot(self, flight_tail: int = 64) -> dict:
        """Live engine introspection (``GET
        /v2/debug/models/{name}/engine``): the slot tables, queue, pool,
        speculation and supervision state and the flight-recorder tail.
        Read while the engine thread runs: each slot's request is read
        once, and the view is best effort, not a consistency point."""
        slots = []
        for i, slot in enumerate(self._slots):
            req = slot.req
            row = {"slot": i, "active": req is not None}
            if req is not None:
                row.update({
                    "prompt_tokens": int(len(req.prompt)),
                    "emitted": req.emitted,
                    "budget": req.budget,
                    "tenant": req.tenant,
                    "slo_class": req.slo_class,
                    "cursor": slot.cursor,
                    "pos_hi": slot.pos_hi,
                    "draft_ready": slot.draft_ready,
                    "traced": req.trace is not None,
                })
            slots.append(row)
        lane_slots = []
        for i, slot in enumerate(self._lane_slots):
            req = slot.req
            row = {"slot": i, "active": req is not None}
            if req is not None:
                row.update({
                    "prompt_tokens": int(len(req.prompt)),
                    "tenant": req.tenant,
                    "slo_class": req.slo_class,
                    "cursor": slot.cursor,
                    "ready": self._lane_done(slot, req)
                    if "lane_buckets" in self._dev else False,
                })
            lane_slots.append(row)
        return {
            "name": self.name,
            "engine_up": self.healthy(),
            "supervision": (None if self.supervisor is None
                            else self.supervisor.snapshot()),
            "failure": (None if self._failed is None else str(self._failed)),
            "n_slots": self._n_slots,
            "chunk": self._chunk,
            "queue_depth": self._pending.qsize(),
            "tokens_emitted": self._tokens_emitted,
            "requests_completed": self._requests_completed,
            "dispatch_duty": self._duty,
            "phase_seconds": {k: round(v, 6)
                              for k, v in self._phase_s.items()},
            "ring": self._ring_snapshot(),
            "prefill_lane": self._prefill_lane_snapshot(),
            "kv_paged": self._paged_snapshot(),
            "kv_tier": self._tier_snapshot(),
            "scheduler": self.scheduler_snapshot(),
            "slots": slots,
            "lane_slots": lane_slots if self._lane_on else None,
            "slo": self.slo_stats.snapshot(),
            "prefix_cache": (None if self._prefix_index is None
                             else self._prefix_index.snapshot()),
            "speculation": self._speculation_snapshot(),
            "runtime": self.runtime_snapshot(),
            "watchdog": self.watchdog_snapshot(),
            "flight_recorder": self.flight.tail(flight_tail),
        }

    def generation_snapshot(self) -> dict:
        """The token-level counters with the live gauges the
        ``client_tpu_generation_*``, ``client_tpu_slo_*``,
        ``client_tpu_sched_*`` and ``client_tpu_watchdog_*`` families and
        the supervision pair export (``server/metrics.py``); the
        ``supervisor`` block is None on an unsupervised engine and the
        ``watchdog`` block None with the watchdog off. ``goodput`` is the
        tracker's snapshot, the ``client_tpu_goodput_*`` feed."""
        snap = self.gen_stats.snapshot()
        snap.update({
            "slo": self.slo_stats.snapshot(),
            "engine_up": self.healthy(),
            "supervisor": (None if self.supervisor is None
                           else self.supervisor.snapshot()),
            "n_slots": self._n_slots,
            "slots_active": self.active_slots(),
            "queue_depth": self._pending.qsize(),
            "chunks_dispatched": self._chunks_dispatched,
            "dispatch_duty": self._duty,
            "phase_seconds": dict(self._phase_s),
            "ring": self._ring_snapshot(),
            "prefill_lane": self._prefill_lane_snapshot(),
            "kv_paged": self._paged_snapshot(),
            "kv_tier": self._tier_snapshot(),
            "scheduler": self.scheduler_snapshot(),
            "prefix_cache": (None if self._prefix_index is None
                             else self._prefix_index.snapshot()),
            "speculation": self._speculation_snapshot(),
            "goodput": self.goodput.snapshot(),
            "watchdog": self.watchdog_snapshot(),
        })
        return snap

    def stats(self) -> dict:
        """Instantaneous engine counters: dispatches (chunks and verify
        rounds; ``dispatch_by_kind`` splits them, with the engine thread's
        host seconds per kind), tokens emitted, the duty, phase seconds of
        the engine thread, the ring, the chunked-prefill lane, the pool
        occupancy, the host tier, the scheduler, the prefix index and
        speculation (each None where the engine has none), the SLO
        statistics, and the slot tables (the rows of the reference's
        ``debug_snapshot``: each held slot's prompt length, tokens
        emitted, budget, SLO labels and cursors; ``lane_slots`` None
        without the dedicated lane). The tables are read while the engine
        thread runs: a best-effort view, not a consistency point."""
        def rows(table):
            out = []
            for i, slot in enumerate(table):
                req = slot.req
                row = {"slot": i, "active": req is not None}
                if req is not None:
                    row.update({"prompt_tokens": int(len(req.prompt)),
                                "emitted": req.emitted,
                                "budget": req.budget, "tenant": req.tenant,
                                "slo_class": req.slo_class,
                                "cursor": slot.cursor,
                                "pos_hi": slot.pos_hi})
                out.append(row)
            return out

        slots = rows(self._slots)
        spec = self._speculation_snapshot()
        return {
            "n_slots": self._n_slots,
            "chunk": self._chunk,
            "kv_layout": self._kv_layout,
            "prefill_mode": self._prefill_mode,
            "slots_active": self.active_slots(),
            "queue_depth": self._pending.qsize(),
            "chunks_dispatched": self._chunks_dispatched,
            "tokens_emitted": self._tokens_emitted,
            "requests_completed": self._requests_completed,
            "requests_failed": self.gen_stats.failed,
            "dispatch_duty": self._duty,
            "phase_seconds": dict(self._phase_s),
            "dispatch_event_ms": self._dispatch_event_ms,
            "timed_dispatches": self._timed_dispatches,
            "ring": self._ring_snapshot(),
            "prefill_lane": self._prefill_lane_snapshot(),
            "kv_paged": self._paged_snapshot(),
            "kv_tier": self._tier_snapshot(),
            "scheduler": self.scheduler_snapshot(),
            "prefix_cache": (None if self._prefix_index is None
                             else self._prefix_index.snapshot()),
            "speculation": spec,
            "spec_acceptance": (None if spec is None
                                else spec["acceptance_rate"]),
            "spec_rounds": None if spec is None else spec["rounds"],
            "dispatch_by_kind": {
                kind: {"dispatches": self._kind_n[kind],
                       "host_s": self._kind_s[kind]}
                for kind in self._kind_n},
            "slots": slots,
            "lane_slots": rows(self._lane_slots) if self._lane_on else None,
            "slo": self.slo_stats.snapshot(),
            "goodput": self.goodput.snapshot(),
        }

    # ------------------------------------------------------------ live knobs
    #
    # The controller's actuators and an operator surface: each setter
    # changes host state the loop reads once per round.

    @property
    def dispatch_duty(self) -> float:
        return self._duty

    def set_dispatch_duty(self, duty: float) -> None:
        """Live pacing: the share of wall time the engine may keep the
        card busy (1.0: no pause between rounds)."""
        if not 0.0 < duty <= 1.0:
            raise ValueError("dispatch_duty must be in (0, 1]")
        self._duty = duty

    @property
    def prefill_token_budget(self) -> int:
        """The chunked lane's live per-round token budget."""
        return self._prefill_budget

    def set_prefill_token_budget(self, budget: int) -> None:
        """Live lane budget, resolved as at construction (under
        ``"chunked"`` 0 is one ``prefill_chunk`` and the floor is one
        token); engines without the lane only record it."""
        if int(budget) < 0:
            raise ValueError("prefill_token_budget must be >= 0")
        self._prefill_budget = self.resolve_prefill_budget(
            self._prefill_mode, self._prefill_chunk_len, int(budget))

    @property
    def fetch_stride(self) -> int:
        """Live dispatches per ring fetch (<= the configured stride)."""
        return self._stride

    def set_fetch_stride(self, stride: int) -> None:
        """Live fetch cadence, clamped to [1, the configured stride]: the
        ring was sized for the configured one, so a larger stride would
        wrap it."""
        if int(stride) < 1:
            raise ValueError("fetch_stride must be >= 1")
        self._stride = min(int(stride), self._stride_cfg)

    @property
    def preempt_burn_threshold(self) -> float:
        """The effective preempt threshold: the live override when set,
        else the configured one (0.0 without a scheduler)."""
        if self._preempt_threshold_override is not None:
            return self._preempt_threshold_override
        return (self._sched.preempt_burn_threshold
                if self._sched is not None else 0.0)

    def set_preempt_burn_threshold(self, threshold=None) -> None:
        """Override the preempt threshold live (None restores the
        configured one)."""
        if threshold is not None and float(threshold) < 0:
            raise ValueError(
                f"preempt_burn_threshold must be >= 0, got {threshold}")
        self._preempt_threshold_override = (
            None if threshold is None else float(threshold))

    def _class_weight(self, slo_class: str) -> float:
        return self._sched.class_weights.get(slo_class,
                                             self._sched.default_weight)

    def scheduler_snapshot(self) -> Optional[dict]:
        """The scheduler's effective config, live knobs, per-flow queue
        depths, parked reservations, controller mode and preemption and
        resume counts; None without a scheduler."""
        if self._sched is None:
            return None
        s = self._sched
        snap = {
            "enabled": True,
            "class_weights": dict(s.class_weights),
            "default_weight": s.default_weight,
            "preemption": s.preemption,
            "preempt_burn_threshold": self.preempt_burn_threshold,
            "max_preemptions": s.max_preemptions,
            "park_bypass_limit": s.park_bypass_limit,
            "controller": (None if self._controller is None
                           else self._controller.snapshot()),
            "knobs": {
                "prefill_token_budget": self._prefill_budget,
                "fetch_stride": self._stride,
                "dispatch_duty": self._duty,
                "speculation_enabled": self.speculation_enabled,
                "speculation_gamma": self.speculation_gamma,
            },
            "queue_depths": {f"{t}/{c}": n for (t, c), n
                             in sorted(self._pending.depths().items())},
            "parked_requests": self._pending.parked,
        }
        snap.update(self._sched_stats.snapshot())
        return snap

    # ---------------------------------------------------- speculation knobs

    @property
    def speculation_enabled(self) -> bool:
        """True while verify rounds may run: the gamma ceiling is nonzero
        (or, on an engine without a draft, the boolean gate is set)."""
        if self._spec is None:
            return self._spec_enabled_flag
        return self._gamma_ceiling > 0

    @property
    def speculation_gamma(self) -> int:
        """The live verify-depth ceiling, always a ladder rung or 0
        (speculation off)."""
        return self._gamma_ceiling if self._spec is not None else 0

    def set_speculation_gamma(self, gamma: int) -> None:
        """Steer the verify-depth ceiling: the value snaps down to the
        largest ladder rung at or below it, and below the smallest rung
        to 0, which puts every slot back on plain decode at the next
        round. Greedy output is the same at any ceiling. Without a draft
        it sets the boolean gate (> 0: enabled)."""
        g = int(gamma)
        if g < 0:
            raise ValueError("speculation gamma ceiling must be >= 0")
        if self._spec is None:
            self._spec_enabled_flag = g > 0
            return
        g = max((r for r in self._spec_ladder if r <= g), default=0)
        if g > 0:
            self._gamma_restore = g
        self._gamma_ceiling = g

    def set_speculation_enabled(self, enabled: bool) -> None:
        """The boolean view of the ceiling: off sets it to 0, on restores
        the last nonzero one. A re-enabled slot verifies with whatever
        draft rows it has: a stale draft lowers acceptance, never
        correctness."""
        if self._spec is None:
            self._spec_enabled_flag = bool(enabled)
            return
        self.set_speculation_gamma(self._gamma_restore if enabled else 0)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ContinuousBatchingEngine":
        with self._lock:
            if self._started or self._stopping:
                return self
            self._started = True
            self._thread = threading.Thread(
                target=self._run, name="cbatch-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            already = self._stopping
            self._stopping = True
            if not self._started or already:
                return
        self._pending.close()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # a wedged thread leaks its device state, slots and pins:
                # report it with the flight tail, which shows where it
                # wedged
                tail = self.flight.tail(16)
                log.error(
                    "generation engine '%s' thread did not exit within "
                    "30s of stop(); its device state (%d slots, chunk "
                    "%d) is leaked. Flight recorder tail (%d "
                    "iteration(s), newest last): %s",
                    self.name, self._n_slots, self._chunk, len(tail),
                    json.dumps(tail, default=str))

    def drain(self, timeout: float = 60.0) -> bool:
        """Stop admitting (a later submit gets a 503) and wait until every
        queued and in-flight stream has finished; False on timeout."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._requests_accepted == self._requests_closed:
                    return True
            time.sleep(0.02)
        return False

    def _release_prefix(self, req: _Request) -> None:
        """Unpin a request's matched chain exactly once, from any thread:
        the take rides the engine lock, since the engine thread may assign
        ``req.prefix`` while a consumer's cancel closes the request."""
        if self._prefix_index is None:
            return
        with self._lock:
            handle, req.prefix = req.prefix, None
        if handle is not None:
            self._prefix_index.release(handle)

    def _release_resume_pin(self, req: _Request) -> None:
        """Unpin the chain a preemption committed, exactly once (the same
        atomic take as ``_release_prefix``): at the resume's admission,
        or when the request closes while queued."""
        if self._prefix_index is None:
            return
        with self._lock:
            handle, req.resume_pin = req.resume_pin, None
        if handle is not None:
            self._prefix_index.release(handle)

    def _close_request(self, req: _Request, terminal,
                       outcome: Optional[str] = None) -> None:
        """Deliver a request's terminal item (None = normal end, or an
        exception) exactly once, unpinning its matched chain and its
        resume pin first whatever the outcome, and record it in the
        token-level and the per-label statistics. ``outcome`` overrides
        the completed/failed attribution for the two bounded-lifetime
        endings, "cancelled" (the client went away) and "deadline" (the
        wire timeout passed), which are counted apart from failures."""
        with self._lock:
            if req.finished:
                return
            req.finished = True
            self._requests_closed += 1
        self._release_prefix(req)
        self._release_resume_pin(req)
        if outcome is None:
            outcome = "completed" if terminal is None else "failed"
        req.outcome = outcome
        if outcome == "completed":
            self.gen_stats.record_completion(
                req.emitted, req.first_token_ns, req.last_emit_ns,
                trace_id=req.trace.id if req.trace is not None else "")
            if req.trace is not None and req.first_token_ns \
                    and req.last_emit_ns >= req.first_token_ns:
                # the steady-state token loop on device-cadence stamps
                req.trace.span(trace_mod.DECODE, req.first_token_ns,
                               req.last_emit_ns, emitted=req.emitted)
            # settle the stream against its class's objective: its mean
            # ITL (none below 2 tokens), TTFT and queue wait
            itl_ns = None
            if req.emitted >= 2 and req.last_emit_ns >= req.first_token_ns:
                itl_ns = ((req.last_emit_ns - req.first_token_ns)
                          // (req.emitted - 1))
            ttft_ns = (max(0, req.first_token_ns - req.enqueue_ns)
                       if req.first_token_ns else 0)
            self.slo_stats.record_completion(req.tenant, req.slo_class,
                                             ttft_ns, itl_ns,
                                             req.queue_wait_ns)
        elif outcome == "cancelled":
            self.gen_stats.record_cancelled()
            self.slo_stats.record_cancelled(req.tenant, req.slo_class)
        elif outcome == "deadline":
            self.gen_stats.record_deadline_expired()
            self.slo_stats.record_deadline(req.tenant, req.slo_class)
        else:
            self.gen_stats.record_failure()
            self.slo_stats.record_failure(req.tenant, req.slo_class)
        req.out.put(terminal)

    def _shed_queued(self, victim: _Request) -> None:
        """Close a queued request the weight-aware shed door evicted: a
        per-label shed (and a failed stream), answered with the retryable
        503 of the queue-mouth shed. A concurrent close of the same
        request wins; its queue space is freed either way."""
        with self._lock:
            if victim.finished:
                return
            victim.finished = True
            self._requests_closed += 1
        self._release_prefix(victim)
        self._release_resume_pin(victim)
        victim.outcome = "failed"
        self.gen_stats.record_failure()
        self.slo_stats.record_shed(victim.tenant, victim.slo_class)
        victim.out.put(ServerError(
            "generation request shed from the queue: a higher-weight "
            "flow's request arrived while the queue was full", 503,
            retry_after=1.0))

    def cancel(self, req: _Request) -> None:
        """Cancel one stream from any thread (idempotent); its slot and
        blocks are reclaimed at the next dispatch boundary."""
        self._close_request(
            req, ServerError("generation request cancelled by the client",
                             499), outcome="cancelled")

    # ---------------------------------------------------------- submission

    def submit(self, prompt, max_new_tokens: int, eos_id: int = -1,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               seed: int = 0, trace=None, tenant_id: str = DEFAULT_TENANT,
               slo_class: str = DEFAULT_SLO_CLASS, deadline_ns: int = 0,
               cancel_event=None) -> Iterator[int]:
        """Enqueue one generation request; yields token ids as they are
        produced. Raises ServerError for invalid requests (400) and when
        the engine is shutting down or the queue is full (503).

        ``tenant_id`` / ``slo_class`` label the stream (validated here as
        the front ends validate them: the engine is itself a public
        submission surface). ``deadline_ns`` is an absolute monotonic-ns
        deadline (``now_ns() + timeout``, 0 = none): once it passes the
        stream ends with a 504, settles as the ``deadline`` outcome and
        frees its slot, blocks and prefix pins at the next dispatch
        boundary. It is enforced on both sides: the engine thread sweeps
        the slots every iteration, and the returned iterator bounds its
        waits, so a wedged engine cannot hold a caller past it.
        ``cancel_event`` is an optional ``threading.Event`` a front end
        sets when the caller goes away (the stream then ends with a 499);
        abandoning the returned iterator cancels too. ``trace`` is the
        request's sampled ``Trace`` (None: untraced), which the engine
        stamps with its spans."""
        for key, val in (("tenant_id", tenant_id),
                         ("slo_class", slo_class)):
            if not isinstance(val, str) or not TENANT_ID_RE.match(val):
                raise ServerError(
                    f"{key} must be 1-64 characters of [A-Za-z0-9._:-] "
                    f"starting with an alphanumeric, got {val!r}", 400)
        prompt = np.asarray(prompt)
        if not (np.issubdtype(prompt.dtype, np.integer)
                or prompt.dtype == bool):
            raise ServerError(
                f"prompt dtype {prompt.dtype} is not an integer token-id "
                f"dtype", 400)
        prompt = prompt.reshape(-1).astype(np.int32)
        if prompt.size == 0:
            return iter(())
        if int(max_new_tokens) < 1:
            raise ServerError(
                f"max_new_tokens must be >= 1, got {int(max_new_tokens)}",
                400)
        if len(prompt) >= self._cfg.max_seq:
            raise ServerError(
                f"prompt of {len(prompt)} tokens leaves no room to generate "
                f"within the model's max context length "
                f"{self._cfg.max_seq}", 400)
        if top_k > MAX_TOP_K:
            raise ServerError(
                f"top_k={top_k} exceeds the sampling width ({MAX_TOP_K}); a "
                f"silent clamp would sample a different distribution than "
                f"requested", 400)
        if not -2 ** 31 <= int(seed) < 2 ** 31:
            raise ServerError(f"seed {seed} does not fit in int32", 400)
        if int(deadline_ns) < 0:
            raise ServerError(
                f"deadline_ns must be >= 0, got {int(deadline_ns)}", 400)
        budget = min(int(max_new_tokens), self._cfg.max_seq - len(prompt))
        if self._paged:
            cap = self._kv_max_blocks * self._kv_block_len
            if len(prompt) >= cap:
                raise ServerError(
                    f"prompt of {len(prompt)} tokens leaves no room to "
                    f"generate within the paged per-stream cap {cap} "
                    f"(kv_max_blocks_per_slot x kv_block_len)", 400)
            budget = min(budget, cap - len(prompt))
            need = -(-(len(prompt) + budget) // self._kv_block_len)
            if need > self._kv_index.usable_blocks:
                raise ServerError(
                    f"request needs {need} KV blocks (prompt {len(prompt)} "
                    f"+ budget {budget} at kv_block_len "
                    f"{self._kv_block_len}) but the pool holds only "
                    f"{self._kv_index.usable_blocks}", 400)
        # the labels go through the cardinality cap once, and only after the
        # 400 checks: a refused request must not take one of the tenant
        # slots. Every later record uses the resolved labels.
        tenant, slo_class = self.slo_stats.resolve(tenant_id, slo_class)
        key = (tenant, slo_class)
        req = _Request(prompt, budget, eos_id, temperature=float(temperature),
                       top_k=int(top_k), top_p=float(top_p), seed=int(seed),
                       trace=trace, tenant=tenant, slo_class=slo_class,
                       deadline_ns=int(deadline_ns), cancel_ev=cancel_event)
        if self._spec is not None:
            req.spec = RequestSpeculation()
        if self._preempt_on:
            # a preemption folds the emitted token values into the prompt
            req.gen_tokens = []
        req.enqueue_ns = now_ns()
        if trace is not None:
            trace.event(trace_mod.GENERATION_ENQUEUE, req.enqueue_ns,
                        tenant=tenant, slo_class=slo_class)
        with self._lock:
            shed = self._stopping or self._draining
            if not shed:
                self._requests_accepted += 1
        if shed:
            self.gen_stats.record_failure()
            self.slo_stats.record_shed(tenant, slo_class)
            sup = self.supervisor
            if sup is not None and self._failed is not None:
                if sup.crash_looped:
                    # no restart is coming: no Retry-After, or retrying
                    # clients would spend their budget on a dead model
                    raise ServerError(
                        "generation engine is down (crash-loop breaker "
                        "tripped); unavailable until an operator "
                        "reload", 503)
                # mid-restart: the backoff tells the client when the
                # fresh engine is due
                raise ServerError(
                    "generation engine is restarting", 503,
                    retry_after=sup.retry_after_hint())
            if self._failed is not None:
                # unsupervised: dead until an operator reload, no hint
                raise ServerError(
                    "generation engine is down (engine failure, no "
                    "supervisor); unavailable until an operator "
                    "reload", 503)
            # plain drain or stop: a reload stages a fresh engine
            raise ServerError("generation engine is shutting down", 503,
                              retry_after=1.0)
        self.start()
        forced_full = faultinject.fire("queue_full",
                                       engine=self.name) is not None
        if self._shed_on_full or forced_full:
            try:
                if forced_full:
                    raise queue.Full
                self._pending.put_nowait(req, key)
            except queue.Full:
                # under a scheduler a full queue first sheds the newest
                # queued entry of a strictly lower-weight flow, and this
                # request takes its place; the FIFO door sheds the arrival,
                # as does an injected queue_full
                victim = (self._pending.shed_lowest(key)
                          if self._sched is not None and not forced_full
                          else None)
                if victim is not None:
                    self._shed_queued(victim)
                    try:
                        self._pending.put_nowait(req, key)
                    except queue.Full:
                        # refilled between the pop and the put
                        victim = None
                if victim is None:
                    with self._lock:
                        req.finished = True
                        self._requests_closed += 1
                    self.gen_stats.record_failure()
                    self.slo_stats.record_shed(tenant, slo_class)
                    raise ServerError(
                        f"generation queue is full ({self._queue_depth} "
                        f"pending); request shed", 503,
                        retry_after=1.0) from None
        else:
            self._pending.put(req, key)
        self.slo_stats.record_admitted(tenant, slo_class)
        if self._stopping:
            # the engine may already have drained the queue
            self._close_request(req, self._failed or ServerError(
                "generation engine stopped", 503))

        def _expire():
            """The consumer side's deadline trip: settle the stream as the
            ``deadline`` outcome (the engine's sweep then only frees its
            slot) and hand the caller its 504. The pins go now, the slot
            when the engine next reaches a dispatch boundary."""
            err = ServerError("generation request deadline exceeded", 504)
            self._close_request(req, err, outcome="deadline")
            return err

        def _drain():
            try:
                while True:
                    if req.deadline_ns:
                        remaining_s = (req.deadline_ns - now_ns()) / 1e9
                        if remaining_s <= 0:
                            raise _expire()
                        try:
                            item = req.out.get(timeout=remaining_s)
                        except queue.Empty:
                            raise _expire() from None
                    else:
                        item = req.out.get()
                    if item is None:
                        return
                    if isinstance(item, Exception):
                        raise item
                    yield from item      # one delivery's worth
            finally:
                # an abandoned iterator is a client cancellation: free the
                # slot instead of decoding to the budget for nobody
                if not req.finished:
                    self.cancel(req)
        return _drain()

    # ---------------------------------------------------------- device side

    def _ensure_ready(self) -> None:
        """Place the weights, build the KV state (the slot rows or the
        pool), positions and ring on the engine's device, with a draft the
        draft's weights and its own slot-layout state (on both layouts, as
        in the reference), and run one all-inactive chunk of each kernel
        variant (greedy and sampled), so the kernels' libraries are built
        before the first request. Runs on the engine thread."""
        if "ready" in self._dev:
            return
        cfg, s, c, dev = self._cfg, self._n_slots, self._chunk, self._device
        if self._paged:
            self._dev["pool"] = init_paged_pool(cfg, self._kv_pool_blocks,
                                                self._kv_block_len, dev)
            self._dev["table_buckets"] = block_count_buckets(
                cfg.max_seq // self._kv_block_len)
            self._dev["pos"] = t.init_paged_state(s, dev)["pos"]
        else:
            # the KV tensors (int8 ones with their scale tables under
            # kv_quant) and the positions
            state = t.init_decode_state(cfg, s, dev)
            self._dev["pos"] = state.pop("pos")
            self._dev["cache"] = state
            if self._prefix_index is not None:
                # the slot layout's prefix pool, in front of the slot rows;
                # a match or commit covers at most max_seq // bl blocks,
                # padded to a power-of-two count of them
                bl = self._prefix_block_len
                self._dev["prefix_pool"] = init_block_pool(
                    cfg, self._prefix_blocks, bl, dev)
                self._dev["prefix_buckets"] = block_count_buckets(
                    max(1, cfg.max_seq // bl))
        if self._prefill_enabled:
            # prompts of at most one chunk take the token-level path
            self._dev["prefill_buckets"] = block_count_buckets(
                cfg.max_seq, start=8, skip_upto=c)
        if self._chunked_prefill:
            # power-of-two lane chunks up to prefill_chunk: a tail chunk
            # pads to the smallest bucket that covers it
            self._dev["pchunk_buckets"] = block_count_buckets(
                self._prefill_chunk_len, start=8)
        if self._lane_on:
            self._init_lane_state()
        if self._spec is not None:
            dstate = t.init_decode_state(self._draft.cfg, s, dev)
            self._dev["dpos"] = dstate.pop("pos")
            self._dev["dcache"] = dstate
            self._dev["dparams"] = _to_device(self._draft.params, dev)
            # the draft's catch-up covers whole prompts
            self._dev["draft_buckets"] = block_count_buckets(cfg.max_seq,
                                                             start=8)
        self._dev["ring"] = torch.zeros(
            (self._ring_entries, s, self._ring_width), dtype=torch.int32,
            device=dev)
        self._dev["ring_cnt"] = torch.zeros((self._ring_entries, s),
                                            dtype=torch.int32, device=dev)
        self._dev["last"] = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._dev["params"] = _to_device(self._params_host, dev)
        # the engine has no reload path: drop the caller's copy
        self._params_host = None
        zi = torch.zeros((s,), dtype=torch.int32, device=dev)
        zb = torch.zeros((s,), dtype=torch.bool, device=dev)
        zf = torch.zeros((s,), dtype=torch.float32, device=dev)
        tab0 = torch.zeros((s, 1), dtype=torch.int32, device=dev)
        feed0 = torch.zeros((s, c), dtype=torch.int32, device=dev)
        for sample in (False, True):
            self._launch_chunk(0, tab0, feed0, zi, zb, zb, zi, zb, zi, zf,
                               zi, zf, sample)
        if self._host_tier_bytes:
            self._attach_tier()
        # the memory ledger: the big device residents this engine placed,
        # by component (the reference's rows; a paged engine has no slot
        # rows, its pool is the one KV residence)
        self._mem_attr = {"weights": pytree_nbytes(self._dev["params"])}
        if self._paged:
            self._mem_attr["kv_pool"] = pytree_nbytes(self._dev["pool"])
        else:
            self._mem_attr["kv_slots"] = pytree_nbytes(
                (self._dev["cache"], self._dev["pos"]))
            if self._prefix_index is not None:
                self._mem_attr["kv_pool"] = pytree_nbytes(
                    self._dev["prefix_pool"])
            if self._lane_on:
                self._mem_attr["kv_lane_slots"] = pytree_nbytes(
                    (self._dev["lane_cache"], self._dev["lane_pos"]))
        if self._spec is not None:
            self._mem_attr["draft_weights"] = pytree_nbytes(
                self._dev["dparams"])
            self._mem_attr["draft_kv"] = pytree_nbytes(
                (self._dev["dcache"], self._dev["dpos"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._dev["ready"] = True

    def _init_lane_state(self) -> None:
        """The dedicated lane's device state: positions and pending first
        tokens (and under the slot layout its own KV rows) for its slots
        plus one scratch row, where the batched lane's padding rows write
        what nothing reads; its chunk ladder of powers of two up to
        ``prefill_lane_width``, and the batched lane's row-count ladder."""
        cfg, dev, n = self._cfg, self._device, self._lane_n + 1
        if self._paged:
            self._dev["lane_pos"] = t.init_paged_state(n, dev)["pos"]
        else:
            state = t.init_decode_state(cfg, n, dev)
            self._dev["lane_pos"] = state.pop("pos")
            self._dev["lane_cache"] = state
        self._dev["lane_last"] = torch.zeros((n,), dtype=torch.int32,
                                             device=dev)
        self._dev["lane_buckets"] = block_count_buckets(self._lane_width,
                                                        start=8)
        if self._lane_batch:
            self._dev["lane_b_buckets"] = block_count_buckets(
                self._lane_batch)

    def _attach_tier(self) -> None:
        """Arm the host tier on the prefix pool (the paged pool, layer-
        major, or the slot layout's block-major one): the index spills a
        block through ``tier_spill`` before its id returns to the free
        list, and restores one through ``tier_restore`` inside the
        ``acquire`` of the admission that reads it, both on the engine's
        stream; their host time goes to the "tier" phase."""
        layer_major = self._paged
        pool = self._dev["pool"] if layer_major else self._dev["prefix_pool"]
        tier = HostTierStore(self._host_tier_bytes,
                             pool_block_nbytes(pool, layer_major))

        def spill(bid: int) -> tuple:
            t0 = time.perf_counter()
            out = tier_spill(pool, bid, layer_major)
            self._phase_s["tier"] += time.perf_counter() - t0
            return out

        def restore(bid: int, rows: dict) -> None:
            t0 = time.perf_counter()
            tier_restore(pool, bid, rows, layer_major)
            self._phase_s["tier"] += time.perf_counter() - t0

        self._kv_index.attach_tier(tier, spill, restore)

    def _launch_chunk(self, entry: int, tables, feed, rem, active, reset,
                      reset_to, freeze, seeds, temps, topks, topps,
                      sample: bool) -> None:
        """Enqueue one chunk kernel of the engine's layout on its device
        state (``tables`` and ``reset_to`` are the paged layout's)."""
        dev = self._dev
        if self._paged:
            dev["last"], dev["pos"] = paged_chunk_kernel(
                self._cfg, dev["params"], dev["pool"], dev["pos"],
                dev["last"], dev["ring"], dev["ring_cnt"], entry, tables,
                feed, rem, active, reset, reset_to, freeze, seeds, temps,
                topks, topps, sample)
        else:
            dev["last"], dev["pos"] = chunk_kernel(
                self._cfg, dev["params"], dev["cache"], dev["pos"],
                dev["last"], dev["ring"], dev["ring_cnt"], entry, feed, rem,
                active, reset, freeze, seeds, temps, topks, topps, sample)

    def _upload(self, arrays: list) -> list:
        """Copy this dispatch's host inputs to the device in ONE transfer:
        packed into one int32 buffer (float32 arrays by their bits), from
        pinned memory with a non-blocking copy on the engine's stream.
        PyTorch's pinned allocator does not hand the buffer out again
        until that copy has run."""
        sizes = [a.size for a in arrays]
        cuda = self._device.type == "cuda"
        host = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=cuda)
        flat = host.numpy()
        off = 0
        for a, n in zip(arrays, sizes):
            src = a.reshape(-1)
            flat[off:off + n] = (src.view(np.int32)
                                 if src.dtype == np.float32 else src)
            off += n
        dev = host.to(self._device, non_blocking=True) if cuda else host
        out, off = [], 0
        for a, n in zip(arrays, sizes):
            part = dev[off:off + n].view(a.shape)
            if a.dtype == np.float32:
                part = part.view(torch.float32)
            elif a.dtype == np.bool_:
                part = part != 0
            out.append(part)
            off += n
        return out

    # ---------------------------------------------------- paged admission

    def _try_reserve_paged(self, req: _Request) -> Optional[dict]:
        """Paged admission, host half: the longest full-block prefix match
        (its chain pinned) and a reservation of the stream's worst case
        (prompt + budget) less the shared blocks. None when the pool
        cannot cover it yet: the match is released and the caller parks
        the request. A hit needs no device work."""
        bl = self._kv_block_len
        handle = None
        if self._prefix_index is not None and len(req.prompt) > bl:
            handle = self._acquire_prefix(req.prompt)
        matched = handle.matched_tokens if handle is not None else 0
        # the worst case is the wire prompt plus the budget: a resumed
        # stream's folded prompt must not inflate it
        need = min(-(-req.cap_tokens // bl), self._kv_max_blocks) \
            - matched // bl
        if not self._kv_index.reserve(need):
            if handle is not None:
                self._prefix_index.release(handle)
            return None
        return {"handle": handle, "matched": matched, "need": need}

    def _acquire_prefix(self, tokens):
        """The prefix match of an admission; a chain that crossed blocks
        restored from the host tier counts as a tier hit."""
        handle = self._prefix_index.acquire(tokens)
        if handle is not None and handle.restored_blocks:
            self.gen_stats.record_tier_hit()
        return handle

    def _bind_paged(self, req: _Request, slot: _Slot, staged: dict,
                    lane: bool = False) -> None:
        """Apply a staged admission: the shared chain of a hit becomes the
        head of the slot's table (no copy: its rows are attended where
        they lie in the pool), the stream grows into its reservation, and
        its start position (0, or the matched length) rides the next
        dispatch as data. A ``lane`` slot needs no pending position: its
        chunks set the position from the host cursor."""
        handle, matched = staged["handle"], staged["matched"]
        slot.reserved_left = staged["need"]
        slot.blocks = []
        slot.n_shared = 0
        slot.pos_pending = None if lane else 0
        if handle is not None:
            req.prefix = handle
            slot.blocks = list(handle.block_ids)
            slot.n_shared = len(handle.block_ids)
            slot.cursor = slot.pos_hi = matched
            slot.pos_pending = None if lane else matched
            self.gen_stats.record_prefix_hit(matched)
            if req.trace is not None:
                req.trace.event(trace_mod.PREFIX_HIT, matched_tokens=matched)
        elif (self._prefix_index is not None
                and len(req.prompt) > self._kv_block_len):
            self.gen_stats.record_prefix_miss()

    def _ensure_blocks(self, slot: _Slot, req: _Request, upto: int) -> None:
        """Grow a slot's table to cover positions [0, upto), clamped to the
        stream's worst case and drawn from its reservation (never fails).
        Positions past the allocated entries resolve to scratch."""
        upto = min(upto, req.cap_tokens)
        need = min(-(-upto // self._kv_block_len), self._kv_max_blocks)
        grow = min(need - len(slot.blocks), slot.reserved_left)
        if grow > 0:
            slot.blocks.extend(self._kv_index.alloc(grow))
            slot.reserved_left -= grow

    def _build_tables(self, width_need: int) -> np.ndarray:
        """Every slot's block table as one scratch-padded [S, Bw] int32
        host array; Bw is the smallest bucket covering ``width_need``,
        every live block and every position this round may write."""
        buckets = self._dev["table_buckets"]
        bw = next((b for b in buckets if b >= width_need), buckets[-1])
        tab = np.zeros((self._n_slots, bw), np.int32)
        for i, slot in enumerate(self._slots):
            if slot.req is not None and slot.blocks:
                n = min(len(slot.blocks), bw)
                tab[i, :n] = slot.blocks[:n]
        return tab

    def _free_slot_paged(self, slot: _Slot, req: Optional[_Request],
                         commit: bool, tokens=None) -> None:
        """Retire a paged slot (idempotent; the slot layout has nothing to
        return): with ``commit`` and the prefix cache on, the full blocks
        of the prompt (or of ``tokens``: a preemption commits the
        extended context and pins it for the resume,
        ``commit_stream_pinned``) are DONATED to the trie (no copy: the
        rows are in the pool already), then every other private block is
        freed and the unused reservation returned. The shared chain is
        never freed here: the trie owns it, and its pin is released when
        the request closes. Kernels already enqueued keep reading their
        table snapshot; any later writer of a freed or donated block, and
        any later reader of a donated one, is enqueued behind them."""
        if not self._paged:
            return
        donated: set = set()
        if (commit and req is not None and self._prefix_index is not None
                and len(slot.blocks) > slot.n_shared):
            toks = tokens if tokens is not None else req.prompt
            if self._preempt_on and req.resume_pending:
                donated, req.resume_pin = \
                    self._kv_index.commit_stream_pinned(
                        toks, slot.blocks, policy=self._prefix_policy)
            else:
                donated = self._kv_index.commit_stream(
                    toks, slot.blocks, policy=self._prefix_policy)
        self._kv_index.free([b for j, b in enumerate(slot.blocks)
                             if j >= slot.n_shared and b not in donated])
        if slot.reserved_left:
            self._kv_index.unreserve(slot.reserved_left)
        slot.blocks = []
        slot.n_shared = 0
        slot.reserved_left = 0
        slot.pos_pending = None

    # ------------------------------------------- the slot layout's prefix pool

    def _restore_prefix(self, idx: int, req: _Request, slot: _Slot,
                        lane: bool = False) -> bool:
        """Prefix-cache admission under the slot layout: the longest
        full-block match is copied into the slot's rows ``[0, matched)``
        by one bucketed ``pool_to_slot``, which also sets the slot's
        position, and the prompt resumes there (a cursor above 0 also
        keeps the next chunk from resetting the slot). ``lane`` acts on
        the dedicated lane's state (the reference's
        ``state_key="lane_state"``) instead of the decode slots'. Under
        ``prefill_mode="batched"`` a match that leaves more than one chunk
        uncovered is released and counted as a miss: the token-level
        resume would be slower than the batched forward it replaces.
        Returns True on a hit."""
        if len(req.prompt) <= self._prefix_block_len:
            return False  # sub-block prompts can never match
        handle = self._acquire_prefix(req.prompt)
        if handle is None:
            self.gen_stats.record_prefix_miss()
            return False
        if (self._prefill_enabled
                and len(req.prompt) - handle.matched_tokens > self._chunk):
            self._prefix_index.release(handle)
            self.gen_stats.record_prefix_miss()
            return False
        req.prefix = handle
        bucket = next(b for b in self._dev["prefix_buckets"]
                      if b >= len(handle.block_ids))
        (ids,) = self._upload([pad_block_ids(handle.block_ids, bucket)])
        cache, pos = self._slot_state(lane)
        pool_to_slot(self._dev["prefix_pool"], cache, pos, idx, ids,
                     handle.matched_tokens)
        # pool->slot KV gather: device time, no model FLOPs
        self._note_dispatch("gather", outputs=pos)
        slot.cursor = slot.pos_hi = handle.matched_tokens
        slot.draft_ready = False
        self.gen_stats.record_prefix_hit(handle.matched_tokens)
        if req.trace is not None:
            req.trace.event(trace_mod.PREFIX_HIT,
                            matched_tokens=handle.matched_tokens)
        return True

    def _slot_state(self, lane: bool) -> tuple:
        """(KV tensors, positions) of the slot layout's decode slots, or
        of the dedicated lane's with ``lane``."""
        if lane:
            return self._dev["lane_cache"], self._dev["lane_pos"]
        return self._dev["cache"], self._dev["pos"]

    def _commit_prefix(self, idx: int, req: _Request, tokens=None,
                       lane: bool = False) -> None:
        """Commit a request's uncovered full prompt blocks (or those of
        ``tokens``: a preemption commits the prompt and the generated
        tokens, whose rows the slot holds too; a lane handoff the prompt
        ingested so far) from slot ``idx`` (of the dedicated lane's state
        with ``lane``) to the prefix pool: one bucketed ``slot_to_pool``
        over the plan's contiguous tail run, then the plan's nodes are
        unpinned.

        Stream order is what makes this right, as device FIFO order is in
        the reference: the copy is enqueued on the engine's stream while
        the slot still holds the request, so it runs after every chunk
        that wrote the prompt's rows and before any later chunk that can
        see the slot free (a free slot parks at position 0 and writes row
        0) or a new request in it; a later ``pool_to_slot`` of these
        blocks is enqueued behind it as well."""
        plan = self._prefix_index.plan_commit(
            tokens if tokens is not None else req.prompt,
            policy=self._prefix_policy)
        if not plan:
            return
        ids = [bid for bid, _off, _node in plan]
        bucket = next(b for b in self._dev["prefix_buckets"]
                      if b >= len(ids))
        offs = np.zeros(bucket, np.int32)  # padding reads rows [0, bl)
        offs[:len(plan)] = [off for _bid, off, _node in plan]
        ids_d, offs_d = self._upload([pad_block_ids(ids, bucket), offs])
        slot_to_pool(self._dev["prefix_pool"], self._slot_state(lane)[0],
                     idx, ids_d, offs_d)
        # slot->pool KV scatter: device time, no model FLOPs
        self._note_dispatch("scatter", outputs=self._dev["prefix_pool"])
        self._prefix_index.finish_commit(plan)

    # ---------------------------------------------------------- engine loop

    def _admissible(self, req: _Request) -> bool:
        """The deadline and cancel gate where a request leaves the queue:
        one that expired or was cancelled while queued is settled here
        (504 / 499) instead of taking a slot."""
        if req.finished:
            # closed while queued (the consumer's cancel or deadline)
            return False
        if req.deadline_ns and now_ns() >= req.deadline_ns:
            self._close_request(
                req, ServerError(
                    "generation request deadline expired before a slot "
                    "was available", 504), outcome="deadline")
            return False
        if req.cancel_ev is not None and req.cancel_ev.is_set():
            self.cancel(req)
            return False
        return True

    def _reap_slots(self) -> None:
        """The dispatch-boundary sweep: settle and free every decode or
        lane slot whose request's deadline passed, whose cancel Event is
        set, or which was closed from outside (a consumer's cancel or
        deadline). It runs once per engine iteration, so such a stream
        holds its slot for at most one more dispatch, never to its
        budget. Nothing is committed: its blocks are freed, its pins
        released."""
        now = now_ns()
        for slot in self._slots + self._lane_slots:
            req = slot.req
            if req is None:
                continue
            if req.finished:
                # a pin the engine assigned after the consumer's close
                # settles here
                self._release_prefix(req)
            elif req.deadline_ns and now >= req.deadline_ns:
                self._close_request(
                    req, ServerError("generation request deadline exceeded "
                                     "while decoding", 504),
                    outcome="deadline")
            elif req.cancel_ev is not None and req.cancel_ev.is_set():
                self.cancel(req)
            else:
                continue
            slot.req = None
            slot.draft_ready = False
            self._free_slot_paged(slot, req, commit=False)

    # ------------------------------------------------------ slot preemption

    def _quiesce(self) -> None:
        """Deliver everything in flight: issue the pending ring fetch and
        drain every outstanding one, so each slot's emitted tokens and
        ``pos_hi`` (speculation's correction included) are exact before a
        preemption folds the tokens into the prompt and commits the rows
        below ``pos_hi``."""
        if self._unfetched:
            self._fetches.append(self._issue_fetch(self._unfetched))
            self._unfetched.clear()
        first = True
        while self._fetches:
            self._drain_fetch(self._fetches[0], cadence=first)
            first = False
            self._fetches.popleft()

    def _maybe_preempt(self) -> None:
        """The preemption trigger, once per iteration: when no slot is
        free, the fair-order head's class burns at or above the preempt
        threshold (0: on weight alone) and a running stream's class
        weight is STRICTLY below the head's, the lowest-weight such
        stream under ``max_preemptions`` is preempted."""
        if not self._preempt_on:
            return
        if any(s.req is None for s in self._slots):
            return
        head_key = self._pending.peek_key()
        if head_key is None:
            return
        w_head = self._class_weight(head_key[1])
        if self.slo_stats.class_burn(head_key[1]) \
                < self.preempt_burn_threshold:
            return
        victim, victim_w = None, w_head
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None or req.finished:
                continue
            w = self._class_weight(req.slo_class)
            if w < victim_w \
                    and req.preempt_count < self._sched.max_preemptions:
                victim, victim_w = i, w
        if victim is None:
            return
        # the fold needs the victim's exact tokens; the drain may itself
        # end streams or free slots, so look again before acting
        self._quiesce()
        req = self._slots[victim].req
        if req is None or req.finished \
                or any(s.req is None for s in self._slots):
            return
        self._preempt_slot(victim)

    def _preempt_slot(self, idx: int) -> None:
        """Preempt one running stream (after ``_quiesce``): commit its
        extended context, the prompt and every token it generated, whose
        rows its kernels have written (a block donation under the paged
        layout, one ``slot_to_pool`` under the slot layout) and pin the
        chain; free the slot; and re-queue the request behind its flow's
        siblings with the generated tokens folded into its prompt and
        its queue clock restamped. Its resume matches the committed chain
        and re-ingests the tail, token for token what an uninterrupted
        greedy run emits."""
        slot = self._slots[idx]
        req = slot.req
        gen = list(req.gen_tokens or ())
        extended = (np.concatenate([req.prompt, np.asarray(gen, np.int32)])
                    if gen else req.prompt)
        # the rows written on the card: exact after the quiesce (a victim
        # still taking in its prompt commits what it took in)
        commit_toks = extended[:min(slot.pos_hi, len(extended))]
        req.resume_pending = True   # the paged commit pins for the resume
        if self._paged:
            self._free_slot_paged(slot, req, commit=True, tokens=commit_toks)
        elif self._prefix_index is not None:
            self._commit_prefix(idx, req, tokens=commit_toks)
            if len(commit_toks) > self._prefix_block_len:
                self._release_resume_pin(req)
                req.resume_pin = self._prefix_index.acquire(commit_toks)
        # the resume acquires its own, longer match
        self._release_prefix(req)
        slot.req = None
        slot.draft_ready = False
        req.prompt = extended
        if req.gen_tokens is not None:
            req.gen_tokens = []
        req.preempt_count += 1
        # the resume's queue wait measures the requeue (its TTFT is set)
        req.enqueue_ns = now_ns()
        self.gen_stats.record_preemption()
        self._sched_stats.record_preemption(req.tenant, req.slo_class)
        if req.trace is not None:
            req.trace.event(trace_mod.SCHED_PREEMPT, generated=len(gen),
                            preempt_count=req.preempt_count)
        self._pending.requeue(req, (req.tenant, req.slo_class))

    def _record_admission(self, req: _Request) -> None:
        """A request took a slot: drop its parked marker, record its queue
        wait, and, for a resume, release the preemption's pin (the
        admission holds its own match by now on the paged layout, and
        takes it next on the slot layout) and count the resume."""
        if req.parked:
            req.parked = False
            req.park_bypasses = 0
            self._pending.unpark()
        self._admissions += 1
        admit_ns = now_ns()
        req.queue_wait_ns = max(0, admit_ns - req.enqueue_ns)
        self.gen_stats.record_queue_wait(
            req.queue_wait_ns,
            trace_id=req.trace.id if req.trace is not None else "")
        if req.trace is not None:
            req.trace.span(trace_mod.QUEUE_WAIT, req.enqueue_ns, admit_ns,
                           tenant=req.tenant, slo_class=req.slo_class)
        self.slo_stats.record_queue_wait(req.tenant, req.slo_class,
                                         req.queue_wait_ns)
        if req.resume_pending:
            req.resume_pending = False
            self._release_resume_pin(req)
            self.gen_stats.record_resume()
            if self._sched_stats is not None:
                self._sched_stats.record_resume(req.tenant, req.slo_class)

    def _admit(self, held: Optional[_Request] = None) -> bool:
        """Fill free slots from the queue in its order (``held`` first).
        Under the paged layout a request whose reservation fails is PARKED
        at its flow's head (it keeps its place). Without a scheduler that
        stops admission, so a big request is never starved by later small
        ones; with one, admission skips to the next flow's head, at most
        ``park_bypass_limit`` admissions past each parked request and
        ``2 * n_slots`` reservation tries per pass, and a parked flow's
        later entries stay behind it. The slot layout admits with no
        tables (the next chunk resets the slot's position while its
        cursor is 0). With the prefix cache on, the slot layout restores a
        match here (``_restore_prefix``) and the paged layout binds it;
        under ``prefill_mode="batched"`` a prompt longer than one chunk
        that was not restored is ingested here, by one forward. With a
        dedicated lane, ``_admit_disagg`` admits instead. Returns True if
        any slot is occupied afterwards."""
        if self._lane_on:
            return self._admit_disagg(held)
        exhausted = False
        admitted_n = 0          # slots filled this pass
        # (req, parked, first park, admissions before it): parked heads
        # and their flows' later entries, re-inserted after the pass
        deferred: list = []
        parked_flows: set = set()
        tries_left = 2 * self._n_slots
        for i, slot in enumerate(self._slots):
            if exhausted:
                break
            if slot.req is not None:
                continue
            req = staged = None
            while not exhausted:
                if held is not None:
                    cand, held = held, None
                else:
                    try:
                        cand = self._pending.get_nowait()
                    except queue.Empty:
                        exhausted = True
                        break
                if not self._admissible(cand):
                    # settled while queued; a parked entry leaving the
                    # queue drops its marker
                    if cand.parked:
                        cand.parked = False
                        self._pending.unpark()
                    continue
                if (cand.tenant, cand.slo_class) in parked_flows:
                    deferred.append((cand, False, False, 0))
                    continue
                if self._paged:
                    tries_left -= 1
                    staged = self._try_reserve_paged(cand)
                    if staged is None:
                        first = not cand.parked
                        cand.parked = True
                        parked_flows.add((cand.tenant, cand.slo_class))
                        deferred.append((cand, True, first, admitted_n))
                        if self._sched is not None and tries_left > 0 \
                                and cand.park_bypasses \
                                < self._sched.park_bypass_limit:
                            continue    # the next flow's head
                        exhausted = True
                        break
                req = cand
                break
            if req is None:
                break
            self._fill_slot(slot, req)
            admitted_n += 1
            if self._paged:
                self._bind_paged(req, slot, staged)
                continue
            restored = (self._prefix_index is not None
                        and self._restore_prefix(i, req, slot))
            if (not restored and self._prefill_enabled
                    and len(req.prompt) > self._chunk):
                self._prefill_slot(i, req, slot)
        # re-insert in reverse pop order, which restores the order; an
        # admission made after a park counts against its bypass bound
        for req, is_parked, first, before in reversed(deferred):
            if is_parked and admitted_n > before:
                req.park_bypasses += 1
            self._pending.push_front(req, (req.tenant, req.slo_class),
                                     parked=is_parked and first)
        if held is not None:   # no free slot took it
            self._pending.push_front(held, (held.tenant, held.slo_class))
        return any(s.req is not None for s in self._slots)

    # ------------------------------------------- the dedicated prefill lane

    def _needs_lane(self, req: _Request) -> bool:
        """Whether a candidate goes through the lane: a prompt longer than
        one decode chunk (a shorter one feeds within one chunk dispatch),
        and under the slot layout one with at least one full block to
        hand off through the pool."""
        plen = len(req.prompt)
        if plen <= self._chunk:
            return False
        if not self._paged:
            return (plen - 1) // self._prefix_block_len > 0
        return True

    def _lane_target(self, req: _Request) -> int:
        """Where lane ingestion ends: the whole prompt under the paged
        layout (its final chunk selects the first token), the last full
        block below the prompt's last token under the slot layout (the
        pool carries full blocks only, a match stops one token short, and
        the tail feeds token by token in the decode slot)."""
        plen = len(req.prompt)
        if self._paged:
            return plen
        bl = self._prefix_block_len
        return ((plen - 1) // bl) * bl

    def _lane_done(self, slot: _Slot, req: _Request) -> bool:
        """A lane slot is ready to hand off once its cursor reached the
        lane target, or once no lane bucket fits below max_seq (the few
        tokens left feed token by token on the decode side)."""
        if slot.cursor >= self._lane_target(req):
            return True
        return slot.cursor + self._dev["lane_buckets"][0] > self._cfg.max_seq

    def _admit_disagg(self, held: Optional[_Request] = None) -> bool:
        """Admission with a dedicated lane: ready lane slots hand off to
        free decode slots first (oldest lane admission first), then free
        slots of both kinds fill from the queue in its order, each
        candidate routed by ``_needs_lane``. A candidate whose slot kind is
        full goes back to its flow's head, and its flow's later entries
        behind it (strict order within a flow), so a backlog of long
        prompts cannot block short ones from free decode slots, nor the
        other way round. A failed paged reservation parks the request and
        ends the pass (no bypass). Fresh arrivals keep their standing
        against ``queue_depth`` when they go back. Returns True if any
        decode or lane slot is occupied afterwards."""
        self._do_handoffs()
        deferred: list = []      # (req, first park, counted)
        deferred_flows: set = set()
        bound = 2 * (self._n_slots + self._lane_n)
        tries_left = bound
        while True:
            if not any(s.req is None for s in self._slots) \
                    and not any(s.req is None for s in self._lane_slots):
                break
            if len(deferred) > bound:
                # a deep queue of the other kind's candidates must not
                # turn one pass into a scan of the queue
                break
            if held is not None:
                cand, held = held, None
                counted = False
            else:
                try:
                    cand, counted = self._pending.get_entry_nowait()
                except queue.Empty:
                    break
            if not self._admissible(cand):
                if cand.parked:
                    cand.parked = False
                    self._pending.unpark()
                continue
            key = (cand.tenant, cand.slo_class)
            if key in deferred_flows:
                deferred.append((cand, False, counted))
                continue
            lane = self._needs_lane(cand)
            table = self._lane_slots if lane else self._slots
            idx = next((i for i, s in enumerate(table) if s.req is None),
                       None)
            if idx is None:
                deferred.append((cand, False, counted))
                deferred_flows.add(key)
                continue
            staged = None
            if self._paged:
                if tries_left <= 0:
                    deferred.append((cand, False, counted))
                    break
                tries_left -= 1
                staged = self._try_reserve_paged(cand)
                if staged is None:
                    first = not cand.parked
                    cand.parked = True
                    deferred.append((cand, first, counted))
                    break
            if lane:
                self._bind_lane_slot(idx, cand, staged)
            else:
                self._bind_decode_direct(idx, cand, staged)
        if held is not None:
            # both kinds filled before the idle path's request was placed
            deferred.insert(0, (held, False, False))
        for cand, first_park, counted in reversed(deferred):
            self._pending.push_front(cand, (cand.tenant, cand.slo_class),
                                     parked=first_park, counted=counted)
        return (any(s.req is not None for s in self._slots)
                or any(s.req is not None for s in self._lane_slots))

    def _fill_slot(self, slot: _Slot, req: _Request) -> None:
        """A request takes a free slot: fresh cursors, then the admission
        record."""
        slot.req = req
        slot.cursor = 0
        slot.pos_hi = 0
        slot.decode_dispatched = 0
        slot.pos_pending = None
        slot.draft_ready = False
        self._record_admission(req)

    def _bind_lane_slot(self, idx: int, req: _Request,
                        staged: Optional[dict]) -> None:
        """Admit a candidate into lane slot ``idx``: the staged paged
        reservation (a hit's chain heads the table, no copy) or, under
        the slot layout, a prefix restore into the lane's rows, and the
        admission order the handoffs follow."""
        slot = self._lane_slots[idx]
        self._fill_slot(slot, req)
        slot.adm_seq = self._lane_adm_seq
        self._lane_adm_seq += 1
        if staged is not None:
            self._bind_paged(req, slot, staged, lane=True)
        elif self._prefix_index is not None:
            self._restore_prefix(idx, req, slot, lane=True)

    def _bind_decode_direct(self, idx: int, req: _Request,
                            staged: Optional[dict]) -> None:
        """Admit a short-prompt candidate straight into decode slot
        ``idx`` (its prompt feeds within one chunk)."""
        slot = self._slots[idx]
        self._fill_slot(slot, req)
        if staged is not None:
            self._bind_paged(req, slot, staged)
        elif self._prefix_index is not None:
            self._restore_prefix(idx, req, slot)

    def _do_handoffs(self) -> None:
        """Move every ready lane slot onto a free decode slot, oldest lane
        admission first. Runs at the top of each admission pass, so a
        prompt whose final lane chunk was dispatched last round decodes
        this round."""
        while True:
            d_idx = next((i for i, s in enumerate(self._slots)
                          if s.req is None), None)
            if d_idx is None:
                return
            ready = [(s.adm_seq, i) for i, s in enumerate(self._lane_slots)
                     if s.req is not None and not s.req.finished
                     and self._lane_done(s, s.req)]
            if not ready:
                return
            self._handoff(min(ready)[1], d_idx)

    def _handoff(self, l_idx: int, d_idx: int) -> None:
        """Hand one prompt from lane slot ``l_idx`` to decode slot
        ``d_idx``.

        Paged: the block table moves on the host (the KV stays in the
        pool: no copy) and ``lane_handoff`` moves the position and the
        first token on the engine's stream; the decode slot starts at
        the lane's cursor, so its first chunk consumes the first token
        like any slot whose prompt is in.

        Slot layout: the lane slot's full blocks commit from the lane's
        rows to the prefix pool, the prompt's chain is acquired pinned
        BEFORE the lane's own handle is released (in the other order the
        LRU could evict the rows between the two), and ``pool_to_slot``
        restores it into the decode slot; the tail feeds token by token.
        Every copy is enqueued on the engine's stream behind the lane
        chunks that wrote the rows and ahead of any later lane chunk in
        the lane slot."""
        t0 = time.perf_counter()
        lane = self._lane_slots[l_idx]
        d = self._slots[d_idx]
        req = lane.req
        start_ns = now_ns() if req.trace is not None else 0
        d.req = req
        d.draft_ready = False
        d.decode_dispatched = 0
        d.pos_pending = None
        dev = self._dev
        if self._paged:
            d.blocks, lane.blocks = lane.blocks, []
            d.n_shared, lane.n_shared = lane.n_shared, 0
            d.reserved_left, lane.reserved_left = lane.reserved_left, 0
            d.cursor = d.pos_hi = lane.cursor
            lane_handoff(dev["pos"], dev["last"], dev["lane_pos"],
                         dev["lane_last"], d_idx, l_idx)
            # a position and token move: device time, no FLOPs
            self._note_dispatch("handoff", outputs=dev["last"])
        else:
            self._commit_prefix(l_idx, req, tokens=req.prompt[:lane.cursor],
                                lane=True)
            handle = self._acquire_prefix(req.prompt)
            self._release_prefix(req)
            d.cursor = d.pos_hi = 0
            if handle is not None:
                req.prefix = handle
                bucket = next(b for b in dev["prefix_buckets"]
                              if b >= len(handle.block_ids))
                (ids,) = self._upload([pad_block_ids(handle.block_ids,
                                                     bucket)])
                pool_to_slot(dev["prefix_pool"], dev["cache"], dev["pos"],
                             d_idx, ids, handle.matched_tokens)
                # pool->slot KV gather: device time, no model FLOPs
                self._note_dispatch("gather", outputs=dev["pos"])
                d.cursor = d.pos_hi = handle.matched_tokens
        lane.req = None
        lane.cursor = 0
        lane.pos_hi = 0
        lane.pos_pending = None
        self._lane_handoffs += 1
        self.gen_stats.record_lane_handoff()
        if req.trace is not None:
            # the host side of the move: the table edit (paged) or the
            # commit, acquire and restore (slot layout)
            req.trace.span(trace_mod.LANE_HANDOFF, start_ns, now_ns(),
                           prompt_tokens=int(len(req.prompt)),
                           decode_slot=d_idx)
        self._kind_s["handoff"] += time.perf_counter() - t0
        self._kind_n["handoff"] += 1

    def _dispatch_lane_dedicated(self) -> int:
        """The dedicated lane's pass of a round: up to
        ``prefill_token_budget`` prompt tokens across the lane slots, one
        bucketed chunk of at most ``prefill_lane_width`` tokens per slot
        per pass, round robin from a rotating start, into the lane's own
        state (decode slots are never touched). With ``prefill_lane_batch``
        the pass packs its chunks into batched dispatches instead
        (``_dispatch_lane_batched``). Returns the lane tokens
        dispatched."""
        if self._lane_batch:
            return self._dispatch_lane_batched()
        budget = self._prefill_budget
        dispatched = 0
        progress = True
        while progress and dispatched < budget:
            progress = False
            start = self._lane_rr % self._lane_n
            for off in range(self._lane_n):
                i = (start + off) % self._lane_n
                slot = self._lane_slots[i]
                req = slot.req
                if req is None or req.finished \
                        or self._lane_done(slot, req):
                    continue
                if dispatched >= budget:
                    break
                assigned = self._lane_assignment(slot, req,
                                                 budget - dispatched)
                if assigned is None:
                    continue
                _pos0, clen, _cap = assigned
                bucket = next(b for b in self._dev["lane_buckets"]
                              if b >= clen)
                self._dispatch_prefill_chunk(i, slot, req, clen, bucket,
                                             lane=True)
                self._lane_rr = i + 1
                dispatched += clen
                progress = True
        return dispatched

    def _lane_assignment(self, slot: _Slot, req: _Request,
                         budget_left: int) -> Optional[tuple]:
        """One lane slot's next chunk, the one sizing rule of the per-slot
        and the batched passes: min(lane width, target left, budget left)
        real tokens, clamped to ``cap``, the largest lane bucket that
        still fits below max_seq at the cursor. Returns ``(pos0, clen,
        cap)``, or None when nothing can go (no budget, or no bucket
        fits)."""
        pos0 = slot.cursor
        clen = min(self._lane_width, self._lane_target(req) - pos0,
                   budget_left)
        fit = self._cfg.max_seq - pos0
        usable = [b for b in self._dev["lane_buckets"] if b <= fit]
        if clen <= 0 or not usable:
            return None
        cap = usable[-1]
        return pos0, min(clen, cap), cap

    def _dispatch_lane_batched(self) -> int:
        """The batched lane's pass: the per-slot pass's order and sizing
        rule, with up to ``prefill_lane_batch`` chunks packed into one
        ``[B, Lc]`` dispatch, Lc the smallest lane bucket covering the
        longest chunk; rows whose slab would not fit below max_seq at
        that width go in narrower groups within the same pass (the
        longest chunk's row always fits its bucket, so the groups
        shrink). Token-identical to the per-slot pass: ingestion resumes
        at any offset and rows are independent. Returns the lane tokens
        dispatched."""
        budget = self._prefill_budget
        dispatched = 0
        progress = True
        while progress and dispatched < budget:
            progress = False
            rows = []            # (idx, slot, req, pos0, clen, cap)
            taken = 0
            start = self._lane_rr % self._lane_n
            for off in range(self._lane_n):
                if len(rows) >= self._lane_batch \
                        or dispatched + taken >= budget:
                    break
                i = (start + off) % self._lane_n
                slot = self._lane_slots[i]
                req = slot.req
                if req is None or req.finished \
                        or self._lane_done(slot, req):
                    continue
                assigned = self._lane_assignment(
                    slot, req, budget - dispatched - taken)
                if assigned is None:
                    continue
                pos0, clen, cap = assigned
                rows.append((i, slot, req, pos0, clen, cap))
                taken += clen
                self._lane_rr = i + 1
            if not rows:
                break
            while rows:
                bucket = next(b for b in self._dev["lane_buckets"]
                              if b >= max(r[4] for r in rows))
                group = [r for r in rows if r[5] >= bucket]
                rows = [r for r in rows if r[5] < bucket]
                self._dispatch_lane_batch_rows(group, bucket)
                dispatched += sum(r[4] for r in group)
            progress = True
        return dispatched

    def _dispatch_lane_batch_rows(self, rows: list, bucket: int) -> None:
        """One batched lane dispatch (async) of ``rows``' chunks at width
        ``bucket``, padded to the smallest row-count bucket. Padding rows
        carry the lane state's scratch row ``prefill_slots`` (and, paged,
        all-zero tables: scratch block 0), so they write only what
        nothing reads."""
        t0 = time.perf_counter()
        start_ns = now_ns()
        n = len(rows)
        bb = next(b for b in self._dev["lane_b_buckets"] if b >= n)
        idxs = np.full((bb,), self._lane_n, np.int32)
        toks = np.zeros((bb, bucket), np.int32)
        pos0s = np.zeros((bb,), np.int32)
        clens = np.ones((bb,), np.int32)
        finals = np.zeros((bb,), np.bool_)
        seeds = np.zeros((bb,), np.int32)
        temps = np.zeros((bb,), np.float32)
        topks = np.zeros((bb,), np.int32)
        topps = np.zeros((bb,), np.float32)
        for r, (i, _slot, req, pos0, clen, _cap) in enumerate(rows):
            idxs[r] = i
            toks[r, :clen] = req.prompt[pos0:pos0 + clen]
            pos0s[r] = pos0
            clens[r] = clen
            finals[r] = pos0 + clen >= len(req.prompt)
            seeds[r] = req.seed
            temps[r] = req.temperature
            topks[r] = req.top_k
            topps[r] = req.top_p
        arrays = [idxs, toks, pos0s, clens, finals, seeds, temps, topks,
                  topps]
        if self._paged:
            tabs = np.zeros((bb, self._cfg.max_seq // self._kv_block_len),
                            np.int32)
            for r, (_i, slot, req, pos0, clen, _cap) in enumerate(rows):
                self._ensure_blocks(slot, req, pos0 + clen)
                tabs[r, :len(slot.blocks)] = slot.blocks
            arrays.append(tabs)
        (idxs_d, toks_d, pos0s_d, clens_d, finals_d, seeds_d, temps_d,
         topks_d, topps_d, *tabs_d) = self._upload(arrays)
        sampling = (seeds_d, temps_d, topks_d, topps_d)
        dev = self._dev
        if self._paged:
            paged_lane_batch(self._cfg, dev["params"], dev["pool"],
                             dev["lane_pos"], dev["lane_last"],
                             idxs_d.long(), tabs_d[0], toks_d, pos0s_d,
                             clens_d, finals_d, sampling)
        else:
            lane_batch_kernel(self._cfg, dev["params"], dev["lane_cache"],
                              dev["lane_pos"], dev["lane_last"],
                              idxs_d.long(), toks_d, pos0s_d, clens_d,
                              finals_d, sampling)
        total = 0
        end_ns = now_ns()
        for r, (i, slot, req, pos0, clen, _cap) in enumerate(rows):
            slot.cursor += clen
            slot.pos_hi = max(slot.pos_hi, slot.cursor)
            total += clen
            if req.trace is not None:
                # every packed row spans the one shared dispatch window
                req.trace.span(trace_mod.PREFILL_CHUNK, start_ns, end_ns,
                               chunk_tokens=int(clen),
                               chunk_index=int(pos0 // max(1, clen)),
                               lane_slot=int(i), batched=True)
                if finals[r]:
                    req.trace.event(trace_mod.PREFILL_END)
        # one dispatch: one lane chunk, and the pair that gives its fill
        self._prefill_chunks_dispatched += 1
        self._prefill_tokens_dispatched += total
        self.gen_stats.record_lane_batch(n, total)
        # the [bb, bucket] batch's FLOPs: real rows' real columns are
        # useful (with a logit pass on final chunks); their bucket-padding
        # columns and the bb - n padding rows are waste
        fm = self._flop_model
        useful = 0
        w_pad = (bb - n) * fm.span(0, bucket, logits=False)
        for r, (_i, _slot, _req, pos0, clen, _cap) in enumerate(rows):
            useful += (fm.span(pos0, clen, logits=False)
                       + (fm.logits if finals[r] else 0))
            w_pad += fm.span(pos0 + clen, bucket - clen, logits=False)
        self._note_dispatch(f"lane_batch{bb}", useful, {"padding": w_pad},
                            outputs=dev["lane_last"])
        self._kind_s["lane_batch"] += time.perf_counter() - t0
        self._kind_n["lane_batch"] += 1

    def _sampling(self, req: _Request) -> tuple:
        """A request's sampling parameters as host arrays for ``_upload``:
        (int32 [seed, top_k], float32 [temperature, top_p])."""
        return (np.asarray([req.seed, req.top_k], np.int32),
                np.asarray([req.temperature, req.top_p], np.float32))

    def _prefill_slot(self, idx: int, req: _Request, slot: _Slot) -> None:
        """Admit by batched prefill: one forward over the bucket-padded
        prompt writes the slot's rows and selects the first token, behind
        any chunk already enqueued (which saw this slot free). The whole
        prompt is consumed, so the slot's first chunk decodes (its cursor
        is not 0, so no reset)."""
        plen = len(req.prompt)
        bucket = next(b for b in self._dev["prefill_buckets"] if b >= plen)
        padded = np.zeros(bucket, np.int32)
        padded[:plen] = req.prompt
        toks, ints, floats = self._upload([padded, *self._sampling(req)])
        dev = self._dev
        prefill_into_slot(self._cfg, dev["params"], dev["cache"], dev["pos"],
                          dev["last"], idx, toks, plen,
                          (ints[0], floats[0], ints[1], floats[1]))
        slot.cursor = plen
        slot.pos_hi = plen
        fm = self._flop_model
        self._note_dispatch(
            "prefill", fm.span(0, plen, logits=False) + fm.logits,
            {"padding": fm.span(plen, bucket - plen, logits=False)},
            outputs=dev["last"])
        if req.trace is not None:
            # the forward is enqueued: the host side of the admission ends
            req.trace.event(trace_mod.PREFILL_END)

    def _in_lane(self, slot: _Slot, req: _Request) -> bool:
        """True while a decode slot's prompt belongs to the piggyback
        chunked-prefill lane: more than one chunk of prompt left (a
        shorter tail feeds through the chunk kernel) and the smallest lane
        bucket still fits below max_seq (a chunk must never clamp at the
        end of the rows). Never with a dedicated lane: prompts ingest in
        the lane's own slots, so a decode chunk carries no prefill
        rider."""
        if not self._chunked_prefill or self._lane_on:
            return False
        if len(req.prompt) - slot.cursor <= self._chunk:
            return False
        return (slot.cursor + self._dev["pchunk_buckets"][0]
                <= self._cfg.max_seq)

    def _on_spec_track(self, req: _Request, ceiling: int) -> bool:
        """True while a stream's decode belongs to verify rounds: the
        engine has a draft, the ceiling is nonzero and the stream has not
        latched to plain decode."""
        return (self._spec is not None and ceiling > 0
                and req.spec is not None and not req.spec.fallback)

    def _slot_modes(self) -> tuple:
        """Each slot's work this round: None (free), "prefill" (a frozen
        rider whose prompt goes through the lane), "chunk" (prompt
        feeding or plain decode in the chunk kernel) or "spec" (a verify
        round). A slot speculates once its prompt is fully dispatched,
        while its stream is on the speculation track and a full round at
        the configured gamma fits below max_seq (else the stream latches
        to plain decode: positions only grow). The draft's catch-up is
        dispatched here the first time a slot qualifies, on the stream
        behind the slot's final prompt chunk, whichever path took the
        prompt in. Returns ``(modes, rungs)``: each "spec" slot's verify
        depth for this round, 0 for the others."""
        modes, rungs = [], []
        # one read of the live ceiling per pass: a cross-thread flip to 0
        # between the gate and the rung pick would select rung 0
        ceiling = self._gamma_ceiling
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None:
                modes.append(None)
                rungs.append(0)
                continue
            if self._in_lane(slot, req):
                modes.append("prefill")
                rungs.append(0)
                continue
            on_track = self._on_spec_track(req, ceiling)
            fed = slot.cursor >= len(req.prompt)
            if (on_track and fed
                    and slot.pos_hi + self._gamma + 1 > self._cfg.max_seq):
                # the verify slab would clamp at the end of the rows
                req.spec.fallback = True
                on_track = False
            spec_ok = on_track and fed
            if spec_ok and not slot.draft_ready:
                self._draft_prefill_slot(i, req)
                slot.draft_ready = True
            modes.append("spec" if spec_ok else "chunk")
            rungs.append(req.spec.select_rung(self._spec_ladder, ceiling)
                         if spec_ok else 0)
        return modes, rungs

    def _draft_prefill_slot(self, idx: int, req: _Request) -> None:
        """The draft's catch-up on a request's whole prompt: one bucketed
        forward into the draft's rows of slot ``idx`` (async)."""
        t0 = time.perf_counter()
        plen = len(req.prompt)
        bucket = next(b for b in self._dev["draft_buckets"] if b >= plen)
        padded = np.zeros(bucket, np.int32)
        padded[:plen] = req.prompt
        (toks,) = self._upload([padded])
        dev = self._dev
        draft_prefill(self._draft.cfg, dev["dparams"], dev["dcache"],
                      dev["dpos"], idx, toks, plen)
        dfm = self._draft_flop_model
        self._note_dispatch(
            "draft_prefill", dfm.span(0, plen, logits=False),
            {"padding": dfm.span(plen, bucket - plen, logits=False)},
            outputs=dev["dpos"])
        self._kind_s["draft_prefill"] += time.perf_counter() - t0
        self._kind_n["draft_prefill"] += 1

    def _dispatch_prefill_lane(self) -> int:
        """This round's lane chunks: up to ``prefill_token_budget`` prompt
        tokens, one chunk per lane slot per pass, round robin from a start
        that rotates across rounds (a fixed start would let the lowest
        slot take a one-chunk budget for its whole prompt); passes repeat
        while budget remains. Returns the lane tokens dispatched."""
        budget = self._prefill_budget
        dispatched = 0
        progress = True
        while progress and dispatched < budget:
            progress = False
            start = self._lane_rr % self._n_slots
            for off in range(self._n_slots):
                i = (start + off) % self._n_slots
                slot = self._slots[i]
                req = slot.req
                if req is None or req.finished \
                        or not self._in_lane(slot, req):
                    continue
                if dispatched >= budget:
                    break
                clen, bucket = self._lane_chunk_shape(slot, req,
                                                      budget - dispatched)
                if clen <= 0:
                    continue
                self._dispatch_prefill_chunk(i, slot, req, clen, bucket)
                self._lane_rr = i + 1
                dispatched += clen
                progress = True
        return dispatched

    def _lane_chunk_shape(self, slot: _Slot, req: _Request,
                          budget_left: int) -> tuple:
        """(clen, bucket) of one lane chunk: min(prefill_chunk, prompt
        left, budget left) real tokens, in the smallest bucket that covers
        them and still fits below max_seq."""
        pos0 = slot.cursor
        clen = min(self._prefill_chunk_len, len(req.prompt) - pos0,
                   budget_left)
        fit = self._cfg.max_seq - pos0
        usable = [b for b in self._dev["pchunk_buckets"] if b <= fit]
        if not usable:
            return 0, 0
        bucket = next((b for b in usable if b >= clen), usable[-1])
        return min(clen, bucket), bucket

    def _dispatch_prefill_chunk(self, idx: int, slot: _Slot, req: _Request,
                                clen: int, bucket: int,
                                lane: bool = False) -> None:
        """One lane chunk (async): ``clen`` prompt tokens into slot
        ``idx`` from its cursor; the prompt's final chunk selects the
        first generated token into the device ``last``, which the decode
        chunk of the same round consumes. Under the paged layout the
        chunk's real rows get their blocks first and the kernel sets the
        position itself, which takes the place of a pending reset. With
        ``lane`` the chunk goes into dedicated lane slot ``idx`` and its
        state (its ``last`` moves to the decode slot at the handoff)."""
        t0 = time.perf_counter()
        start_ns = now_ns() if lane and req.trace is not None else 0
        pos0 = slot.cursor
        padded = np.zeros(bucket, np.int32)
        padded[:clen] = req.prompt[pos0:pos0 + clen]
        final = pos0 + clen >= len(req.prompt)
        arrays = [padded, *self._sampling(req)]
        if self._paged:
            self._ensure_blocks(slot, req, pos0 + clen)
            row = np.zeros((self._cfg.max_seq // self._kv_block_len,),
                           np.int32)
            row[:len(slot.blocks)] = slot.blocks
            slot.pos_pending = None
            arrays.append(row)
        toks, ints, floats, *table = self._upload(arrays)
        sampling = (ints[0], floats[0], ints[1], floats[1])
        dev = self._dev
        pos, last = ((dev["lane_pos"], dev["lane_last"]) if lane
                     else (dev["pos"], dev["last"]))
        if self._paged:
            paged_prefill_chunk_into_slot(
                self._cfg, dev["params"], dev["pool"], pos, last, idx,
                table[0], toks, pos0, clen, final, sampling)
        else:
            prefill_chunk_into_slot(
                self._cfg, dev["params"], self._slot_state(lane)[0], pos,
                last, idx, toks, pos0, clen, final, sampling)
        slot.cursor += clen
        slot.pos_hi = max(slot.pos_hi, slot.cursor)
        self._prefill_chunks_dispatched += 1
        self._prefill_tokens_dispatched += clen
        self.gen_stats.record_prefill_chunk(clen)
        fm = self._flop_model
        self._note_dispatch(
            "lane_chunk" if lane else "prefill_chunk",
            fm.span(pos0, clen, logits=False) + (fm.logits if final else 0),
            {"padding": fm.span(pos0 + clen, bucket - clen, logits=False)},
            outputs=last)
        if req.trace is not None:
            if lane:
                # the host side of one lane resume (the card's work
                # overlaps the next pass)
                req.trace.span(trace_mod.PREFILL_CHUNK, start_ns, now_ns(),
                               chunk_tokens=int(clen),
                               chunk_index=int(pos0 // max(1, clen)),
                               lane_slot=idx)
            if final:
                req.trace.event(trace_mod.PREFILL_END)
        if lane:
            self._kind_s["lane"] += time.perf_counter() - t0
            self._kind_n["lane"] += 1

    def _dispatch(self) -> list:
        """Launch this round's device work (async): the chunked-prefill
        lane first (the piggyback lane or the dedicated one), so a prompt
        whose final piggyback chunk lands now decodes in the same round;
        then one chunk over the slots that feed a prompt or decode plainly
        (the speculating ones ride it frozen); then one verify round per
        distinct rung over the speculating slots, behind the chunk on the
        stream. Returns the ring entries dispatched (none when every
        occupied slot rides a lane)."""
        # fault point: a slow or wedged kernel in front of the dispatch
        faultinject.fire("kernel_delay", engine=self.name)
        if self._chunked_prefill:
            # with a dedicated lane the prompts ingest in its own slots
            # (handed off at the next admission pass)
            t_pf = time.perf_counter()
            if self._lane_on:
                self._dispatch_lane_dedicated()
            else:
                self._dispatch_prefill_lane()
            self._phase_s["prefill"] += time.perf_counter() - t_pf
        modes, rungs = self._slot_modes()
        any_chunk = "chunk" in modes
        spec_rungs = sorted({r for m, r in zip(modes, rungs) if m == "spec"})
        self._rungs_last = spec_rungs
        tables = None
        if self._paged and (any_chunk or spec_rungs):
            tables = self._prepare_paged_round(modes, rungs)
        entries = []
        if any_chunk:
            entries.append(self._dispatch_chunk(modes, tables))
        for rung in spec_rungs:
            entries.append(self._dispatch_spec(modes, rungs, rung, tables))
        return entries

    def _prepare_paged_round(self, modes: list, rungs: list) -> np.ndarray:
        """Grow the block tables to cover this round's writes (lazily, out
        of each stream's reservation) and snapshot them at a width that
        covers every live block and every position a kernel may write: a
        chunk's C steps, a verify round's rung + 1 (a frozen rider
        advances nothing)."""
        width = 1
        for slot, mode, rung in zip(self._slots, modes, rungs):
            if slot.req is None:
                continue
            adv = (self._chunk if mode == "chunk"
                   else rung + 1 if mode == "spec" else 0)
            if adv:
                self._ensure_blocks(slot, slot.req, slot.pos_hi + adv)
            width = max(width, len(slot.blocks),
                        (slot.pos_hi + adv) // self._kv_block_len + 1)
        return self._build_tables(width)

    def _dispatch_chunk(self, modes: list, tables) -> tuple:
        t0 = time.perf_counter()
        s, c = self._n_slots, self._chunk
        feed = np.zeros((s, c), np.int32)
        rem = np.zeros((s,), np.int32)
        active = np.zeros((s,), np.bool_)
        reset = np.zeros((s,), np.bool_)
        reset_to = np.zeros((s,), np.int32)
        freeze = np.zeros((s,), np.bool_)
        seeds = np.zeros((s,), np.int32)
        temps = np.zeros((s,), np.float32)
        topks = np.zeros((s,), np.int32)
        topps = np.zeros((s,), np.float32)
        meta = []
        eager_free = []
        gp_rows = []   # (pos0, useful columns, frozen): the FLOP ledger
        gp_pad = 0     # free slot rows: pure padding
        ceiling = self._gamma_ceiling
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None:
                meta.append((None, 0))
                gp_pad += 1
                continue
            active[i] = True
            if self._paged:
                # a paged admission's reset rides the next kernel as data;
                # a lane chunk sets the position itself and clears it
                if slot.pos_pending is not None:
                    reset[i] = True
                    reset_to[i] = slot.pos_pending
                    slot.pos_pending = None
            else:
                reset[i] = slot.cursor == 0
            if modes[i] == "prefill":
                # a lane rider: frozen, feeds and delivers nothing; its
                # frozen steps' K/V write at the held position is
                # overwritten by its next lane chunk before it is attended
                freeze[i] = True
                meta.append((req, c))
                gp_rows.append((slot.pos_hi, 0, True))
                continue
            if modes[i] != "spec":
                # a verify slot keeps the zero defaults: a sampled one must
                # not force the sampling variant onto a greedy chunk
                seeds[i] = req.seed
                temps[i] = req.temperature
                topks[i] = req.top_k
                topps[i] = req.top_p
            k = min(len(req.prompt) - slot.cursor, c)
            # a slot on the speculation track must not decode here: a
            # verify slot (its K/V write at the held position is the first
            # row its round writes again), and a prompt feeder that will
            # speculate once its prompt is in (else this chunk would
            # decode past the prompt). A plain-decode slot is never
            # frozen: with no prompt left it would stall
            freeze[i] = modes[i] == "spec" or (
                self._on_spec_track(req, ceiling)
                and slot.cursor < len(req.prompt)
                and len(req.prompt) + self._gamma + 1 <= self._cfg.max_seq)
            if modes[i] == "spec":
                meta.append((req, c))
                gp_rows.append((slot.pos_hi, 0, True))
                continue
            if k > 0:
                feed[i, :k] = req.prompt[slot.cursor:slot.cursor + k]
                rem[i] = k
                slot.cursor += k
                if (self._chunked_prefill and req.trace is not None
                        and slot.cursor >= len(req.prompt)):
                    # a lane prompt whose sub-chunk tail feeds here ends
                    # its ingestion with this chunk
                    req.trace.event(trace_mod.PREFILL_END)
            gp_rows.append((slot.pos_hi, k if freeze[i] else c,
                            bool(freeze[i])))
            slot.pos_hi += k if freeze[i] else c
            # columns >= this are generated tokens (none when frozen)
            meta.append((req, c if freeze[i] else k))
            if not freeze[i] and slot.cursor >= len(req.prompt):
                slot.decode_dispatched += c - k
                # the budget this admission still owes: a resumed stream's
                # prompt holds its earlier tokens, counted in emitted
                if slot.decode_dispatched >= \
                        req.budget - (len(req.prompt) - req.base_plen):
                    # every token the stream may still emit is in flight:
                    # commit and free after the kernel below, which may
                    # feed the prompt's final columns
                    eager_free.append((i, req))
        sample = bool(temps.max(initial=0.0) > 0)
        arrays = [feed, rem, active, reset, freeze, seeds, temps, topks,
                  topps]
        if self._paged:
            arrays += [tables, reset_to]
        (feed_d, rem_d, active_d, reset_d, freeze_d, seeds_d, temps_d,
         topks_d, topps_d, *paged) = self._upload(arrays)
        tab_d, reset_to_d = paged or (None, None)
        seq = self._ring_seq
        self._ring_seq += 1
        timing = self._start_timing()
        # with no frozen slot the steps skip the freeze masking
        self._launch_chunk(seq % self._ring_entries, tab_d, feed_d, rem_d,
                           active_d, reset_d, reset_to_d,
                           freeze_d if freeze.any() else None, seeds_d,
                           temps_d, topks_d, topps_d, sample)
        if timing is not None:
            timing[1].record()
        for i, req in eager_free:
            # the slot layout's commit copy is enqueued behind the chunk
            # above (see _commit_prefix); the paged commit is a donation
            if self._paged:
                self._free_slot_paged(self._slots[i], req, commit=True)
            elif self._prefix_index is not None:
                self._commit_prefix(i, req)
            self._slots[i].req = None
            self._slots[i].draft_ready = False
        self._chunks_dispatched += 1
        # the FLOPs: every row runs the same [S, C] steps; useful work is
        # the fed columns at their real contexts, and the waste splits into
        # free-row padding, frozen rider columns and (paged) the attention
        # slack of the bucketed table width beyond the real context
        fm = self._flop_model
        useful = 0
        w_pad = gp_pad * fm.span(0, c)
        w_frozen = 0
        w_slack = 0
        tw = (int(tables.shape[1]) * self._kv_block_len
              if self._paged and tables is not None else 0)
        for pos0, used, frozen in gp_rows:
            useful += fm.span(pos0, used)
            if frozen:
                if used < c:
                    w_frozen += fm.span(pos0 + used, c - used)
            elif tw:
                ctx_sum = c * pos0 + c * (c + 1) // 2
                w_slack += fm.attn * max(0, c * tw - ctx_sum)
        self._note_dispatch(
            "paged_decode" if self._paged else "chunk", useful,
            {"padding": w_pad, "frozen": w_frozen, "table_slack": w_slack},
            outputs=self._dev["ring_cnt"])
        self._kind_s["chunk"] += time.perf_counter() - t0
        self._kind_n["chunk"] += 1
        return ("chunk", seq, meta, timing, 0)

    def _note_dispatch(self, kind: str, useful: int = 0,
                       wasted: Optional[dict] = None,
                       outputs=None) -> None:
        """The goodput hook of one dispatch: the per-kind cadence (and the
        opt-in synchronous sample) in the tracker, the useful and wasted
        FLOP roll-up in gen_stats."""
        self.goodput.note_dispatch(kind, useful, wasted, outputs=outputs)
        w = sum(wasted.values()) if wasted else 0
        if useful or w:
            self.gen_stats.record_flops(useful, w)

    def _note_flops(self, kind: str, useful: int = 0,
                    wasted: Optional[dict] = None) -> None:
        """Deferred FLOP attribution with no dispatch: the verify round's
        retire, where the accepted counts arrive."""
        self.goodput.note_flops(kind, useful, wasted)
        w = sum(wasted.values()) if wasted else 0
        if useful or w:
            self.gen_stats.record_flops(useful, w)

    def _start_timing(self):
        """A pair of CUDA events, the first recorded now (None on the
        CPU): the stream time of one dispatch's kernels."""
        if self._device.type != "cuda":
            return None
        timing = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        timing[0].record()
        return timing

    def _dispatch_spec(self, modes: list, rungs: list, rung: int,
                       tables) -> tuple:
        """Launch one verify round (async) at depth ``rung`` over the
        slots in "spec" mode that picked it. Each slot's ``pos_hi`` grows
        by the bound rung + 1, corrected to the real advance at retire.
        Only these slots' sampling rows go to the device, with every
        slot's table under the paged layout (its verify runs all S rows);
        with every slot in the round the kernels index nothing."""
        t0 = time.perf_counter()
        rows, meta = [], []
        gp_part = []   # (slot, pos0): the FLOP ledger for the retire
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None or modes[i] != "spec" or rungs[i] != rung:
                meta.append(None)
                continue
            rows.append(i)
            gp_part.append((i, slot.pos_hi))
            slot.pos_hi += rung + 1
            meta.append(req)
        reqs = [self._slots[i].req for i in rows]
        seeds = np.asarray([r.seed for r in reqs], np.int32)
        temps = np.asarray([r.temperature for r in reqs], np.float32)
        topks = np.asarray([r.top_k for r in reqs], np.int32)
        topps = np.asarray([r.top_p for r in reqs], np.float32)
        every = len(rows) == self._n_slots
        arrays = [seeds, temps, topks, topps]
        if not every:
            arrays.append(np.asarray(rows, np.int32))
        if self._paged:
            arrays.append(np.ascontiguousarray(tables))
        seeds_d, temps_d, topks_d, topps_d, *rest = self._upload(arrays)
        rows_d = None if every else rest.pop(0).long()
        tab_d = rest[0] if self._paged else None
        sample = bool(temps.max(initial=0.0) > 0)
        seq = self._ring_seq
        self._ring_seq += 1
        timing = self._start_timing()
        self._launch_spec(seq % self._ring_entries, tab_d, rows_d,
                          (seeds_d, temps_d, topks_d, topps_d), rung,
                          sample)
        if timing is not None:
            timing[1].record()
        self._chunks_dispatched += 1
        # timing is noted now; the useful-against-rejected row split waits
        # for the retire, keyed by ring seq. The slots outside the round
        # are the reference's masked padding rows of its [S, rung + 1]
        # shape (the slot layout's round indexes only its own rows; both
        # layouts count the others as the reference does)
        fm = self._flop_model
        gkind = f"spec_g{rung}"
        self._spec_gp[seq] = (gkind, gp_part)
        self._note_dispatch(
            gkind, 0,
            {"padding": (self._n_slots - len(gp_part))
             * fm.span(0, rung + 1)},
            outputs=self._dev["ring_cnt"])
        self._kind_s["spec"] += time.perf_counter() - t0
        self._kind_n["spec"] += 1
        return ("spec", seq, meta, timing, rung)

    def _launch_spec(self, entry: int, tables, rows, sampling: tuple,
                     rung: int, sample: bool) -> None:
        """Enqueue one verify round of the engine's layout on its device
        state (``tables`` are the round's slots' rows, paged only)."""
        dev = self._dev
        common = (dev["dcache"], dev["dpos"], dev["last"], dev["ring"],
                  dev["ring_cnt"], entry)
        if self._paged:
            dev["last"], dev["pos"], dev["dpos"] = paged_spec_round(
                self._cfg, self._draft.cfg, dev["params"], dev["dparams"],
                dev["pool"], dev["pos"], *common, tables, rows, sampling,
                rung, sample)
        else:
            dev["last"], dev["pos"], dev["dpos"] = spec_round(
                self._cfg, self._draft.cfg, dev["params"], dev["dparams"],
                dev["cache"], dev["pos"], *common, rows, sampling, rung,
                sample)

    def _issue_fetch(self, unfetched: list, forced: bool = False) -> tuple:
        """Start the ring's D2H copy (non-blocking, on the engine's
        stream, behind every kernel dispatched so far): one transfer
        delivers every entry in ``unfetched``. On the CPU the ring is
        cloned, since nothing orders a later in-place write after it."""
        ring, cnt = self._dev["ring"], self._dev["ring_cnt"]
        if ring.is_cuda:
            copies = start_host_copies({"ring": ring, "cnt": cnt})
        else:
            copies = ({"ring": ring.clone(), "cnt": cnt.clone()}, None)
        self.gen_stats.record_ring_fetch(forced=forced)
        return (copies, list(unfetched))

    def _drain_fetch(self, fetch, cadence: bool = True) -> None:
        """Deliver one issued fetch: wait for its bytes (retire_fetch),
        then hand every covered entry's tokens to its streams
        (retire_deliver). ``cadence`` False marks the 2nd+ drain of a
        burst, which must not feed the chunk-time EWMA."""
        copies, entries = fetch
        t0 = time.perf_counter()
        # fault point: where a deferred device error surfaces, at the
        # blocking collect of the ring's D2H copy
        faultinject.fire_or_raise("ring_fetch", engine=self.name)
        host = finish_host_copies(copies)
        self._phase_s["retire_fetch"] += time.perf_counter() - t0
        t1 = time.perf_counter()
        arrival = now_ns()
        newest = entries[-1][1]
        last = self._last_drain
        self._last_drain = (newest, arrival)
        # the goodput cadence: the wall since the previous mark covers the
        # dispatches issued in between (a burst drain carries ~0)
        self.goodput.drain_mark(arrival)
        if cadence and last is not None and newest > last[0]:
            sample = (arrival - last[1]) / (newest - last[0])
            if 0 < sample < 5e9:
                self._chunk_ns_ewma = (
                    sample if not self._chunk_ns_ewma
                    else 0.7 * self._chunk_ns_ewma + 0.3 * sample)
        ring_host, cnt_host = host["ring"], host["cnt"]
        for kind, seq, meta, timing, rung in entries:
            if timing is not None:   # both events ran before the copy
                self._dispatch_event_ms += timing[0].elapsed_time(timing[1])
                self._timed_dispatches += 1
            self._deliver_ns = int(arrival
                                   - (newest - seq) * self._chunk_ns_ewma)
            e = seq % self._ring_entries
            if kind == "chunk":
                self._retire(ring_host[e][:, :self._chunk], meta)
            else:
                self._retire_spec(ring_host[e][:, :rung + 1], cnt_host[e],
                                  meta, rung, seq)
            self._retired_seq = seq + 1
        self._phase_s["retire_deliver"] += time.perf_counter() - t1

    def _retire(self, toks: np.ndarray, meta: list) -> None:
        """Distribute one chunk's tokens: meta[i] = (req, k), columns >= k
        of row i are that request's generated tokens."""
        for i, (req, k) in enumerate(meta):
            if req is None or req.finished:
                continue
            self._deliver(i, req, toks[i, k:])

    def _retire_spec(self, toks: np.ndarray, n_out: np.ndarray, meta: list,
                     rung: int, seq: Optional[int] = None) -> None:
        """Distribute one verify round at depth ``rung``: the first
        n_out[i] columns of row i are its verified tokens (the pending
        token and the accepted proposals). Corrects the slot's ``pos_hi``
        from the bound rung + 1 to the real advance, and records the round
        in the engine's counters and in the stream's rolling acceptance,
        which drives its fallback latch and its next rung; attributes the
        round's rows of entry ``seq``: k useful (the accepted prefix and
        the bonus token), rung + 1 - k rejected."""
        gp = self._spec_gp.pop(seq, None)
        gp_pos = dict(gp[1]) if gp is not None else {}
        for i, req in enumerate(meta):
            if req is None:
                continue
            k = int(n_out[i])
            slot = self._slots[i]
            if slot.req is req:
                slot.pos_hi -= (rung + 1) - k
            pos0 = gp_pos.get(i)
            if pos0 is not None:
                self._note_flops(
                    gp[0], self._flop_model.span(pos0, k),
                    {"spec_reject":
                     self._flop_model.span(pos0 + k, rung + 1 - k)})
            if req.finished:
                continue
            accepted = k - 1
            self._spec.record_round(rung, accepted)
            req.spec.record(rung, accepted, self._spec.min_acceptance)
            self.gen_stats.record_spec_round(rung, accepted)
            if req.trace is not None:
                req.trace.event(trace_mod.SPEC_VERIFY, proposed=rung,
                                accepted=accepted)
            self._deliver(i, req, toks[i, :k])

    def _deliver(self, i: int, req: _Request, tok_seq) -> None:
        """Deliver one chunk's tokens for one request as ONE queue put,
        truncated at EOS or the budget; close the stream and free its slot
        when it is done."""
        deliver = []
        done = False
        for tok in tok_seq:
            tok = int(tok)
            deliver.append(tok)
            req.emitted += 1
            if tok == req.eos_id or req.emitted >= req.budget:
                done = True
                break
        if req.gen_tokens is not None and deliver:
            # kept for a preemption to fold into the prompt
            req.gen_tokens.extend(deliver)
        if deliver:
            emit_ns = max(self._deliver_ns or now_ns(), req.last_emit_ns,
                          req.first_token_ns, req.enqueue_ns)
            first = req.first_token_ns == 0
            if first:
                req.first_token_ns = emit_ns
                self.gen_stats.record_ttft(
                    emit_ns - req.enqueue_ns,
                    trace_id=req.trace.id if req.trace is not None else "")
                self.slo_stats.record_ttft(req.tenant, req.slo_class,
                                           emit_ns - req.enqueue_ns)
            if req.trace is not None and (
                    first or req.emitted % trace_mod.TOKEN_EMIT_SAMPLE_EVERY
                    < len(deliver)):
                # the device-cadence emit stamp -> the fetch's arrival on
                # the host: the fetch stride's delivery lag, sampled at the
                # TOKEN_EMIT cadence
                arrival_ns = (self._last_drain[1]
                              if self._last_drain is not None else now_ns())
                req.trace.span(trace_mod.RING_DELIVER, emit_ns,
                               max(arrival_ns, emit_ns), tokens=len(deliver),
                               emitted=req.emitted)
            req.last_emit_ns = emit_ns
            self.gen_stats.record_tokens(len(deliver))
            self._tokens_emitted += len(deliver)
            req.out.put(deliver)
        slot = self._slots[i]
        if done:
            # commit while the slot still holds the request (a slot freed
            # at dispatch time committed then, and may hold another
            # request by now, whose rows must never be committed under
            # this prompt)
            if slot.req is req:
                if self._paged:
                    self._free_slot_paged(slot, req, commit=True)
                elif self._prefix_index is not None:
                    self._commit_prefix(i, req)
            self._close_request(req, None)
            self._requests_completed += 1
        if req.finished and slot.req is req:
            slot.req = None
            slot.draft_ready = False
            self._free_slot_paged(slot, req, commit=False)

    def _record_flight(self, dispatched: bool, occ_active: int,
                       slot_tenants: dict) -> None:
        """One flight-recorder entry per loop iteration, with the
        reference's keys, from host counters only (no tensor is read):
        the context a crash takes with it. ``slot_tenants`` is this
        iteration's per-(tenant, slo_class) slot occupancy."""
        spec = self._spec
        gp_device_share, gp_waste_share = self.goodput.shares()
        self.flight.record(
            ns=now_ns(),
            phase="dispatch" if dispatched else "drain",
            slots_active=occ_active,
            device_time_share=round(gp_device_share, 4),
            wasted_flop_share=round(gp_waste_share, 4),
            slot_tenants=slot_tenants,
            queue_depth=self._pending.qsize(),
            tokens_emitted=self._tokens_emitted,
            ring_lag=self._ring_seq - self._retired_seq,
            chunks_dispatched=self._chunks_dispatched,
            prefill_backlog=(self._prefill_backlog()
                             if self._chunked_prefill else None),
            lane=(None if not self._lane_on else {
                "active": self.active_lane_slots(),
                "handoffs": self._lane_handoffs,
                "batch": (None if not self._lane_batch else {
                    "dispatches": self.gen_stats.lane_batch_dispatches,
                    "slots": self.gen_stats.lane_batch_slots,
                }),
            }),
            requests_completed=self._requests_completed,
            spec_acceptance=(
                None if spec is None
                else round(spec.snapshot()["acceptance_rate"], 4)),
            spec_rungs=None if spec is None else list(self._rungs_last),
            spec_gamma=None if spec is None else self._gamma_ceiling,
            pool_blocks_used=(
                None if self._kv_index is None
                else self._kv_index.snapshot()["blocks_used"]),
            sched=(None if self._sched is None else {
                "mode": ("throughput" if self._controller is None
                         else ("latency" if self._controller.latency_mode
                               else "throughput")),
                "preemptions": self._sched_stats.preemptions_total,
                "parked": self._pending.parked,
                "fetch_stride": self._stride,
                "prefill_budget": self._prefill_budget,
                "spec_enabled": self.speculation_enabled,
                "spec_gamma": self.speculation_gamma,
            }))

    def _run(self) -> None:
        """Engine thread entry: any failure (the build, a dispatch, a
        deferred device error at the ring fetch, an injected fault) fails
        every queued and in-flight request, since this thread is their
        only producer. The BaseException catch is deliberate and
        allowlisted by name in the reference's failure-path lint: even a
        SystemExit raised into this thread answers the waiters before it
        propagates."""
        try:
            # inference mode and the current device are thread-local
            with torch.inference_mode():
                if self._device.type == "cuda":
                    torch.cuda.set_device(self._device)
                self._run_loop()
        except BaseException as e:  # noqa: BLE001 — surface to waiters
            self._fail_all(e)
            if not isinstance(e, Exception):
                raise

    def _run_loop(self) -> None:
        self._ensure_ready()
        unfetched, fetches = self._unfetched, self._fetches
        # the occupied-slot count integrated over wall time (slot-busy
        # seconds; over n_slots x a window it is the occupancy)
        occ_last = time.perf_counter()
        occ_active = 0
        while True:
            occ_now = time.perf_counter()
            if occ_active:
                self.gen_stats.add_slot_busy(
                    int(occ_active * (occ_now - occ_last) * 1e9))
            occ_last = occ_now
            if self._stopping:
                if self._held is not None:
                    self._close_request(
                        self._held,
                        ServerError("generation engine stopped", 503))
                    self._held = None
                break
            # fault point: an armed engine_loop fault kills this thread
            # here, as a device or host fault between dispatches would
            faultinject.fire_or_raise("engine_loop", engine=self.name,
                                      iteration=self._chunks_dispatched)
            # the closed loop, once per round (host code only): the
            # controller steers the live knobs from the burn, and a
            # burning higher-weight head may take a running slot
            if self._controller is not None:
                self._controller.step(self, self.slo_stats.max_class_burn())
            self._maybe_preempt()
            self._reap_slots()
            t_admit = time.perf_counter()
            held, self._held = self._held, None
            admitted = self._admit(held)
            self._phase_s["admit"] += time.perf_counter() - t_admit
            if not admitted and not unfetched and not fetches:
                if self._pending.parked:
                    # a parked head waits for blocks nothing active will
                    # free: retry without blocking on the queue
                    time.sleep(0.001)
                    continue
                # idle: block until a request (or the stop sentinel); the
                # idle gap must not enter the chunk-time EWMA, nor read as
                # a stall: one forced slots-idle watchdog sample starts
                # the next request's wall-gap pair from an idle sample
                self._last_drain = None
                # idle wall must not count as device time: attribute the
                # tail and drop the goodput mark with the EWMA's
                self.goodput.reset_cadence()
                if self._watchdog is not None:
                    self._watchdog.mark_idle(now_ns(),
                                             self._watchdog_signals())
                self._held = self._pending.get()
                if self._held is None:
                    break
                continue
            if self._kv_index is not None and self._kv_index.tier is not None:
                self._kv_index.drain_tier()
            iter_t0 = time.perf_counter()
            dispatched = False
            if any(s.req is not None for s in self._slots) \
                    or any(s.req is not None for s in self._lane_slots):
                dispatched = True
                t_disp = time.perf_counter()
                pf_before = self._phase_s["prefill"]
                unfetched.extend(self._dispatch())
                # the lane's time went to "prefill" inside _dispatch: the
                # phases partition the thread's time
                self._phase_s["dispatch"] += (
                    time.perf_counter() - t_disp
                    - (self._phase_s["prefill"] - pf_before))
            active_now = any(s.req is not None for s in self._slots)
            # issue a fetch at the stride, before the ring could wrap an
            # unfetched entry, when overlap is off, or to flush the tail
            forced = len(unfetched) + self._entries_per_iter \
                > self._ring_entries
            if unfetched and (len(unfetched) >= self._stride or forced
                              or not self._overlap or not active_now):
                fetches.append(self._issue_fetch(unfetched, forced=forced))
                unfetched.clear()
            # deliver only fetches older than the in-flight window, or
            # everything once no slot is active
            first = True
            while fetches and (len(fetches) > self._fetch_depth
                               or not active_now):
                self._drain_fetch(fetches[0], cadence=first)
                first = False
                fetches.popleft()
                active_now = any(s.req is not None for s in self._slots)
            occ_active = 0
            slot_tenants: dict = {}
            for s in self._slots:
                req = s.req
                if req is None:
                    continue
                occ_active += 1
                key = f"{req.tenant}/{req.slo_class}"
                slot_tenants[key] = slot_tenants.get(key, 0) + 1
            self._record_flight(dispatched, occ_active, slot_tenants)
            if self._watchdog is not None:
                self._watchdog_tick()
            duty = self._duty
            if dispatched and duty < 1.0:
                # pacing: a round's wall time tracks its device cost (the
                # delivery blocks on the fetch), so sleeping (1/duty - 1)
                # of it cedes that share of the card
                busy = time.perf_counter() - iter_t0
                self._loop_ewma_s = (busy if not self._loop_ewma_s else
                                     0.8 * self._loop_ewma_s + 0.2 * busy)
                pause = min(0.5, self._loop_ewma_s * (1.0 / duty - 1.0))
                self._phase_s["pace"] += pause
                time.sleep(pause)
        # a stop delivers everything already dispatched first
        if unfetched:
            fetches.append(self._issue_fetch(unfetched))
            unfetched.clear()
        first = True
        while fetches:
            self._drain_fetch(fetches[0], cadence=first)
            first = False
            fetches.popleft()
        self._fail_all(ServerError("generation engine stopped", 503))

    def _fail_all(self, err: BaseException) -> None:
        """Deliver a terminal to every request still held, in a decode or
        lane slot, in an undelivered ring entry or queued; marks the
        engine dead first so no later submit can enqueue a request nothing
        will consume. An expected stop (a 503) logs at DEBUG; anything
        else is a death: logged at ERROR with the flight recorder's dump,
        recorded as an ``engine_death`` incident, and, under an
        ``EngineSupervisor``, answered with a retryable 503 carrying the
        next backoff as ``Retry-After`` (or a 503 with no hint when this
        death trips the crash-loop breaker) before the supervisor is
        notified, last. A traced request gets an ENGINE_RESTART span. The
        dead engine drops its device state: nothing runs on it again, and
        the supervisor's rebuild must not sit beside it on the card."""
        self._stopping = True
        expected = isinstance(err, ServerError) and err.status == 503
        sup = self.supervisor
        terminal: BaseException = err
        if not expected:
            # liveness flips before any waiter is answered: a client
            # retrying the instant its stream fails sees not-ready
            self._failed = err
            if sup is not None and sup.would_restart():
                terminal = ServerError(
                    f"generation engine failed and is restarting "
                    f"({err}); retry after the backoff", 503,
                    retry_after=sup.retry_after_hint())
            elif sup is not None:
                terminal = ServerError(
                    f"generation engine failed ({err}); crash-loop "
                    f"breaker tripped — not restarting, the model "
                    f"stays unavailable until an operator reload", 503)

        def close(req) -> int:
            if req is None or req.finished:
                return 0
            if not expected and req.trace is not None:
                hint = getattr(terminal, "retry_after", None)
                req.trace.event(
                    trace_mod.ENGINE_RESTART, failure=str(err),
                    retryable=sup is not None and hint is not None,
                    retry_after_s=hint)
            self._close_request(req, terminal)
            return 1

        held, self._held = self._held, None
        failed = close(held)
        # lane slots hold requests mid-ingestion: they fail like decode
        # slots' requests
        for slot in self._slots + self._lane_slots:
            failed += close(slot.req)
            # pins were released as each request closed; failed streams
            # commit nothing
            self._free_slot_paged(slot, slot.req, commit=False)
            slot.req = None
            slot.draft_ready = False
        inflight = list(self._unfetched)
        for _copies, entries in list(self._fetches):
            inflight.extend(entries)
        self._unfetched.clear()
        self._fetches.clear()
        self._spec_gp.clear()   # the in-flight rounds' FLOP context too
        for kind, _seq, meta, _timing, _rung in inflight:
            for item in meta:
                # a chunk's meta holds (req, k), a verify round's req
                failed += close(item[0] if kind == "chunk" else item)
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            failed += close(req)
        if expected:
            log.debug("generation engine '%s' stopped; closed %d "
                      "request(s)", self.name, failed)
            return
        # a death: free the device state (the supervisor's rebuild places
        # its own), then log the failure and the flight dump
        self._dev.clear()
        log.error(
            "generation engine '%s' loop failed (%d slots, chunk %d, %d "
            "request(s) answered with %s): %s", self.name, self._n_slots,
            self._chunk, failed,
            "retryable 503s" if sup is not None else "errors", err,
            exc_info=err if isinstance(err, Exception) else None)
        dump = self.flight.dump()
        log.error(
            "generation engine '%s' flight recorder (%d iteration(s), "
            "newest last): %s", self.name, len(dump),
            json.dumps(dump, default=str))
        # the goodput tail: was the card starved (a low device-time share)
        # or saturated when the loop died
        gp = self.goodput.snapshot()
        log.error(
            "generation engine '%s' goodput tail: %s", self.name,
            json.dumps({
                "device_time_share": round(gp["device_time_share"], 4),
                "useful_flop_share": round(gp["useful_flop_share"], 4),
                "idle_seconds": round(gp["idle_seconds"], 3),
                "device_seconds_total":
                    round(gp["device_seconds_total"], 3),
                "mfu": (None if gp["mfu"] is None
                        else round(gp["mfu"], 4)),
                "dispatches": gp["dispatches"],
            }, default=str))
        # the death bundle lands in the store the next engine shares, so
        # it stays readable after a supervised restart; capture is best
        # effort and must not mask the failure
        if self._watchdog is not None:
            try:
                self._watchdog.record_death(
                    err, ns=now_ns(),
                    evidence=self._incident_evidence(
                        "engine_death", {"error": str(err)}))
            except Exception:  # noqa: BLE001 — see above
                log.exception(
                    "generation engine '%s': death-incident capture "
                    "failed (flight dump already logged)", self.name)
        if sup is not None:
            # last: the supervisor may swap in a fresh engine the moment
            # this returns, and every waiter above is answered
            sup.notify_failure(self, err)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
