"""Per-model statistics: the v2 statistics-extension counters, and the
generation engine's token-level counters.

The port's counterpart of ``ModelStats`` and ``GenerationStats`` in
``client_tpu/server/stats.py``. ``ModelStats`` semantics follow Triton's:
``inference_count`` counts inferences (sum of request batch-1 units),
``execution_count`` counts model executions (batches), per-request queue
time, per-execution compute times attributed to every request in the
batch, response-cache hits and misses, and per-batch-size execution stats.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right

from client_tpu_torch.server.metrics import DEFAULT_BUCKETS_S

# latency histogram bounds in ns (the /metrics feed), on the exposition's
# buckets so a scrape needs no re-binning
LATENCY_BUCKETS_NS = tuple(int(b * 1e9) for b in DEFAULT_BUCKETS_S)


class Duration:
    __slots__ = ("count", "ns")

    def __init__(self):
        self.count = 0
        self.ns = 0

    def add(self, ns: int, count: int = 1):
        self.count += count
        self.ns += ns

    def to_json(self):
        return {"count": self.count, "ns": self.ns}


class ModelStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.inference_count = 0
        self.execution_count = 0
        self.last_inference_ms = 0
        self.success = Duration()
        self.fail = Duration()
        self.queue = Duration()
        self.compute_input = Duration()
        self.compute_infer = Duration()
        self.compute_output = Duration()
        self.cache_hit = Duration()
        self.cache_miss = Duration()
        self.rejected = Duration()   # admission-control sheds
        self.batch_stats: dict[int, dict] = {}
        # per-request end-to-end latency histogram (the success and
        # cache-hit paths, as ``success``); last bucket is +Inf
        self.latency_counts = [0] * (len(LATENCY_BUCKETS_NS) + 1)

    def record_execution(self, batch_size: int, num_requests: int,
                         queue_ns_per_request, compute_input_ns: int,
                         compute_infer_ns: int, compute_output_ns: int,
                         request_total_ns_each) -> None:
        """Record one successful model execution covering num_requests."""
        with self._lock:
            self.inference_count += batch_size
            self.execution_count += 1
            self.last_inference_ms = int(time.time() * 1000)
            for q in queue_ns_per_request:
                self.queue.add(q)
            for t in request_total_ns_each:
                self.success.add(t)
                self.latency_counts[bisect_right(LATENCY_BUCKETS_NS, t)] += 1
            self.compute_input.add(compute_input_ns, num_requests)
            self.compute_infer.add(compute_infer_ns, num_requests)
            self.compute_output.add(compute_output_ns, num_requests)
            bs = self.batch_stats.setdefault(
                batch_size,
                {"compute_input": Duration(), "compute_infer": Duration(),
                 "compute_output": Duration()},
            )
            bs["compute_input"].add(compute_input_ns)
            bs["compute_infer"].add(compute_infer_ns)
            bs["compute_output"].add(compute_output_ns)

    def record_failure(self, total_ns: int) -> None:
        with self._lock:
            self.fail.add(total_ns)

    def record_cache_hit(self, lookup_ns: int) -> None:
        """A request answered from the response cache: a success, an
        inference, and its lookup time as its latency."""
        with self._lock:
            self.cache_hit.add(lookup_ns)
            self.success.add(lookup_ns)
            self.latency_counts[
                bisect_right(LATENCY_BUCKETS_NS, lookup_ns)] += 1
            self.inference_count += 1
            self.last_inference_ms = int(time.time() * 1000)

    def record_cache_miss(self, insert_ns: int) -> None:
        with self._lock:
            self.cache_miss.add(insert_ns)

    def record_rejection(self, waited_ns: int = 0) -> None:
        """A request shed by admission control (counted separately from
        execution failures so overload is visible in the stats report)."""
        with self._lock:
            self.rejected.add(waited_ns)
            self.fail.add(waited_ns)

    def snapshot(self) -> dict:
        """Flat counter snapshot for the /metrics collector."""
        with self._lock:
            return {
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "success_count": self.success.count,
                "fail_count": self.fail.count,
                "rejected_count": self.rejected.count,
                "queue_ns": self.queue.ns,
                "compute_input_ns": self.compute_input.ns,
                "compute_infer_ns": self.compute_infer.ns,
                "compute_output_ns": self.compute_output.ns,
                "cache_hit_count": self.cache_hit.count,
                "cache_miss_count": self.cache_miss.count,
            }

    def latency_histogram(self) -> tuple:
        """(bucket_counts, sum_ns, count) on LATENCY_BUCKETS_NS."""
        with self._lock:
            return list(self.latency_counts), self.success.ns, \
                self.success.count

    def to_json(self, name: str, version: str) -> dict:
        with self._lock:
            return {
                "name": name,
                "version": version,
                "last_inference": self.last_inference_ms,
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "inference_stats": {
                    "success": self.success.to_json(),
                    "fail": self.fail.to_json(),
                    "queue": self.queue.to_json(),
                    "compute_input": self.compute_input.to_json(),
                    "compute_infer": self.compute_infer.to_json(),
                    "compute_output": self.compute_output.to_json(),
                    "cache_hit": self.cache_hit.to_json(),
                    "cache_miss": self.cache_miss.to_json(),
                    "rejected": self.rejected.to_json(),
                },
                "batch_stats": [
                    {
                        "batch_size": bs,
                        "compute_input": d["compute_input"].to_json(),
                        "compute_infer": d["compute_infer"].to_json(),
                        "compute_output": d["compute_output"].to_json(),
                    }
                    for bs, d in sorted(self.batch_stats.items())
                ],
            }


class _HistNs:
    """Cumulative ns-valued histogram on the LATENCY_BUCKETS_NS grid (the
    last bucket is +Inf).

    Exemplars: an observation of a traced request keeps its trace id as
    its bucket's newest exemplar (trace_id, value_ns, unix_ts), the
    OpenMetrics link from a bucket to a trace. One per bucket, so the
    storage is bounded by the grid; untraced observations store none."""

    __slots__ = ("counts", "sum_ns", "count", "exemplars")

    def __init__(self):
        self.counts = [0] * (len(LATENCY_BUCKETS_NS) + 1)
        self.sum_ns = 0
        self.count = 0
        self.exemplars: dict = {}   # bucket idx -> (trace_id, ns, unix_ts)

    def observe(self, ns: int, count: int = 1, trace_id: str = "") -> None:
        idx = bisect_right(LATENCY_BUCKETS_NS, ns)
        self.counts[idx] += count
        self.sum_ns += ns * count
        self.count += count
        if trace_id:
            self.exemplars[idx] = (trace_id, ns, time.time())

    def snapshot(self) -> tuple:
        return list(self.counts), self.sum_ns, self.count

    def exemplar_snapshot(self) -> dict:
        return dict(self.exemplars)


class GenerationStats:
    """Token-level counters of a generation engine, limited to what the
    port's engine feeds: time to first token (engine enqueue to the first
    emitted token), inter-token latency (``(last_emit - first_token) /
    (tokens - 1)`` per completed stream of >= 2 tokens), queue wait
    (enqueue to slot admission), tokens emitted, stream outcomes, the
    time-weighted occupied-slot integral (``slot_busy_ns``), the
    batched ring fetches, the chunked-prefill lane's chunks and tokens, the
    dedicated lane's handoffs and batched dispatches, and the prefix-cache
    lookups: one per admission of a prompt longer than one
    block with the cache on, a hit adding its matched tokens to
    ``prefix_saved_tokens`` (the allocator's evictions and commits are the
    ``RadixBlockIndex``'s), and the speculative verify rounds: draft
    tokens proposed, accepted and rejected, rounds, and rounds by
    gamma-ladder rung, host-tier hits, preemptions and resumes, and the
    goodput plane's roll-up of attributed model FLOPs, useful against
    wasted (``server/goodput.py`` keeps the per-kind split). All mutators
    take ns; the engine thread writes, any thread reads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ttft = _HistNs()
        self.inter_token = _HistNs()
        self.queue_wait = _HistNs()
        self.tokens = 0
        self.completed = 0
        self.failed = 0
        # distinct stream endings, not failures: a stream its client
        # cancelled and one whose deadline passed freed their slot and
        # prefix pins on purpose
        self.cancelled = 0
        self.deadline_expired = 0
        self.slot_busy_ns = 0
        self.ring_fetches = 0
        self.ring_forced_fetches = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        # the dedicated prefill lane: prompts handed to a decode slot, and
        # the batched lane dispatches with the lane slots they packed
        self.lane_handoffs = 0
        self.lane_batch_dispatches = 0
        self.lane_batch_slots = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_saved_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.spec_rounds = 0
        # verify rounds by ladder rung ({gamma: rounds}; a rung-g round
        # scores g + 1 rows)
        self.spec_rung_rounds: dict = {}
        # host-RAM prefix tier: admissions whose matched chain crossed
        # spilled blocks (their spill and restore counts are the
        # RadixBlockIndex's)
        self.tier_hits = 0
        # the scheduler's engine-wide totals (the per-(tenant, class)
        # split is its SchedStats')
        self.preemptions = 0
        self.resumes = 0
        # the goodput plane's engine-level roll-up of its per-(kind,
        # reason) FLOP decomposition
        self.useful_flops = 0
        self.wasted_flops = 0

    def record_queue_wait(self, ns: int, trace_id: str = "") -> None:
        with self._lock:
            self.queue_wait.observe(max(0, int(ns)), trace_id=trace_id)

    def record_ttft(self, ns: int, trace_id: str = "") -> None:
        with self._lock:
            self.ttft.observe(max(0, int(ns)), trace_id=trace_id)

    def record_tokens(self, n: int) -> None:
        with self._lock:
            self.tokens += n

    def record_completion(self, emitted: int, first_token_ns: int,
                          last_emit_ns: int, trace_id: str = "") -> None:
        """A stream closed normally: count it and record its mean
        inter-token latency (defined only for >= 2 emitted tokens)."""
        with self._lock:
            self.completed += 1
            if emitted >= 2 and last_emit_ns >= first_token_ns:
                self.inter_token.observe(
                    (last_emit_ns - first_token_ns) // (emitted - 1),
                    trace_id=trace_id)

    def record_failure(self) -> None:
        with self._lock:
            self.failed += 1

    def record_cancelled(self) -> None:
        """A stream was cancelled by its client (an abandoned consumer or
        a set cancel Event) before finishing."""
        with self._lock:
            self.cancelled += 1

    def record_deadline_expired(self) -> None:
        """A stream reached its deadline (the wire ``timeout``) and was
        ended with a 504."""
        with self._lock:
            self.deadline_expired += 1

    def add_slot_busy(self, ns: int) -> None:
        with self._lock:
            self.slot_busy_ns += max(0, int(ns))

    def record_ring_fetch(self, forced: bool = False) -> None:
        """One batched D2H ring fetch was issued; ``forced`` marks fetches
        issued early so the ring would not wrap an unfetched entry."""
        with self._lock:
            self.ring_fetches += 1
            if forced:
                self.ring_forced_fetches += 1

    def record_prefill_chunk(self, tokens: int) -> None:
        """One chunked-prefill lane dispatch ingested ``tokens`` prompt
        tokens (the real count, not the bucket's padding)."""
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_tokens += max(0, int(tokens))

    def record_lane_handoff(self) -> None:
        """A dedicated-lane prompt finished ingesting and moved to a
        decode slot (paged: its block table; slot layout: through the
        prefix pool's commit and restore)."""
        with self._lock:
            self.lane_handoffs += 1

    def record_lane_batch(self, slots: int, tokens: int) -> None:
        """One batched lane dispatch ingested ``tokens`` real prompt tokens
        across ``slots`` lane slots: one lane chunk (the dispatch) and the
        lane-batch pair (slots / dispatches is the mean fill)."""
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_tokens += max(0, int(tokens))
            self.lane_batch_dispatches += 1
            self.lane_batch_slots += max(0, int(slots))

    def record_prefix_hit(self, matched_tokens: int) -> None:
        """An admission reused ``matched_tokens`` tokens of cached prefix
        KV instead of computing them again."""
        with self._lock:
            self.prefix_hits += 1
            self.prefix_saved_tokens += max(0, int(matched_tokens))

    def record_prefix_miss(self) -> None:
        with self._lock:
            self.prefix_misses += 1

    def record_spec_round(self, proposed: int, accepted: int) -> None:
        """One verify round of one slot: ``proposed`` draft tokens scored
        (the round's ladder rung), ``accepted`` of them kept; the stream
        advanced ``accepted + 1`` tokens."""
        with self._lock:
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            self.spec_rejected += proposed - accepted
            self.spec_rounds += 1
            self.spec_rung_rounds[proposed] = \
                self.spec_rung_rounds.get(proposed, 0) + 1

    def record_tier_hit(self) -> None:
        """An admission's matched chain crossed blocks spilled to the
        host-RAM tier; their restores were enqueued ahead of the
        stream's first chunk."""
        with self._lock:
            self.tier_hits += 1

    def record_preemption(self) -> None:
        """A running stream was preempted: its K/V committed to the
        prefix cache, its slot released, the request re-queued with its
        generated tokens folded into its prompt."""
        with self._lock:
            self.preemptions += 1

    def record_resume(self) -> None:
        """A preempted stream was admitted again (its prefix restored,
        the tail re-ingested)."""
        with self._lock:
            self.resumes += 1

    def record_flops(self, useful: int, wasted: int = 0) -> None:
        """Attribute one dispatch's (or one deferred retire's) model
        FLOPs: ``useful`` advanced real streams, ``wasted`` went to
        padding rows, rejected proposals, table slack or frozen riders."""
        with self._lock:
            self.useful_flops += max(0, int(useful))
            self.wasted_flops += max(0, int(wasted))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ttft": self.ttft.snapshot(),
                "inter_token": self.inter_token.snapshot(),
                "queue_wait": self.queue_wait.snapshot(),
                # bucket idx -> (trace_id, ns, unix_ts); empty unless
                # tracing is on: the /metrics exemplar feed
                "exemplars": {
                    "ttft": self.ttft.exemplar_snapshot(),
                    "inter_token": self.inter_token.exemplar_snapshot(),
                    "queue_wait": self.queue_wait.exemplar_snapshot(),
                },
                "tokens": self.tokens,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "deadline_expired": self.deadline_expired,
                "slot_busy_ns": self.slot_busy_ns,
                "ring_fetches": self.ring_fetches,
                "ring_forced_fetches": self.ring_forced_fetches,
                "prefill_chunks": self.prefill_chunks,
                "prefill_tokens": self.prefill_tokens,
                "lane_handoffs": self.lane_handoffs,
                "lane_batch_dispatches": self.lane_batch_dispatches,
                "lane_batch_slots": self.lane_batch_slots,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_saved_tokens": self.prefix_saved_tokens,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_rejected": self.spec_rejected,
                "spec_rounds": self.spec_rounds,
                "spec_rung_rounds": dict(self.spec_rung_rounds),
                "tier_hits": self.tier_hits,
                "preemptions": self.preemptions,
                "resumes": self.resumes,
                "useful_flops": self.useful_flops,
                "wasted_flops": self.wasted_flops,
            }
