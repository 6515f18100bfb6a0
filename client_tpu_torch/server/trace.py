"""Request tracing: the v2 trace extension, recording traces.

The port's own copy of ``client_tpu/server/trace.py`` (framework-free
there; the port imports nothing of the reference package), with the same
span names, settings and export format.

Dapper-style always-on sampled tracing (Sigelman et al., 2010): every
``trace_rate``-th request is stamped with span timestamps from arrival
through queue, compute and output delivery, up to a ``trace_count``
budget, and exported as JSON-lines to ``trace_file`` (flushed every
``log_frequency`` completed traces; 0 flushes immediately).

Settings parity: the knobs the reference trace API exposes
(ref:src/python/library/tritonclient/http/__init__.py:738-840
update_trace_settings) — trace_level OFF/TIMESTAMPS/TENSORS, trace_rate,
trace_count (-1 = unlimited), log_frequency, trace_file — global with
per-model overrides.

Propagation: a caller-supplied id (HTTP ``triton-trace-id`` header /
gRPC ``triton_trace_id`` request parameter) forces sampling so client
and server spans correlate; ensemble steps get child traces linked by
``parent_id``.
"""

from __future__ import annotations

import collections
import json
import threading
import uuid
import weakref
from typing import Optional

from client_tpu_torch.server.types import now_ns

# Sentinel for a sub-request whose parent request was NOT sampled: the
# step must not be independently rate-sampled (sampling decisions happen
# at top level only, Dapper-style), or internal steps would burn the
# trace budget on orphan traces.
UNSAMPLED_PARENT = object()

# Span names in serving-path order. REQUEST_START..REQUEST_END bracket a
# request; CACHE_HIT replaces the compute spans on a response-cache hit.
REQUEST_START = "REQUEST_START"
QUEUE_START = "QUEUE_START"
COMPUTE_START = "COMPUTE_START"
COMPUTE_INPUT_END = "COMPUTE_INPUT_END"
COMPUTE_OUTPUT_START = "COMPUTE_OUTPUT_START"
REQUEST_END = "REQUEST_END"
CACHE_HIT = "CACHE_HIT"

# Token-generation spans (decoupled / continuous-batching serving path):
# GENERATION_ENQUEUE marks entry into the generation engine's pending
# queue (its ``tenant``/``slo_class`` fields carry the request's SLO
# attribution, mirroring the same fields on REQUEST_START), PREFIX_HIT a prefix-cache admission (its ``matched_tokens``
# field carries how many prompt tokens were restored from the KV block
# pool instead of re-prefilled), PREFILL_END the completion of batched
# prompt prefill, FIRST_TOKEN the first streamed response (the TTFT
# boundary), and TOKEN_EMIT every TOKEN_EMIT_SAMPLE_EVERY-th streamed
# token thereafter (sampled: a per-token span on every token would make
# the trace cost scale with generation length).
GENERATION_ENQUEUE = "GENERATION_ENQUEUE"
PREFIX_HIT = "PREFIX_HIT"
PREFILL_END = "PREFILL_END"
# LANE_HANDOFF: the dedicated prefill lane finished ingesting this
# request's prompt and handed its KV to a decode slot (paged: a
# zero-copy block-table move; slot layout: pool commit/restore) —
# carries prompt_tokens and the receiving decode_slot
LANE_HANDOFF = "LANE_HANDOFF"
FIRST_TOKEN = "FIRST_TOKEN"
TOKEN_EMIT = "TOKEN_EMIT"
# SPEC_VERIFY: one speculative-decoding verify round retired for this
# request; its ``proposed``/``accepted`` fields carry how many draft
# tokens were scored by the parallel verification pass and how many
# survived (the stream advanced accepted + 1 tokens that round).
SPEC_VERIFY = "SPEC_VERIFY"
# ENGINE_RESTART: the continuous-batching engine serving this request
# died and a supervised restart is pending — the request was answered
# with a retryable 503. Fields: ``failure`` (the engine error),
# ``retryable`` (False when no supervisor is attached and the death is
# terminal until an operator reload), ``retry_after_s`` (the backoff
# the restart will wait, mirrored in the HTTP Retry-After header).
ENGINE_RESTART = "ENGINE_RESTART"
# SCHED_PREEMPT: the closed-loop scheduler preempted this stream's
# slot for a burning higher-weight class — its computed KV was
# committed to the prefix pool and the request re-queued with its
# generated-so-far tokens folded into the prompt; the resume rides the
# prefix-restore + chunked-prefill path token-identical (greedy) to an
# uninterrupted run. Fields: ``generated`` (tokens folded this
# preemption), ``preempt_count`` (cumulative, bounded by
# SchedulerConfig.max_preemptions).
SCHED_PREEMPT = "SCHED_PREEMPT"
# COMPILE: a serving-phase XLA compile observed by the runtime plane's
# CompileWatch AFTER warmup sealed the model's compile set — every
# in-flight stream stalled behind it. Fields: ``kernel`` (the watched
# entry point), ``signature`` (the novel shape signature that forced
# the compile), ``seconds`` (measured compile wall time).
COMPILE = "COMPILE"

# Fleet-router spans: FLEET_ROUTE is stamped once per ROUTED submit and
# carries the full policy decision — ``replica`` (index that won),
# ``replica_name``, ``leg`` (which policy leg decided: "affinity" when
# the sketch's warmest replica was taken, "load" when the least-loaded
# fallback won, "tolerance" when a warm replica was rejected for being
# more than affinity_tolerance above the coldest load, "round_robin"/
# "random" under those policies), ``affinity_hit`` (bool),
# ``affinity_depth`` (matched sketch blocks), ``load`` (chosen
# replica's load at decision time) and ``tolerance`` (the configured
# bound). FLEET_REROUTE marks each bounce — a replica accepted the
# route but refused admission (503) — with the refusing ``replica``
# and ``attempt`` ordinal, so a request's full replica history reads
# off its trace. FLEET_DRAIN marks lifecycle verbs (drain/swap/
# rolling_restart/replace_all) in fleet-level event records; requests
# in flight during a drain see it via the fleet's lifecycle ring
# rather than per-request stamps (a drain is fleet-wide, not owned by
# any one trace).
FLEET_ROUTE = "FLEET_ROUTE"
FLEET_REROUTE = "FLEET_REROUTE"
FLEET_DRAIN = "FLEET_DRAIN"
# Outer-control-loop spans (server/autoscale.py): FLEET_SCALE marks an
# autoscaler actuation on the fleet lifecycle ring — verb
# "attach_replica" (scale-up: a warmed replica published to the
# router) or "detach_replica" (scale-down: drain + remove) with the
# driving signals (``burn``, ``queue_depth``, ``replicas``) in the
# event fields. CANARY_PROMOTE / CANARY_ROLLBACK mark the CanaryJudge
# verdict on a canary rollout: promote restarts the stable set onto
# the canary's model version; rollback drains the canary with zero
# failed streams. All three are fleet-level event records (the timeline's
# lifecycle track), not per-request stamps — like
# FLEET_DRAIN, a scale decision is fleet-wide, owned by no one trace.
FLEET_SCALE = "FLEET_SCALE"
CANARY_PROMOTE = "CANARY_PROMOTE"
CANARY_ROLLBACK = "CANARY_ROLLBACK"

# INCIDENT: a watchdog anomaly detector fired on the engine serving
# this request (server/watchdog.py) — the full evidence bundle lives
# in the incident store at /v2/debug/incidents; this per-request stamp
# carries ``detector`` and ``incident_id`` so a request timeline shows
# the incident cutting across its spans (stamped best-effort on every
# traced in-flight request, the serving-phase COMPILE plumbing).
INCIDENT = "INCIDENT"

# Duration-model spans (begin/end pairs collapsed into one record
# carrying ``dur_ns``; see Trace.span): QUEUE_WAIT covers enqueue ->
# admission, PREFILL_CHUNK one chunked-prefill dispatch on the lane
# (fields: ``chunk_tokens``, ``chunk_index``), DECODE the steady-state
# token loop FIRST_TOKEN -> last emit, RING_DELIVER the device-cadence
# emit stamp -> host arrival gap for a fetch batch (the stride-k
# fetch cost made explicit: TTFT/ITL use the device-cadence emit_ns,
# so stride never inflates them — the delivery lag lives HERE).
QUEUE_WAIT = "QUEUE_WAIT"
PREFILL_CHUNK = "PREFILL_CHUNK"
DECODE = "DECODE"
RING_DELIVER = "RING_DELIVER"

TOKEN_EMIT_SAMPLE_EVERY = 8

LEVELS = ("OFF", "TIMESTAMPS", "TENSORS")

DEFAULT_SETTINGS = {
    "trace_level": ["OFF"],
    "trace_rate": ["1000"],
    "trace_count": ["-1"],
    "log_frequency": ["0"],
    "trace_file": [""],
}


class Trace:
    """One sampled request: an id, an optional parent link, and spans."""

    __slots__ = ("id", "parent_id", "model_name", "model_version",
                 "timestamps", "tensors", "wants_tensors",
                 "_file", "_log_frequency")

    def __init__(self, trace_id: str, model_name: str, model_version: str,
                 parent_id: Optional[str] = None,
                 wants_tensors: bool = False,
                 export_file: str = "", log_frequency: int = 0):
        self.id = trace_id
        self.parent_id = parent_id
        self.model_name = model_name
        self.model_version = model_version
        # [(span_name, monotonic_ns)] or, for spans carrying fields
        # (e.g. PREFIX_HIT's matched_tokens), (name, ns, {field: value})
        self.timestamps: list = []
        self.tensors: list = []         # [{kind, name, datatype, shape}]
        self.wants_tensors = wants_tensors
        self._file = export_file
        self._log_frequency = log_frequency

    def event(self, name: str, ns: Optional[int] = None,
              **fields) -> None:
        """Stamp a span. Extra keyword ``fields`` (span payload, e.g.
        ``matched_tokens`` on PREFIX_HIT) ride along into the exported
        timestamp record."""
        stamp = now_ns() if ns is None else ns
        self.timestamps.append((name, stamp, fields) if fields
                               else (name, stamp))

    def span(self, name: str, start_ns: int, end_ns: int,
             **fields) -> None:
        """Stamp a DURATION span: one record at ``start_ns`` carrying
        ``dur_ns = end_ns - start_ns`` (clamped to >= 0 — monotonic
        stamps taken on different threads can disagree by a few ns and
        a negative duration would wreck downstream viewers). Collapsing
        the begin/end pair into one record keeps to_json() stable for
        existing flat-event consumers while giving the timeline
        exporter real durations."""
        self.timestamps.append(
            (name, start_ns,
             dict(fields, dur_ns=max(0, int(end_ns) - int(start_ns)))))

    def add_tensors(self, kind: str, tensors) -> None:
        """TENSORS level: record wire metadata per tensor (not payloads —
        a trace must stay cheap enough to leave on in production)."""
        if not self.wants_tensors:
            return
        for t in tensors:
            self.tensors.append({
                "kind": kind, "name": t.name,
                "datatype": getattr(t, "datatype", ""),
                "shape": list(getattr(t, "shape", ()) or ()),
            })

    def to_json(self) -> dict:
        stamps = []
        for ts in self.timestamps:
            d = {"name": ts[0], "ns": ts[1]}
            if len(ts) > 2:
                d.update(ts[2])
            stamps.append(d)
        j = {
            "id": self.id,
            "model_name": self.model_name,
            "model_version": self.model_version,
            "timestamps": stamps,
        }
        if self.parent_id:
            j["parent_id"] = self.parent_id
        if self.tensors:
            j["tensors"] = self.tensors
        return j


# Every live Tracer, weakly held. Fleet lifecycle verbs (drain /
# rolling_restart / replace_all) replace engines owned by models a
# Tracer may have buffered JSONL for, but the fleet layer has no handle
# on the serving core's Tracer — flush_all() gives it one without a
# dependency edge. WeakSet: a registry entry must not keep a dead
# server's tracer (and its buffers) alive.
_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def flush_all() -> None:
    """Flush buffered trace JSONL on every live Tracer. Called by fleet
    lifecycle verbs before a replica is replaced so its spans hit disk
    even though only core.stop()/unload_model flush per-tracer."""
    for tracer in list(_TRACERS):
        tracer.flush()


class Tracer:
    """Owns trace settings, sampling state and JSONL export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._settings = {k: list(v) for k, v in DEFAULT_SETTINGS.items()}
        self._model_settings: dict[str, dict] = {}
        self._seq: dict[str, int] = {}      # model -> arrival counter
        self._budget_used = 0
        self._buffers: dict[str, list] = {}  # trace_file -> pending lines
        # read-mostly fast-path gate: False when every scope is OFF, so
        # sample() costs one GIL-atomic read per request instead of a
        # mutex (the serving hot path; rebuilt on every settings update)
        self._active = False
        # last completed traces, for API introspection and tests (bounded
        # so an always-on tracer can't grow without a trace_file)
        self.completed: collections.deque = collections.deque(maxlen=128)
        _TRACERS.add(self)

    # ---- settings (the get/update_trace_settings API) ----

    def get_settings(self, model_name: str = "") -> dict:
        with self._lock:
            merged = {k: list(v) for k, v in self._settings.items()}
            if model_name:
                for k, v in self._model_settings.get(model_name, {}).items():
                    merged[k] = list(v)
            return merged

    def update_settings(self, model_name: str = "",
                        settings: Optional[dict] = None) -> dict:
        settings = settings or {}
        with self._lock:
            target = (self._model_settings.setdefault(model_name, {})
                      if model_name else self._settings)
            for k, v in settings.items():
                if v is None:
                    target.pop(k, None)
                    if not model_name:
                        target[k] = list(DEFAULT_SETTINGS.get(k, []))
                else:
                    target[k] = ([str(x) for x in v]
                                 if isinstance(v, (list, tuple))
                                 else [str(v)])
            self._active = self._any_scope_on()
        return self.get_settings(model_name)

    def _any_scope_on(self) -> bool:
        """True when the global scope or any model override traces.
        Caller holds self._lock."""
        def on(levels):
            return bool(levels) and "OFF" not in [x.upper() for x in levels]

        if on(self._settings.get("trace_level", [])):
            return True
        return any(on(o.get("trace_level",
                            self._settings.get("trace_level", [])))
                   for o in self._model_settings.values())

    def _resolved(self, model_name: str) -> tuple:
        """(levels, rate, count, log_frequency, trace_file) under lock."""
        merged = dict(self._settings)
        for k, v in self._model_settings.get(model_name, {}).items():
            merged[k] = v

        def first_int(key, default):
            try:
                return int(merged.get(key, [default])[0])
            except (ValueError, IndexError):
                return default

        levels = [x.upper() for x in merged.get("trace_level", ["OFF"]) if x]
        rate = first_int("trace_rate", 1000)
        count = first_int("trace_count", -1)
        freq = first_int("log_frequency", 0)
        fval = merged.get("trace_file", [""])
        return (levels, rate, count, freq, fval[0] if fval else "")

    # ---- sampling ----

    def sample(self, model_name: str, model_version: str,
               propagated_id: str = "",
               parent: Optional[Trace] = None) -> Optional[Trace]:
        """Decide whether this request is traced. A child of a traced
        ensemble parent is always traced (and rides the parent's budget);
        a propagated id bypasses rate sampling (the caller explicitly
        asked for correlation) but still honors the budget."""
        if not self._active or parent is UNSAMPLED_PARENT:
            return None  # lock-free hot path / unsampled-parent step
        with self._lock:
            levels, rate, count, freq, trace_file = self._resolved(model_name)
            if "OFF" in levels or not levels:
                return None
            if parent is not None:
                return Trace(uuid.uuid4().hex[:16], model_name,
                             model_version, parent_id=parent.id,
                             wants_tensors=parent.wants_tensors,
                             export_file=trace_file, log_frequency=freq)
            if not propagated_id:
                seq = self._seq.get(model_name, 0) + 1
                self._seq[model_name] = seq
                if rate <= 0 or seq % rate != 0:
                    return None
            if count >= 0 and self._budget_used >= count:
                return None
            self._budget_used += 1
            return Trace(propagated_id or uuid.uuid4().hex[:16],
                         model_name, model_version,
                         wants_tensors="TENSORS" in levels,
                         export_file=trace_file, log_frequency=freq)

    # ---- export ----

    def release(self, trace: Trace) -> None:
        """A trace is complete: keep it for introspection and export it.
        Disk writes happen OUTSIDE the lock — sample() contends on it per
        traced-model request, and a stalled trace_file filesystem must
        not stall the serving path."""
        to_write = None
        with self._lock:
            self.completed.append(trace)
            if not trace._file:
                return
            buf = self._buffers.setdefault(trace._file, [])
            buf.append(json.dumps(trace.to_json(),
                                  separators=(",", ":")))
            if len(buf) >= max(1, trace._log_frequency):
                to_write, self._buffers[trace._file] = buf, []
        if to_write:
            self._write(trace._file, to_write)

    def flush(self) -> None:
        with self._lock:
            drained = {p: lines for p, lines in self._buffers.items()
                       if lines}
            for p in drained:
                self._buffers[p] = []
        for path, lines in drained.items():
            self._write(path, lines)

    @staticmethod
    def _write(path: str, lines: list) -> None:
        try:
            with open(path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            pass  # tracing must never take down the serving path
