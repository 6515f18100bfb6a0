"""Chrome-trace / Perfetto timeline export: the port's counterpart of
``client_tpu/server/timeline.py``, the "why was this request slow" file an
operator opens in one viewer.

Merges two sources the serving stack already keeps:

- **Request traces** (server/trace.py): sampled per-request span records.
  Duration spans (records carrying ``dur_ns``: QUEUE_WAIT, PREFILL_CHUNK,
  LANE_HANDOFF, DECODE, RING_DELIVER) become complete ("X") events, or
  async begin/end pairs for the device-cadence ones; flat lifecycle stamps
  (GENERATION_ENQUEUE, PREFILL_END, ...) become thread-scoped instants
  ("i"). Each traced request gets its own thread track inside the replica
  process its FLEET_ROUTE span named, or the model's first replica when
  unrouted (a single-engine model).
- **FlightRecorder iteration rings** (server/runtime_stats.py): the
  engine-loop log. Iterations become back-to-back "X" events on the
  decode-lane track (named by phase, duration = gap to the next
  iteration), the dedicated prefill lane and speculation rungs become
  their own tracks, and occupancy and queue depth render as counter ("C")
  events.

Output is the Chrome Trace Event Format (the JSON-array flavour inside
``{"traceEvents": [...]}``), loadable by ``chrome://tracing`` and
Perfetto: one process per replica (``pid``; metadata "M" events carry
the replica name), fixed ``tid`` tracks per process for the engine
planes, and a tid band from :data:`REQUEST_TID_BASE` up for request
tracks. Timestamps convert the engine's monotonic ns to the format's
microseconds (one shared clock: every source stamps ``types.now_ns``).
"""

from __future__ import annotations

# Fixed per-process track ids (tid) for the engine planes; request
# tracks are allocated upward from REQUEST_TID_BASE in trace order.
TID_DECODE_LANE = 1
TID_PREFILL_LANE = 2
TID_SPEC_RUNGS = 3
TID_HANDOFFS = 4
TID_PREEMPTIONS = 5
TID_LIFECYCLE = 6
TID_INCIDENTS = 7
REQUEST_TID_BASE = 100

_TRACK_NAMES = {
    TID_DECODE_LANE: "decode lane",
    TID_PREFILL_LANE: "prefill lane",
    TID_SPEC_RUNGS: "spec rungs",
    TID_HANDOFFS: "handoffs",
    TID_PREEMPTIONS: "preemptions",
    TID_LIFECYCLE: "lifecycle",
    TID_INCIDENTS: "incidents",
}

# Span names that re-render onto an engine-plane track IN ADDITION to
# the request's own track (the per-replica aggregate views).
_HANDOFF_SPAN = "LANE_HANDOFF"
_PREEMPT_SPAN = "SCHED_PREEMPT"
_RESTART_SPAN = "ENGINE_RESTART"
_ROUTE_SPAN = "FLEET_ROUTE"
_INCIDENT_SPAN = "INCIDENT"

# Device-cadence duration spans (DECODE, RING_DELIVER) render as async
# begin/end pairs ("b"/"e"), NOT as "X" slices: their bounds are
# device-step attributions that legitimately overlap the host-side
# dispatch slices on the same request track (a RING_DELIVER span's
# host-arrival end can land past the DECODE span's final emit stamp),
# and forcing them into the synchronous slice model would either lie
# about the bounds or break per-track nesting.
_ASYNC_SPANS = frozenset({"DECODE", "RING_DELIVER"})


def _us(ns) -> float:
    """Monotonic ns -> Chrome-trace microseconds (float: the format
    keeps sub-us precision)."""
    return float(ns) / 1e3


def _meta(pid: int, name: str, tid=None) -> dict:
    ev = {"ph": "M", "pid": pid,
          "name": "process_name" if tid is None else "thread_name",
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _flight_events(pid: int, flight: list) -> list:
    """One replica's FlightRecorder ring -> decode-lane "X" slices,
    prefill-lane / spec tracks, and occupancy counters. Iteration i's
    duration is the gap to iteration i+1 (the loop is back-to-back by
    construction); the final iteration renders as an instant — its
    end is unobserved and a guessed duration would be a lie."""
    events: list = []
    entries = [e for e in flight if isinstance(e.get("ns"), int)]
    for i, entry in enumerate(entries):
        ts = _us(entry["ns"])
        nxt = entries[i + 1]["ns"] if i + 1 < len(entries) else None
        args = {k: entry[k] for k in
                ("iteration", "phase", "slots_active", "queue_depth",
                 "ring_lag", "tokens_emitted", "chunks_dispatched")
                if entry.get(k) is not None}
        if nxt is not None and nxt >= entry["ns"]:
            events.append({"ph": "X", "pid": pid,
                           "tid": TID_DECODE_LANE,
                           "name": str(entry.get("phase", "iter")),
                           "ts": ts, "dur": _us(nxt - entry["ns"]),
                           "args": args})
        else:
            events.append({"ph": "i", "pid": pid,
                           "tid": TID_DECODE_LANE, "s": "t",
                           "name": str(entry.get("phase", "iter")),
                           "ts": ts, "args": args})
        events.append({"ph": "C", "pid": pid, "name": "occupancy",
                       "ts": ts, "args": {
                           "slots_active": entry.get("slots_active", 0),
                           "queue_depth": entry.get("queue_depth", 0)}})
        lane = entry.get("lane")
        if lane is not None:
            lane_args = {"active": lane.get("active", 0),
                         "handoffs": lane.get("handoffs", 0)}
            if nxt is not None and nxt >= entry["ns"] \
                    and lane.get("active", 0) > 0:
                events.append({"ph": "X", "pid": pid,
                               "tid": TID_PREFILL_LANE,
                               "name": f"lane[{lane['active']}]",
                               "ts": ts, "dur": _us(nxt - entry["ns"]),
                               "args": lane_args})
            events.append({"ph": "C", "pid": pid,
                           "name": "prefill_lane_active", "ts": ts,
                           "args": {"active": lane.get("active", 0)}})
        rungs = entry.get("spec_rungs")
        if rungs:
            events.append({"ph": "i", "pid": pid,
                           "tid": TID_SPEC_RUNGS, "s": "t",
                           "name": f"rungs {sorted(rungs)}",
                           "ts": ts,
                           "args": {"rungs": list(rungs),
                                    "gamma": entry.get("spec_gamma")}})
    return events


def _trace_events(trace: dict, pid_of_replica: dict,
                  default_pid: int, tid: int) -> list:
    """One completed request trace -> its own thread track (duration
    records as "X", flat stamps as instants) plus re-renders onto the
    replica's handoff/preempt/lifecycle aggregate tracks. The track
    lands in the process of the replica the FLEET_ROUTE span named."""
    stamps = trace.get("timestamps") or []
    pid = default_pid
    for st in stamps:
        if st.get("name") == _ROUTE_SPAN \
                and st.get("replica") in pid_of_replica:
            pid = pid_of_replica[st["replica"]]
            break
    events = [_meta(pid, f"req {trace.get('id', '?')}", tid)]
    seq = 0
    for st in stamps:
        name = st.get("name", "?")
        ns = st.get("ns", 0)
        args = {k: v for k, v in st.items()
                if k not in ("name", "ns", "dur_ns")}
        args["trace_id"] = trace.get("id", "")
        if "dur_ns" in st and name in _ASYNC_SPANS:
            seq += 1
            base = {"pid": pid, "tid": tid, "name": name,
                    "cat": "device", "args": args,
                    "id": f"{trace.get('id', '')}:{seq}"}
            events.append(dict(base, ph="b", ts=_us(ns)))
            events.append(dict(base, ph="e",
                               ts=_us(ns + st["dur_ns"])))
            continue
        if "dur_ns" in st:
            ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
                  "ts": _us(ns), "dur": _us(st["dur_ns"]),
                  "args": args}
        else:
            ev = {"ph": "i", "pid": pid, "tid": tid, "name": name,
                  "ts": _us(ns), "s": "t", "args": args}
        events.append(ev)
        if name == _HANDOFF_SPAN:
            events.append(dict(ev, tid=TID_HANDOFFS))
        elif name == _PREEMPT_SPAN:
            events.append(dict(ev, tid=TID_PREEMPTIONS))
        elif name == _RESTART_SPAN:
            events.append(dict(ev, tid=TID_LIFECYCLE))
        elif name == _INCIDENT_SPAN:
            events.append(dict(ev, tid=TID_INCIDENTS))
    return events


def build_timeline(models: list) -> dict:
    """Merge per-model timeline snapshots into ONE Chrome-trace JSON.

    ``models``: [{model, version, traces: [trace.to_json() dicts],
    replicas: [{replica, name, flight: [ring entries]}], fleet:
    fleet_snapshot() or None}]. Replica processes take sequential
    pids across models; every replica gets the fixed engine-plane
    thread tracks, every trace its own request track."""
    events: list = []
    next_pid = 1
    for m in models:
        replicas = m.get("replicas") or [{"replica": 0,
                                          "name": m.get("model", "?")}]
        pid_of_replica: dict = {}
        for rep in replicas:
            pid = next_pid
            next_pid += 1
            pid_of_replica[rep.get("replica", 0)] = pid
            events.append(_meta(
                pid, str(rep.get("name", m.get("model", "?")))))
            for tid, track in _TRACK_NAMES.items():
                events.append(_meta(pid, track, tid))
            events.extend(_flight_events(pid, rep.get("flight") or []))
        default_pid = min(pid_of_replica.values())
        # watchdog incident bundles -> process-scoped instants on the
        # incidents track of the recording engine's replica (bundles
        # carry the engine name — fleet replicas are "name/rN"; a
        # restarted engine's death bundle keeps its original name)
        pid_of_engine = {str(rep.get("name", "")): pid_of_replica[
            rep.get("replica", 0)] for rep in replicas}
        inc_snap = m.get("incidents")
        if inc_snap:
            for inc in inc_snap.get("incidents") or []:
                events.append({
                    "ph": "i",
                    "pid": pid_of_engine.get(
                        str(inc.get("engine", "")), default_pid),
                    "tid": TID_INCIDENTS, "s": "p",
                    "name": f"INCIDENT:{inc.get('detector', '?')}",
                    "ts": _us(inc.get("ns", 0)),
                    "args": {"id": inc.get("id"),
                             "detector": inc.get("detector"),
                             "kind": inc.get("kind"),
                             "engine": inc.get("engine"),
                             "breach": inc.get("breach")}})
        fleet = m.get("fleet")
        if fleet:
            for ev in fleet.get("lifecycle_events") or []:
                pid = pid_of_replica.get(ev.get("replica"),
                                         default_pid)
                events.append({
                    "ph": "i", "pid": pid, "tid": TID_LIFECYCLE,
                    "s": "p",
                    "name": f"{ev.get('event', 'FLEET_DRAIN')}:"
                            f"{ev.get('verb', '?')}",
                    "ts": _us(ev.get("ns", 0)),
                    "args": {k: v for k, v in ev.items() if k != "ns"}})
        for i, trace in enumerate(m.get("traces") or []):
            events.extend(_trace_events(
                trace, pid_of_replica, default_pid,
                REQUEST_TID_BASE + i))
    # stable viewer ordering; metadata first so names bind before use
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: dict) -> list:
    """Schema check for the exported document — the tests' (and the
    benchmark gate's) single validity oracle. Returns a list of
    violation strings, empty when the document is a well-formed
    Chrome-trace JSON: required keys per phase type, non-negative
    timestamps/durations, metadata-before-reference naming, and
    per-track "X" slices that nest without partial overlap."""
    errors: list = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document must be {'traceEvents': [...]}"]
    by_track: dict = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M", "B", "E", "b", "e"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "pid" not in ev or "name" not in ev:
            errors.append(f"event {i}: missing pid/name")
            continue
        if ph == "M":
            if ev["name"] not in ("process_name", "thread_name"):
                errors.append(f"event {i}: bad metadata {ev['name']!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: X without valid dur")
                continue
            by_track.setdefault(
                (ev["pid"], ev.get("tid", 0)), []).append(
                (ts, ts + dur, i))
        elif ph in ("b", "e") and ("id" not in ev or "cat" not in ev):
            errors.append(f"event {i}: async event without id/cat")
        elif ph == "i" and ev.get("s") not in ("g", "p", "t"):
            errors.append(f"event {i}: instant scope {ev.get('s')!r}")
    # nesting honesty: on one track, two slices either nest or are
    # disjoint — partial overlap means durations were fabricated.
    # eps absorbs the ns->us float conversion: back-to-back engine
    # iterations can land a slice end ~1e-7 us past the next start,
    # which is rounding, not a fabricated overlap.
    eps = 1e-3
    for (pid, tid), slices in by_track.items():
        slices.sort()
        stack: list = []
        for start, end, idx in slices:
            while stack and stack[-1] <= start + eps:
                stack.pop()
            if stack and end > stack[-1] + eps:
                errors.append(
                    f"event {idx}: slice on pid={pid} tid={tid} "
                    f"partially overlaps an open slice "
                    f"([{start}, {end}) vs end {stack[-1]})")
                continue
            stack.append(end)
    return errors
