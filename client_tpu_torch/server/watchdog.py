"""Watchdog & incident plane: always-on anomaly detectors over an
in-process metric history, with post-mortem evidence bundles. The
port's own copy of ``client_tpu/server/watchdog.py``.

The serving stack *measures* everything (SLO burn windows, goodput/MFU,
per-kernel device time, request timelines, flight recorders) and the
controllers *act* on some of it (knob steering, preemption pressure,
autoscaling) — but nothing watches those signals for the failure modes
the controllers cannot fix: a wedged kernel in front of the dispatch, a
paged-pool block leak, token-ring lag runaway, speculation acceptance
collapse, host-tier thrash. This module closes that gap with three
pieces, all pure host code on signals the engine already computes
(no device work and no added synchronisation with the card):

- :class:`MetricHistory` — a bounded in-process time series: the engine
  loop (and the fleet controller) offer one small dict of live signals
  per iteration; the history accepts at most one sample per
  ``interval_s`` and keeps the last N. Detectors evaluate over this
  window, so a firing detector can hand the *triggering history slice*
  to the incident bundle.

- the **detector set** — each detector is a pure function over the
  history window returning breach evidence or None. Hysteresis lives in
  the window requirement (a breach needs K consecutive bad samples, or
  one unambiguous wall-clock gap); flap suppression lives in the
  episode state machine (:class:`Watchdog`): a detector fires ONCE per
  episode, the episode closes only after ``clear_samples`` consecutive
  healthy evaluations, and a re-breach within ``cooldown_s`` of the
  last fire re-opens the episode silently instead of minting a second
  incident.

- :class:`IncidentStore` — a bounded ring of structured JSON incident
  bundles (flight-recorder tail, scheduler/goodput/slo/paged-pool
  snapshots, the triggering history window), optionally spilled to a
  JSONL file. The store is created ONCE per model and shared across
  supervised engine restarts and fleet replicas, so a death incident
  recorded by a crashing engine stays retrievable at
  ``GET /v2/debug/incidents`` after the supervisor swaps in a fresh
  engine, and fleet incidents merge trivially (each bundle carries the
  recording engine's name — replicas are ``name/rN``).

Surfaced as the ``client_tpu_watchdog_*`` /metrics families, the
``INCIDENT`` trace/timeline event, and ``GET /v2/debug/incidents``.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("client_tpu_torch.watchdog")

# history ring depth (at the default 0.25 s interval: the last minute)
HISTORY_CAP = 240
# incident bundles retained in process (each carries its evidence; the
# optional JSONL spill keeps everything ever recorded)
INCIDENT_RING_CAP = 32
# flight-recorder iterations copied into a bundle
EVIDENCE_FLIGHT_TAIL = 32
# history samples copied into a bundle (the triggering slice)
EVIDENCE_HISTORY_TAIL = 16

# the anomaly detector set — evaluation order is also the stable
# /metrics label order (the lint pins the schema)
DETECTORS = (
    "engine_stall",
    "queue_stagnation",
    "pool_leak",
    "ring_lag_runaway",
    "burn_spike",
    "compile_violation",
    "acceptance_collapse",
    "tier_thrash",
)
# the promoted engine-death bundle rides the same store/counter schema
ENGINE_DEATH = "engine_death"
INCIDENT_KINDS = DETECTORS + (ENGINE_DEATH,)

# Detector thresholds. Defaults are deliberately conservative: a
# healthy engine under the committed benches/tests must never breach
# them (the bench's clean arm and the false-positive e2e test pin
# exactly that). Tests and the chaos bench tighten them per-arm.
DEFAULT_THRESHOLDS = {
    # engine_stall: wall gap between loop samples while slots were
    # active (a wedged kernel freezes the loop → the gap IS the
    # evidence), or this many consecutive samples with active slots
    # and zero dispatch/token progress
    "stall_wall_s": 5.0,
    "stall_samples": 8,
    # queue_stagnation: queued work with zero admissions AND zero
    # token progress for this many consecutive samples
    "stagnation_samples": 12,
    # pool_leak: orphan paged blocks (stream-owned occupancy minus
    # the blocks live slot tables account for) at least this large
    # and non-decreasing for this many consecutive samples
    "leak_min_blocks": 2,
    "leak_samples": 6,
    # ring_lag_runaway: dispatches riding ahead of the last retired
    # fetch beyond this for this many consecutive samples (forced
    # backpressure bounds a healthy engine far below it)
    "ring_lag_limit": 1024,
    "ring_lag_samples": 4,
    # burn_spike: max per-class error-budget burn at/above this for
    # this many consecutive samples (suppressed while a canary is in
    # flight — the judge owns burn during a rollout)
    "burn_limit": 8.0,
    "burn_samples": 4,
    # compile_violation: any serving-phase unexpected-compile delta
    # (a capture after the engine sealed its compile set)
    # acceptance_collapse: speculation acceptance EWMA below the
    # floor for this many samples, once enough rounds ran to trust it
    "acceptance_floor": 0.05,
    "acceptance_samples": 6,
    "acceptance_min_rounds": 64,
    # tier_thrash: host-tier spill+restore events per second over the
    # window at/above this rate
    "tier_thrash_rate": 64.0,
    "tier_thrash_samples": 6,
    # episode hygiene (shared): consecutive healthy evaluations that
    # close an episode; minimum wall time between two *incidents*
    # from the same detector (a re-breach inside the cooldown
    # re-opens the episode silently — same episode, one bundle)
    "clear_samples": 4,
    "cooldown_s": 30.0,
}


class MetricHistory:
    """Bounded fixed-interval time series of signal dicts.

    ``sample()`` accepts at most one entry per ``interval_s`` (callers
    offer every loop iteration; the ring stays a fixed wall-clock
    window, not a fixed iteration window) and returns whether the
    sample was accepted — the caller only evaluates detectors on
    accepted samples. Thread-safe: the engine thread writes, scrape
    threads read."""

    def __init__(self, capacity: int = HISTORY_CAP,
                 interval_s: float = 0.25):
        if capacity <= 1:
            raise ValueError("MetricHistory capacity must be > 1")
        if interval_s < 0:
            raise ValueError("MetricHistory interval_s must be >= 0")
        self.capacity = int(capacity)
        self.interval_s = float(interval_s)
        self._buf: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._accepted = 0
        self._last_ns: Optional[int] = None

    def sample(self, ns: int, signals: dict,
               force: bool = False) -> bool:
        with self._lock:
            if not force and self._last_ns is not None \
                    and ns - self._last_ns < self.interval_s * 1e9:
                return False
            entry = dict(signals)
            entry["ns"] = int(ns)
            self._buf.append(entry)
            self._accepted += 1
            self._last_ns = ns
            return True

    def window(self, n: Optional[int] = None) -> list:
        """The last ``n`` samples (all when None), oldest first."""
        with self._lock:
            buf = list(self._buf)
        return buf if n is None else buf[-max(0, int(n)):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "interval_s": self.interval_s,
                "depth": len(self._buf),
                "samples_accepted": self._accepted,
            }


# ---------------------------------------------------------------------
# detectors — pure functions (window, thresholds) -> breach | None.
# Window samples are the engine's signal dicts (oldest first, newest
# last); any signal may be None (plane not armed on this engine) and a
# None signal never breaches.
# ---------------------------------------------------------------------

def _tail_ok(w: list, n: int) -> Optional[list]:
    """The last ``n`` samples, or None when history is too short for
    the detector's hysteresis window."""
    if len(w) < n:
        return None
    return w[-n:]


def _d_engine_stall(w: list, th: dict) -> Optional[dict]:
    # gap path: the loop froze mid-dispatch (a wedged kernel) — the
    # wall gap between the last two samples exceeds the limit while
    # slots were active going in. One sample pair is the whole proof.
    if len(w) >= 2:
        prev, cur = w[-2], w[-1]
        gap_s = (cur["ns"] - prev["ns"]) / 1e9
        if prev.get("slots_active", 0) > 0 \
                and gap_s > th["stall_wall_s"]:
            return {"path": "wall_gap", "gap_s": round(gap_s, 3),
                    "limit_s": th["stall_wall_s"],
                    "slots_active": prev["slots_active"]}
    # freeze path: the loop keeps iterating but makes no dispatch or
    # token progress while slots stay occupied
    tail = _tail_ok(w, th["stall_samples"])
    if tail is None:
        return None
    if not all(s.get("slots_active", 0) > 0 for s in tail):
        return None
    d_chunks = tail[-1].get("chunks_dispatched", 0) \
        - tail[0].get("chunks_dispatched", 0)
    d_tokens = tail[-1].get("tokens_emitted", 0) \
        - tail[0].get("tokens_emitted", 0)
    if d_chunks == 0 and d_tokens == 0:
        return {"path": "frozen_progress",
                "samples": th["stall_samples"],
                "slots_active": tail[-1].get("slots_active", 0)}
    return None


def _d_queue_stagnation(w: list, th: dict) -> Optional[dict]:
    tail = _tail_ok(w, th["stagnation_samples"])
    if tail is None:
        return None
    if not all(s.get("queue_depth", 0) > 0 for s in tail):
        return None
    d_admissions = tail[-1].get("admissions", 0) \
        - tail[0].get("admissions", 0)
    d_tokens = tail[-1].get("tokens_emitted", 0) \
        - tail[0].get("tokens_emitted", 0)
    if d_admissions == 0 and d_tokens == 0:
        return {"queue_depth": tail[-1].get("queue_depth", 0),
                "samples": th["stagnation_samples"]}
    return None


def _d_pool_leak(w: list, th: dict) -> Optional[dict]:
    tail = _tail_ok(w, th["leak_samples"])
    if tail is None:
        return None
    orphans = [s.get("pool_orphan_blocks") for s in tail]
    if any(o is None for o in orphans):
        return None
    if not all(o >= th["leak_min_blocks"] for o in orphans):
        return None
    # monotone non-decreasing drift — legitimate churn (a stream
    # releasing blocks) breaks the run
    if any(b < a for a, b in zip(orphans, orphans[1:])):
        return None
    return {"orphan_blocks": orphans[-1],
            "min_blocks": th["leak_min_blocks"],
            "samples": th["leak_samples"]}


def _d_ring_lag_runaway(w: list, th: dict) -> Optional[dict]:
    tail = _tail_ok(w, th["ring_lag_samples"])
    if tail is None:
        return None
    lags = [s.get("ring_lag", 0) or 0 for s in tail]
    if all(lag > th["ring_lag_limit"] for lag in lags):
        return {"ring_lag": lags[-1], "limit": th["ring_lag_limit"],
                "samples": th["ring_lag_samples"]}
    return None


def _d_burn_spike(w: list, th: dict) -> Optional[dict]:
    tail = _tail_ok(w, th["burn_samples"])
    if tail is None:
        return None
    burns = [s.get("max_class_burn") for s in tail]
    if any(b is None for b in burns):
        return None
    if all(b >= th["burn_limit"] for b in burns):
        return {"max_class_burn": round(burns[-1], 4),
                "limit": th["burn_limit"],
                "samples": th["burn_samples"]}
    return None


def _d_compile_violation(w: list, th: dict) -> Optional[dict]:
    if len(w) < 2:
        return None
    prev = w[-2].get("unexpected_compiles", 0) or 0
    cur = w[-1].get("unexpected_compiles", 0) or 0
    if cur > prev:
        return {"unexpected_compiles": cur, "new": cur - prev}
    return None


def _d_acceptance_collapse(w: list, th: dict) -> Optional[dict]:
    tail = _tail_ok(w, th["acceptance_samples"])
    if tail is None:
        return None
    rates = [s.get("spec_acceptance") for s in tail]
    if any(r is None for r in rates):
        return None
    if (tail[-1].get("spec_rounds") or 0) < th["acceptance_min_rounds"]:
        return None
    if all(r < th["acceptance_floor"] for r in rates):
        return {"acceptance": round(rates[-1], 4),
                "floor": th["acceptance_floor"],
                "rounds": tail[-1].get("spec_rounds"),
                "samples": th["acceptance_samples"]}
    return None


def _d_tier_thrash(w: list, th: dict) -> Optional[dict]:
    tail = _tail_ok(w, th["tier_thrash_samples"])
    if tail is None:
        return None
    first, last = tail[0], tail[-1]
    if first.get("tier_spills") is None \
            or last.get("tier_spills") is None:
        return None
    events = ((last.get("tier_spills", 0)
               - first.get("tier_spills", 0))
              + (last.get("tier_restores", 0)
                 - first.get("tier_restores", 0)))
    elapsed_s = (last["ns"] - first["ns"]) / 1e9
    if elapsed_s <= 0:
        return None
    rate = events / elapsed_s
    if rate >= th["tier_thrash_rate"]:
        return {"events_per_s": round(rate, 2),
                "limit": th["tier_thrash_rate"],
                "samples": th["tier_thrash_samples"]}
    return None


DETECTOR_FNS: dict = {
    "engine_stall": _d_engine_stall,
    "queue_stagnation": _d_queue_stagnation,
    "pool_leak": _d_pool_leak,
    "ring_lag_runaway": _d_ring_lag_runaway,
    "burn_spike": _d_burn_spike,
    "compile_violation": _d_compile_violation,
    "acceptance_collapse": _d_acceptance_collapse,
    "tier_thrash": _d_tier_thrash,
}
assert tuple(DETECTOR_FNS) == DETECTORS


class IncidentStore:
    """Bounded ring of structured incident bundles, shared across
    supervised engine restarts and fleet replicas (created once per
    model, threaded into every engine build the factory mints). The
    per-detector counters live HERE, not on the watchdog, so the
    /metrics ``client_tpu_watchdog_incidents_total`` counter stays
    monotone across an engine swap — exactly the property a counter
    scraped through a crash must keep."""

    def __init__(self, capacity: int = INCIDENT_RING_CAP,
                 spill_path: Optional[str] = None):
        if capacity <= 0:
            raise ValueError("IncidentStore capacity must be > 0")
        self.capacity = int(capacity)
        self.spill_path = spill_path
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.recorded_total = 0
        self.dropped_total = 0
        self.counts = {kind: 0 for kind in INCIDENT_KINDS}
        self._spill_failed = False

    def record(self, detector: str, engine: str,
               kind: str = "anomaly", ns: Optional[int] = None,
               breach: Optional[dict] = None,
               history: Optional[list] = None,
               evidence: Optional[dict] = None) -> str:
        if ns is None:
            ns = time.time_ns()
        with self._lock:
            self._seq += 1
            iid = f"inc-{self._seq:06d}"
            incident = {
                "id": iid,
                "ns": int(ns),
                "engine": engine,
                "detector": detector,
                "kind": kind,
                "breach": breach or {},
                "history": history or [],
                "evidence": evidence or {},
            }
            if len(self._ring) == self.capacity:
                self.dropped_total += 1
            self._ring.append(incident)
            self.recorded_total += 1
            self.counts[detector] = self.counts.get(detector, 0) + 1
        self._spill(incident)
        return iid

    def _spill(self, incident: dict) -> None:
        if self.spill_path is None or self._spill_failed:
            return
        try:
            with open(self.spill_path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(incident, default=str) + "\n")
        except OSError as e:
            # never let evidence capture take the engine down; warn
            # once and keep the in-process ring authoritative
            self._spill_failed = True
            log.warning("incident spill to %s failed (%s); further "
                        "spills disabled, in-process ring still "
                        "records", self.spill_path, e)

    def incidents(self, n: Optional[int] = None) -> list:
        """The last ``n`` bundles (all when None), oldest first."""
        with self._lock:
            buf = list(self._ring)
        return buf if n is None else buf[-max(0, int(n)):]

    def summary(self) -> dict:
        """Counters + ring occupancy without the bundles (the
        /metrics source; the full bundles ride the debug endpoint)."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "depth": len(self._ring),
                "recorded_total": self.recorded_total,
                "dropped_total": self.dropped_total,
                "counts": dict(self.counts),
                "spill_path": self.spill_path,
            }

    def snapshot(self) -> dict:
        """Full store state for ``GET /v2/debug/incidents``."""
        snap = self.summary()
        snap["incidents"] = self.incidents()
        return snap


class Watchdog:
    """Per-engine detector host. The engine loop calls
    :meth:`observe` once per iteration with its live signal dict;
    the watchdog downsamples through its :class:`MetricHistory`,
    evaluates every non-suppressed detector over the window, and
    runs the episode state machine: a detector fires ONE incident
    per episode (with the caller-built evidence bundle), stays
    ``active`` until ``clear_samples`` consecutive healthy
    evaluations close the episode, and a re-breach within
    ``cooldown_s`` of the last fire re-opens the episode without a
    second bundle. ``suppress()`` gates a detector externally (the
    fleet controller suppresses ``burn_spike`` while a canary
    rollout is in flight — the judge owns burn then)."""

    def __init__(self, engine: str, store: IncidentStore,
                 interval_s: float = 0.25,
                 thresholds: Optional[dict] = None,
                 history_cap: int = HISTORY_CAP):
        unknown = set(thresholds or ()) - set(DEFAULT_THRESHOLDS)
        if unknown:
            raise ValueError(
                f"unknown watchdog threshold(s) {sorted(unknown)}; "
                f"known: {sorted(DEFAULT_THRESHOLDS)}")
        self.engine = engine
        self.store = store
        self._th = dict(DEFAULT_THRESHOLDS)
        if thresholds:
            self._th.update(thresholds)
        self.history = MetricHistory(history_cap, interval_s)
        self._lock = threading.Lock()
        self.samples = 0
        self._state = {
            name: {"fires": 0, "active": False, "suppressed": False,
                   "healthy_streak": 0, "last_fire_ns": None}
            for name in DETECTORS}

    @property
    def thresholds(self) -> dict:
        return dict(self._th)

    def suppress(self, detector: str, on: bool = True) -> None:
        if detector not in self._state:
            raise ValueError(f"unknown detector '{detector}'")
        with self._lock:
            st = self._state[detector]
            st["suppressed"] = bool(on)
            if on:
                # a suppressed detector holds no episode open — the
                # next un-suppressed breach is a fresh episode
                st["active"] = False
                st["healthy_streak"] = 0

    def mark_idle(self, ns: int, signals: dict) -> None:
        """Record an idle boundary. The engine loop blocks on its
        request queue when nothing is in flight, so no samples land
        while the engine is quiet — without a boundary, the first
        sample of the next request would pair with the last sample of
        the previous one and the stall detector's wall-gap path would
        read the whole idle wait as a frozen dispatch. Forcing one
        slots-idle sample past the downsampling gate (the caller's
        signal dict reports ``slots_active == 0`` here) makes the gap
        pair start from a provably-idle sample. Detectors are not
        evaluated: going idle is not an anomaly."""
        self.history.sample(ns, signals, force=True)

    def observe(self, ns: int, signals: dict,
                evidence_fn: Optional[Callable] = None) -> list:
        """One engine-loop tick. Returns the incidents fired by THIS
        evaluation as ``[{"id", "detector", "breach"}]`` (empty on
        the fast path) so the caller can stamp trace events."""
        if not self.history.sample(ns, signals):
            return []
        w = self.history.window()
        fired = []
        with self._lock:
            self.samples += 1
            cooldown_ns = self._th["cooldown_s"] * 1e9
            for name in DETECTORS:
                st = self._state[name]
                if st["suppressed"]:
                    continue
                breach = DETECTOR_FNS[name](w, self._th)
                if breach is None:
                    if st["active"]:
                        st["healthy_streak"] += 1
                        if st["healthy_streak"] >= \
                                self._th["clear_samples"]:
                            st["active"] = False
                            st["healthy_streak"] = 0
                    continue
                st["healthy_streak"] = 0
                if st["active"]:
                    continue  # episode already reported once
                st["active"] = True
                if st["last_fire_ns"] is not None \
                        and ns - st["last_fire_ns"] < cooldown_ns:
                    # same episode resuming inside the cooldown — no
                    # second bundle (the never-flaps contract)
                    continue
                st["fires"] += 1
                st["last_fire_ns"] = ns
                fired.append({"detector": name, "breach": breach})
        # evidence capture happens OUTSIDE the state lock: the
        # evidence function reads engine snapshots that may themselves
        # take locks, and a slow capture must not block scrapes
        for f in fired:
            evidence = None
            if evidence_fn is not None:
                try:
                    evidence = evidence_fn(f["detector"], f["breach"])
                except Exception as e:  # noqa: BLE001 — capture is
                    # best-effort; a broken snapshot hook must not
                    # kill the engine loop that hosts the watchdog
                    evidence = {"evidence_error": str(e)}
            f["id"] = self.store.record(
                detector=f["detector"], engine=self.engine, ns=ns,
                breach=f["breach"],
                history=self.history.window(EVIDENCE_HISTORY_TAIL),
                evidence=evidence)
            log.warning(
                "watchdog: engine '%s' detector '%s' fired incident "
                "%s: %s", self.engine, f["detector"], f["id"],
                json.dumps(f["breach"], default=str))
        return fired

    def record_death(self, err: BaseException, ns: Optional[int] = None,
                     evidence: Optional[dict] = None) -> str:
        """Promote an engine-death flight dump to a first-class
        incident bundle (the store outlives the engine, so the bundle
        stays retrievable after the supervisor swaps in a fresh
        one)."""
        return self.store.record(
            detector=ENGINE_DEATH, engine=self.engine,
            kind="engine_death", ns=ns,
            breach={"error": str(err), "type": type(err).__name__},
            history=self.history.window(EVIDENCE_HISTORY_TAIL),
            evidence=evidence)

    def snapshot(self) -> dict:
        """The ``watchdog`` block of the generation snapshot — the
        ``client_tpu_watchdog_*`` /metrics source. Per-detector
        incident counts come from the shared store (monotone across
        restarts); episode state is this watchdog's own."""
        with self._lock:
            detectors = {
                name: {"fires": st["fires"], "active": st["active"],
                       "suppressed": st["suppressed"]}
                for name, st in self._state.items()}
            samples = self.samples
        return {
            "interval_s": self.history.interval_s,
            "samples": samples,
            "history": self.history.snapshot(),
            "detectors": detectors,
            "store": self.store.summary(),
        }


def merge_watchdog(snaps: list) -> Optional[dict]:
    """Fleet merge of per-replica watchdog blocks. The replicas share
    ONE store (attribution rides each bundle's ``engine`` name), so
    the store summary passes through from the first replica; samples
    sum, a detector is active/suppressed fleet-wide when it is on any
    replica, and fires sum across replicas (episodes are
    per-replica)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return None
    detectors: dict = {}
    for s in snaps:
        for name, st in (s.get("detectors") or {}).items():
            acc = detectors.setdefault(
                name, {"fires": 0, "active": False,
                       "suppressed": False})
            acc["fires"] += st.get("fires", 0)
            acc["active"] = acc["active"] or bool(st.get("active"))
            acc["suppressed"] = (acc["suppressed"]
                                 or bool(st.get("suppressed")))
    return {
        "interval_s": snaps[0].get("interval_s"),
        "samples": sum(s.get("samples", 0) for s in snaps),
        "replicas": len(snaps),
        "detectors": detectors,
        "store": snaps[0].get("store"),
    }
