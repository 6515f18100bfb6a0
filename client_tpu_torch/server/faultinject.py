"""Deterministic fault injection — the chaos half of the fault-
tolerance plane. The port's own copy of
``client_tpu/server/faultinject.py``: its injector is a process-global
of its own, beside the reference's.

Recovery code that only runs when hardware actually misbehaves is
untested code: this module gives the serving stack *named injection
points* it consults on its hot paths, driven by a deterministic seeded
schedule, so the chaos tests (tests/test_torch_supervision.py) can prove
the supervisor / deadline / retry machinery end-to-end and CI can
replay the exact same failure sequence on every run.

Injection points (the call sites pass the point name plus context):

- ``engine_loop``      — raise inside the continuous-batching engine's
                         iteration loop (kills the engine thread; the
                         supervised-restart path).
- ``ring_fetch``       — raise at the D2H token-ring fetch (the
                         deferred-device-error surface).
- ``kernel_delay``     — sleep ``delay_s`` before a dispatch (a slow /
                         wedged kernel; drives deadline expiry).
- ``queue_full``       — force the engine's submit path to shed with
                         503 as if the pending queue were full.
- ``transport_reset``  — make a frontend drop the connection / abort
                         the RPC before answering (client-visible
                         transport fault; drives the retry policy).

Scheduling is deterministic: every ``check()`` of a point increments
that point's hit counter; a spec fires on hits strictly after ``after``
(so ``after=k`` fires on the k+1-th hit), at most ``times`` times
(0 = unlimited), gated by ``probability`` drawn from a ``Random(seed)``
stream — same seed, same hit sequence, same firings.

Arming surfaces:

- programmatic: ``get_injector().arm([...])`` (the chaos tests);
- environment: ``CLIENT_TPU_FAULTS`` holds a JSON list of spec dicts
  (plus ``CLIENT_TPU_FAULT_SEED``) consumed at first use — faults for
  a server process launched by a harness;
- wire: ``POST /v2/debug/faults`` on the HTTP frontend, gated by the
  same opt-in flag as every ``/v2/debug/*`` endpoint (404 when debug
  is off — production servers do not expose a crash button).

The disarmed fast path is one attribute read (``_armed``) — serving
hot paths pay nothing while no fault is armed.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
from dataclasses import asdict, dataclass, field

log = logging.getLogger(__name__)

POINTS = ("engine_loop", "ring_fetch", "kernel_delay", "queue_full",
          "transport_reset")

ENV_FAULTS = "CLIENT_TPU_FAULTS"
ENV_SEED = "CLIENT_TPU_FAULT_SEED"


class InjectedFault(RuntimeError):
    """Raised at an armed injection point (never in production: arming
    requires the debug endpoint, the env schedule, or test code)."""


@dataclass
class FaultSpec:
    """One armed fault. ``after``/``times`` give the deterministic
    window (hit counters are per point name); ``probability`` < 1
    makes firing stochastic but reproducible under the injector's
    seed; ``delay_s`` only applies to ``kernel_delay``. ``match``
    narrows the spec to call sites whose context carries every listed
    key at the listed value (e.g. ``{"engine": "fleet_lm/r2"}`` arms a
    kernel delay on ONE replica's engine only — the canary bench's
    injected-regression shim); a context key the call site does not
    pass never matches. Matching happens BEFORE the hit counter is
    consumed against ``after``: a per-engine spec counts only that
    engine's hits, so its window is deterministic regardless of how
    peer replicas interleave."""

    point: str
    after: int = 0
    times: int = 1
    probability: float = 1.0
    delay_s: float = 0.0
    message: str = ""
    match: dict = field(default_factory=dict)
    fired: int = field(default=0, compare=False)
    # matched-hit counter for match-narrowed specs (their after/times
    # window counts only THEIR call sites, not peer engines')
    seen: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r} (expected one of "
                f"{POINTS})")
        if self.after < 0 or self.times < 0:
            raise ValueError("after/times must be >= 0")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        if self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")
        if not isinstance(self.match, dict) or any(
                not isinstance(k, str) for k in self.match):
            raise ValueError(
                "match must be a dict of context-key -> value")

    def matches(self, context: dict) -> bool:
        return all(context.get(k) == v for k, v in self.match.items())


class FaultInjector:
    """Named-point fault scheduler. Thread-safe: any serving thread may
    ``check()``; arming replaces the whole schedule atomically and
    resets hit counters + the RNG so a re-armed schedule replays
    identically."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        self._hits: dict[str, int] = {}
        self._rng = random.Random(seed)
        self._seed = seed
        # fast-path flag, read without the lock (bool reads are atomic):
        # serving paths skip the lock entirely while nothing is armed
        self._armed = False

    def arm(self, specs, seed=None) -> None:
        """Install a schedule (replacing any current one). ``specs``
        are FaultSpec objects or dicts of their fields."""
        parsed = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                  for s in specs]
        with self._lock:
            if seed is not None:
                self._seed = int(seed)
            self._specs = parsed
            self._hits = {}
            self._rng = random.Random(self._seed)
            self._armed = bool(parsed)
        if parsed:
            log.warning(
                "fault injection ARMED: %d spec(s) %s (seed %d) — this "
                "process will deliberately fail at the scheduled points",
                len(parsed), [s.point for s in parsed], self._seed)

    def clear(self) -> None:
        self.arm(())

    def check(self, point: str, **context):
        """Consult one injection point. Returns the matched FaultSpec
        (after serving any ``kernel_delay`` sleep) or None. Call sites
        decide the failure shape — raise, shed, reset — so each point
        fails the way that layer really fails."""
        if not self._armed:
            return None
        with self._lock:
            hits = self._hits.get(point, 0) + 1
            self._hits[point] = hits
            spec = None
            for s in self._specs:
                if s.point != point:
                    continue
                if s.match:
                    if not s.matches(context):
                        continue
                    # window on the spec's OWN matched-hit count: peer
                    # call sites (other replicas) must not consume a
                    # per-engine spec's deterministic after window
                    s.seen += 1
                    if s.seen <= s.after:
                        continue
                elif hits <= s.after:
                    continue
                if s.times and s.fired >= s.times:
                    continue
                if s.probability < 1.0 \
                        and self._rng.random() >= s.probability:
                    continue
                s.fired += 1
                spec = s
                break
        if spec is None:
            return None
        log.warning("fault injection firing at point '%s' (hit %d%s)",
                    point, hits,
                    f", context {context}" if context else "")
        if point == "kernel_delay" and spec.delay_s > 0:
            import time

            time.sleep(spec.delay_s)
        return spec

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "armed": self._armed,
                "seed": self._seed,
                "hits": dict(self._hits),
                "specs": [asdict(s) for s in self._specs],
            }


# process-global injector: serving code consults ONE schedule so a
# harness can arm faults without threading an object through every
# constructor. Lazily env-armed on first access.
_INJECTOR: FaultInjector | None = None
_INJECTOR_LOCK = threading.Lock()


def get_injector() -> FaultInjector:
    global _INJECTOR
    inj = _INJECTOR
    if inj is not None:
        return inj
    with _INJECTOR_LOCK:
        if _INJECTOR is None:
            inj = FaultInjector(seed=int(os.environ.get(ENV_SEED, "0")))
            env = os.environ.get(ENV_FAULTS, "")
            if env:
                try:
                    inj.arm(json.loads(env))
                except (ValueError, TypeError) as e:
                    # a typo'd schedule must be loud, not silently inert
                    log.error("ignoring malformed %s: %s", ENV_FAULTS, e)
            _INJECTOR = inj
        return _INJECTOR


def fire(point: str, **context):
    """Module-level fast path for serving code: after the first call
    materializes the injector (consuming any env schedule once), a
    disarmed check is one attribute read — no lock, no allocation, no
    environment lookup."""
    inj = _INJECTOR
    if inj is None:
        inj = get_injector()
    if not inj._armed:
        return None
    return inj.check(point, **context)


def fire_or_raise(point: str, **context) -> None:
    """fire() + raise InjectedFault — the shape the raising points
    (the engine loop and the D2H ring fetch) use, kept here so the
    failure shape cannot drift between call sites."""
    spec = fire(point, **context)
    if spec is not None:
        raise InjectedFault(
            spec.message or f"injected fault at '{point}'")
