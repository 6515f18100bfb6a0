"""Opt-in client retry policy, shared by the HTTP and gRPC clients: the
port's copy of ``client_tpu/client/retry.py``.

The server answers transient failure with *retryable* signals — 503 +
``Retry-After`` on admission sheds and supervised-engine restarts,
``UNAVAILABLE`` + ``retry-after`` trailing metadata over gRPC — and
this module is the client half: bounded attempts, exponential backoff
with **full jitter** (uniform in ``[0, backoff)``, so a fleet of clients
that all saw the same failure does not retry in step), and the server's
``Retry-After`` hint honored as a *floor* (retrying sooner than the
server asked would land on an engine still warming up).

Scope: **non-streaming calls only by default.** A unary infer is
idempotent from the client's perspective (the server either admitted
it or shed it before any tokens flowed); a half-consumed token stream
is not — replaying it mid-conversation would need application-level
dedup, so streaming calls surface their error to the caller.

Off by default: constructing a client without ``retry_policy`` keeps
fail-fast behavior. The perf analyzer surfaces the policy
(``--retries``) and counts retries separately from rejects, so the
client/server shed accounting stays split three ways: client-side
rejects, server-side sheds, and retries that eventually succeeded.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

# status values (stringly-typed: HTTP codes arrive as "503", gRPC as
# code names) the policy treats as retryable by default: overload
# sheds and engine restarts — NOT 500s (a deterministic model error
# would fail identically on every attempt) and NOT 504 (the deadline
# already spent the caller's budget).
DEFAULT_RETRYABLE = frozenset({"502", "503", "UNAVAILABLE",
                               "RESOURCE_EXHAUSTED"})


@dataclass
class RetryPolicy:
    """Retry knobs + thread-safe accounting.

    ``max_attempts`` counts the first try (3 = one call, two retries).
    ``seed`` (optional) makes the jitter deterministic for tests; by
    default each policy draws from its own ``Random()``."""

    max_attempts: int = 3
    backoff_s: float = 0.1
    backoff_mult: float = 2.0
    backoff_max_s: float = 5.0
    jitter: bool = True
    retryable_codes: frozenset = DEFAULT_RETRYABLE
    honor_retry_after: bool = True
    # connection-level transport faults (reset / refused / broken pipe
    # — no status code to match) are retryable by default: a server
    # restarting, or a chaos transport_reset, drops the connection
    # before any response bytes. Deadline-shaped timeouts are NOT
    # retried — the caller's budget is already spent.
    retry_connection_errors: bool = True
    seed: int | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    _rng: random.Random = field(default=None, repr=False, compare=False)
    retries: int = field(default=0, compare=False)       # sleeps taken
    giveups: int = field(default=0, compare=False)       # budget spent

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s <= 0 or self.backoff_max_s <= 0:
            raise ValueError("backoff_s/backoff_max_s must be > 0")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1")
        self.retryable_codes = frozenset(
            str(c) for c in self.retryable_codes)
        if self._rng is None:
            self._rng = random.Random(self.seed)

    def is_retryable(self, status) -> bool:
        return status is not None and str(status) in self.retryable_codes

    def is_retryable_error(self, exc: Exception,
                           connection_errors=None) -> bool:
        """Whole-exception retryability: a matching status code, or —
        when connection-error retries apply — a statusless connection-
        level transport fault (``ConnectionError`` covers reset /
        refused / broken pipe; ``http.client.RemoteDisconnected``
        subclasses it). ``connection_errors`` overrides the policy
        knob per call: a coded 503 shed is guaranteed pre-execution,
        but a dropped connection is NOT — the server may have fully
        executed the request — so callers replaying non-idempotent
        requests (sequence steps mutate per-correlation-id state)
        pass False here."""
        status = getattr(exc, "status", None)
        status = status() if callable(status) else status
        if self.is_retryable(status):
            if connection_errors is False \
                    and getattr(exc, "retry_after_s", None) is None:
                # replay-unsafe request: only a server-ADVERTISED shed
                # may be retried, and the server's shed paths all
                # attach a Retry-After hint (they are guaranteed
                # pre-execution). A retryable code WITHOUT a hint —
                # e.g. gRPC turning a dropped connection into a bare
                # UNAVAILABLE — may follow a completed execution.
                return False
            return True
        allow = (self.retry_connection_errors
                 if connection_errors is None else connection_errors)
        return allow and isinstance(exc, ConnectionError)

    def delay_s(self, attempt: int, retry_after_s=None) -> float:
        """Sleep before retry number ``attempt`` (0-based: the first
        retry). Full jitter over the exponential ceiling; the server's
        Retry-After is a floor when honored."""
        ceiling = min(self.backoff_max_s,
                      self.backoff_s * self.backoff_mult ** attempt)
        with self._lock:
            delay = (self._rng.uniform(0.0, ceiling) if self.jitter
                     else ceiling)
        if self.honor_retry_after and retry_after_s is not None:
            delay = max(delay, float(retry_after_s))
        return delay

    def note_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def note_giveup(self) -> None:
        with self._lock:
            self.giveups += 1

    def stats(self) -> dict:
        with self._lock:
            return {"retries": self.retries, "giveups": self.giveups}


def call_with_retry(policy, fn, sleep=time.sleep,
                    connection_errors=None):
    """Run ``fn()`` under ``policy``. Retries exceptions whose
    ``status()`` is in the retryable set — plus raw connection-level
    transport errors when allowed (the policy default; pass
    ``connection_errors=False`` for requests that are NOT safe to
    replay after a possible server-side execution, e.g. sequence
    steps) — honoring a ``retry_after_s`` attribute the transports
    stash on the exception (the parsed Retry-After header /
    trailing-metadata key). With ``policy`` None this is a plain
    call — zero overhead for the default fail-fast client."""
    if policy is None:
        return fn()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            if not policy.is_retryable_error(e, connection_errors):
                raise
            if attempt + 1 >= policy.max_attempts:
                policy.note_giveup()
                raise
            delay = policy.delay_s(
                attempt, getattr(e, "retry_after_s", None))
            policy.note_retry()
            sleep(delay)
            attempt += 1
