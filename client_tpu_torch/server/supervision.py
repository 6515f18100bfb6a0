"""Engine supervision: auto-restart a crashed continuous-batching
engine with exponential backoff and a crash-loop breaker. The port's
own copy of ``client_tpu/server/supervision.py``.

Before this module an engine-thread death was terminal: ``_fail_all``
answered every in-flight stream, readiness flipped, and the model
stayed dead until an operator reloaded it. Under "heavy traffic from
millions of users" that converts one transient device fault into an
outage. The supervisor makes engine death a *bounded* event:

1. the dying engine dumps its flight recorder and fails every
   in-flight/queued stream with a retryable 503 carrying a
   ``Retry-After`` hint equal to the supervisor's next backoff
   (clients running the opt-in ``RetryPolicy`` resubmit after it);
2. the supervisor sleeps the backoff, then rebuilds the engine from
   scratch through the same factory the model's unload/reload path
   uses — fresh device state (slots, KV pool, draft KV, token ring),
   a fresh radix index and a fresh ``CompileWatch`` (so the restart's
   warmup captures are sealed again instead of false-flagging as
   serving-phase violations; the dead engine freed its CUDA graphs and
   their memory pool with its device state), built on the new engine's
   own thread (``torch.cuda.set_device`` and inference mode are
   thread-local, so the factory builds no device state on the
   supervisor's thread) — and swaps it in once ``start()`` has the
   engine thread building;
3. backoff grows exponentially with the number of failures inside a
   sliding window; ``max_failures`` failures within ``window_s``
   trips the crash-loop breaker — the supervisor gives up, readiness
   stays false, and the ``client_tpu_engine_crash_looped`` gauge
   flips so the alert fires on "needs a human", not "restarting".

An engine sharded over a mesh (one process per card) is supervised on
every rank: the driver's supervisor decides, and after the dead
engine's ``FAIL`` plan it sends its verdict on the same channel
(``parallel/spmd.py``). Each follower's supervisor (:meth:`follow`)
then builds the same fresh engine from the same factory, in the same
order as the driver (``dist.new_group`` is collective over the default
group), and follows it; a tripped breaker ends the followers with
``STOP``.

Readiness during the whole sequence is honest: the model's
``engine_healthy()`` probe reads the supervisor's *current* engine, so
``/v2/health/ready`` is false from the crash until the restarted
engine is live (and forever once crash-looped).

The supervisor owns no device state itself — everything device-side is
rebuilt by the factory, which is exactly what makes the restart safe:
there is nothing to "repair", only to replace.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

from client_tpu_torch.parallel import spmd
from client_tpu_torch.server.types import now_ns

log = logging.getLogger(__name__)


@dataclass
class RestartPolicy:
    """Backoff + crash-loop-breaker knobs. ``backoff_base_s`` doubles
    (``backoff_mult``) per failure inside the window up to
    ``backoff_max_s``; ``max_failures`` failures within ``window_s``
    seconds trip the breaker."""

    backoff_base_s: float = 0.5
    backoff_mult: float = 2.0
    backoff_max_s: float = 30.0
    max_failures: int = 5
    window_s: float = 300.0

    def __post_init__(self):
        if self.backoff_base_s <= 0 or self.backoff_max_s <= 0:
            raise ValueError("backoff_base_s/backoff_max_s must be > 0")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1")
        if self.max_failures < 1:
            raise ValueError("max_failures must be >= 1")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")

    def backoff_for(self, failures_in_window: int) -> float:
        """Backoff before restart attempt number ``failures_in_window``
        (1-based: the first failure waits backoff_base_s)."""
        n = max(0, failures_in_window - 1)
        return min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_mult ** n)


class EngineSupervisor:
    """Owns the live engine reference for one generation model and
    rebuilds it when its thread dies.

    ``factory`` is a zero-arg callable returning a fresh, unstarted
    ``ContinuousBatchingEngine`` (the same one the model's unload path
    uses). The supervisor attaches itself to every engine it creates;
    the engine calls :meth:`notify_failure` from ``_fail_all`` when it
    dies on an unexpected error, and :meth:`retry_after_hint` while
    composing the retryable 503 it answers in-flight streams with.

    ``collective``: the factory's engines are built by every rank of a
    mesh together, so a rebuild the driver abandons (a shutdown during
    the backoff) is still built and stopped, which releases the
    followers building it beside the driver.
    """

    def __init__(self, factory, policy: RestartPolicy | None = None,
                 name: str = "generation-engine", collective: bool = False):
        self._factory = factory
        self._collective = collective
        self.policy = policy or RestartPolicy()
        self.name = name
        self._lock = threading.Lock()
        self._failure_times: deque = deque()
        self._stopped = False
        self._restarting = False
        # bumped by replace_clean(): a restart scheduled against an
        # engine the operator has since replaced must abandon instead
        # of swapping a second engine in over the staged one
        self._epoch = 0
        self.restarts = 0               # successful rebuilds
        self.crash_looped = False
        self.last_error: str | None = None
        self.last_restart_ns = 0
        self.engine = self._attach(factory())

    def _attach(self, engine):
        engine.supervisor = self
        return engine

    # -- state the engine / observability planes read --

    def healthy(self) -> bool:
        """The readiness signal: current engine alive AND not crash-
        looped (a breaker trip keeps readiness false even though the
        dead engine object never changes again)."""
        return not self.crash_looped and self.engine.healthy()

    def _prune_failures(self) -> int:
        """Drop failure timestamps that aged out of the sliding window
        and return the live count. Caller holds the lock. Every reader
        prunes (not just notify_failure): a crash after a long healthy
        stretch must not advertise a Retry-After inflated by failures
        the window forgot long ago."""
        cutoff = time.monotonic() - self.policy.window_s
        while self._failure_times and self._failure_times[0] < cutoff:
            self._failure_times.popleft()
        return len(self._failure_times)

    def retry_after_hint(self) -> float:
        """The backoff the NEXT restart will wait — what a failing
        engine should advertise as Retry-After to its in-flight
        streams (callers retrying sooner would land on a dead or
        still-warming engine)."""
        with self._lock:
            n = self._prune_failures() + (0 if self._restarting else 1)
        return self.policy.backoff_for(max(1, n))

    def would_restart(self) -> bool:
        """Whether the NEXT failure would schedule a restart — the
        dying engine asks this while composing its terminal error, so
        the crash that will trip the breaker does not promise callers
        a restart that never comes. Advisory (the real decision is
        notify_failure's, under the same lock, moments later)."""
        with self._lock:
            if self._stopped or self.crash_looped:
                return False
            return self._prune_failures() + 1 < self.policy.max_failures

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "restarts": self.restarts,
                "crash_looped": self.crash_looped,
                "restarting": self._restarting,
                "failures_in_window": self._prune_failures(),
                "max_failures": self.policy.max_failures,
                "window_s": self.policy.window_s,
                "backoff_base_s": self.policy.backoff_base_s,
                "backoff_max_s": self.policy.backoff_max_s,
                "last_error": self.last_error,
                "last_restart_ns": self.last_restart_ns,
            }

    # -- failure path --

    def notify_failure(self, engine, err: BaseException) -> bool:
        """Called by the dying engine thread (after it failed its
        waiters and dumped the flight recorder). Schedules a restart
        unless stopped, already restarting, or crash-looped; returns
        whether it did (a mesh driver's verdict to its followers)."""
        with self._lock:
            if self._stopped or self.crash_looped \
                    or engine is not self.engine or self._restarting:
                return False
            self._failure_times.append(time.monotonic())
            self.last_error = str(err)
            failures = self._prune_failures()
            if failures >= self.policy.max_failures:
                self.crash_looped = True
                log.error(
                    "engine '%s' crash loop: %d failures within %.0fs — "
                    "supervisor giving up; model stays not-ready until "
                    "an operator reloads it (last error: %s)",
                    self.name, failures, self.policy.window_s, err)
                return False
            backoff = self.policy.backoff_for(failures)
            self._restarting = True
            epoch = self._epoch
        log.error(
            "engine '%s' died (%s); supervised restart %d/%d in %.3fs",
            self.name, err, failures, self.policy.max_failures, backoff)
        threading.Thread(
            target=self._restart, args=(backoff, epoch), daemon=True,
            name=f"engine-supervisor-{self.name}").start()
        return True

    def _stale(self, epoch: int) -> bool:
        """Caller holds the lock. A restart is stale once the server
        stopped, the breaker tripped, or an operator reload replaced
        the engine out from under it (epoch bump) — swapping anyway
        would abandon the staged engine with its thread and device
        state still live."""
        return self._stopped or self.crash_looped or epoch != self._epoch

    def _restart(self, backoff_s: float, epoch: int) -> None:
        time.sleep(backoff_s)
        with self._lock:
            stale = self._stale(epoch)
            if stale:
                self._restarting = False
        if stale:
            if self._collective:
                # the followers build this engine with the driver: build
                # it, and its stop releases them
                self._factory().stop()
            return
        try:
            # the factory builds a fresh engine whose device state
            # (slots / KV pool / draft KV / token ring / radix index) is
            # built on its own thread: start() puts that thread into
            # _ensure_ready immediately, so the build overlaps the swap.
            # A card whose context a sticky CUDA error poisoned fails
            # there, on the engine thread, and that death comes back
            # through notify_failure toward the breaker
            engine = self._factory()
            engine.start()
        except BaseException as e:  # noqa: BLE001 — deliberate broad
            # catch (the failure-path lint allowlists _restart): ANY
            # rebuild failure — even a BaseException — is one more
            # engine failure and must route through the crash-loop
            # breaker; letting it kill this supervisor thread silently
            # would leave the model dead with no restart scheduled and
            # no breaker trip to alert on
            with self._lock:
                self._restarting = False
                stale = self._stale(epoch)
            log.error("engine '%s' rebuild failed: %s", self.name, e,
                      exc_info=e if isinstance(e, Exception) else None)
            if not stale:
                # gone-stale rebuilds (an operator reload staged a
                # healthy engine while the factory ran) must NOT count
                # a failure against the operator's reset window or
                # schedule a restart over the staged engine
                self.notify_failure(self.engine, e)
            if not isinstance(e, Exception):
                raise
            return
        with self._lock:
            if self._stale(epoch):
                self._restarting = False
            else:
                self.restarts += 1
                self.last_restart_ns = now_ns()
                self._restarting = False
                self.engine = self._attach(engine)
                log.warning(
                    "engine '%s' restarted (restart #%d); readiness "
                    "restored once warmup completes", self.name,
                    self.restarts)
                return
        # raced a shutdown or an operator reload: the just-built
        # engine must not leak its thread/device state
        engine.stop()

    # -- a follower rank of a mesh --

    def follow(self) -> None:
        """A follower rank's loop under a mesh: follow the current
        engine's plans until the driver stops it; when the driver's
        engine dies (its ``FAIL`` plan), read the driver's verdict and
        either build the same fresh engine from the factory and follow
        it, or, when the driver's breaker tripped, return crash-looped.
        An unsupervised follower raises ``SpmdError`` instead
        (``ContinuousBatchingEngine.start``)."""
        while True:
            engine = self.engine
            try:
                engine._follow()
                return
            except spmd.SpmdError as e:
                self.last_error = str(e)
                if not spmd.await_verdict(engine._chan):
                    with self._lock:
                        self.crash_looped = True
                    return
            # the driver's supervisor builds its engine now: the same
            # factory, the same order of process groups
            fresh = self._attach(self._factory())
            with self._lock:
                self.restarts += 1
                self.last_restart_ns = now_ns()
                self.engine = fresh

    # -- lifecycle (the model's unload/reload path) --

    def replace_clean(self) -> None:
        """Operator-initiated swap (model unload/reload): stop the
        current engine, stage a fresh one, and reset the failure
        window + breaker — an explicit reload is a human saying
        'try again'. Bumping the epoch abandons any restart still
        sleeping its backoff (it would otherwise wake later and swap
        a SECOND engine in over the staged one)."""
        with self._lock:
            old = self.engine
            self._epoch += 1
            self._failure_times.clear()
            self.crash_looped = False
        old.stop()
        raced = None
        with self._lock:
            # old.stop() joins a possibly-dying engine thread whose
            # final act is notify_failure: that failure landed AFTER
            # the reset above and captured the bumped epoch, so bump +
            # clear AGAIN here — the operator's reset wins and any
            # restart scheduled in the window abandons as stale. If
            # such a restart already swapped its engine in (tiny
            # backoff), stop that one too instead of leaking it.
            self._epoch += 1
            self._failure_times.clear()
            self.crash_looped = False
            if self.engine is not old:
                raced = self.engine
            if not self._stopped:
                self.engine = self._attach(self._factory())
        if raced is not None:
            raced.stop()

    def shutdown(self) -> None:
        """Terminal stop (server shutdown): no further restarts."""
        with self._lock:
            self._stopped = True
        self.engine.stop()
