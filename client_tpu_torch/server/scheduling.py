"""Closed-loop SLO scheduling of the continuous-batching engine: the
port's own copy of ``client_tpu/server/scheduling.py``. Pure host code;
every knob it steers is host state the engine reads once per round.

- :class:`FairQueue`: the engine's pending queue. Start-time fair queuing
  across ``(tenant, slo_class)`` flows: each arrival is tagged
  ``max(vclock, flow.last_tag) + 1/weight`` and the smallest head tag pops
  first, so a class of weight w gets a w-proportional share of admissions
  under backlog; within a flow order stays FIFO. With ``fair=False`` (no
  scheduler) every request lands in one flow and the queue is exactly the
  FIFO it replaces. ``push_front`` keeps a parked request (a paged
  reservation that failed) at its flow's head; ``requeue`` puts a
  preempted one behind its flow's siblings; ``shed_lowest`` is the
  weight-aware shed door.
- Slot preemption (policy here, mechanics in ``server/generation.py``):
  when no slot is free and the fair-order head's class burns its error
  budget at or above the threshold, the lowest-weight running stream of a
  strictly lower weight is preempted: its K/V is committed to the prefix
  cache, its slot released, and it re-queues with its generated tokens
  folded into its prompt, so its resume matches the committed chain and
  re-ingests only the tail. ``max_preemptions`` bounds it per stream.
- :class:`EngineController`: a hysteresis controller sampled once per
  dispatch round. When the max windowed burn of the declared classes
  reaches ``burn_high`` it trades throughput for latency (the lane budget
  to its floor, fetch stride 1, duty 1.0, speculation off); after
  ``hold_rounds`` samples below ``burn_low`` it restores the knobs.

FairQueue and SchedStats are locked; EngineController runs on the engine
thread only.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from typing import Optional

from client_tpu_torch.server.config import SchedulerConfig

# sentinel the engine's stop() path uses to wake a blocked idle get
# (FairQueue.close() arms it; get() then returns None exactly like the
# queue.Queue None-sentinel convention it replaces)
_CLOSED = object()


def resolve_scheduler(scheduler, prefix_cache: bool,
                      prefix_commit_policy: str
                      ) -> Optional[SchedulerConfig]:
    """Validate and normalize the scheduler knob — the ONE place the
    rules live, shared between the engine and config introspection
    (decoder_lm) so the model config JSON can never advertise a
    scheduler the engine does not run. Accepts a
    :class:`~client_tpu_torch.server.config.SchedulerConfig`, its dict form
    (the model-config JSON block), ``True`` (enabled defaults) or
    None/disabled (returns None — the engine keeps the exact pre-
    scheduler FIFO behavior). Nonsensical combinations are loud
    errors, never silent fallbacks:

    - every declared class weight must be > 0 (a zero/negative weight
      is an infinite/negative virtual-time step — meaningless);
    - ``preemption`` requires the prefix cache with a writable commit
      policy: the preempt-resume path IS the prefix-restore path, so
      without cross-request prefix matching (``prefix_cache``) or
      with ``prefix_commit_policy="none"`` a preempted stream would
      re-prefill its whole context from token 0 — a silent
      throughput cliff the operator must opt into understanding
      (disable preemption or enable the commit path);
    - the controller's hysteresis band must be ordered
      (``burn_low < burn_high``) and ``hold_rounds``/
      ``max_preemptions``/``park_bypass_limit`` must be >= 1.

    Weight keys need not name declared objective classes: undeclared
    classes are legal wire values (they take ``default_weight``), and
    a weight may be declared for a class that only ever arrives off
    the wire.
    """
    cfg = scheduler
    if cfg is None or cfg is False:
        return None
    if cfg is True:
        cfg = SchedulerConfig(enabled=True)
    if isinstance(cfg, dict):
        from client_tpu_torch.server.config import config_from_dict

        cfg = config_from_dict(SchedulerConfig, cfg,
                               defaults={"enabled": True})
    if not isinstance(cfg, SchedulerConfig):
        raise ValueError(
            f"scheduler must be a SchedulerConfig, its dict form, True "
            f"or None — got {type(cfg).__name__}")
    if not cfg.enabled:
        return None
    for name, w in dict(cfg.class_weights).items():
        if not (isinstance(w, (int, float)) and w > 0):
            raise ValueError(
                f"scheduler class weight for {name!r} must be > 0, got "
                f"{w!r} (a non-positive weight has no virtual-time "
                f"meaning — use shed/deadline policy to exclude a "
                f"class, not weight 0)")
    if not cfg.default_weight > 0:
        raise ValueError(
            f"scheduler default_weight must be > 0, got "
            f"{cfg.default_weight!r}")
    if cfg.preemption:
        if not prefix_cache or prefix_commit_policy == "none":
            raise ValueError(
                "scheduler preemption requires the prefix cache with a "
                "writable commit policy (prefix_cache=True and "
                "prefix_commit_policy != 'none'): a preempted stream "
                "resumes through the prefix-restore + chunked-prefill "
                "path, and without the KV commit it would re-prefill "
                "its whole context from token 0 — enable the commit "
                "path or disable preemption, never silently degrade")
        if cfg.max_preemptions < 1:
            raise ValueError(
                f"scheduler max_preemptions must be >= 1 when "
                f"preemption is enabled, got {cfg.max_preemptions}")
        if cfg.preempt_burn_threshold < 0:
            raise ValueError(
                f"scheduler preempt_burn_threshold must be >= 0, got "
                f"{cfg.preempt_burn_threshold} (0 preempts on weight "
                f"alone)")
    if cfg.controller:
        if not 0 <= cfg.burn_low < cfg.burn_high:
            raise ValueError(
                f"scheduler controller hysteresis band must satisfy "
                f"0 <= burn_low < burn_high, got burn_low="
                f"{cfg.burn_low} burn_high={cfg.burn_high}")
        if cfg.controller_hold_rounds < 1:
            raise ValueError(
                f"scheduler controller_hold_rounds must be >= 1, got "
                f"{cfg.controller_hold_rounds}")
        if cfg.min_prefill_token_budget < 0:
            raise ValueError(
                f"scheduler min_prefill_token_budget must be >= 0 "
                f"(0 = one prefill chunk), got "
                f"{cfg.min_prefill_token_budget}")
    if cfg.park_bypass_limit < 1:
        raise ValueError(
            f"scheduler park_bypass_limit must be >= 1, got "
            f"{cfg.park_bypass_limit}")
    return cfg


class _Flow:
    """One (tenant, slo_class) backlog: strictly FIFO internally."""

    __slots__ = ("key", "items", "last_tag")

    def __init__(self, key):
        self.key = key
        self.items: deque = deque()   # (tag, seq, req)
        self.last_tag = 0.0           # finish tag of the newest arrival


class FairQueue:
    """Bounded multi-flow fair queue — the engine's pending queue.

    Start-time-fair-queuing order across flows: each arrival is tagged
    ``max(vclock, flow.last_tag) + cost/weight`` (cost 1 per request);
    ``get`` pops the globally smallest ``(tag, seq)`` head, advancing
    the virtual clock to that tag. Within one flow order is strictly
    FIFO (tags are monotone per flow by construction). With
    ``fair=False`` every request maps to a single flow, making the
    whole queue ONE FIFO — the exact semantics of the ``queue.Queue``
    this class replaces (the default-config bit-compatibility
    contract, pinned by tests).

    ``push_front`` re-inserts a request at its flow's head with a tag
    no later than the current head's — the paged-mode *parking*
    primitive (a failed block reservation keeps its place in line) and
    the requeue point for consumer-settled requests. Parked entries
    are counted so the engine's idle path knows not to block forever
    on a queue whose only content cannot be admitted yet.

    ``maxsize`` bounds the total backlog exactly like ``queue.Queue``:
    ``put`` blocks (or raises :class:`queue.Full` via
    ``put_nowait``). ``close()`` arms the stop sentinel: any blocked
    or future ``get`` returns None immediately (the engine's loop-top
    ``_stopping`` check owns the actual shutdown; queued requests are
    drained by ``_fail_all`` through ``get_nowait``). Re-queued
    (parked / preempted) entries do not count against ``maxsize`` —
    they were admitted once and must never dead-lock against new
    arrivals.
    """

    def __init__(self, maxsize: int = 0, weight_fn=None,
                 fair: bool = False):
        self._maxsize = int(maxsize)
        self._weight_fn = weight_fn or (lambda key: 1.0)
        self._fair = bool(fair)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._flows: dict = {}       # key -> _Flow
        self._vclock = 0.0
        self._seq = 0                # global arrival order (tie-break)
        self._size = 0               # counted against maxsize
        self._requeued = 0           # parked/preempted re-inserts
        self._parked = 0             # entries waiting on a reservation
        self._closed = False

    def _flow(self, key) -> _Flow:
        # flow count is BOUNDED: the engine keys flows on the
        # (tenant, slo_class) labels ALREADY resolved through the
        # SloStats cardinality caps (slo_max_tenants / max_classes,
        # wire floods collapse into __other__), so the per-flow scan
        # in _min_flow is over at most caps-many flows, never
        # wire-controlled. Drained flows deliberately keep their
        # _Flow (and its last_tag): forgetting a flow's virtual-time
        # position on idle would let a bursty flow reset its debt.
        if not self._fair:
            key = ()
        flow = self._flows.get(key)
        if flow is None:
            flow = self._flows[key] = _Flow(key)
        return flow

    def _tag_for(self, flow: _Flow) -> float:
        w = float(self._weight_fn(flow.key)) if self._fair else 1.0
        tag = max(self._vclock, flow.last_tag) + 1.0 / max(w, 1e-9)
        flow.last_tag = tag
        return tag

    # ---- producer side ----

    def put(self, req, key=(), block: bool = True) -> None:
        """Enqueue as a fresh arrival of flow ``key``. Blocks while the
        backlog holds ``maxsize`` counted entries (``block=False``
        raises queue.Full instead, the shed path)."""
        with self._lock:
            while self._maxsize > 0 and self._size >= self._maxsize:
                if not block:
                    raise queue_mod.Full
                self._not_full.wait()
            flow = self._flow(key)
            self._seq += 1
            flow.items.append((self._tag_for(flow), self._seq, req,
                               True))
            self._size += 1
            self._not_empty.notify()

    def put_nowait(self, req, key=()) -> None:
        self.put(req, key, block=False)

    def push_front(self, req, key=(), parked: bool = False,
                   counted: bool = False) -> None:
        """Re-insert at the HEAD of flow ``key`` (parking / preempt
        requeue-at-resolved-order): the entry keeps its place in line
        with a tag no later than the flow's current head (or the
        virtual clock if the flow drained). ``counted`` restores a
        FRESH entry's standing against ``maxsize`` (the disagg
        admission pass pops fresh arrivals it may have to defer — a
        deferred backlog must keep counting toward the bound and stay
        sheddable, or sustained overload grows the queue without
        limit); parked/preempted re-inserts keep the uncounted
        default (admitted once, must never dead-lock against new
        arrivals). ``parked`` marks the queue as holding work that is
        waiting on pool blocks rather than a slot."""
        with self._lock:
            flow = self._flow(key)
            if flow.items:
                tag = min(flow.items[0][0], self._vclock)
                seq = flow.items[0][1] - 1
            else:
                tag, seq = self._vclock, self._seq
            flow.items.appendleft((tag, seq, req, counted))
            if counted:
                self._size += 1
            else:
                self._requeued += 1
            if parked:
                self._parked += 1
            self._not_empty.notify()

    def requeue(self, req, key=()) -> None:
        """Re-enqueue a PREEMPTED request as a fresh arrival of its
        flow: a new finish tag puts it behind its class's queued
        siblings (it already received service), so the fair order the
        preemption was executed FOR — the burning class's head —
        cannot be jumped by its own victim. Does not count against
        ``maxsize`` (the request was admitted once; blocking the
        engine thread on its own requeue would deadlock)."""
        with self._lock:
            flow = self._flow(key)
            self._seq += 1
            flow.items.append((self._tag_for(flow), self._seq, req,
                               False))
            self._requeued += 1
            self._not_empty.notify()

    # ---- consumer side (engine thread) ----

    def _min_flow(self):
        """(flow, head entry) with the globally smallest (tag, seq),
        or None when every flow is empty (caller holds the lock)."""
        best = None
        for flow in self._flows.values():
            if not flow.items:
                continue
            head = flow.items[0]
            if best is None or head[:2] < best[1][:2]:
                best = (flow, head)
        return best

    def _pop_min(self):
        best = self._min_flow()
        if best is None:
            return _CLOSED  # caller translates
        flow, (tag, _seq, req, counted) = best
        flow.items.popleft()
        self._vclock = max(self._vclock, tag)
        if counted:
            self._size -= 1
            self._not_full.notify()
        else:
            self._requeued -= 1
        return req

    def get(self, block: bool = True, timeout: Optional[float] = None):
        """Next request in fair order; None once :meth:`close` armed
        the stop sentinel; raises queue.Empty when ``block=False`` and
        the backlog is empty, or when ``timeout`` seconds pass with
        nothing queued."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed:
                    return None
                item = self._pop_min()
                if item is not _CLOSED:
                    return item
                if not block:
                    raise queue_mod.Empty
                if deadline is None:
                    self._not_empty.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    raise queue_mod.Empty
                self._not_empty.wait(left)

    def get_nowait(self):
        """Non-blocking pop (fair order), ignoring the close sentinel —
        the ``_fail_all`` drain path must empty the backlog even after
        close(). Raises queue.Empty when nothing is queued."""
        with self._lock:
            item = self._pop_min()
            if item is _CLOSED:
                raise queue_mod.Empty
            return item

    def get_entry_nowait(self):
        """Non-blocking pop returning ``(req, counted)`` — the disagg
        admission pass needs each candidate's standing against
        ``maxsize`` so a deferred re-insert (:meth:`push_front`
        ``counted=``) can restore it exactly. Raises queue.Empty when
        nothing is queued."""
        with self._lock:
            best = self._min_flow()
            if best is None:
                raise queue_mod.Empty
            flow, (tag, _seq, req, counted) = best
            flow.items.popleft()
            self._vclock = max(self._vclock, tag)
            if counted:
                self._size -= 1
                self._not_full.notify()
            else:
                self._requeued -= 1
            return req, counted

    def shed_lowest(self, key):
        """Weight-aware shed door (the engine's ``shed_on_full`` on a
        scheduled queue): pop and return the NEWEST fresh arrival of
        the strictly-lowest-weight flow whose weight is below ``key``'s
        — the entry overload theory says to sacrifice so the arriving
        higher-weight request can take its queue space. Parked and
        requeued (preempted) entries are never sheddable: they were
        admitted once and hold reservations / generated state. Returns
        None when no strictly-lower-weight fresh entry exists (the
        caller sheds the arrival — which is also the exact FIFO-door
        behavior on ``fair=False`` queues, where this always returns
        None)."""
        if not self._fair:
            return None
        with self._lock:
            w_new = float(self._weight_fn(key))
            victim = None       # (weight, entry seq, flow, index)
            for flow in self._flows.values():
                # counted (fresh) entries only — and never a PARKED
                # one (a deferred-counted park holds the queue's
                # parked marker; shedding it would leak the marker
                # and spin the engine's idle path forever)
                idx = next(
                    (j for j in range(len(flow.items) - 1, -1, -1)
                     if flow.items[j][3]
                     and not getattr(flow.items[j][2], "parked",
                                     False)), None)
                if idx is None:
                    continue
                w = float(self._weight_fn(flow.key))
                # strictly lowest weight; newest arrival (highest seq)
                # breaks ties between equal-weight flows
                cand = (w, -flow.items[idx][1], flow, idx)
                if victim is None or cand[:2] < victim[:2]:
                    victim = cand
            if victim is None or victim[0] >= w_new:
                return None
            _w, _negseq, flow, idx = victim
            req = flow.items[idx][2]
            del flow.items[idx]
            self._size -= 1
            self._not_full.notify()
            return req

    def peek_key(self):
        """Flow key of the fair-order head (the request the next
        :meth:`get` would pop), or None when the queue is empty — the
        engine's preemption trigger reads the head's (tenant,
        slo_class) without consuming it."""
        with self._lock:
            best = self._min_flow()
            return None if best is None else best[0].key

    def unpark(self) -> None:
        """A previously parked entry was admitted (its reservation
        finally covered): drop the parked marker."""
        with self._lock:
            if self._parked > 0:
                self._parked -= 1

    def close(self) -> None:
        """Arm the stop sentinel: every blocked/future :meth:`get`
        returns None (the engine's stop wake-up)."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    # ---- observability ----

    def qsize(self) -> int:
        with self._lock:
            return self._size + self._requeued

    @property
    def parked(self) -> int:
        return self._parked

    def depths(self) -> dict:
        """{(tenant, slo_class): queued requests}, for the engine's
        scheduler snapshot (the no-fairness single flow reports under
        the key ``()``)."""
        with self._lock:
            return {flow.key: len(flow.items)
                    for flow in self._flows.values() if flow.items}


class SchedStats:
    """Per-(tenant, slo_class) scheduler attribution — preemptions
    executed and preempted streams resumed — for the engine's scheduler
    snapshot. Keys arrive already resolved through the SloStats
    cardinality cap (the engine stamps resolved labels on every
    request). Engine thread writes; scrape threads read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._preemptions: dict = {}
        self._resumes: dict = {}
        self.preemptions_total = 0
        self.resumes_total = 0

    def record_preemption(self, tenant: str, slo_class: str) -> None:
        with self._lock:
            key = (tenant, slo_class)
            self._preemptions[key] = self._preemptions.get(key, 0) + 1
            self.preemptions_total += 1

    def record_resume(self, tenant: str, slo_class: str) -> None:
        with self._lock:
            key = (tenant, slo_class)
            self._resumes[key] = self._resumes.get(key, 0) + 1
            self.resumes_total += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "preemptions_total": self.preemptions_total,
                "resumes_total": self.resumes_total,
                "preemptions": {f"{t}/{c}": n for (t, c), n
                                in sorted(self._preemptions.items())},
                "resumes": {f"{t}/{c}": n for (t, c), n
                            in sorted(self._resumes.items())},
            }


class EngineController:
    """Hysteresis burn controller over the engine's dynamic knobs.

    :meth:`step` is called once per dispatch round from the engine
    thread with the live burn signal. Two modes:

    - **throughput** (baseline): the knobs the operator configured.
    - **latency**: entered when burn >= ``burn_high`` — prefill lane
      budget shrunk to its floor, ring fetch stride 1, dispatch duty
      1.0, speculation disabled for subsequent rounds. Exited (knobs
      restored) only after burn < ``burn_low`` for ``hold_rounds``
      consecutive samples, so a single clean window cannot flap the
      knobs while the backlog that caused the spike is still
      draining.

    The controller only calls the engine's live setters
    (``set_prefill_token_budget`` / ``set_fetch_stride`` /
    ``set_dispatch_duty`` / ``set_speculation_enabled``) — all pure
    host state read per round; no device state changes shape.
    """

    __slots__ = ("burn_high", "burn_low", "hold_rounds",
                 "min_prefill_budget", "latency_mode", "_clear_streak",
                 "_baseline", "_latency_values", "flips")

    def __init__(self, burn_high: float, burn_low: float,
                 hold_rounds: int, min_prefill_budget: int = 0):
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.hold_rounds = int(hold_rounds)
        self.min_prefill_budget = int(min_prefill_budget)
        self.latency_mode = False
        self._clear_streak = 0
        self._baseline: Optional[dict] = None
        # the values this controller itself set on entering latency
        # mode — exit restores a knob only while it still holds them
        self._latency_values: dict = {}
        self.flips = 0  # mode transitions (debug/flight recorder)

    def step(self, engine, burn: float) -> None:
        if not self.latency_mode:
            if burn >= self.burn_high:
                self._enter_latency(engine)
            return
        if burn < self.burn_low:
            self._clear_streak += 1
            if self._clear_streak >= self.hold_rounds:
                self._exit_latency(engine)
        else:
            self._clear_streak = 0

    def _enter_latency(self, engine) -> None:
        self._baseline = {
            "prefill_token_budget": engine.prefill_token_budget,
            "fetch_stride": engine.fetch_stride,
            "dispatch_duty": engine.dispatch_duty,
            "speculation_enabled": engine.speculation_enabled,
            "speculation_gamma": getattr(engine, "speculation_gamma",
                                         0),
        }
        floor = self.min_prefill_budget
        if engine.prefill_token_budget:
            engine.set_prefill_token_budget(
                max(1, floor) if floor else 0)  # 0 = one-chunk floor
        engine.set_fetch_stride(1)
        engine.set_dispatch_duty(1.0)
        # speculation knob = the gamma-ladder CEILING (0 ≡ the old
        # boolean gate's disabled state; engines without the ladder
        # knob keep the boolean). Steering the ceiling instead of a
        # bool lets a future partial-backoff policy pick a shallow
        # rung; the latency mode's policy today is full off.
        if hasattr(engine, "set_speculation_gamma"):
            engine.set_speculation_gamma(0)
        else:
            engine.set_speculation_enabled(False)
        self._latency_values = {
            "prefill_token_budget": engine.prefill_token_budget,
        }
        self.latency_mode = True
        self._clear_streak = 0
        self.flips += 1

    def _exit_latency(self, engine) -> None:
        # restore each knob only while it still holds the value THIS
        # controller set on entry: the setters are also a live
        # operator surface, and an operator retune made during
        # latency mode must not be silently reverted to a stale
        # pre-spike baseline
        base = self._baseline or {}
        if "prefill_token_budget" in base and engine.prefill_token_budget \
                and engine.prefill_token_budget \
                == self._latency_values.get("prefill_token_budget"):
            engine.set_prefill_token_budget(base["prefill_token_budget"])
        if "fetch_stride" in base and engine.fetch_stride == 1:
            engine.set_fetch_stride(base["fetch_stride"])
        if "dispatch_duty" in base and engine.dispatch_duty == 1.0:
            engine.set_dispatch_duty(base["dispatch_duty"])
        # the ceiling restores only while it still holds the
        # controller's value (0): an operator who re-opened
        # speculation — at any rung — during latency mode keeps
        # their setting
        if not engine.speculation_enabled \
                and getattr(engine, "speculation_gamma", 0) == 0:
            gamma0 = base.get("speculation_gamma", 0)
            if gamma0 and hasattr(engine, "set_speculation_gamma"):
                engine.set_speculation_gamma(gamma0)
            else:
                engine.set_speculation_enabled(
                    base.get("speculation_enabled", True))
        self.latency_mode = False
        self._clear_streak = 0
        self.flips += 1

    def snapshot(self) -> dict:
        return {
            "mode": "latency" if self.latency_mode else "throughput",
            "burn_high": self.burn_high,
            "burn_low": self.burn_low,
            "hold_rounds": self.hold_rounds,
            "flips": self.flips,
        }
