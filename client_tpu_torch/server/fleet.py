"""Replica fleet router: the port of ``client_tpu/server/fleet.py``.

N independent continuous-batching engine replicas of one model config
behind the existing /v2 wire surface. A :class:`ReplicaFleet` owns N
replicas, each with its own device state, prefix pool and supervisor,
optionally pinned to a device by ``engine_devices`` (on one card they
share it, as the reference's CPU fleet shares cores), and routes each
submitted stream to one of them with the reference's three-stage policy
chain:

1. **Prefix affinity**: a host-side fleet-level sketch
   (:class:`FleetAffinityIndex`) of which replica's prefix pool is warm
   for a prompt's leading blocks (a rolling CRC32 chain at
   ``affinity_block_len``-token blocks). Ties, the cold start included,
   break on a stable tenant hash, so one tenant coheres onto one replica.
2. **Load-aware fallback**: the affinity winner is honoured only while
   its load (queue depth plus occupied decode and lane slots) stays
   within ``affinity_tolerance`` of the least-loaded healthy replica.
3. **Health**: replicas whose engine died, whose supervisor tripped its
   breaker, or which are mid-``drain`` are excluded. A submit that races
   a death is re-routed fleet-side before the caller sees an error.

The routing is host code on integers and CRCs, the reference's exactly:
the same workload routes to the same replicas. Streams are pinned: a
stream's tokens come from the replica that admitted it.

Lifecycle verbs: ``drain`` (stop routing to one replica, let its streams
finish, swap in a fresh engine: zero failed requests), ``rolling_restart``,
``attach_replica`` and ``detach_replica``, ``replace_all`` (an unload),
and the canary verbs ``begin_canary``, ``promote_canary`` and
``rollback_canary``. The fleet autoscaler and the canary judge that call
these verbs are ``server/autoscale.py``.

Observability: ``fleet_snapshot`` feeds the ``client_tpu_fleet_*``
families (``server/metrics.py``) and ``GET /v2/debug/fleet``;
``generation_snapshot`` and ``runtime_snapshot`` merge the replicas'
planes so the model-level families read fleet-wide truth; a sampled
trace carries ``FLEET_ROUTE`` (and one ``FLEET_REROUTE`` per bounce).
A replica row carries its engine's count of unexpected compiles, and the
merged runtime block sums the replicas' compile totals and merges their
per-kind compile histograms beside the memory ledger, liveness and
goodput.
"""

from __future__ import annotations

import collections
import threading
import zlib
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from client_tpu_torch.parallel import spmd
from client_tpu_torch.server import trace as trace_mod
from client_tpu_torch.server.config import FleetConfig, config_from_dict
from client_tpu_torch.server.goodput import merge_goodput
from client_tpu_torch.server.types import DEFAULT_TENANT, ServerError, now_ns
from client_tpu_torch.server.watchdog import merge_watchdog

ROUTING_POLICIES = ("affinity", "random")

# Bounded rings on the fleet debug surface: the last N routing
# decisions (live debugging without full tracing on) and the last N
# lifecycle events (drain/swap/attach — the timeline's restart track).
DECISION_RING_CAP = 64
LIFECYCLE_RING_CAP = 64


def resolve_fleet(fleet) -> Optional[FleetConfig]:
    """ONE shared validation rule for the fleet knob (the same pattern
    as ``scheduling.resolve_scheduler``): accepts a ``FleetConfig``,
    its dict form (validating field names), an int replica count, or
    None. Nonsensical values are loud build-time errors, never silent
    fallbacks; the model config JSON advertises exactly the fleet the
    router runs."""
    if fleet is None:
        return None
    if isinstance(fleet, bool):
        raise ValueError(
            "fleet must be a FleetConfig, its dict form, or a replica "
            "count — a bare boolean does not say how many replicas")
    if isinstance(fleet, int):
        fleet = FleetConfig(replicas=fleet)
    if isinstance(fleet, dict):
        fleet = config_from_dict(FleetConfig, fleet)
    if not isinstance(fleet, FleetConfig):
        raise ValueError(
            f"fleet must be a FleetConfig, its dict form, an int "
            f"replica count, or None; got {type(fleet).__name__}")
    if fleet.replicas < 1:
        raise ValueError(f"fleet.replicas must be >= 1, got "
                         f"{fleet.replicas}")
    if fleet.affinity_block_len < 1:
        raise ValueError(
            f"fleet.affinity_block_len must be >= 1, got "
            f"{fleet.affinity_block_len}")
    if fleet.affinity_max_blocks < 1:
        raise ValueError(
            f"fleet.affinity_max_blocks must be >= 1, got "
            f"{fleet.affinity_max_blocks}")
    if fleet.affinity_capacity < 1:
        raise ValueError(
            f"fleet.affinity_capacity must be >= 1, got "
            f"{fleet.affinity_capacity}")
    if fleet.affinity_tolerance < 0:
        raise ValueError(
            f"fleet.affinity_tolerance must be >= 0, got "
            f"{fleet.affinity_tolerance}")
    if fleet.drain_timeout_s <= 0:
        raise ValueError(
            f"fleet.drain_timeout_s must be > 0, got "
            f"{fleet.drain_timeout_s}")
    if fleet.policy not in ROUTING_POLICIES:
        raise ValueError(
            f"unknown fleet.policy {fleet.policy!r} (expected one of "
            f"{ROUTING_POLICIES})")
    return fleet


class FleetAffinityIndex:
    """Host-side fleet-level radix sketch: which replica's prefix pool
    is (likely) warm for a prompt's leading blocks.

    Not a copy of any replica's RadixBlockIndex — a *sketch*: per
    replica, an LRU set of rolling-CRC block-chain hashes of the
    prompts routed there, capped at ``capacity`` entries so a prompt
    flood cannot grow host memory without bound. The chain hash at
    depth i covers the prompt's first ``(i+1) * block_len`` tokens, so
    a score of k means "this replica has seen this prompt's first k
    blocks" — exactly the prefix the replica's radix pool would hit
    on. CRC32 is deterministic across processes (unlike salted
    ``hash()``), which is what makes routing decisions reproducible —
    a property the tests pin. Thread-safe under the fleet's lock
    (callers hold it)."""

    def __init__(self, block_len: int, max_blocks: int, capacity: int):
        self.block_len = int(block_len)
        self.max_blocks = int(max_blocks)
        self.capacity = int(capacity)
        self._seen: dict[int, OrderedDict] = {}

    def chain(self, prompt: np.ndarray) -> tuple:
        """Rolling CRC32 chain over the prompt's leading full blocks
        (up to ``max_blocks``); computed ONCE per submit and shared by
        scoring and recording."""
        prompt = np.ascontiguousarray(prompt, dtype=np.int32)
        n_blocks = min(len(prompt) // self.block_len, self.max_blocks)
        out, crc = [], 0
        for i in range(n_blocks):
            block = prompt[i * self.block_len:(i + 1) * self.block_len]
            crc = zlib.crc32(block.tobytes(), crc)
            out.append(crc)
        return tuple(out)

    def score(self, replica: int, chain: tuple) -> int:
        """Matched leading blocks for ``replica`` — the affinity
        signal. 0 = nothing of this prompt's prefix is known warm."""
        seen = self._seen.get(replica)
        if not seen or not chain:
            return 0
        matched = 0
        for h in chain:
            if h not in seen:
                break
            matched += 1
        return matched

    def record(self, replica: int, chain: tuple) -> None:
        """The routing decision landed: remember the prompt's chain as
        warm on ``replica`` (LRU-refreshing existing entries)."""
        seen = self._seen.setdefault(replica, OrderedDict())
        for h in chain:
            if h in seen:
                seen.move_to_end(h)
            else:
                seen[h] = True
                if len(seen) > self.capacity:
                    seen.popitem(last=False)

    def forget(self, replica: int) -> None:
        """A replica restarted (drain-swap / crash): its prefix pool is
        cold, so its sketch entries are lies — drop them."""
        self._seen.pop(replica, None)

    def size(self, replica: int) -> int:
        seen = self._seen.get(replica)
        return len(seen) if seen else 0


class _Replica:
    """One fleet member: the live engine (behind a per-replica
    supervisor when supervision is configured, a plain box otherwise)
    plus its routing counters. Counter mutation happens under the
    fleet lock."""

    def __init__(self, idx: int, factory: Callable, policy=None,
                 name: str = "fleet", collective: bool = False):
        self.idx = idx
        self.name = f"{name}/r{idx}"
        self._factory = factory
        self.sup = None
        self._box = None
        if policy is not None:
            from client_tpu_torch.server.supervision import EngineSupervisor

            self.sup = EngineSupervisor(factory, policy, name=self.name,
                                        collective=collective)
        else:
            self._box = {"engine": factory()}
        self.draining = False
        self.routed = 0
        self.rerouted = 0
        self.affinity_hits = 0
        self.drains = 0

    @property
    def engine(self):
        return self.sup.engine if self.sup is not None \
            else self._box["engine"]

    def healthy(self) -> bool:
        return self.sup.healthy() if self.sup is not None \
            else self.engine.healthy()

    def swap_fresh(self) -> None:
        """Stop the current engine and stage a fresh one (the drain-
        swap / unload path). Supervised replicas reset their failure
        window + breaker too — a drain-restart is an operator action."""
        if self.sup is not None:
            self.sup.replace_clean()
        else:
            self._box["engine"].stop()
            self._box["engine"] = self._factory()

    def shutdown(self) -> None:
        if self.sup is not None:
            self.sup.shutdown()
        else:
            self._box["engine"].stop()


class ReplicaFleet:
    """N engine replicas of one model config behind one routing
    surface (module docstring). ``factory(idx)`` builds replica
    ``idx``'s fresh, unstarted engine — the SAME factory the replica's
    supervisor and drain-swap reuse, so every rebuild gets fresh
    device state. ``supervision`` is an
    optional ``supervision.RestartPolicy`` applied per replica (each
    replica crash-restarts independently; one replica's breaker trip
    never stops its peers)."""

    def __init__(self, factory: Callable, config: FleetConfig,
                 supervision=None, name: str = "fleet",
                 version_factory: Optional[Callable] = None,
                 model_version: str = "1", plans=None):
        cfg = resolve_fleet(config)
        if cfg is None:
            raise ValueError("ReplicaFleet requires a FleetConfig")
        self.config = cfg
        self.name = name
        self._factory = factory
        # version-parameterized factory (``f(idx, version) -> engine``)
        # for canary rollout / versioned rolling restart; replica
        # builds read their version at CALL time, so a supervisor
        # crash-restart or drain-swap always rebuilds at the version
        # the replica currently holds
        self._version_factory = version_factory
        self._version = str(model_version)       # the stable version
        self._versions: dict[int, str] = {}      # per-replica override
        # live canary state (None = no rollout in flight): replica
        # idx, target version, tenant-hash split %, routed count
        self._canary: Optional[dict] = None
        self._supervision = supervision
        # under a mesh, the fleet's plan channel (parallel.spmd.
        # FleetChannel): the driver announces each replica build on it
        # (the factory's) and the followers run ``follow``, which builds
        # their part of every replica
        self.plans = plans
        # a follower's view of every replica it followed: builds, the
        # rebuilds after a failure, and whether its breaker tripped
        self.followed: dict = {}
        self._lock = threading.Lock()
        self._affinity = FleetAffinityIndex(
            cfg.affinity_block_len, cfg.affinity_max_blocks,
            cfg.affinity_capacity)
        # deterministic "random" arm (the affinity-vs-random A/B
        # baseline): seeded counter hash, no global RNG state
        self._random_seq = 0
        # last-N routing decisions + lifecycle events, surfaced on
        # GET /v2/debug/fleet via fleet_snapshot(); mutated under the
        # fleet lock (decisions) / appended race-tolerantly (lifecycle
        # — deque.append is atomic and readers only snapshot)
        self._decisions: collections.deque = collections.deque(
            maxlen=DECISION_RING_CAP)
        self._lifecycle: collections.deque = collections.deque(
            maxlen=LIFECYCLE_RING_CAP)
        self._replicas = [
            _Replica(i, self._replica_factory(i), supervision, name,
                     collective=plans is not None)
            for i in range(cfg.replicas)
            if plans is None or plans.is_driver]
        # scale-up mints indices from here; reserved under the lock so
        # concurrent attaches can never mint duplicate replica ids
        # (the replica metrics label and the drain verb key on them)
        self._next_idx = cfg.replicas

    def _replica_factory(self, idx: int) -> Callable:
        if self._version_factory is not None:
            return lambda: self._version_factory(
                idx, self.replica_version(idx))
        return lambda: self._factory(idx)

    def replica_version(self, idx: int) -> str:
        """The model version replica ``idx`` builds at (per-replica
        override during a canary/promotion, the stable version
        otherwise)."""
        return self._versions.get(idx, self._version)

    # ------------------------------------------------------------ routing

    def _candidates(self, exclude=()) -> list:
        return [r for r in self._replicas
                if r.idx not in exclude and not r.draining
                and r.healthy()]

    def _retry_hint(self) -> float:
        """Retry-After for an all-replicas-unavailable 503: the
        smallest supervised backoff among down replicas (a restart is
        coming), else a short constant (a drain-swap finishes fast)."""
        hints = [r.sup.retry_after_hint() for r in self._replicas
                 if r.sup is not None and not r.sup.crash_looped
                 and not r.healthy()]
        return min(hints) if hints else 1.0

    def route(self, prompt, tenant_id: str = DEFAULT_TENANT,
              exclude=()) -> "_Replica":
        """Pick the replica for one submit AND commit the decision
        (routed/affinity counters + sketch record) — the operator/
        test surface. ``submit`` uses the two-step form so a decision
        whose engine admit then bounces is never recorded as warm.
        Deterministic given the sketch + load state — pinned by
        tests. Raises a retryable 503 when no healthy, admitting
        replica remains."""
        chain = self._affinity.chain(np.asarray(prompt).reshape(-1))
        with self._lock:
            rep, decision = self._route_locked(chain, tenant_id,
                                               exclude)
            self._commit_locked(rep, chain, decision)
        return rep

    def _commit_locked(self, rep: "_Replica", chain: tuple,
                       decision: dict) -> None:
        """The routing decision LANDED (the engine admitted the
        stream): count it, mark the prompt's chain warm on the
        replica, and push the decision onto the debug ring. Deferred
        past the engine admit so a shed submit never marks a replica
        warm for a prefix its pool never saw. Caller holds the lock."""
        rep.routed += 1
        if decision["affinity_hit"]:
            rep.affinity_hits += 1
        if decision["leg"] == "canary" and self._canary is not None \
                and self._canary["replica"] == rep.idx:
            # admitted canary streams, counted at commit (a bounced
            # canary decision never counts) — the judge's min_requests
            # gate and the client_tpu_canary_routed_total counter
            self._canary["routed"] += 1
        self._affinity.record(rep.idx, chain)
        self._decisions.append(dict(decision, ns=now_ns()))

    def _route_locked(self, chain: tuple, tenant_id: str,
                      exclude=()) -> tuple:
        """(chosen replica, decision dict) for one decision — the
        decision carries the policy leg that won ("affinity", "load",
        "tolerance" when a warm replica was rejected for exceeding
        affinity_tolerance, or "random"), the chosen replica's matched
        sketch depth and load. The only counter it touches is the
        warm-but-unroutable re-route attribution. Caller holds the
        lock."""
        cands = self._candidates(exclude)
        if not cands:
            raise ServerError(
                f"fleet '{self.name}': no healthy replica is admitting "
                f"({len(self._replicas)} configured)", 503,
                retry_after=self._retry_hint())
        # canary split: while a rollout is in flight, ``split_pct`` %
        # of tenants (by stable CRC hash — a tenant's streams cohere
        # on one side so its SLO windows stay attributable) route to
        # the canary replica; everyone else is kept OFF it so the
        # stable set stays a clean comparison baseline. A canary that
        # is unroutable (draining/unhealthy/bounced) falls through to
        # the stable chain, and if NO stable replica is routable the
        # filter is dropped — degraded service beats a 503.
        canary = self._canary
        if canary is not None:
            cidx = canary["replica"]
            crep = next((r for r in cands if r.idx == cidx), None)
            if zlib.crc32(tenant_id.encode()) % 100 \
                    < canary["split_pct"]:
                if crep is not None:
                    return crep, {
                        "replica": crep.idx,
                        "replica_name": crep.name,
                        "leg": "canary", "affinity_hit": False,
                        "affinity_depth": 0,
                        "load": crep.engine.load_depth(),
                        "tolerance": self.config.affinity_tolerance,
                    }
            else:
                stable = [r for r in cands if r.idx != cidx]
                if stable:
                    cands = stable
        if self.config.policy == "random":
            # seeded deterministic baseline for the A/B: stable per
            # submission index, no affinity, no load awareness
            pick = zlib.crc32(
                f"{self.config.random_seed}:{self._random_seq}".encode()
            ) % len(cands)
            self._random_seq += 1
            rep = sorted(cands, key=lambda r: r.idx)[pick]
            return rep, {
                "replica": rep.idx, "replica_name": rep.name,
                "leg": "random", "affinity_hit": False,
                "affinity_depth": 0, "load": rep.engine.load_depth(),
                "tolerance": self.config.affinity_tolerance,
            }
        loads = {r.idx: r.engine.load_depth() for r in cands}
        min_load = min(loads.values())
        scores = {r.idx: self._affinity.score(r.idx, chain)
                  for r in cands}
        best = max(scores.values()) if scores else 0
        tie = zlib.crc32(tenant_id.encode())
        n = max(len(self._replicas), 1)

        def order(r):
            # least load first, then a stable tenant-salted rotation so
            # cold-start ties spread by tenant, not all onto replica 0
            return (loads[r.idx], (r.idx + tie) % n, r.idx)

        chosen, affinity_hit, leg = None, False, "load"
        if best > 0:
            warm = [r for r in cands if scores[r.idx] == best
                    and loads[r.idx]
                    <= min_load + self.config.affinity_tolerance]
            if warm:
                chosen = min(warm, key=order)
                affinity_hit = True
                leg = "affinity"
            else:
                # warm prefixes exist fleet-wide but every holder is
                # over the load tolerance: the LOAD fallback won
                # because of the tolerance bound — attribute that
                leg = "tolerance"
        if chosen is None:
            chosen = min(cands, key=order)
        # re-route attribution: the fleet-wide affinity winner is
        # unroutable (unhealthy/draining) while holding a warm prefix
        # — its loss is the re-route the counters surface. Replicas in
        # ``exclude`` bounced THIS submit and were already counted by
        # submit()'s retry loop — counting them here would double.
        if best == 0 and chain:
            for r in self._replicas:
                if r.idx in exclude:
                    continue
                if (r.draining or not r.healthy()) \
                        and self._affinity.score(r.idx, chain) > 0:
                    r.rerouted += 1
                    break
        return chosen, {
            "replica": chosen.idx, "replica_name": chosen.name,
            "leg": leg, "affinity_hit": affinity_hit,
            "affinity_depth": scores.get(chosen.idx, 0),
            "load": loads[chosen.idx],
            "tolerance": self.config.affinity_tolerance,
        }

    def submit(self, prompt, max_new_tokens: int, **kw):
        """Route one generation request and return the chosen
        replica's token iterator — the stream stays pinned to that
        replica for its whole life. A submit that bounces off a
        replica's 503 gate (death/drain race, queue-full shed) is
        re-routed to the remaining replicas before the caller sees an
        error; only when EVERY replica refuses does the last 503 (with
        its Retry-After) propagate — the same retryable contract the
        single-engine path already speaks. Routing bookkeeping (the
        routed/affinity counters and the sketch record) commits only
        AFTER the engine admits, so a bounced decision never marks a
        replica warm. A sampled ``trace`` in ``kw`` gets the policy
        decision stamped as a FLEET_ROUTE span (plus one FLEET_REROUTE
        per bounced replica), so a request's replica history reads off
        its trace."""
        tenant = kw.get("tenant_id", DEFAULT_TENANT)
        trace = kw.get("trace")
        chain = self._affinity.chain(np.asarray(prompt).reshape(-1))
        tried: set = set()
        last_err: Optional[ServerError] = None
        for attempt in range(len(self._replicas)):
            try:
                with self._lock:
                    rep, decision = self._route_locked(
                        chain, tenant, tried)
            except ServerError:
                # no candidates remain: the LAST engine's concrete 503
                # (its message + Retry-After hint) beats the router's
                # generic one when a bounce preceded this
                if last_err is not None:
                    raise last_err from None
                raise
            try:
                it = rep.engine.submit(prompt, max_new_tokens, **kw)
            except ServerError as e:
                if e.status != 503:
                    raise
                tried.add(rep.idx)
                last_err = e
                with self._lock:
                    rep.rerouted += 1
                if trace is not None:
                    trace.event(trace_mod.FLEET_REROUTE,
                                replica=rep.idx, attempt=attempt,
                                status=e.status)
                continue
            with self._lock:
                self._commit_locked(rep, chain, decision)
            if trace is not None:
                trace.event(trace_mod.FLEET_ROUTE, **decision)
            return it
        raise last_err if last_err is not None else ServerError(
            f"fleet '{self.name}': no healthy replica is admitting",
            503, retry_after=self._retry_hint())

    # ---------------------------------------------------------- lifecycle

    def drain(self, replica: int, timeout: Optional[float] = None) -> bool:
        """Drain-on-restart for one replica: stop routing to it, let
        every queued and in-flight stream run to completion
        (``engine.drain``), then swap in a fresh engine and drop the
        replica's affinity sketch (its new prefix pool is cold). Zero
        failed requests by construction — admission stops at the
        ROUTER before the engine gate ever sheds. Returns False if the
        engine did not go idle within the timeout (the swap still
        happens; stragglers get the engine's retryable 503)."""
        rep = self._replica_checked(replica)
        with self._lock:
            if rep.draining:
                raise ServerError(
                    f"fleet '{self.name}': replica {replica} is "
                    f"already draining", 409)
            rep.draining = True
        self._lifecycle_event("drain", rep.idx)
        try:
            ok = rep.engine.drain(
                timeout if timeout is not None
                else self.config.drain_timeout_s)
            # the replaced engine's completed streams may still sit in
            # tracer JSONL buffers — flush before the swap discards the
            # engine (only core.stop()/unload_model flush otherwise)
            trace_mod.flush_all()
            rep.swap_fresh()
            with self._lock:
                self._affinity.forget(rep.idx)
                rep.drains += 1
            self._lifecycle_event("swap_fresh", rep.idx, drained=ok)
        finally:
            with self._lock:
                rep.draining = False
        return ok

    def rolling_restart(self, timeout: Optional[float] = None,
                        new_model_version=None) -> list:
        """Drain-swap every replica in sequence (the fleet keeps
        serving on the others throughout); returns the per-replica
        drain results in index order. ``new_model_version`` restarts
        the whole fleet onto that version DIRECTLY (every swap builds
        at it) — the unjudged flavor; the canary-gated flavor is
        ``autoscale.FleetController.rolling_restart``, which attaches
        a judged canary first and only promotes the rest on clean SLO
        gates."""
        if new_model_version is not None:
            with self._lock:
                self._version = str(new_model_version)
                for r in self._replicas:
                    self._versions[r.idx] = str(new_model_version)
        self._lifecycle_event(
            "rolling_restart", -1,
            **({"version": str(new_model_version)}
               if new_model_version is not None else {}))
        return [self.drain(r.idx, timeout)
                for r in list(self._replicas)]

    def attach_replica(self, warm_prompt=None, warm_tokens: int = 2,
                       version=None, signals: Optional[dict] = None
                       ) -> int:
        """Scale-up: build replica N via the same indexed factory and
        publish it to the router. With ``warm_prompt`` the new engine
        runs one throwaway stream BEFORE publication, so its device
        state and kernels are ready before it ever takes routed traffic
        ("freshly warmed replica"). ``version`` builds the replica at
        a non-stable model version (the canary path); ``signals``
        (e.g. the autoscaler's burn/queue readings) ride into the
        FLEET_SCALE lifecycle event. Returns the new replica index."""
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
            if version is not None:
                self._versions[idx] = str(version)
        rep = _Replica(idx, self._replica_factory(idx),
                       self._supervision, self.name,
                       collective=self.plans is not None)
        if warm_prompt is not None:
            list(rep.engine.submit(np.asarray(warm_prompt),
                                   int(warm_tokens)))
        with self._lock:
            self._replicas.append(rep)
        self._lifecycle_event(
            "attach_replica", idx, event=trace_mod.FLEET_SCALE,
            version=self.replica_version(idx), **(signals or {}))
        return idx

    def detach_replica(self, replica: int,
                       timeout: Optional[float] = None,
                       signals: Optional[dict] = None) -> bool:
        """Scale-down: drain one replica (router-excluded first, every
        queued and in-flight stream finishes — zero failed requests by
        construction, same contract as ``drain``) and then REMOVE it
        from the fleet instead of swapping a fresh engine in. Refuses
        a replica already draining (409 — the scale-down policy must
        never pick a replica mid-drain) and the last ADMITTING
        replica — draining or dead peers don't count (an empty fleet
        serves nothing; scale-to-zero is an unload, not a detach).
        Returns the drain result."""
        rep = self._replica_checked(replica)
        with self._lock:
            if rep.draining:
                raise ServerError(
                    f"fleet '{self.name}': replica {replica} is "
                    f"already draining", 409)
            others = [r for r in self._replicas
                      if r.idx != rep.idx and not r.draining
                      and r.healthy()]
            if not others:
                raise ServerError(
                    f"fleet '{self.name}': refusing to detach the "
                    f"last admitting replica {replica}", 409)
            rep.draining = True
        self._lifecycle_event(
            "detach_replica", rep.idx, event=trace_mod.FLEET_SCALE,
            version=self.replica_version(rep.idx), **(signals or {}))
        ok = rep.engine.drain(
            timeout if timeout is not None
            else self.config.drain_timeout_s)
        # same flush contract as drain(): the removed engine's spans
        # must not vanish with it
        trace_mod.flush_all()
        rep.shutdown()
        with self._lock:
            self._affinity.forget(rep.idx)
            self._versions.pop(rep.idx, None)
            if rep in self._replicas:
                self._replicas.remove(rep)
        return ok

    # ------------------------------------------------------ canary rollout

    def begin_canary(self, new_version, split_pct: int,
                     warm_prompt=None, warm_tokens: int = 2) -> int:
        """Open a canary rollout toward ``new_version``: attach ONE
        replica built at the new version (warmed before the
        router sees it, like every attach) and start splitting
        ``split_pct`` % of tenants onto it by tenant hash. The stable
        set keeps serving everyone else — it IS the judge's baseline.
        One rollout at a time (409 while one is in flight). Returns
        the canary replica's index."""
        if not 0 < int(split_pct) <= 100:
            raise ServerError(
                f"canary split_pct must be in (0, 100], got "
                f"{split_pct}", 400)
        with self._lock:
            if self._canary is not None:
                raise ServerError(
                    f"fleet '{self.name}': a canary rollout is "
                    f"already in flight "
                    f"(replica {self._canary['replica']})", 409)
        idx = self.attach_replica(
            warm_prompt=warm_prompt, warm_tokens=warm_tokens,
            version=new_version)
        with self._lock:
            self._canary = {
                "replica": idx, "version": str(new_version),
                "split_pct": int(split_pct), "started_ns": now_ns(),
                "routed": 0,
            }
        self._lifecycle_event(
            "begin_canary", idx, event=trace_mod.FLEET_SCALE,
            version=str(new_version), split_pct=int(split_pct))
        return idx

    def promote_canary(self, timeout: Optional[float] = None,
                       verdict: Optional[dict] = None) -> list:
        """The canary passed its gates: clear the split (the canary
        replica joins normal routing at full weight) and drain-swap
        every STABLE replica onto the canary's version in sequence —
        the rolling-restart tail of the rollout, zero failed streams
        per drain. ``verdict`` (the CanaryJudge's comparison) rides
        into the CANARY_PROMOTE lifecycle event so the decision is
        auditable from the debug ring and the timeline export."""
        with self._lock:
            canary = self._canary
            if canary is None:
                raise ServerError(
                    f"fleet '{self.name}': no canary rollout is in "
                    f"flight", 409)
            self._canary = None
            new_version = canary["version"]
            stable = [r for r in self._replicas
                      if r.idx != canary["replica"]]
        self._lifecycle_event(
            "promote_canary", canary["replica"],
            event=trace_mod.CANARY_PROMOTE,
            # the judge's verdict may restate version/routed — its
            # values win (they are the audited comparison)
            **{"version": new_version,
               "canary_routed": canary["routed"], **(verdict or {})})
        results = []
        for r in stable:
            with self._lock:
                self._versions[r.idx] = new_version
            results.append(self.drain(r.idx, timeout))
        with self._lock:
            # the canary's per-replica override folds into the stable
            # version — a later attach builds at the promoted version
            self._version = new_version
            self._versions.pop(canary["replica"], None)
        return results

    def rollback_canary(self, timeout: Optional[float] = None,
                        verdict: Optional[dict] = None) -> bool:
        """The canary breached a gate: stop splitting traffic to it
        (immediately — no new stream routes there) and detach it
        (drain first: its in-flight streams finish, zero failed by
        construction). The stable set never stopped serving.
        ``verdict`` rides into the CANARY_ROLLBACK lifecycle event."""
        with self._lock:
            canary = self._canary
            if canary is None:
                raise ServerError(
                    f"fleet '{self.name}': no canary rollout is in "
                    f"flight", 409)
            self._canary = None
        self._lifecycle_event(
            "rollback_canary", canary["replica"],
            event=trace_mod.CANARY_ROLLBACK,
            **{"version": canary["version"],
               "canary_routed": canary["routed"], **(verdict or {})})
        return self.detach_replica(canary["replica"], timeout)

    @property
    def canary(self) -> Optional[dict]:
        """The live canary rollout state (replica, version, split %,
        routed count) or None."""
        with self._lock:
            return dict(self._canary) if self._canary else None

    def replace_all(self) -> None:
        """Model unload/reload: stage a fresh engine on every replica
        and cold the whole sketch. Buffered trace JSONL is flushed
        first — the replaced engines' spans must not vanish with
        them."""
        self._lifecycle_event("replace_all", -1)
        trace_mod.flush_all()
        for rep in self._replicas:
            rep.swap_fresh()
        with self._lock:
            for rep in self._replicas:
                self._affinity.forget(rep.idx)

    def _lifecycle_event(self, verb: str, replica: int,
                         event: Optional[str] = None, **fields) -> None:
        """Record one lifecycle event on the bounded debug ring
        (``replica`` -1 = fleet-wide verb). ``event`` picks the span
        kind the timeline export renders — FLEET_DRAIN (the default:
        drain/swap/restart verbs), FLEET_SCALE (autoscaler attach/
        detach), CANARY_PROMOTE / CANARY_ROLLBACK (judge verdicts)."""
        self._lifecycle.append(dict(
            fields, ns=now_ns(),
            event=event or trace_mod.FLEET_DRAIN,
            verb=verb, replica=replica))

    def shutdown(self) -> None:
        """Terminal stop (server shutdown): no restarts are staged. Under
        a mesh the followers' loops end with the fleet."""
        for rep in self._replicas:
            rep.shutdown()
        if self.plans is not None and self.plans.is_driver \
                and self.plans.group is not None:
            self.plans.send(None, spmd.STOP)
            self.plans.destroy()

    def follow(self) -> None:
        """A follower rank's part of a fleet under a mesh: read every plan
        of the fleet's channel in order and hand it to this rank's shard
        of its replica (a replica whose mesh leaves this rank out skips
        it); build a replica's engine at its ``BUILD`` plan, the first
        replicas' too, from the same factory as rank 0, and let an engine
        go at its ``STOP``. A failed replica (its ``FAIL`` plan) waits for
        rank 0's next build of it; a ``STOP`` after its failure is its
        breaker's verdict, and stops only that replica. Returns at the
        fleet's ``STOP``; ``followed`` counts each replica's builds and
        rebuilds."""
        import torch

        plans = self.plans
        engines: dict = {}
        failed: set = set()
        try:
            with torch.inference_mode():
                while True:
                    replica, op, args = plans.recv()
                    if replica is None:
                        if op == spmd.STOP:
                            return
                        continue
                    row = self.followed.setdefault(replica, {
                        "builds": 0, "restarts": 0, "crash_looped": False})
                    if op == spmd.BUILD:
                        row["builds"] += 1
                        if replica in failed:
                            failed.discard(replica)
                            row["restarts"] += 1
                        engines[replica] = self._replica_factory(replica)()
                    elif op == spmd.FAIL:
                        failed.add(replica)
                        engines[replica]._failed = spmd.SpmdError(
                            f"the driver rank failed: {args[0]}")
                    elif op == spmd.STOP:
                        eng = engines.pop(replica)
                        if replica in failed:
                            row["crash_looped"] = True
                        else:
                            eng._finish_following()
                    elif op not in (spmd.NOOP, spmd.RESTART):
                        engines[replica].run_plan(op, args)
        finally:
            plans.destroy()

    def healthy(self) -> bool:
        """The fleet serves while ANY replica is healthy — the router
        excludes the dead ones."""
        return any(r.healthy() for r in self._replicas)

    def _replica_checked(self, replica: int) -> "_Replica":
        # looked up by replica ID, not list position: concurrent
        # attaches may publish out of reservation order
        if isinstance(replica, int):
            for rep in self._replicas:
                if rep.idx == replica:
                    return rep
        raise ServerError(
            f"fleet '{self.name}': unknown replica {replica!r} "
            f"(have {len(self._replicas)})", 404)

    @property
    def replicas(self) -> list:
        return list(self._replicas)

    # ------------------------------------------------------- observability

    def fleet_snapshot(self) -> dict:
        """Per-replica health/affinity/occupancy for the
        ``client_tpu_fleet_*`` /metrics families and
        ``GET /v2/debug/fleet``. Reads race the engine threads by
        design (best-effort introspection, same contract as the
        engine's own debug snapshot)."""
        with self._lock:
            reps = list(self._replicas)
            rows = []
            for r in reps:
                eng = r.engine
                healthy = r.healthy()
                row = {
                    "replica": r.idx,
                    "engine": r.name,
                    "version": self._versions.get(r.idx,
                                                  self._version),
                    "healthy": healthy,
                    "draining": r.draining,
                    "queue_depth": eng._pending.qsize(),
                    "active_slots": eng.active_slots(),
                    "load": eng.load_depth(),
                    "routed": r.routed,
                    "rerouted": r.rerouted,
                    "affinity_hits": r.affinity_hits,
                    "drains": r.drains,
                    "sketch_blocks": self._affinity.size(r.idx),
                    "unexpected_compiles": eng.compile_watch.unexpected,
                    "restarts": (r.sup.restarts if r.sup is not None
                                 else 0),
                    "crash_looped": (r.sup.crash_looped
                                     if r.sup is not None else False),
                }
                # per-replica goodput tail: the utilization signal the
                # autoscaler wants per replica, not fleet-merged
                gp_dts, gp_wfs = eng.goodput.shares()
                row["device_time_share"] = round(gp_dts, 4)
                row["wasted_flop_share"] = round(gp_wfs, 4)
                rows.append(row)
            decisions = list(self._decisions)
            canary = dict(self._canary) if self._canary else None
        return {
            "replicas": len(reps),
            "healthy_replicas": sum(1 for row in rows if row["healthy"]),
            "version": self._version,
            # live canary rollout state (phase/split/routed) — the
            # /v2/debug/fleet canary block; the judge windows ride in
            # the autoscale block the FleetController attaches
            "canary": canary,
            "policy": self.config.policy,
            "affinity_block_len": self.config.affinity_block_len,
            "affinity_max_blocks": self.config.affinity_max_blocks,
            "affinity_tolerance": self.config.affinity_tolerance,
            "rows": rows,
            # bounded debug rings: recent routing decisions (replica,
            # winning policy leg, affinity depth — live debugging
            # without tracing on) + lifecycle events (drain/swap/
            # attach verbs, the timeline's restart track)
            "recent_decisions": decisions,
            "lifecycle_events": list(self._lifecycle),
        }

    def generation_snapshot(self) -> dict:
        """Fleet-merged token-level snapshot so the model-level
        ``client_tpu_generation_*`` families read fleet-wide truth:
        histograms merge bucket-wise (shared grid), counters and
        capacity gauges sum. Per-engine sub-planes whose merged value
        would be a lie (ring stride, lane geometry, paged occupancy,
        scheduler, speculation, per-tenant SLO windows) are reported
        as absent here — so the model-level ``client_tpu_slo_*`` /
        ``client_tpu_sched_*`` families and ``/v2/debug/slo`` /
        ``/v2/debug/scheduler`` do not cover fleet models; their
        per-replica truth lives in the fleet model's
        ``GET /v2/debug/models/{name}/engine`` (every replica's full
        engine debug snapshot, INCLUDING its slo and scheduler
        blocks) next to ``GET /v2/debug/fleet``'s routing rows."""
        snaps = [r.engine.generation_snapshot()
                 for r in self._replicas]
        merged = _merge_generation(snaps)
        merged["engine_up"] = self.healthy()
        # watchdog block: replicas share ONE incident store, so the
        # merge sums samples/fires and passes the store counters
        # through — the model-level client_tpu_watchdog_* families
        # read fleet-wide truth (per-replica attribution rides each
        # bundle's engine name in the store)
        merged["watchdog"] = merge_watchdog(
            [s.get("watchdog") for s in snaps])
        sups = [r.sup for r in self._replicas if r.sup is not None]
        merged["supervisor"] = None if not sups else {
            "restarts": sum(s.restarts for s in sups),
            # the fleet is only operator-dead once EVERY supervised
            # replica's breaker tripped — one tripped replica is a
            # routed-around event, not a model outage
            "crash_looped": all(s.crash_looped for s in sups),
        }
        return merged

    def runtime_snapshot(self) -> dict:
        """Fleet-merged runtime plane (compile totals and the card-memory
        ledger summed across replicas; per-kind compile histograms merged
        bucket-wise), liveness and the merged goodput block. Per-replica
        compile tables live in each replica's engine debug snapshot."""
        snaps = [r.engine.runtime_snapshot() for r in self._replicas]
        hist: dict = {}
        for s in snaps:
            for kind, (counts, sum_s, count) in (s.get("hist")
                                                 or {}).items():
                if kind in hist:
                    acc = hist[kind]
                    acc[0] = [a + b for a, b in zip(acc[0], counts)]
                    acc[1] += sum_s
                    acc[2] += count
                else:
                    hist[kind] = [list(counts), sum_s, count]
        memory: dict = {}
        for s in snaps:
            for component, nbytes in (s.get("memory") or {}).items():
                memory[component] = memory.get(component, 0) + nbytes
        return {
            "sealed": all(s.get("sealed", False) for s in snaps),
            "total_compiles": sum(s.get("total_compiles", 0)
                                  for s in snaps),
            "unexpected_compiles": sum(s.get("unexpected_compiles", 0)
                                       for s in snaps),
            "warmup_compiles": sum(s.get("warmup_compiles", 0)
                                   for s in snaps),
            "warmup_compile_seconds": round(
                sum(s.get("warmup_compile_seconds", 0.0)
                    for s in snaps), 6),
            "compiles": [],
            "hist": {k: (v[0], v[1], v[2]) for k, v in hist.items()},
            "memory": memory,
            "engine_up": self.healthy(),
            "goodput": merge_goodput([s.get("goodput")
                                      for s in snaps]),
        }

    def stats(self) -> dict:
        """The HTTP statistics endpoint's ``runtime`` block: fleet
        routing state plus the merged engine counters."""
        merged = self.generation_snapshot()
        return {
            "fleet": self.fleet_snapshot(),
            "n_slots": merged["n_slots"],
            "slots_active": merged["slots_active"],
            "queue_depth": merged["queue_depth"],
            "tokens_emitted": merged["tokens"],
            "requests_completed": merged["completed"],
            "requests_failed": merged["failed"],
        }


def _merge_hist(hists: list) -> tuple:
    """Merge (counts, sum, count) histogram snapshots on one shared
    bucket grid."""
    counts = [sum(col) for col in zip(*(h[0] for h in hists))]
    return (counts, sum(h[1] for h in hists),
            sum(h[2] for h in hists))


# generation-snapshot keys that sum across replicas (counters and
# capacity/occupancy gauges — every one additive by construction)
_SUM_KEYS = (
    "tokens", "completed", "failed", "cancelled", "deadline_expired",
    "slot_busy_ns", "prefix_hits", "prefix_misses",
    "prefix_saved_tokens", "n_slots", "slots_active", "queue_depth",
    "chunks_dispatched", "useful_flops", "wasted_flops",
)

# per-replica prefix-pool snapshot keys that sum into the fleet view
_POOL_SUM_KEYS = ("hits", "misses", "evictions", "commits", "blocks",
                  "blocks_used", "saved_tokens")


def _merge_generation(snaps: list) -> dict:
    merged: dict = {}
    for key in ("ttft", "inter_token", "queue_wait"):
        merged[key] = _merge_hist([s[key] for s in snaps])
    # per-bucket exemplars: most recent wall-clock stamp wins per
    # bucket (same convention the per-engine _HistNs keeps)
    exemplars: dict = {}
    for s in snaps:
        for hist_key, buckets in (s.get("exemplars") or {}).items():
            dst = exemplars.setdefault(hist_key, {})
            for idx, ex in buckets.items():
                if idx not in dst or ex[2] > dst[idx][2]:
                    dst[idx] = ex
    merged["exemplars"] = exemplars
    for key in _SUM_KEYS:
        merged[key] = sum(s.get(key, 0) for s in snaps)
    phase: dict = {}
    for s in snaps:
        for k, v in (s.get("phase_seconds") or {}).items():
            phase[k] = phase.get(k, 0.0) + v
    merged["phase_seconds"] = phase
    # the MOST THROTTLED replica's duty: duty is steered per engine,
    # so the fleet-level gauge reports the conservative bound (a mean
    # or replica-0 read would mask a throttled replica entirely)
    merged["dispatch_duty"] = min(
        (s.get("dispatch_duty", 1.0) for s in snaps), default=1.0)
    pools = [s.get("prefix_cache") for s in snaps]
    if pools and all(p is not None for p in pools):
        merged["prefix_cache"] = {
            k: sum(p.get(k, 0) for p in pools) for k in _POOL_SUM_KEYS}
    else:
        merged["prefix_cache"] = None
    # per-engine sub-planes whose merged value would mislead (module
    # docstring): absent fleet-wide, per-replica via the debug surface
    for key in ("ring", "prefill_lane", "kv_paged", "kv_tier",
                "scheduler", "speculation", "slo"):
        merged[key] = None
    # the goodput plane DOES merge (unlike the planes above): FLOP and
    # device-second counters are additive, histograms share the grid,
    # and fleet MFU is the summed useful-FLOP rate over the summed
    # peak — server/goodput.py owns the arithmetic
    merged["goodput"] = merge_goodput(
        [s.get("goodput") for s in snaps])
    return merged
