"""The fleet autoscaler and the canary judge: the port's counterpart of
``client_tpu/server/autoscale.py``, the outer control loop over a replica
fleet (``server/fleet.py``).

:class:`FleetController` reads the fleet's live signals, the windowed
per-class error-budget burn (``server/slo_stats.py``) and the queue depth
of the admitting replicas, and walks a ladder once per round, cheapest
actuator first:

1. **Knob steering**: one ``scheduling.EngineController`` per replica,
   stepped with that replica's own burn (a replica that runs its own
   controller is left to it: that one steers at dispatch cadence).
2. **Preemption pressure**: a replica whose burn crosses the high band
   gets its preempt-burn threshold lowered, restored once its burn falls
   under the low band.
3. **Scale up**: after ``hold_rounds`` hot rounds in a row (burn or queue
   above the high bands) the fleet attaches a replica, warmed before the
   router sees it.
4. **Scale down**: after ``idle_rounds`` idle rounds in a row the least
   loaded admitting replica drains and detaches (admission stops at the
   router first, so no stream fails).

The gap between the high and low bands is a dead zone, ``min_replicas``
and ``max_replicas`` bound the fleet, and ``cooldown_s`` separates two
scale verbs, so a noisy signal does not flap the fleet. Every actuation
lands on a bounded decision ring (``GET /v2/debug/fleet`` and the
``client_tpu_autoscale_*`` families), and the scale verbs stamp
FLEET_SCALE lifecycle events.

``FleetController.rolling_restart(new_version)`` with a canary policy
attaches one canary replica at the new version, routes ``split_pct`` % of
tenants to it, and arms a :class:`CanaryJudge` that compares it with the
stable set over a soak window on burn, TTFT p95 (histogram deltas over
the soak) and goodput MFU where both sides measure one. Inside every gate
the stable set drain-swaps onto the new version (promote); a breached
gate drains and detaches the canary (rollback). Both verdicts stamp
CANARY_PROMOTE / CANARY_ROLLBACK lifecycle events with the comparison.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Optional

from client_tpu_torch.server.config import (
    AutoscaleConfig,
    CanaryConfig,
    config_from_dict,
)
from client_tpu_torch.server.metrics import DEFAULT_BUCKETS_S
from client_tpu_torch.server.scheduling import EngineController
from client_tpu_torch.server.types import now_ns
from client_tpu_torch.server.watchdog import MetricHistory

log = logging.getLogger(__name__)

# the bounded decision ring on the debug surface (the cap discipline of
# the fleet's routing and lifecycle rings)
DECISION_RING_CAP = 64


def resolve_autoscale(autoscale) -> Optional[AutoscaleConfig]:
    """The one validation rule for the autoscale knob: an
    ``AutoscaleConfig``, its dict form (field names checked), ``True``
    for the enabled defaults, or None. Unordered bands, crossed bounds, a
    zero hold window and the like raise; a disabled config returns None
    (no controller is built)."""
    if autoscale is None:
        return None
    if autoscale is True:
        autoscale = AutoscaleConfig(enabled=True)
    if isinstance(autoscale, dict):
        autoscale = config_from_dict(AutoscaleConfig, autoscale,
                                     defaults={"enabled": True})
    if not isinstance(autoscale, AutoscaleConfig):
        raise ValueError(
            f"autoscale must be an AutoscaleConfig, its dict form, "
            f"True, or None; got {type(autoscale).__name__}")
    if not autoscale.enabled:
        return None
    if not 0 <= autoscale.burn_low < autoscale.burn_high:
        raise ValueError(
            f"autoscale burn band must satisfy 0 <= burn_low < "
            f"burn_high, got [{autoscale.burn_low}, "
            f"{autoscale.burn_high}]")
    if not 0 <= autoscale.queue_low < autoscale.queue_high:
        raise ValueError(
            f"autoscale queue band must satisfy 0 <= queue_low < "
            f"queue_high, got [{autoscale.queue_low}, "
            f"{autoscale.queue_high}]")
    if autoscale.min_replicas < 1:
        raise ValueError(
            f"autoscale.min_replicas must be >= 1, got "
            f"{autoscale.min_replicas}")
    if autoscale.max_replicas < autoscale.min_replicas:
        raise ValueError(
            f"autoscale.max_replicas ({autoscale.max_replicas}) must "
            f"be >= min_replicas ({autoscale.min_replicas})")
    if autoscale.hold_rounds < 1 or autoscale.idle_rounds < 1:
        raise ValueError(
            f"autoscale hold_rounds/idle_rounds must be >= 1, got "
            f"{autoscale.hold_rounds}/{autoscale.idle_rounds}")
    if autoscale.cooldown_s < 0:
        raise ValueError(
            f"autoscale.cooldown_s must be >= 0, got "
            f"{autoscale.cooldown_s}")
    if autoscale.pressure_preempt_threshold < 0:
        raise ValueError(
            f"autoscale.pressure_preempt_threshold must be >= 0, got "
            f"{autoscale.pressure_preempt_threshold}")
    if autoscale.warm_tokens < 1:
        raise ValueError(
            f"autoscale.warm_tokens must be >= 1, got "
            f"{autoscale.warm_tokens}")
    if autoscale.interval_s < 0:
        raise ValueError(
            f"autoscale.interval_s must be >= 0 (0 = no background "
            f"thread, step() is driven manually), got "
            f"{autoscale.interval_s}")
    return autoscale


def resolve_canary(canary) -> Optional[CanaryConfig]:
    """``resolve_autoscale``'s twin for the canary policy: a split
    outside (0, 100], a soak window that is not positive, or ratio gates
    that cannot pass raise; a disabled config returns None."""
    if canary is None:
        return None
    if canary is True:
        canary = CanaryConfig(enabled=True)
    if isinstance(canary, dict):
        canary = config_from_dict(CanaryConfig, canary,
                                  defaults={"enabled": True})
    if not isinstance(canary, CanaryConfig):
        raise ValueError(
            f"canary must be a CanaryConfig, its dict form, True, or "
            f"None; got {type(canary).__name__}")
    if not canary.enabled:
        return None
    if not 0 < canary.split_pct <= 100:
        raise ValueError(
            f"canary.split_pct must be in (0, 100], got "
            f"{canary.split_pct}")
    if canary.soak_s <= 0:
        raise ValueError(
            f"canary.soak_s must be > 0, got {canary.soak_s}")
    if canary.min_requests < 1:
        raise ValueError(
            f"canary.min_requests must be >= 1, got "
            f"{canary.min_requests}")
    if canary.burn_ratio_max <= 0 or canary.ttft_p95_ratio_max <= 0:
        raise ValueError(
            f"canary ratio gates must be > 0, got burn_ratio_max="
            f"{canary.burn_ratio_max}, ttft_p95_ratio_max="
            f"{canary.ttft_p95_ratio_max}")
    if canary.burn_abs_max < 0:
        raise ValueError(
            f"canary.burn_abs_max must be >= 0, got "
            f"{canary.burn_abs_max}")
    if not 0 <= canary.mfu_ratio_min <= 1:
        raise ValueError(
            f"canary.mfu_ratio_min must be in [0, 1], got "
            f"{canary.mfu_ratio_min}")
    return canary


def _hist_quantile(counts, q: float) -> Optional[float]:
    """A quantile (seconds, the bucket's upper bound) of one latency
    histogram on ``DEFAULT_BUCKETS_S``; None when it is empty. The +Inf
    bucket reads twice the last finite bound, so ratio gates stay
    computable."""
    total = sum(counts)
    if not total:
        return None
    target = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return (DEFAULT_BUCKETS_S[i] if i < len(DEFAULT_BUCKETS_S)
                    else DEFAULT_BUCKETS_S[-1] * 2)
    return DEFAULT_BUCKETS_S[-1] * 2


def _replica_burn(engine) -> float:
    """One replica's largest windowed per-class burn; 0.0 for an engine
    without the SLO plane."""
    stats = getattr(engine, "slo_stats", None)
    if stats is None:
        return 0.0
    try:
        return float(stats.max_class_burn())
    except Exception:  # noqa: BLE001 — an engine swapped mid-read reads 0
        return 0.0


def _replica_mfu(engine) -> Optional[float]:
    """One replica's live goodput MFU; None where it cannot be measured
    (the CPU, or a card without a known peak)."""
    gp = getattr(engine, "goodput", None)
    if gp is None:
        return None
    try:
        return gp.snapshot().get("mfu")
    except Exception:  # noqa: BLE001
        return None


def _ttft_counts(engine) -> Optional[list]:
    """One replica's cumulative TTFT bucket counts on the shared grid;
    None for an engine without the generation plane."""
    fn = getattr(engine, "generation_snapshot", None)
    if fn is None:
        return None
    try:
        return list(fn()["ttft"][0])
    except Exception:  # noqa: BLE001
        return None


class CanaryJudge:
    """Compares one canary replica with the stable set over a soak
    window, on three axes:

    - **burn**: the live windowed largest per-class burn (already a
      sliding window);
    - **TTFT p95**: histogram deltas over the soak (counts at the verdict
      less counts when the judge was armed) on both sides, so neither the
      stable set's earlier history nor the canary's warm stream counts;
    - **goodput MFU**: judged only when both sides report one.

    ``verdict()`` only observes; the controller acts on it. ``ready``
    needs the soak window, the routed floor and, on engines with a
    generation plane, at least one completed canary request in the soak
    delta (routed counts at commit time, so a canary whose first token
    never lands cannot promote without evidence)."""

    def __init__(self, fleet, cfg: CanaryConfig, canary_idx: int,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.canary_idx = canary_idx
        self._fleet = fleet
        self._clock = clock
        self._t0 = clock()
        # each replica's TTFT counts when the soak starts, the canary's
        # too: its warm stream has landed already
        self._ttft_base: dict[int, list] = {}
        for rep in fleet.replicas:
            counts = _ttft_counts(rep.engine)
            if counts is not None:
                self._ttft_base[rep.idx] = counts

    def soak_elapsed_s(self) -> float:
        return self._clock() - self._t0

    def _delta_counts(self, rep) -> Optional[list]:
        cur = _ttft_counts(rep.engine)
        if cur is None:
            return None
        base = self._ttft_base.get(rep.idx)
        if base is None or len(base) != len(cur):
            return cur
        # a drain-swap during the soak resets the counters: a negative
        # delta means that, and the fresh engine's counts stand
        delta = [c - b for c, b in zip(cur, base)]
        return cur if any(d < 0 for d in delta) else delta

    def verdict(self) -> dict:
        """The live comparison: ``ready`` once the soak window and the
        routed floor are met, ``healthy`` while every judged gate holds,
        ``reasons`` naming each breached gate. An axis without data on
        either side is skipped, never failed."""
        cfg = self.cfg
        canary_state = self._fleet.canary or {}
        routed = int(canary_state.get("routed", 0))
        canary_rep, stable = None, []
        for rep in self._fleet.replicas:
            if rep.idx == self.canary_idx:
                canary_rep = rep
            else:
                stable.append(rep)
        elapsed = self.soak_elapsed_s()
        out = {
            "ready": (elapsed >= cfg.soak_s
                      and routed >= cfg.min_requests),
            "healthy": True,
            "reasons": [],
            "soak_elapsed_s": round(elapsed, 3),
            "soak_s": cfg.soak_s,
            "canary_routed": routed,
            "min_requests": cfg.min_requests,
        }
        if canary_rep is None:
            out["ready"] = False
            return out
        # burn: an absolute ceiling always, the ratio to the stable set
        # only while that set burns (a stable burn of 0 makes every
        # ratio infinite)
        c_burn = _replica_burn(canary_rep.engine)
        s_burn = max((_replica_burn(r.engine) for r in stable),
                     default=0.0)
        out["canary_burn"] = round(c_burn, 4)
        out["stable_burn"] = round(s_burn, 4)
        if c_burn > cfg.burn_abs_max:
            out["healthy"] = False
            out["reasons"].append(
                f"burn {c_burn:.3f} > burn_abs_max "
                f"{cfg.burn_abs_max}")
        if s_burn > 0 and c_burn > s_burn * cfg.burn_ratio_max:
            out["healthy"] = False
            out["reasons"].append(
                f"burn {c_burn:.3f} > {cfg.burn_ratio_max}x stable "
                f"{s_burn:.3f}")
        # TTFT p95 on the soak deltas of both sides
        c_counts = self._delta_counts(canary_rep)
        merged: Optional[list] = None
        for rep in stable:
            d = self._delta_counts(rep)
            if d is None:
                continue
            merged = (d if merged is None
                      else [a + b for a, b in zip(merged, d)])
        c_p95 = _hist_quantile(c_counts, 0.95) if c_counts else None
        s_p95 = _hist_quantile(merged, 0.95) if merged else None
        out["canary_ttft_p95_s"] = c_p95
        out["stable_ttft_p95_s"] = s_p95
        # no completed canary request in the soak delta: not ready
        # (engines without a generation plane are exempt)
        if c_counts is not None and sum(c_counts) == 0:
            out["ready"] = False
        if c_p95 is not None and s_p95 is not None and s_p95 > 0 \
                and c_p95 > s_p95 * cfg.ttft_p95_ratio_max:
            out["healthy"] = False
            out["reasons"].append(
                f"ttft p95 {c_p95:.3f}s > {cfg.ttft_p95_ratio_max}x "
                f"stable {s_p95:.3f}s")
        # goodput MFU, judged only when both sides measure one
        c_mfu = _replica_mfu(canary_rep.engine)
        s_mfus = [m for m in (_replica_mfu(r.engine) for r in stable)
                  if m is not None]
        s_mfu = max(s_mfus) if s_mfus else None
        out["canary_mfu"] = c_mfu
        out["stable_mfu"] = s_mfu
        if c_mfu is not None and s_mfu is not None and s_mfu > 0 \
                and c_mfu < s_mfu * cfg.mfu_ratio_min:
            out["healthy"] = False
            out["reasons"].append(
                f"mfu {c_mfu:.4f} < {cfg.mfu_ratio_min}x stable "
                f"{s_mfu:.4f}")
        return out

    def snapshot(self) -> dict:
        """The live verdict for the debug surface, without acting on
        it."""
        return self.verdict()


class FleetController:
    """The outer control loop (see the module docstring) over a live
    ``ReplicaFleet``: one pass of the ladder per :meth:`step`, from the
    background thread (``start()``, every ``config.interval_s``) or by
    hand (``interval_s`` 0; ``clock`` is injectable)."""

    def __init__(self, fleet, config: AutoscaleConfig,
                 canary: Optional[CanaryConfig] = None,
                 warm_prompt=None,
                 clock: Callable[[], float] = time.monotonic):
        cfg = resolve_autoscale(config)
        if cfg is None:
            raise ValueError(
                "FleetController requires an enabled AutoscaleConfig")
        self.config = cfg
        self.canary_config = resolve_canary(canary)
        self._fleet = fleet
        # the prompt an attached or canary replica warms on
        self.warm_prompt = warm_prompt
        self._clock = clock
        self._lock = threading.Lock()
        # rung 1: one steering controller per replica, made on first use
        self._steer: dict[int, EngineController] = {}
        # rung 2: the replicas under preemption pressure
        self._pressured: set[int] = set()
        self._hot_rounds = 0
        self._idle_rounds = 0
        self._last_scale: Optional[float] = None
        self._decisions: collections.deque = collections.deque(
            maxlen=DECISION_RING_CAP)
        self._judge: Optional[CanaryJudge] = None
        # the fleet's metric history, one sample per control round
        self.history = MetricHistory(interval_s=0.0)
        # whether the replicas' burn_spike detectors are suppressed for
        # a canary
        self._burn_suppressed = False
        self.rounds = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.pressure_events = 0
        self.promotions = 0
        self.rollbacks = 0
        self._last_signals: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ signals

    def _signals(self) -> dict:
        """One lock-free read of the fleet: each replica's burn and load,
        the fleet's largest burn and the admitting replicas' mean
        load."""
        reps = self._fleet.replicas
        per = {}
        for rep in reps:
            eng = rep.engine
            per[rep.idx] = {
                "burn": _replica_burn(eng),
                "load": int(eng.load_depth()),
                "draining": rep.draining,
                "healthy": rep.healthy(),
            }
        admitting = [r for r in reps
                     if not r.draining and r.healthy()]
        loads = [per[r.idx]["load"] for r in admitting]
        return {
            "per_replica": per,
            "burn": max((per[r.idx]["burn"] for r in reps),
                        default=0.0),
            "queue_depth": (sum(loads) / len(loads)) if loads else 0.0,
            "replicas": len(reps),
            "admitting": len(admitting),
        }

    def _record(self, action: str, sig: dict, **fields) -> None:
        self._decisions.append(dict(
            fields, ns=now_ns(), action=action,
            burn=round(sig["burn"], 4),
            queue_depth=round(sig["queue_depth"], 2),
            replicas=sig["replicas"]))

    def _cooldown_ok(self) -> bool:
        if self._last_scale is None:
            return True
        return (self._clock() - self._last_scale
                >= self.config.cooldown_s)

    # --------------------------------------------------------------- loop

    def step(self) -> list:
        """One control round over the whole ladder; returns the decisions
        it recorded (empty in a steady state). One round at a time."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> list:
        cfg = self.config
        sig = self._signals()
        self._last_signals = {
            "burn": sig["burn"], "queue_depth": sig["queue_depth"],
            "replicas": sig["replicas"],
            "admitting": sig["admitting"],
            # for the replica-labelled client_tpu_autoscale_* gauges
            "per_replica": {
                idx: {"burn": round(p["burn"], 4),
                      "load": p["load"]}
                for idx, p in sig["per_replica"].items()},
        }
        self.rounds += 1
        before = len(self._decisions)
        reps = {r.idx: r for r in self._fleet.replicas}
        self.history.sample(now_ns(), {
            "burn": round(sig["burn"], 4),
            "queue_depth": round(sig["queue_depth"], 2),
            "replicas": sig["replicas"],
            "admitting": sig["admitting"],
        })
        # while a canary runs the judge owns the burn signal: a
        # regressing canary rolls back instead of raising burn_spike on
        # every replica. Applied every round, so an engine swapped in
        # during the rollout is suppressed too.
        suppress = self._fleet.canary is not None
        if suppress or self._burn_suppressed:
            for rep in reps.values():
                sup_fn = getattr(rep.engine, "watchdog_suppress", None)
                if callable(sup_fn):
                    sup_fn("burn_spike", suppress)
            self._burn_suppressed = suppress

        # rung 1: knob steering, each replica with its own burn (one
        # burning replica must not throttle its healthy peers)
        for idx, rep in reps.items():
            eng = rep.engine
            if getattr(eng, "_controller", None) is not None:
                continue  # its own controller steers at dispatch cadence
            if not hasattr(eng, "set_fetch_stride"):
                continue  # an engine without live knobs
            ctl = self._steer.get(idx)
            if ctl is None:
                ctl = self._steer[idx] = EngineController(
                    cfg.burn_high, cfg.burn_low, cfg.hold_rounds)
            was = ctl.latency_mode
            ctl.step(eng, sig["per_replica"][idx]["burn"])
            if ctl.latency_mode != was:
                self._record(
                    "steer_latency" if ctl.latency_mode
                    else "steer_restore", sig, replica=idx)
        for idx in list(self._steer):
            if idx not in reps:
                del self._steer[idx]

        # rung 2: preemption pressure on a burning replica, released
        # once its burn clears the low band
        for idx, rep in reps.items():
            eng = rep.engine
            if not hasattr(eng, "set_preempt_burn_threshold"):
                continue
            burn = sig["per_replica"][idx]["burn"]
            if idx not in self._pressured and burn >= cfg.burn_high:
                eng.set_preempt_burn_threshold(
                    cfg.pressure_preempt_threshold)
                self._pressured.add(idx)
                self.pressure_events += 1
                self._record("pressure_on", sig, replica=idx,
                             threshold=cfg.pressure_preempt_threshold)
            elif idx in self._pressured and burn < cfg.burn_low:
                eng.set_preempt_burn_threshold(None)
                self._pressured.discard(idx)
                self._record("pressure_off", sig, replica=idx)
        self._pressured &= set(reps)

        # while a rollout runs the judge owns the round: a scale verb
        # would spoil the canary-against-stable comparison
        if self._fleet.canary is not None:
            self._judge_round(sig)
            return list(self._decisions)[before:]
        self._judge = None

        # rungs 3 and 4: hysteresis, then the scale verbs
        hot = (sig["burn"] >= cfg.burn_high
               or sig["queue_depth"] >= cfg.queue_high)
        idle = (sig["burn"] <= cfg.burn_low
                and sig["queue_depth"] <= cfg.queue_low)
        if hot:
            self._hot_rounds += 1
            self._idle_rounds = 0
        elif idle:
            self._idle_rounds += 1
            self._hot_rounds = 0
        else:
            self._hot_rounds = 0
            self._idle_rounds = 0

        if (self._hot_rounds >= cfg.hold_rounds
                and sig["replicas"] < cfg.max_replicas
                and self._cooldown_ok()):
            idx = self._fleet.attach_replica(
                warm_prompt=self.warm_prompt,
                warm_tokens=cfg.warm_tokens,
                signals={"burn": round(sig["burn"], 4),
                         "queue_depth": round(sig["queue_depth"], 2)})
            self.scale_ups += 1
            self._last_scale = self._clock()
            self._hot_rounds = 0
            self._record("scale_up", sig, replica=idx,
                         hold_rounds=cfg.hold_rounds)
        elif (self._idle_rounds >= cfg.idle_rounds
                and sig["admitting"] > cfg.min_replicas
                and self._cooldown_ok()):
            victim = self._scale_down_pick(sig)
            if victim is not None:
                # the detached engine's count of unexpected compiles
                # rides into the decision: scale-down must not hide a
                # replica that compiled during serving
                compiles = getattr(
                    getattr(victim.engine, "compile_watch", None),
                    "unexpected", 0)
                self._fleet.detach_replica(
                    victim.idx,
                    signals={"burn": round(sig["burn"], 4),
                             "queue_depth":
                                 round(sig["queue_depth"], 2)})
                self.scale_downs += 1
                self._last_scale = self._clock()
                self._idle_rounds = 0
                self._record("scale_down", sig, replica=victim.idx,
                             idle_rounds=cfg.idle_rounds,
                             unexpected_compiles=compiles)
        return list(self._decisions)[before:]

    def _scale_down_pick(self, sig: dict):
        """The least loaded admitting replica: never one that is draining
        (it is leaving already), never an unhealthy one (removing it is
        supervision's call), never the canary."""
        canary = self._fleet.canary
        canary_idx = canary["replica"] if canary else None
        cands = [r for r in self._fleet.replicas
                 if not r.draining and r.healthy()
                 and r.idx != canary_idx]
        if len(cands) <= self.config.min_replicas:
            return None
        return min(cands,
                   key=lambda r: (sig["per_replica"]
                                  .get(r.idx, {}).get("load", 0),
                                  -r.idx))

    def _judge_round(self, sig: dict) -> None:
        canary = self._fleet.canary
        if canary is None:
            return
        if self._judge is None or \
                self._judge.canary_idx != canary["replica"]:
            # a rollout begun through the fleet's verb (not
            # rolling_restart below) arms the judge when first seen
            self._judge = CanaryJudge(
                self._fleet, self.canary_config or CanaryConfig(
                    enabled=True), canary["replica"],
                clock=self._clock)
            self._record("canary_armed", sig,
                         replica=canary["replica"],
                         version=canary["version"],
                         split_pct=canary["split_pct"])
            return
        v = self._judge.verdict()
        cfg = self._judge.cfg
        # the routed floor gates both verdicts: a breach rolls back as
        # soon as the canary has taken enough traffic, and a clean verdict
        # waits for the soak as well
        if v["canary_routed"] < cfg.min_requests:
            return
        if not v["ready"] and v["healthy"]:
            return  # still soaking
        verdict_fields = {k: v[k] for k in v
                          if k not in ("ready", "healthy")}
        if v["healthy"]:
            self._fleet.promote_canary(verdict=verdict_fields)
            self.promotions += 1
            self._record("canary_promote", sig,
                         replica=canary["replica"],
                         version=canary["version"], **verdict_fields)
        else:
            self._fleet.rollback_canary(verdict=verdict_fields)
            self.rollbacks += 1
            self._record("canary_rollback", sig,
                         replica=canary["replica"],
                         version=canary["version"], **verdict_fields)
        self._judge = None
        self._last_scale = self._clock()

    # ----------------------------------------------------------- rollout

    def rolling_restart(self, new_version,
                        timeout: Optional[float] = None):
        """Deploy ``new_version``. With a canary policy: attach one canary
        replica at the new version, arm the split and the judge (a later
        ``step()`` decides), and return the canary's index. Without one:
        the fleet's unjudged drain-swap of every replica (returns each
        drain's result)."""
        if self.canary_config is None:
            return self._fleet.rolling_restart(
                timeout, new_model_version=new_version)
        with self._lock:
            idx = self._fleet.begin_canary(
                new_version, self.canary_config.split_pct,
                warm_prompt=self.warm_prompt,
                warm_tokens=self.config.warm_tokens)
            self._judge = CanaryJudge(self._fleet, self.canary_config,
                                      idx, clock=self._clock)
            sig = self._signals()
            self._record("canary_begin", sig, replica=idx,
                         version=str(new_version),
                         split_pct=self.canary_config.split_pct)
        return idx

    # ------------------------------------------------------ observability

    def snapshot(self) -> dict:
        """The controller's state for ``GET /v2/debug/fleet`` (the
        ``autoscale`` block) and the ``client_tpu_autoscale_*`` /
        ``client_tpu_canary_*`` families: the policy, the last signals,
        the ladder's state and the decision ring."""
        with self._lock:
            judge = (self._judge.snapshot()
                     if self._judge is not None else None)
            return {
                "enabled": True,
                "burn_high": self.config.burn_high,
                "burn_low": self.config.burn_low,
                "queue_high": self.config.queue_high,
                "queue_low": self.config.queue_low,
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
                "hold_rounds": self.config.hold_rounds,
                "idle_rounds": self.config.idle_rounds,
                "cooldown_s": self.config.cooldown_s,
                "rounds": self.rounds,
                "hot_rounds": self._hot_rounds,
                "idle_rounds_now": self._idle_rounds,
                "cooldown_active": not self._cooldown_ok(),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "pressure_events": self.pressure_events,
                "pressured_replicas": sorted(self._pressured),
                "steer_flips": sum(c.flips
                                   for c in self._steer.values()),
                "promotions": self.promotions,
                "rollbacks": self.rollbacks,
                "last_signals": dict(self._last_signals),
                "decisions": list(self._decisions),
                "history": dict(self.history.snapshot(),
                                recent=self.history.window(16)),
                "burn_suppressed": self._burn_suppressed,
                "canary_policy": (None if self.canary_config is None
                                  else self.canary_config.to_json()),
                "judge": judge,
            }

    # ----------------------------------------------------------- threading

    def start(self) -> None:
        """Start the background control thread at ``interval_s``; a no-op
        at interval 0 (rounds by hand) or when it already runs."""
        if self.config.interval_s <= 0 or self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.interval_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001
                    # a failed actuation is logged and tried again next
                    # round; the loop neither dies nor takes the server
                    # down
                    log.exception("autoscale step failed")

        self._thread = threading.Thread(
            target=loop, name="fleet-autoscale", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None
