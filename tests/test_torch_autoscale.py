"""The fleet autoscaler and the canary judge of the port
(``client_tpu_torch/server/autoscale.py``), on the CPU, held against the
JAX package's.

- Controller parity over stub engines: one scripted stub engine (the
  reference test's, ``tests/test_autoscale.py``), each package's
  ``ReplicaFleet`` over it and each package's ``FleetController`` driven
  by the same script under the same injected clock. Every scenario of the
  reference's test classes (resolve, scale up, scale down, cooldown and
  pressure, verb races, the canary judge, observability) runs on both
  packages with the reference's assertions, and the decision ring, the
  ``snapshot()``, every ``verdict()`` the judge gives, the fleet's
  lifecycle events and the returned decisions are equal field for field
  (the wall-clock ``ns`` stamps left out). The bad-knob errors carry the
  same words; the fault injector's ``match`` narrowing answers alike.
- Metrics parity: the ``client_tpu_autoscale_*`` / ``client_tpu_canary_*``
  families rendered from equal snapshots are the reference's lines, and
  the reference's lint (``scripts/check_metrics_names.py:check``) returns
  ``[]``, on the registry and on a served ``/metrics``.
- Real engines at a tiny width (2 layers, paged, f32, ``device="cpu"``,
  the JAX fleet's weights through ``params_from_jax``): the port's
  ``make_replica_fleet(autoscale=..., canary=...)`` scales 1 -> 2 under a
  queue held by gating replica 0's dispatch and back to 1 once idle; a
  ``kernel_delay`` fault matched to the canary's engine name rolls the
  rollout back and a clean one promotes it; the background thread
  attaches and stops. Zero failed streams, and every greedy stream equals
  the reference fleet's for the same prompt.

Tolerance: decisions, snapshots, verdicts, events, metric lines and
tokens exact.
"""

import json
import os
import sys
import threading
import time
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.server import autoscale as jas
from client_tpu.server import config as jconfig
from client_tpu.server import faultinject as jfi
from client_tpu.server import fleet as jfleet
from client_tpu.server import metrics as jmetrics
from client_tpu.server import trace as jtrace
from client_tpu.server.types import ServerError as JServerError
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import autoscale as tas
from client_tpu_torch.server import config as tconfig
from client_tpu_torch.server import faultinject as tfi
from client_tpu_torch.server import fleet as tfleet
from client_tpu_torch.server import metrics as tmetrics
from client_tpu_torch.server import trace as ttrace
from client_tpu_torch.server.types import ServerError as TServerError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_metrics_names  # noqa: E402  (the reference's lint)

PKGS = {
    "ref": SimpleNamespace(autoscale=jas, config=jconfig, fleet=jfleet,
                           metrics=jmetrics, trace=jtrace, fi=jfi,
                           ServerError=JServerError),
    "port": SimpleNamespace(autoscale=tas, config=tconfig, fleet=tfleet,
                            metrics=tmetrics, trace=ttrace, fi=tfi,
                            ServerError=TServerError),
}
N_BUCKETS = len(tmetrics.DEFAULT_BUCKETS_S) + 1
assert tmetrics.DEFAULT_BUCKETS_S == jmetrics.DEFAULT_BUCKETS_S


# ------------------------------------------------ the reference's stubs

class _Stats:
    """Scripted SLO plane: the controller only reads the scalar."""

    def __init__(self):
        self.burn = 0.0

    def max_class_burn(self):
        return self.burn


class _StubEngine:
    """The engine surface the autoscaler consumes, fully scripted (the
    reference test's stub): burn, load, health, the preempt-pressure
    setter and, optionally, TTFT and goodput snapshots for the judge."""

    def __init__(self, name="stub"):
        self.name = name
        self.load = 0
        self.alive = True
        self.slo_stats = _Stats()
        self.preempt_sets: list = []
        self.compile_watch = SimpleNamespace(unexpected=0)
        self.drained = 0
        self.drain_gate = None  # threading.Event to block drain on
        self.ttft_counts = None  # list[int] to serve via snapshot
        self.mfu = None
        self.submits = 0

    def load_depth(self):
        return self.load

    def active_slots(self):
        return self.load

    def healthy(self):
        return self.alive

    def submit(self, prompt, budget, **kw):
        self.submits += 1
        return iter(())

    def set_preempt_burn_threshold(self, v=None):
        self.preempt_sets.append(v)

    def generation_snapshot(self):
        if self.ttft_counts is None:
            raise AttributeError("no generation plane scripted")
        counts = list(self.ttft_counts)
        return {"ttft": (counts, 0, sum(counts))}

    @property
    def goodput(self):
        mfu = self.mfu
        return SimpleNamespace(snapshot=lambda: {"mfu": mfu},
                               shares=lambda: (0.0, 0.0))

    def drain(self, timeout=None):
        if self.drain_gate is not None:
            self.drain_gate.wait(5.0)
        self.drained += 1
        return True

    def stop(self):
        self.alive = False

    class _Q:
        @staticmethod
        def qsize():
            return 0

    _pending = _Q()


class _Clock:
    """Injectable monotonic clock: tests advance it explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fleet(P, n=1, version_factory=None, **cfg_kw):
    cfg_kw.setdefault("replicas", n)
    return P.fleet.ReplicaFleet(lambda i: _StubEngine(f"stub/r{i}"),
                                P.config.FleetConfig(**cfg_kw), name="stub",
                                version_factory=version_factory)


def _cfg(P, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("burn_high", 1.0)
    kw.setdefault("burn_low", 0.2)
    kw.setdefault("queue_high", 4)
    kw.setdefault("queue_low", 1)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("hold_rounds", 2)
    kw.setdefault("idle_rounds", 2)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("interval_s", 0.0)
    return P.config.AutoscaleConfig(**kw)


def _canary_cfg(P, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("split_pct", 50)
    kw.setdefault("soak_s", 5.0)
    kw.setdefault("min_requests", 1)
    return P.config.CanaryConfig(**kw)


def _ctl(P, fleet, clock=None, canary=None, **cfg_kw):
    return P.autoscale.FleetController(fleet, _cfg(P, **cfg_kw),
                                       canary=canary,
                                       clock=clock or _Clock())


def _burn(fleet, idx, burn):
    next(r for r in fleet.replicas
         if r.idx == idx).engine.slo_stats.burn = burn


def _strip(x):
    """Drop the wall-clock stamps (``ns``, the canary's ``started_ns``)."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in ("ns", "started_ns")}
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v) for v in x)
    return x


class _Recorder:
    """Steps a controller and records what it returns, and every verdict
    the live judge gives before a round."""

    def __init__(self, ctl):
        self.ctl = ctl
        self.steps = []
        self.verdicts = []

    def step(self):
        judge = self.ctl._judge
        if judge is not None:
            self.verdicts.append(judge.verdict())
        out = self.ctl.step()
        self.steps.append(out)
        return out

    def observe(self, fleet, **extra):
        snap = fleet.fleet_snapshot()
        return _strip({
            "steps": self.steps, "verdicts": self.verdicts,
            "snapshot": self.ctl.snapshot(),
            "lifecycle": snap["lifecycle_events"],
            "canary": fleet.canary, "version": snap["version"],
            "replicas": [(r.idx, r.draining, fleet.replica_version(r.idx))
                         for r in fleet.replicas],
            **extra})


# ----------------------------------------------------- config resolution

@pytest.mark.parametrize("kw", [
    {"burn_low": 1.0, "burn_high": 1.0},
    {"burn_low": -0.1},
    {"queue_low": 4, "queue_high": 4},
    {"min_replicas": 0},
    {"min_replicas": 3, "max_replicas": 2},
    {"hold_rounds": 0},
    {"idle_rounds": 0},
    {"cooldown_s": -1.0},
    {"pressure_preempt_threshold": -0.5},
    {"warm_tokens": 0},
    {"interval_s": -1.0},
])
def test_bad_autoscale_knobs_raise_the_reference_words(kw):
    errs = {}
    for side, P in PKGS.items():
        with pytest.raises(ValueError) as ei:
            P.autoscale.resolve_autoscale(_cfg(P, **kw))
        errs[side] = str(ei.value)
    assert errs["port"] == errs["ref"]


@pytest.mark.parametrize("kw", [
    {"split_pct": 0},
    {"split_pct": 101},
    {"soak_s": 0.0},
    {"min_requests": 0},
    {"burn_ratio_max": 0.0},
    {"ttft_p95_ratio_max": -1.0},
    {"burn_abs_max": -0.1},
    {"mfu_ratio_min": 1.5},
])
def test_bad_canary_knobs_raise_the_reference_words(kw):
    errs = {}
    for side, P in PKGS.items():
        with pytest.raises(ValueError) as ei:
            P.autoscale.resolve_canary(_canary_cfg(P, **kw))
        errs[side] = str(ei.value)
    assert errs["port"] == errs["ref"]


@pytest.mark.parametrize("call", [
    lambda P: P.autoscale.resolve_autoscale({"burn_hi": 2.0}),
    lambda P: P.autoscale.resolve_canary({"split": 5}),
    lambda P: P.autoscale.resolve_autoscale("yes"),
    lambda P: P.autoscale.resolve_canary(3),
    lambda P: P.autoscale.FleetController(_fleet(P, 1),
                                          P.config.AutoscaleConfig()),
], ids=["autoscale_key", "canary_key", "autoscale_type", "canary_type",
        "disabled_controller"])
def test_refusals_match_the_reference(call):
    errs = {}
    for side, P in PKGS.items():
        with pytest.raises(ValueError) as ei:
            call(P)
        errs[side] = str(ei.value)
    assert errs["port"] == errs["ref"]


def test_resolution_and_config_blocks_equal_the_reference():
    for P in PKGS.values():
        a = P.autoscale
        assert a.resolve_autoscale(None) is None
        assert a.resolve_autoscale(P.config.AutoscaleConfig()) is None
        assert a.resolve_canary(None) is None
        assert a.resolve_canary(P.config.CanaryConfig()) is None
        assert a.resolve_autoscale(True).enabled
        got = a.resolve_autoscale({"burn_high": 2.0})
        assert got.enabled and got.burn_high == 2.0
        assert a.resolve_canary({"split_pct": 5}).split_pct == 5
    assert tconfig.AutoscaleConfig().to_json() == \
        jconfig.AutoscaleConfig().to_json()
    assert tconfig.CanaryConfig().to_json() == \
        jconfig.CanaryConfig().to_json()
    blocks = {}
    for side, P in PKGS.items():
        j = P.config.ModelConfig(name="m", autoscale=_cfg(P),
                                 canary=_canary_cfg(P)).to_json()
        assert j["autoscale"]["burn_high"] == 1.0
        assert j["canary"]["split_pct"] == 50
        blocks[side] = (j["autoscale"], j["canary"])
    assert blocks["port"] == blocks["ref"]
    assert tas.DECISION_RING_CAP == jas.DECISION_RING_CAP == 64


@pytest.mark.parametrize("counts,q", [
    ([0] * N_BUCKETS, 0.95), ([0, 0, 0, 100] + [0] * (N_BUCKETS - 4), 0.95),
    ([0, 0, 0, 100] + [0] * (N_BUCKETS - 5) + [10000], 0.95),
    ([5] * N_BUCKETS, 0.5), ([1] + [0] * (N_BUCKETS - 1), 0.99)])
def test_hist_quantile_equals_the_reference(counts, q):
    assert tas._hist_quantile(counts, q) == jas._hist_quantile(counts, q)


# ---------------------------------------- the ladder, scenario for scenario
# Each scenario is a test of tests/test_autoscale.py, run on one package
# with the reference's assertions; it returns what the run observed.


def sc_sustained_burn_attaches_a_replica(P):
    fleet = _fleet(P, 1)
    rec = _Recorder(_ctl(P, fleet))
    _burn(fleet, 0, 2.0)
    assert rec.step() is not None and len(fleet.replicas) == 1
    decisions = rec.step()  # hold_rounds=2: second hot round fires
    assert len(fleet.replicas) == 2
    assert rec.ctl.scale_ups == 1
    up = next(d for d in decisions if d["action"] == "scale_up")
    assert up["burn"] == 2.0 and up["replicas"] == 1
    return rec.observe(fleet)


def sc_queue_depth_alone_scales_up(P):
    fleet = _fleet(P, 1)
    rec = _Recorder(_ctl(P, fleet))
    fleet.replicas[0].engine.load = 10
    rec.step()
    rec.step()
    assert len(fleet.replicas) == 2 and rec.ctl.scale_ups == 1
    return rec.observe(fleet)


def sc_one_hot_round_is_not_enough(P):
    fleet = _fleet(P, 1)
    rec = _Recorder(_ctl(P, fleet, hold_rounds=2))
    for _ in range(4):
        _burn(fleet, 0, 2.0)
        rec.step()
        _burn(fleet, 0, 0.5)  # dead zone: streaks reset
        rec.step()
    assert len(fleet.replicas) == 1 and rec.ctl.scale_ups == 0
    return rec.observe(fleet)


def sc_max_replicas_bound(P):
    fleet = _fleet(P, 3)
    rec = _Recorder(_ctl(P, fleet, max_replicas=3, cooldown_s=0.0))
    for idx in (0, 1, 2):
        _burn(fleet, idx, 2.0)
    for _ in range(6):
        rec.step()
    assert len(fleet.replicas) == 3 and rec.ctl.scale_ups == 0
    return rec.observe(fleet)


def sc_scale_up_event_rides_the_lifecycle_ring(P):
    fleet = _fleet(P, 1)
    rec = _Recorder(_ctl(P, fleet))
    _burn(fleet, 0, 2.0)
    rec.step()
    rec.step()
    ev = fleet.fleet_snapshot()["lifecycle_events"][-1]
    assert ev["event"] == P.trace.FLEET_SCALE
    assert ev["verb"] == "attach_replica"
    assert ev["burn"] == 2.0
    return rec.observe(fleet)


def sc_sustained_idle_detaches_least_loaded(P):
    fleet = _fleet(P, 3)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, idle_rounds=2, cooldown_s=0.0))
    fleet.replicas[0].engine.load = 1
    fleet.replicas[1].engine.load = 0  # the victim
    fleet.replicas[2].engine.load = 1
    rec.step()
    decisions = rec.step()
    assert [r.idx for r in fleet.replicas] == [0, 2]
    down = next(d for d in decisions if d["action"] == "scale_down")
    assert down["replica"] == 1
    assert down["unexpected_compiles"] == 0
    assert fleet.replicas[0].engine.drained == 0  # victim only
    return rec.observe(fleet)


def sc_min_replicas_floor(P):
    fleet = _fleet(P, 1)
    rec = _Recorder(_ctl(P, fleet, idle_rounds=1, cooldown_s=0.0))
    for _ in range(4):
        rec.step()
    assert len(fleet.replicas) == 1 and rec.ctl.scale_downs == 0
    return rec.observe(fleet)


def sc_scale_down_never_picks_a_draining_replica(P):
    fleet = _fleet(P, 3)
    rec = _Recorder(_ctl(P, fleet, idle_rounds=1, cooldown_s=0.0))
    fleet.replicas[0].draining = True
    fleet.replicas[0].engine.load = 0  # loads would pick it
    fleet.replicas[1].engine.load = 1
    fleet.replicas[2].engine.load = 0
    rec.step()
    assert [r.idx for r in fleet.replicas] == [0, 1]
    assert fleet.replicas[0].draining  # untouched
    return rec.observe(fleet)


def sc_detach_refusals_are_409(P):
    out = []
    fleet = _fleet(P, 2)
    fleet.replicas[0].draining = True
    with pytest.raises(P.ServerError) as ei:
        fleet.detach_replica(0)
    assert ei.value.status == 409
    out.append(str(ei.value))
    fleet = _fleet(P, 2)
    fleet.replicas[1].engine.alive = False
    with pytest.raises(P.ServerError) as ei:
        fleet.detach_replica(0)
    assert ei.value.status == 409
    assert "last admitting" in str(ei.value)
    out.append(str(ei.value))
    return out


def sc_cooldown_suppresses_flapping(P):
    fleet = _fleet(P, 1)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, hold_rounds=1, idle_rounds=1,
                         cooldown_s=10.0))
    _burn(fleet, 0, 2.0)
    rec.step()
    assert len(fleet.replicas) == 2 and rec.ctl.scale_ups == 1
    for r in fleet.replicas:
        r.engine.slo_stats.burn = 0.0
        r.engine.load = 0
    for _ in range(5):
        rec.step()
    assert len(fleet.replicas) == 2 and rec.ctl.scale_downs == 0
    inside = rec.ctl.snapshot()
    assert inside["cooldown_active"]
    clock.t = 11.0
    rec.step()
    assert len(fleet.replicas) == 1 and rec.ctl.scale_downs == 1
    return rec.observe(fleet, inside=inside)


def sc_pressure_rung_engages_and_releases_per_replica(P):
    fleet = _fleet(P, 2)
    rec = _Recorder(_ctl(P, fleet, pressure_preempt_threshold=0.4,
                         hold_rounds=99))
    _burn(fleet, 0, 2.0)
    rec.step()
    e0 = fleet.replicas[0].engine
    e1 = fleet.replicas[1].engine
    assert e0.preempt_sets == [0.4]
    assert e1.preempt_sets == []
    assert rec.ctl.snapshot()["pressured_replicas"] == [0]
    _burn(fleet, 0, 0.5)
    rec.step()
    assert e0.preempt_sets == [0.4]
    _burn(fleet, 0, 0.1)
    rec.step()
    assert e0.preempt_sets == [0.4, None]
    assert rec.ctl.snapshot()["pressured_replicas"] == []
    assert rec.ctl.pressure_events == 1
    return rec.observe(fleet, sets=[e0.preempt_sets, e1.preempt_sets])


def sc_steering_rung_delegates_to_engine_controller(P):
    fleet = _fleet(P, 2)
    eng = fleet.replicas[0].engine
    eng.prefill_token_budget = 64
    eng.fetch_stride = 4
    eng.dispatch_duty = 0.5
    eng.speculation_enabled = True
    eng.set_prefill_token_budget = \
        lambda v: setattr(eng, "prefill_token_budget", v)
    eng.set_fetch_stride = lambda v: setattr(eng, "fetch_stride", v)
    eng.set_dispatch_duty = lambda v: setattr(eng, "dispatch_duty", v)
    eng.set_speculation_enabled = \
        lambda v: setattr(eng, "speculation_enabled", v)
    rec = _Recorder(_ctl(P, fleet, hold_rounds=1, cooldown_s=0.0,
                         max_replicas=2))
    eng.slo_stats.burn = 2.0
    decisions = rec.step()
    assert eng.fetch_stride == 1 and eng.dispatch_duty == 1.0
    assert not eng.speculation_enabled
    assert any(d["action"] == "steer_latency" and d["replica"] == 0
               for d in decisions)
    assert rec.ctl.snapshot()["steer_flips"] == 1
    assert not hasattr(fleet.replicas[1].engine, "fetch_stride")
    # and back once the burn clears for the controller's hold
    eng.slo_stats.burn = 0.0
    for _ in range(3):
        rec.step()
    return rec.observe(fleet, knobs=[eng.prefill_token_budget,
                                     eng.fetch_stride, eng.dispatch_duty,
                                     eng.speculation_enabled])


def sc_attach_during_drain(P):
    fleet = _fleet(P, 2)
    gate = threading.Event()
    fleet.replicas[0].engine.drain_gate = gate
    t = threading.Thread(target=fleet.drain, args=(0,))
    t.start()
    for _ in range(100):
        if fleet.replicas[0].draining:
            break
        threading.Event().wait(0.01)
    try:
        idx = fleet.attach_replica()
        assert idx == 2 and len(fleet.replicas) == 3
        picks = [fleet.route(np.arange(8, dtype=np.int32), f"t{i}").idx
                 for i in range(12)]
        assert 0 not in picks and 2 in picks
    finally:
        gate.set()
        t.join(timeout=5.0)
    return {"picks": picks,
            "lifecycle": _strip(fleet.fleet_snapshot()["lifecycle_events"])}


def sc_rollback_races_stable_crash(P):
    fleet = _fleet(P, 3)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock,
                         canary=_canary_cfg(P, burn_abs_max=0.5),
                         hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    _burn(fleet, cidx, 2.0)
    with fleet._lock:
        fleet._canary["routed"] = 1
    fleet.replicas[1].engine.alive = False
    clock.t = 100.0
    decisions = rec.step()
    assert any(d["action"] == "canary_rollback" for d in decisions)
    assert rec.ctl.rollbacks == 1
    assert fleet.canary is None
    assert [r.idx for r in fleet.replicas] == [0, 1, 2]
    assert cidx == 3
    kinds = [e["event"] for e in fleet.fleet_snapshot()["lifecycle_events"]]
    assert P.trace.CANARY_ROLLBACK in kinds
    return rec.observe(fleet)


def sc_rollback_with_no_admitting_stable_is_409(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock,
                         canary=_canary_cfg(P, burn_abs_max=0.5),
                         hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    for r in fleet.replicas:
        if r.idx != cidx:
            r.engine.alive = False
    _burn(fleet, cidx, 2.0)
    clock.t = 100.0
    with pytest.raises(P.ServerError) as ei:
        fleet.rollback_canary()
    assert ei.value.status == 409
    return rec.observe(fleet, error=str(ei.value))


def _counts(fast=0, slow=0):
    """A TTFT histogram: ``fast`` samples in the lowest bucket, ``slow``
    in the highest finite bucket."""
    c = [0] * N_BUCKETS
    c[0] = fast
    c[N_BUCKETS - 2] = slow
    return c


def sc_not_ready_before_soak_or_min_requests(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock,
                         canary=_canary_cfg(P, soak_s=5.0, min_requests=2),
                         hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    assert rec.step() == []
    clock.t = 6.0
    assert rec.step() == []
    assert fleet.canary is not None and rec.ctl.promotions == 0
    mid = rec.ctl.snapshot()
    with fleet._lock:
        fleet._canary["routed"] = 2
    decisions = rec.step()
    assert any(d["action"] == "canary_promote" for d in decisions)
    assert fleet.canary is None and cidx in [r.idx for r in fleet.replicas]
    return rec.observe(fleet, mid=mid)


def sc_burn_breach_rolls_back_immediately(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, soak_s=1000.0, burn_abs_max=0.5), hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    _burn(fleet, cidx, 0.9)
    with fleet._lock:
        fleet._canary["routed"] = 1
    decisions = rec.step()
    rb = next(d for d in decisions if d["action"] == "canary_rollback")
    assert "burn" in " ".join(rb["reasons"])
    assert len(fleet.replicas) == 2 and fleet.canary is None
    return rec.observe(fleet)


def sc_breach_needs_evidence_floor(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, soak_s=1000.0, burn_abs_max=0.5, min_requests=2),
        hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    _burn(fleet, cidx, 0.9)
    assert rec.step() == []
    assert fleet.canary is not None and rec.ctl.rollbacks == 0
    with fleet._lock:
        fleet._canary["routed"] = 2
    decisions = rec.step()
    assert any(d["action"] == "canary_rollback" for d in decisions)
    return rec.observe(fleet)


def sc_burn_ratio_gate_vs_stable(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, burn_ratio_max=1.5, burn_abs_max=10.0), hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    _burn(fleet, 0, 0.4)
    _burn(fleet, cidx, 0.9)
    with fleet._lock:
        fleet._canary["routed"] = 1
    clock.t = 100.0
    decisions = rec.step()
    rb = next(d for d in decisions if d["action"] == "canary_rollback")
    assert any("1.5x stable" in r for r in rb["reasons"])
    return rec.observe(fleet)


def sc_ttft_gate_uses_soak_deltas_not_history(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    stable = fleet.replicas[0].engine
    stable.ttft_counts = _counts(fast=0, slow=1000)
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, ttft_p95_ratio_max=2.0), hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    canary_eng = next(r for r in fleet.replicas if r.idx == cidx).engine
    stable.ttft_counts = [a + b for a, b in zip(
        stable.ttft_counts, _counts(fast=200))]
    canary_eng.ttft_counts = _counts(slow=50)
    with fleet._lock:
        fleet._canary["routed"] = 5
    clock.t = 100.0
    decisions = rec.step()
    rb = next(d for d in decisions if d["action"] == "canary_rollback")
    assert any("ttft" in r for r in rb["reasons"])
    assert rb["stable_ttft_p95_s"] == tmetrics.DEFAULT_BUCKETS_S[0]
    return rec.observe(fleet)


def sc_ttft_gate_excludes_canary_warm_stream(P):
    def factory(i, v):
        eng = _StubEngine(f"fleet/r{i}")
        eng.ttft_counts = _counts(slow=1)  # the warm sample
        return eng

    fleet = _fleet(P, 2, version_factory=factory)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, ttft_p95_ratio_max=2.0), hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    canary_eng = next(r for r in fleet.replicas if r.idx == cidx).engine
    fleet.replicas[0].engine.ttft_counts = _counts(fast=100)
    canary_eng.ttft_counts = [a + b for a, b in zip(
        canary_eng.ttft_counts, _counts(fast=100))]
    with fleet._lock:
        fleet._canary["routed"] = 5
    clock.t = 100.0
    decisions = rec.step()
    pr = next(d for d in decisions if d["action"] == "canary_promote")
    assert pr["canary_ttft_p95_s"] == tmetrics.DEFAULT_BUCKETS_S[0]
    return rec.observe(fleet)


def sc_no_promote_without_completed_canary_request(P):
    def factory(i, v):
        eng = _StubEngine(f"fleet/r{i}")
        eng.ttft_counts = _counts()  # plane present, 0 samples
        return eng

    fleet = _fleet(P, 2, version_factory=factory)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock,
                         canary=_canary_cfg(P, min_requests=2),
                         hold_rounds=99))
    rec.ctl.rolling_restart("v2")
    with fleet._lock:
        fleet._canary["routed"] = 5
    clock.t = 100.0
    assert rec.step() == []
    assert fleet.canary is not None and rec.ctl.promotions == 0
    return rec.observe(fleet)


def sc_mfu_gate_skipped_when_unmeasurable(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, mfu_ratio_min=0.9), hold_rounds=99))
    rec.ctl.rolling_restart("v2")
    with fleet._lock:
        fleet._canary["routed"] = 5
    clock.t = 100.0
    decisions = rec.step()
    assert any(d["action"] == "canary_promote" for d in decisions)
    return rec.observe(fleet)


def sc_mfu_gate_enforced_when_both_measure(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, mfu_ratio_min=0.9), hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    fleet.replicas[0].engine.mfu = 0.5
    next(r for r in fleet.replicas if r.idx == cidx).engine.mfu = 0.2
    with fleet._lock:
        fleet._canary["routed"] = 5
    clock.t = 100.0
    decisions = rec.step()
    rb = next(d for d in decisions if d["action"] == "canary_rollback")
    assert any("mfu" in r for r in rb["reasons"])
    return rec.observe(fleet)


def sc_promote_drain_swaps_stable_onto_new_version(P):
    built = []

    def vf(i, v):
        built.append((i, v))
        return _StubEngine(f"stub/r{i}@{v}")

    fleet = _fleet(P, 2, version_factory=vf)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(P),
                         hold_rounds=99))
    cidx = rec.ctl.rolling_restart("v2")
    assert built[-1] == (cidx, "v2")
    with fleet._lock:
        fleet._canary["routed"] = 5
    clock.t = 100.0
    rec.step()
    snap = fleet.fleet_snapshot()
    assert snap["version"] == "v2"
    assert all(row["version"] == "v2" for row in snap["rows"])
    assert built.count((0, "v2")) == 1 and built.count((1, "v2")) == 1
    kinds = [e["event"] for e in snap["lifecycle_events"]]
    assert P.trace.CANARY_PROMOTE in kinds
    return rec.observe(fleet, built=built)


def sc_one_rollout_at_a_time(P):
    fleet = _fleet(P, 2)
    rec = _Recorder(_ctl(P, fleet, _Clock(), canary=_canary_cfg(P),
                         hold_rounds=99))
    rec.ctl.rolling_restart("v2")
    with pytest.raises(P.ServerError) as ei:
        fleet.begin_canary("v3", 10)
    assert ei.value.status == 409
    return rec.observe(fleet, error=str(ei.value))


def sc_scaling_holds_during_rollout(P):
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(
        P, soak_s=1000.0, burn_abs_max=10.0, burn_ratio_max=10.0),
        hold_rounds=1, cooldown_s=0.0, max_replicas=5))
    rec.ctl.rolling_restart("v2")
    for r in fleet.replicas:
        r.engine.slo_stats.burn = 2.0
    before = len(fleet.replicas)
    for _ in range(4):
        rec.step()
    assert len(fleet.replicas) == before and rec.ctl.scale_ups == 0
    return rec.observe(fleet)


def sc_judge_armed_on_a_fleet_verb(P):
    """A rollout begun through the fleet's verb (not rolling_restart)
    arms the judge when the controller first sees it; without a canary
    policy the judge runs the default gates."""
    fleet = _fleet(P, 2)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, hold_rounds=99))
    cidx = fleet.begin_canary("v7", 25)
    rec.step()                        # canary_armed
    with fleet._lock:
        fleet._canary["routed"] = 9
    clock.t = 3.0
    rec.step()                        # soaking (default soak 5 s)
    clock.t = 9.0
    rec.step()                        # promote
    assert rec.ctl.promotions == 1 and cidx == 2
    return rec.observe(fleet)


def sc_unjudged_rolling_restart_without_canary_policy(P):
    fleet = _fleet(P, 2)
    rec = _Recorder(_ctl(P, fleet, hold_rounds=99))
    out = rec.ctl.rolling_restart("v9")
    assert fleet.canary is None
    return rec.observe(fleet, drains=out)


def sc_decision_ring_is_bounded(P):
    fleet = _fleet(P, 2)
    rec = _Recorder(_ctl(P, fleet, pressure_preempt_threshold=0.4,
                         hold_rounds=99))
    for _ in range(P.autoscale.DECISION_RING_CAP + 20):
        _burn(fleet, 0, 2.0)
        rec.step()
        _burn(fleet, 0, 0.0)
        rec.step()
    ring = rec.ctl.snapshot()["decisions"]
    assert len(ring) == P.autoscale.DECISION_RING_CAP
    assert ring[-1]["action"] == "pressure_off"
    return rec.observe(fleet)


def sc_snapshot_shape(P):
    fleet = _fleet(P, 1)
    rec = _Recorder(_ctl(P, fleet, canary=_canary_cfg(P)))
    rec.step()
    snap = rec.ctl.snapshot()
    assert snap["enabled"] and snap["rounds"] == 1
    assert snap["last_signals"]["replicas"] == 1
    assert snap["last_signals"]["per_replica"][0]["burn"] == 0.0
    assert snap["canary_policy"]["split_pct"] == 50
    assert snap["judge"] is None
    return rec.observe(fleet)


def sc_watchdog_burn_spike_suppressed_while_a_canary_runs(P):
    calls = []

    def factory(i, v=None):
        eng = _StubEngine(f"stub/r{i}")
        eng.watchdog_suppress = lambda det, on, i=i: calls.append(
            (i, det, on))
        return eng

    fleet = P.fleet.ReplicaFleet(factory, P.config.FleetConfig(replicas=2),
                                 name="stub", version_factory=factory)
    clock = _Clock()
    rec = _Recorder(_ctl(P, fleet, clock, canary=_canary_cfg(P),
                         hold_rounds=99))
    rec.step()                        # nothing to suppress yet
    rec.ctl.rolling_restart("v2")
    rec.step()
    assert rec.ctl.snapshot()["burn_suppressed"]
    with fleet._lock:
        fleet._canary["routed"] = 5
    clock.t = 100.0
    rec.step()                        # promote: the canary settles
    rec.step()                        # re-armed once
    rec.step()                        # then left alone
    assert not rec.ctl.snapshot()["burn_suppressed"]
    return rec.observe(fleet, calls=calls)


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_matches_the_reference(name):
    got = {side: SCENARIOS[name](P) for side, P in PKGS.items()}
    assert got["port"] == got["ref"]


# --------------------------------------------- per-engine fault narrowing

@pytest.mark.parametrize("side", ["ref", "port"])
def test_fault_match_narrows_to_context(side):
    fi = PKGS[side].fi
    inj = fi.FaultInjector(seed=0)
    inj.arm([{"point": "kernel_delay", "after": 1, "times": 1,
              "match": {"engine": "fleet/r2"}}])
    for _ in range(10):
        assert inj.check("kernel_delay", engine="fleet/r0") is None
    assert inj.check("kernel_delay", engine="fleet/r2") is None
    spec = inj.check("kernel_delay", engine="fleet/r2")
    assert spec is not None and spec.fired == 1
    assert inj.check("kernel_delay", engine="fleet/r2") is None
    inj = fi.FaultInjector(seed=0)
    inj.arm([{"point": "kernel_delay", "match": {"engine": "fleet/r1"}}])
    assert inj.check("kernel_delay") is None
    assert inj.snapshot()["specs"][0]["match"] == {"engine": "fleet/r1"}
    with pytest.raises(ValueError, match="match"):
        fi.FaultSpec(point="kernel_delay", match=[("engine", "x")])


# ------------------------------------------------------------ the metrics

def _families(text: str) -> list:
    return [ln for ln in text.splitlines()
            if "client_tpu_autoscale_" in ln or "client_tpu_canary_" in ln]


def _render(P, snap):
    reg = P.metrics.MetricsRegistry()
    P.metrics._collect_fleet(reg, [("m", "1", snap)])
    P.metrics._collect_autoscale(reg, [("m", "1", snap)])
    return reg.render()


def sc_metrics_families(P):
    fleet = _fleet(P, 2)
    ctl = _ctl(P, fleet, _Clock(), hold_rounds=1, cooldown_s=0.0)
    _burn(fleet, 0, 2.0)
    ctl.step()                      # scale_up + pressure_on
    snap = fleet.fleet_snapshot()
    snap["autoscale"] = ctl.snapshot()
    return _render(P, snap)


def sc_canary_metrics(P):
    fleet = _fleet(P, 2)
    ctl = _ctl(P, fleet, _Clock(), canary=_canary_cfg(P, split_pct=25),
               hold_rounds=99)
    ctl.rolling_restart("v2")
    with fleet._lock:
        fleet._canary["routed"] = 3
    snap = fleet.fleet_snapshot()
    snap["autoscale"] = ctl.snapshot()
    return _render(P, snap)


@pytest.mark.parametrize("scenario", [sc_metrics_families,
                                      sc_canary_metrics],
                         ids=["autoscale", "canary"])
def test_metric_families_equal_the_reference_and_lint(scenario):
    text = {side: scenario(P) for side, P in PKGS.items()}
    assert check_metrics_names.check(text["port"]) == []
    assert _families(text["port"]) == _families(text["ref"])
    if scenario is sc_metrics_families:
        assert 'client_tpu_autoscale_replica_burn{model="m",' \
            'version="1",replica="0"} 2' in text["port"]
        assert 'client_tpu_autoscale_replica_pressured{model="m",' \
            'version="1",replica="0"} 1' in text["port"]
        assert 'client_tpu_canary_active{model="m",version="1"} 0' \
            in text["port"]
    else:
        assert 'client_tpu_canary_split_pct{model="m",' \
            'version="1"} 25' in text["port"]
        assert 'client_tpu_canary_routed_total{model="m",' \
            'version="1"} 3' in text["port"]


# ------------------------------------------------------------ the thread

@pytest.mark.parametrize("side", ["ref", "port"])
def test_background_thread_runs_and_stops(side):
    P = PKGS[side]
    fleet = _fleet(P, 1)
    ctl = P.autoscale.FleetController(fleet, _cfg(P, interval_s=0.01))
    ctl.start()
    try:
        for _ in range(200):
            if ctl.rounds >= 2:
                break
            threading.Event().wait(0.01)
        assert ctl.rounds >= 2
    finally:
        ctl.stop()
    assert ctl._thread is None
    rounds = ctl.rounds
    threading.Event().wait(0.05)
    assert ctl.rounds == rounds
    manual = _ctl(P, _fleet(P, 1))  # interval_s 0
    manual.start()
    assert manual._thread is None


# ------------------------------------------------ real engines, tiny width

TINY = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, head_dim=8,
            d_ff=32, max_seq=96, causal=True, attn_impl="ref")
KNOBS = dict(n_slots=2, chunk_size=4, max_new_tokens=6, kv_layout="paged",
             prefill_mode="chunked", prefill_chunk=16)
PROMPTS = [(np.arange(5 + 3 * i, dtype=np.int32) * (i + 3)) % 60 + 1
           for i in range(6)]


@pytest.fixture(scope="module")
def tiny():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **TINY)
    jparams = jt.init_params(jax.random.key(1), jcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def ref_tokens(tiny):
    """Each prompt's greedy stream from the reference fleet."""
    jcfg, jparams, _, _ = tiny
    m = jlm.make_replica_fleet("ref_fleet", replicas=1, cfg=jcfg,
                               params=jparams, **KNOBS)
    try:
        return [list(m.fleet.submit(p, 6)) for p in PROMPTS]
    finally:
        m.shutdown()


def _port_fleet(tiny, name, **kw):
    _, _, tcfg, tparams = tiny
    return tlm.make_replica_fleet(name, cfg=tcfg, params=tparams,
                                  device="cpu", **{**KNOBS, **kw})


class _Streams:
    """Consumes fleet streams on threads; records tokens and failures."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.threads = []
        self.tokens = {}
        self.failed = []

    def submit(self, key, prompt, tenant):
        it = self.fleet.submit(prompt, 6, tenant_id=tenant)

        def run():
            try:
                self.tokens[key] = list(it)
            except Exception as e:  # noqa: BLE001 — counted as failed
                self.failed.append((key, repr(e)))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self.threads.append(t)

    def join(self):
        for t in self.threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in self.threads)


def _idle(fleet, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if all(r.engine.load_depth() == 0 for r in fleet.replicas):
            return
        time.sleep(0.01)
    raise AssertionError("fleet did not go idle")


def _gate(engine):
    """Hold ``engine``'s dispatches until the returned event is set."""
    ev = threading.Event()
    inner = engine._dispatch

    def gated(*a, **kw):
        ev.wait(60)
        return inner(*a, **kw)

    engine._dispatch = gated
    return ev


def test_real_fleet_scales_up_under_a_queue_and_down_when_idle(
        tiny, ref_tokens):
    from client_tpu_torch.server import TorchInferenceServer

    m = _port_fleet(tiny, "as_lm", replicas=1, autoscale=dict(
        min_replicas=1, max_replicas=2, queue_high=3, queue_low=0,
        burn_high=1.0, burn_low=0.2, hold_rounds=2, idle_rounds=2,
        cooldown_s=0.0, interval_s=0.0))
    core = TorchInferenceServer()
    core.register_model(m)
    try:
        fleet, ctl = m.fleet, m.autoscaler
        assert m.config.to_json()["autoscale"]["max_replicas"] == 2
        gate = _gate(fleet.replicas[0].engine)
        streams = _Streams(fleet)
        for i in range(4):
            streams.submit(i, PROMPTS[i], f"t{i}")
        assert fleet.replicas[0].engine.load_depth() == 4
        assert ctl.step() == []
        up = ctl.step()
        assert [d["action"] for d in up] == ["scale_up"]
        assert len(fleet.replicas) == 2
        # the new replica is warm and takes traffic at once
        streams.submit(4, PROMPTS[4], "t4")
        streams.submit(5, PROMPTS[5], "t5")
        gate.set()
        streams.join()
        _idle(fleet)
        assert ctl.step() == []
        down = ctl.step()
        assert [d["action"] for d in down] == ["scale_down"]
        assert down[0]["replica"] == 1
        assert down[0]["unexpected_compiles"] == 0
        assert [r.idx for r in fleet.replicas] == [0]
        assert streams.failed == []
        assert [streams.tokens[i] for i in range(6)] == ref_tokens
        verbs = [e["verb"] for e in fleet.fleet_snapshot()[
            "lifecycle_events"] if e["event"] == ttrace.FLEET_SCALE]
        assert verbs == ["attach_replica", "detach_replica"]
        snap = m.fleet_snapshot()["autoscale"]
        assert (snap["scale_ups"], snap["scale_downs"]) == (1, 1)
        assert m.autoscale_snapshot()["rounds"] == 4
        text = core.metrics_text()
        assert check_metrics_names.check(text) == []
        assert 'client_tpu_autoscale_scale_downs_total{model="as_lm",' \
            'version="1"} 1' in text
        assert 'client_tpu_canary_active{model="as_lm",version="1"} 0' \
            in text
    finally:
        core.stop()


def _rollout(m, version, tenants, streams):
    """Open a judged rollout, send ``tenants`` one after another and step
    the controller until it gives a verdict."""
    fleet, ctl = m.fleet, m.autoscaler
    cidx = ctl.rolling_restart(version)
    for i, tenant in enumerate(tenants):
        streams.submit((version, i), PROMPTS[i % len(PROMPTS)], tenant)
        streams.threads[-1].join(timeout=120)
    end = time.monotonic() + 60
    while fleet.canary is not None and time.monotonic() < end:
        ctl.step()
        time.sleep(0.05)
    assert fleet.canary is None
    return cidx


def test_real_canary_rolls_back_under_a_fault_and_promotes_when_clean(
        tiny, ref_tokens):
    canary = dict(split_pct=50, soak_s=0.3, min_requests=2,
                  burn_abs_max=1.0, burn_ratio_max=1.5,
                  ttft_p95_ratio_max=3.0, mfu_ratio_min=0.5)
    m = _port_fleet(tiny, "canary_lm", replicas=2, autoscale=dict(
        min_replicas=2, max_replicas=2, hold_rounds=99, idle_rounds=99,
        cooldown_s=0.0, interval_s=0.0), canary=canary)
    inj = tfi.get_injector()
    try:
        fleet, ctl = m.fleet, m.autoscaler
        assert m.config.to_json()["canary"] == {"enabled": True, **canary}
        streams = _Streams(fleet)
        for i, p in enumerate(PROMPTS[:2]):       # stable history
            streams.submit(("warm", i), p, f"w{i}")
            streams.threads[-1].join(timeout=120)
        # which tenants the 50 % split sends to the canary
        tenants = [f"tenant{i}" for i in range(12)]
        inj.arm([{"point": "kernel_delay", "delay_s": 0.4, "times": 0,
                  "match": {"engine": "canary_lm/r2"}}])
        cidx = _rollout(m, "2", tenants, streams)
        assert cidx == 2 and ctl.rollbacks == 1 and ctl.promotions == 0
        rb = [d for d in ctl.snapshot()["decisions"]
              if d["action"] == "canary_rollback"][0]
        assert any("ttft" in r for r in rb["reasons"])
        assert rb["canary_mfu"] is None and rb["stable_mfu"] is None
        assert [r.idx for r in fleet.replicas] == [0, 1]
        inj.clear()
        cidx = _rollout(m, "3", tenants, streams)
        assert cidx == 3 and ctl.promotions == 1
        snap = fleet.fleet_snapshot()
        assert snap["version"] == "3"
        assert all(row["version"] == "3" for row in snap["rows"])
        kinds = [e["event"] for e in snap["lifecycle_events"]]
        assert ttrace.CANARY_ROLLBACK in kinds
        assert ttrace.CANARY_PROMOTE in kinds
        streams.join()
        assert streams.failed == []
        for key, toks in streams.tokens.items():
            assert toks == ref_tokens[key[1] % len(PROMPTS)], key
        routed = [d["canary_routed"] for d in ctl.snapshot()["decisions"]
                  if d["action"] in ("canary_rollback", "canary_promote")]
        assert all(n >= 2 for n in routed)
    finally:
        inj.clear()
        m.shutdown()


def test_background_thread_attaches_on_a_real_fleet_and_stops(
        tiny, ref_tokens):
    m = _port_fleet(tiny, "bg_lm", replicas=1, autoscale=dict(
        min_replicas=1, max_replicas=2, queue_high=2, queue_low=0,
        hold_rounds=1, idle_rounds=50, cooldown_s=0.0, interval_s=0.02))
    try:
        fleet, ctl = m.fleet, m.autoscaler
        assert ctl._thread is not None and ctl._thread.is_alive()
        gate = _gate(fleet.replicas[0].engine)
        streams = _Streams(fleet)
        for i in range(3):
            streams.submit(i, PROMPTS[i], f"t{i}")
        end = time.monotonic() + 60
        while len(fleet.replicas) < 2 and time.monotonic() < end:
            time.sleep(0.02)
        assert len(fleet.replicas) == 2
        gate.set()
        streams.join()
        assert streams.failed == []
        assert [streams.tokens[i] for i in range(3)] == ref_tokens[:3]
        thread = ctl._thread
    finally:
        m.shutdown()
    assert ctl._thread is None and not thread.is_alive()


def test_generator_autoscale_knobs_refuse_as_the_reference(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    cases = [dict(autoscale=True),
             dict(fleet=2, canary=True),
             dict(fleet=5, autoscale={"max_replicas": 4}),
             dict(fleet=2, autoscale={"burn_low": 3.0})]
    for kw in cases:
        errs = []
        for lm, cfg, params, extra in ((jlm, jcfg, jparams, {}),
                                       (tlm, tcfg, tparams,
                                        {"device": "cpu"})):
            with pytest.raises(ValueError) as ei:
                lm.make_continuous_generator("bad", cfg=cfg, params=params,
                                             **kw, **extra)
            errs.append(str(ei.value))
        assert errs[0] == errs[1], kw


def test_debug_fleet_route_carries_the_autoscale_block(tiny):
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    m = _port_fleet(tiny, "dbg_lm", replicas=1, autoscale=dict(
        max_replicas=2, interval_s=0.0))
    server = TorchInferenceServer()
    server.register_model(m)
    http = HttpInferenceServer(server, port=0, debug_endpoints=True).start()
    try:
        m.autoscaler.step()
        url = f"http://{http.url}/v2/debug/fleet"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.loads(r.read())
        blocks = [e["fleet"] for e in body["models"]
                  if e["model"] == "dbg_lm"]
        assert blocks and blocks[0]["autoscale"]["rounds"] == 1
        assert blocks[0]["autoscale"]["max_replicas"] == 2
        assert server.debug_fleet()["models"][0]["fleet"]["autoscale"][
            "enabled"]
    finally:
        http.stop()
        server.stop()
