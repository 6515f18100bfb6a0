"""The replica fleet router of the port, on the CPU, held against the JAX
package's.

- ``resolve_fleet``, the generator's fleet knobs and ``engine_devices``:
  the reference's loud errors, with the same words;
- the affinity sketch: the same CRC chains as the reference's, the
  leading-match score, the LRU cap and ``forget``;
- routing over stub engines (the router reads only load, health and
  submit): one scripted run of routes, submits, bounces, load and health
  changes, drains, attaches and a canary rollout, fed to both packages'
  ``ReplicaFleet``; every pick, every counter, the decision ring and the
  lifecycle ring equal, under the affinity policy at two tolerances and
  the seeded random policy;
- real two-replica fleets at a tiny f32 width (the same weights through
  ``params_from_jax``): a tenant workload routed to the same replicas,
  with the same decisions, tokens and ``client_tpu_fleet_*`` samples as
  the JAX fleet's, under both policies; greedy identity across replicas
  and against the JAX engine; a stream pinned through a peer's drain and
  through its own replica's drain (held with an event at the point the
  stream is admitted), zero failures, the engine swapped and the sketch
  cold; rolling restart; a dead replica kept out of rotation and the
  503 once every replica is down; the 409 and 404 verbs;
- observability: ``fleet_snapshot`` and ``/v2/debug/fleet`` (404 without
  the flag), the statistics' runtime block, the merged generation
  snapshot, ``FLEET_ROUTE`` on a trace, the reference's metrics lint
  (``scripts/check_metrics_names.py:check``) on the port's ``/metrics``,
  and the perf analyzer's fleet families and report block against the
  reference's.

Every test is deterministic: submits run one after another with the
fleet idle in between, and the drain joins on events. Tolerance: tokens,
counters and routing decisions exact.
"""

import http.client
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.perf import report as jreport
from client_tpu.perf.inference_profiler import PerfStatus as JPerfStatus
from client_tpu.server import TpuInferenceServer
from client_tpu.server import fleet as jfleet
from client_tpu.server.config import FleetConfig as JFleetConfig
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JEngine,
)
from client_tpu.server.types import ServerError as JServerError
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf import report as treport
from client_tpu_torch.perf.inference_profiler import (
    InferenceProfiler as TProfiler,
)
from client_tpu_torch.perf.inference_profiler import PerfStatus as TPerfStatus
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import fleet as tfleet
from client_tpu_torch.server import metrics as tmetrics
from client_tpu_torch.server import trace as ttrace
from client_tpu_torch.server.config import FleetConfig as TFleetConfig
from client_tpu_torch.server.generation import (
    ContinuousBatchingEngine as TEngine,
)
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.server.types import ServerError as TServerError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_metrics_names  # noqa: E402  (the reference's lint)

PKGS = {"ref": (jfleet, JFleetConfig, JServerError),
        "port": (tfleet, TFleetConfig, TServerError)}
PROMPT = np.arange(40, dtype=np.int32) % 60 + 1


# ------------------------------------------------------------ validation

@pytest.mark.parametrize("fleet,match", [
    (True, "replica count"), ({"replicas": 2, "warp_factor": 9},
                              "unknown FleetConfig"),
    ("three", "got str"), ({"replicas": 0}, "replicas must be >= 1"),
    ({"affinity_block_len": 0}, "affinity_block_len must be >= 1"),
    ({"affinity_max_blocks": 0}, "affinity_max_blocks must be >= 1"),
    ({"affinity_capacity": 0}, "affinity_capacity must be >= 1"),
    ({"affinity_tolerance": -1}, "affinity_tolerance must be >= 0"),
    ({"drain_timeout_s": 0.0}, "drain_timeout_s must be > 0"),
    ({"policy": "psychic"}, "unknown fleet.policy")])
def test_resolve_fleet_refuses_as_the_reference(fleet, match):
    for mod, _, _ in PKGS.values():
        with pytest.raises(ValueError, match=match):
            mod.resolve_fleet(fleet)


def test_resolve_fleet_accepts_what_the_reference_accepts():
    for mod, cfg_cls, _ in PKGS.values():
        assert mod.resolve_fleet(None) is None
        assert mod.resolve_fleet(3) == cfg_cls(replicas=3)
        assert mod.resolve_fleet({"policy": "random"}).policy == "random"
    assert TFleetConfig().to_json() == JFleetConfig().to_json()


@pytest.fixture(scope="module")
def tiny():
    """The reference fleet tests' tiny decode config, in f32 with the
    same weights in both packages."""
    kw = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
              head_dim=8, d_ff=32, max_seq=96, causal=True,
              attn_impl="ref")
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    return jcfg, jparams, tcfg, tparams


FLEET_KNOBS = dict(n_slots=2, chunk_size=4, max_new_tokens=8,
                   prefix_cache=True, prefill_mode="chunked",
                   prefill_chunk=16)


def _port_fleet(tiny, name="fleet_lm", replicas=2, **kw):
    _, _, tcfg, tparams = tiny
    return tlm.make_replica_fleet(name, replicas=replicas, cfg=tcfg,
                                  params=tparams, device="cpu",
                                  **{**FLEET_KNOBS, **kw})


@pytest.mark.parametrize("kw,exc,match", [
    (dict(replica_devices=[("cpu",), ("cpu",)]), ValueError,
     "requires a fleet"),
    (dict(fleet=2, replica_devices=[("cpu",)]), ValueError,
     "one device subset per"),
    (dict(fleet=2, engine_devices=("cpu",),
          replica_devices=[("cpu",), ("cpu",)]), ValueError,
     "mutually exclusive"),
    (dict(autoscale=True), ValueError, "autoscale requires a fleet"),
    (dict(fleet=2, canary={"split_pct": 10}), ValueError,
     "canary requires autoscale"),
    (dict(engine_devices=(), device="cpu"), ValueError,
     "at least one device"),
    (dict(mesh=object(), device="cpu"), TypeError, "DeviceMesh"),
])
def test_generator_fleet_knobs_refuse_loudly(tiny, kw, exc, match):
    _, _, tcfg, tparams = tiny
    with pytest.raises(exc, match=match):
        tlm.make_continuous_generator("bad", cfg=tcfg, params=tparams,
                                      **kw)


def test_replicas_argument_and_fleet_block(tiny):
    with pytest.raises(ValueError, match="conflicts with"):
        tlm.make_replica_fleet("clash", replicas=2,
                               fleet=TFleetConfig(replicas=8))
    m = _port_fleet(tiny, name="count_lm", replicas=3,
                    fleet={"policy": "random"})
    try:
        assert m.config.fleet.replicas == 3
        assert m.config.fleet.policy == "random"
        j = m.config.to_json()
        assert j["fleet"] == {**JFleetConfig().to_json(), "replicas": 3,
                              "policy": "random"}
        assert [r.name for r in m.fleet.replicas] == [
            "count_lm/r0", "count_lm/r1", "count_lm/r2"]
    finally:
        m.shutdown()


@pytest.mark.parametrize("devices,exc,match", [
    ((99,), ValueError, "out of range"),
    (("cpu", "cpu"), ValueError, "twice"),
    ((), ValueError, "at least one device"),
    (("cpu", "meta"), ValueError, "live process group")])
def test_engine_devices_refusals(devices, exc, match):
    with pytest.raises(exc, match=match):
        TEngine.resolve_engine_devices(devices)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TEngine.resolve_engine_devices(("cpu",), object())
    assert TEngine.resolve_engine_devices(None) is None
    assert TEngine.resolve_engine_devices([torch.device("cpu")]) == \
        torch.device("cpu")


def test_pinned_engine_lives_on_its_device_and_decodes_the_same(tiny):
    _, _, tcfg, tparams = tiny
    ref = TEngine(tcfg, tparams, n_slots=2, chunk=4, device="cpu",
                  name="dev_ref")
    pin = TEngine(tcfg, tparams, n_slots=2, chunk=4,
                  engine_devices=[torch.device("cpu")], name="dev_pin")
    try:
        assert list(pin.submit(PROMPT[:8], 6)) == list(
            ref.submit(PROMPT[:8], 6))
        assert all(t.device.type == "cpu"
                   for t in pin._dev["params"]["layers"].values())
    finally:
        ref.stop()
        pin.stop()


# ------------------------------------------------------- affinity sketch

def test_affinity_chains_scores_and_lru_equal_the_reference():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 60, n).astype(np.int32)
               for n in (3, 4, 7, 16, 20, 40)]
    idx = {s: mod.FleetAffinityIndex(block_len=4, max_blocks=3,
                                     capacity=5)
           for s, (mod, _, _) in PKGS.items()}
    for p in prompts:
        assert idx["port"].chain(p) == idx["ref"].chain(p)
    assert len(idx["port"].chain(prompts[-1])) == 3
    assert idx["port"].chain(prompts[0]) == ()
    for i, p in enumerate(prompts):
        for s in idx:
            idx[s].record(i % 2, idx[s].chain(p))
        for r in (0, 1, 2):
            got = {s: idx[s].score(r, idx[s].chain(prompts[-1]))
                   for s in idx}
            assert got["port"] == got["ref"]
            assert idx["port"].size(r) == idx["ref"].size(r) <= 5
    a = np.arange(16, dtype=np.int32)
    b = a.copy()
    b[4:] += 7
    sk = tfleet.FleetAffinityIndex(block_len=4, max_blocks=4, capacity=64)
    sk.record(0, sk.chain(a))
    assert sk.score(0, sk.chain(a)) == 4 and sk.score(0, sk.chain(b)) == 1
    sk.forget(0)
    assert sk.score(0, sk.chain(a)) == 0 and sk.size(0) == 0


# ------------------------------------------------ routing over stub engines

class _Stub:
    """The engine surface the router reads, with scripted load and
    health, raising the package's own ServerError."""

    def __init__(self, error_cls):
        self.error_cls = error_cls
        self.load = 0
        self.alive = True
        self.refuse = False
        self.submits = 0

    def load_depth(self):
        return self.load

    def active_slots(self):
        return self.load

    def healthy(self):
        return self.alive

    def submit(self, prompt, budget, **kw):
        if self.refuse:
            raise self.error_cls("stub gate shed", 503, retry_after=0.5)
        self.submits += 1
        return iter(())

    def drain(self, timeout=None):
        return True

    def stop(self):
        pass

    class _Q:
        @staticmethod
        def qsize():
            return 0

    class _Watch:
        unexpected = 0

    class _Goodput:
        @staticmethod
        def shares():
            return 0.0, 0.0

    _pending = _Q()
    compile_watch = _Watch()     # the JAX engine's snapshot field
    goodput = _Goodput()


def _script(seed: int) -> list:
    """A fixed run of router operations: tenants with shared prefixes,
    load and health flips, bounces, drains, an attach and a canary."""
    rng = np.random.default_rng(seed)
    base = [rng.integers(1, 60, 48).astype(np.int32) for _ in range(4)]
    prompts = [np.concatenate([base[i % 4][:16 * (1 + i % 3)],
                               rng.integers(1, 60, 5).astype(np.int32)])
               for i in range(10)] + [np.array([7], np.int32)]
    ops = []
    for step in range(70):
        r = int(rng.integers(0, 3))
        kind = rng.choice(["route", "route", "submit", "load", "alive",
                           "refuse", "drain_flag"])
        if step == 30:
            ops.append(("attach",))
        elif step == 40:
            ops.append(("canary", "2", 50))
        elif step == 55:
            ops.extend([("drain_flag", i, False) for i in range(5)])
            ops.append(("promote",))
        elif step == 60:
            ops.append(("canary", "3", 30))
        elif step == 66:
            ops.append(("rollback",))
        elif kind in ("route", "submit"):
            ops.append((str(kind), prompts[int(rng.integers(0, 11))],
                        f"tenant{int(rng.integers(0, 5))}"))
        elif kind == "load":
            ops.append(("load", r, int(rng.integers(0, 9))))
        else:
            ops.append((str(kind), r, bool(rng.integers(0, 2))))
    ops.append(("drain", 0))
    ops.append(("unknown",))
    return ops


def _strip(rows: list) -> list:
    return [{k: v for k, v in row.items() if k != "ns"} for row in rows]


def _run_script(side: str, ops: list, **cfg_kw) -> list:
    mod, cfg_cls, err_cls = PKGS[side]
    fleet = mod.ReplicaFleet(lambda i: _Stub(err_cls),
                             cfg_cls(**{"replicas": 3, **cfg_kw}),
                             name="stub",
                             version_factory=lambda i, v: _Stub(err_cls))
    out = []

    def rep(i):
        reps = fleet.replicas
        return reps[i % len(reps)]

    for op in ops:
        try:
            if op[0] == "route":
                out.append(("route", fleet.route(op[1], op[2]).idx))
            elif op[0] == "submit":
                fleet.submit(op[1], 4, tenant_id=op[2])
                out.append(("submit", [r.engine.submits
                                       for r in fleet.replicas]))
            elif op[0] == "load":
                rep(op[1]).engine.load = op[2]
            elif op[0] == "alive":
                rep(op[1]).engine.alive = op[2]
            elif op[0] == "refuse":
                rep(op[1]).engine.refuse = op[2]
            elif op[0] == "drain_flag":
                rep(op[1]).draining = op[2]
            elif op[0] == "attach":
                out.append(("attach", fleet.attach_replica()))
            elif op[0] == "canary":
                out.append(("canary", fleet.begin_canary(op[1], op[2])))
            elif op[0] == "promote":
                out.append(("promote", fleet.promote_canary()))
            elif op[0] == "rollback":
                out.append(("rollback", fleet.rollback_canary()))
            elif op[0] == "drain":
                out.append(("drain", fleet.drain(op[1])))
            elif op[0] == "unknown":
                fleet.drain(99)
        except Exception as e:  # noqa: BLE001 — the router's refusals
            out.append(("error", type(e).__name__, getattr(e, "status", 0),
                        str(e)))
        out.append([(r.idx, r.routed, r.rerouted, r.affinity_hits,
                     r.drains, r.draining) for r in fleet.replicas])
    snap = fleet.fleet_snapshot()
    out.append(_strip(snap["recent_decisions"]))
    out.append(_strip(snap["lifecycle_events"]))
    out.append((snap["version"], snap["canary"], snap["healthy_replicas"]))
    return out


@pytest.mark.parametrize("cfg_kw", [
    {}, {"affinity_tolerance": 1, "affinity_block_len": 8},
    {"policy": "random", "random_seed": 11}],
    ids=["affinity", "tolerance1", "random"])
def test_stub_routing_equals_the_reference_decision_for_decision(cfg_kw):
    ops = _script(3)
    got = {s: _run_script(s, ops, **cfg_kw) for s in PKGS}
    assert got["port"] == got["ref"]
    picks = [o[1] for o in got["port"] if isinstance(o, tuple)
             and o[0] == "route"]
    assert len(set(picks)) > 1          # traffic actually spreads
    assert any(isinstance(o, tuple) and o[0] == "error" and o[2] == 503
               for o in got["port"])    # the all-down 503 was reached
    assert got["port"][-5][1:3] == ("ServerError", 404)


def test_stub_verbs_answer_409_as_the_reference():
    for side, (mod, cfg_cls, err_cls) in PKGS.items():
        fleet = mod.ReplicaFleet(lambda i: _Stub(err_cls),
                                 cfg_cls(replicas=2), name="stub")
        fleet.replicas[0].draining = True
        for verb in (fleet.drain, fleet.detach_replica):
            with pytest.raises(err_cls) as ei:
                verb(0)
            assert ei.value.status == 409
        fleet.replicas[0].draining = False
        fleet.replicas[1].engine.alive = False
        with pytest.raises(err_cls, match="last admitting") as ei:
            fleet.detach_replica(0)
        assert ei.value.status == 409
        for verb in (fleet.promote_canary, fleet.rollback_canary):
            with pytest.raises(err_cls, match="no canary") as ei:
                verb()
            assert ei.value.status == 409
        with pytest.raises(err_cls) as ei:
            fleet.begin_canary("2", 0)
        assert ei.value.status == 400


# ----------------------------------------------- real two-replica fleets

def _idle(engines) -> None:
    """Wait until every engine holds no request (each stream's slot is
    freed by its engine thread right after its last token): the next
    routing decision then reads the same loads in both packages."""
    done = threading.Event()
    for _ in range(2000):
        if all(e.load_depth() == 0 for e in engines):
            return
        done.wait(0.005)
    raise AssertionError("the fleet did not go idle")


def _workload(seed: int = 7) -> list:
    """4 tenants x 2 requests: a 32-token tenant prefix and an 8-token
    suffix each (two affinity blocks), tenants interleaved."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, 60, 32).astype(np.int32) for _ in range(4)]
    return [(np.concatenate([prefixes[t], rng.integers(1, 60, 8).astype(
        np.int32)]), f"tenant{t}") for _ in range(2) for t in range(4)]


def _serve_workload(model, jobs) -> tuple:
    toks = []
    for prompt, tenant in jobs:
        toks.append([int(x) for x in model.fleet.submit(
            prompt, 6, tenant_id=tenant)])
        _idle([r.engine for r in model.fleet.replicas])
    snap = model.fleet_snapshot()
    return toks, _strip(snap["recent_decisions"]), [
        (r["replica"], r["routed"], r["affinity_hits"], r["rerouted"])
        for r in snap["rows"]]


def _fleet_samples(text: str, parse) -> dict:
    return {(n, labels.get("replica")): v
            for n, labels, v in parse(text)["samples"]
            if n.startswith("client_tpu_fleet_")}


@pytest.mark.parametrize("policy", ["affinity", "random"])
def test_workload_routes_and_decodes_as_the_jax_fleet(tiny, policy):
    jcfg, jparams, _, _ = tiny
    from client_tpu.server.metrics import parse_prometheus_text as jparse

    fleet = {"policy": policy, "random_seed": 5}
    jm = jlm.make_replica_fleet("fleet_lm", replicas=2, cfg=jcfg,
                                params=jparams, fleet=fleet, **FLEET_KNOBS)
    tm = _port_fleet(tiny, fleet=fleet)
    cores = {"ref": TpuInferenceServer(), "port": TorchInferenceServer()}
    cores["ref"].register_model(jm)
    cores["port"].register_model(tm)
    try:
        jobs = _workload()
        got = {"ref": _serve_workload(jm, jobs),
               "port": _serve_workload(tm, jobs)}
        assert got["port"] == got["ref"]
        toks, decisions, rows = got["port"]
        assert all(len(t) == 6 for t in toks)
        if policy == "affinity":
            # every tenant's second request found its first one's replica
            assert sum(d["affinity_hit"] for d in decisions) == 4
            assert {d["leg"] for d in decisions} == {"load", "affinity"}
        samples = {"ref": _fleet_samples(cores["ref"].metrics_text(),
                                         jparse),
                   "port": _fleet_samples(cores["port"].metrics_text(),
                                          tmetrics.parse_prometheus_text)}
        assert samples["port"] == samples["ref"]
        assert sum(v for (n, _), v in samples["port"].items()
                   if n == "client_tpu_fleet_routed_total") == 8
    finally:
        cores["ref"].stop()
        cores["port"].stop()


@pytest.fixture(scope="module")
def fleet_model(tiny):
    m = _port_fleet(tiny)
    yield m
    m.shutdown()


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """The JAX engine's greedy tokens for PROMPT, budgets 6 and 8."""
    jcfg, jparams, _, _ = tiny
    eng = JEngine(jcfg, jparams, n_slots=2, chunk=4, name="identity_ref")
    try:
        return {n: list(eng.submit(PROMPT, n)) for n in (6, 8)}
    finally:
        eng.stop()


def test_greedy_identity_across_replicas(fleet_model, jax_tokens):
    for rep in fleet_model.fleet.replicas:
        assert list(rep.engine.submit(PROMPT, 6)) == jax_tokens[6]


def test_stream_stays_pinned_through_a_peer_drain(tiny, jax_tokens):
    m = _port_fleet(tiny, name="pin_lm")
    try:
        fleet = m.fleet
        rep = fleet.route(PROMPT, "pin-t")
        peer = [r for r in fleet.replicas if r.idx != rep.idx][0]
        it = rep.engine.submit(PROMPT, 8)
        first = next(it)
        assert fleet.drain(peer.idx, timeout=30)
        assert [first] + list(it) == jax_tokens[8]
        assert peer.drains == 1 and rep.drains == 0
    finally:
        m.shutdown()


def test_drain_of_a_streaming_replica_fails_nothing(tiny, jax_tokens):
    """The drain starts once the stream is admitted (its first token is
    the event); the stream finishes on the old engine, then the replica
    swaps to a fresh engine with a cold sketch."""
    m = _port_fleet(tiny, name="drain_lm")
    try:
        fleet = m.fleet
        it = fleet.submit(PROMPT, 8, tenant_id="drain-t")
        target = fleet.replicas[fleet.fleet_snapshot()[
            "recent_decisions"][-1]["replica"]]
        old = target.engine
        admitted = threading.Event()
        result = {}

        def drain():
            admitted.wait(30)
            result["ok"] = fleet.drain(target.idx, timeout=30)

        th = threading.Thread(target=drain)
        th.start()
        toks = [next(it)]
        admitted.set()
        toks += list(it)
        th.join(30)
        assert result == {"ok": True}
        assert toks == jax_tokens[8]
        assert target.engine is not old and target.drains == 1
        assert fleet._affinity.size(target.idx) == 0
        assert m.generation_stats()["failed"] == 0
        assert [e["verb"] for e in fleet.fleet_snapshot()[
            "lifecycle_events"]] == ["drain", "swap_fresh"]
    finally:
        m.shutdown()


def test_rolling_restart_keeps_the_tokens(tiny, jax_tokens):
    m = _port_fleet(tiny, name="roll_lm")
    try:
        fleet = m.fleet
        before = list(fleet.submit(PROMPT, 6, tenant_id="roll"))
        olds = [r.engine for r in fleet.replicas]
        assert fleet.rolling_restart(timeout=30) == [True, True]
        assert all(r.engine is not e for r, e in zip(fleet.replicas, olds))
        assert list(fleet.submit(PROMPT, 6, tenant_id="roll")) == before \
            == jax_tokens[6]
        assert m.engine_healthy() and m.generation_stats()["failed"] == 0
    finally:
        m.shutdown()


def test_dead_replica_is_routed_around_then_503(tiny):
    m = _port_fleet(tiny, name="half_lm")
    try:
        fleet = m.fleet
        dead = fleet.replicas[0]
        dead.engine._failed = RuntimeError("simulated death")
        assert not dead.healthy() and m.engine_healthy()
        assert all(fleet.route(PROMPT, f"h-{t}").idx == 1
                   for t in range(4))
        assert len(list(fleet.submit(PROMPT, 4, tenant_id="h-x"))) == 4
        snap = m.fleet_snapshot()
        assert snap["healthy_replicas"] == 1
        assert snap["rows"][0]["healthy"] is False
        fleet.replicas[1].engine._failed = RuntimeError("boom")
        assert not m.engine_healthy()
        with pytest.raises(TServerError) as ei:
            fleet.submit(PROMPT, 4)
        assert ei.value.status == 503 and ei.value.retry_after is not None
        with pytest.raises(TServerError) as ei:
            fleet.drain(7)
        assert ei.value.status == 404
    finally:
        m.shutdown()


def test_attached_replica_is_warmed_and_takes_traffic(tiny):
    m = _port_fleet(tiny, name="grow_lm", replicas=1)
    try:
        fleet = m.fleet
        assert fleet.attach_replica(warm_prompt=PROMPT[:8],
                                    warm_tokens=2) == 1
        new = fleet.replicas[1]
        assert new.engine.gen_stats.snapshot()["completed"] == 1
        fleet.replicas[0].engine._failed = RuntimeError("down")
        assert len(list(fleet.submit(PROMPT, 4, tenant_id="g"))) == 4
        assert new.routed == 1
    finally:
        m.shutdown()


# --------------------------------------------------------- observability

def test_snapshot_keys_equal_the_reference(fleet_model):
    snap = fleet_model.fleet_snapshot()
    ref = jfleet.ReplicaFleet(
        lambda i: _Stub(JServerError), JFleetConfig(replicas=1)
    ).fleet_snapshot()
    assert set(snap) == set(ref)
    assert set(snap["rows"][0]) == set(ref["rows"][0])
    assert snap["rows"][0]["unexpected_compiles"] == \
        ref["rows"][0]["unexpected_compiles"] == 0
    stats = fleet_model.runtime_stats()
    assert stats["fleet"]["replicas"] == 2 and len(stats["fleet"]["rows"]) \
        == 2
    gen = fleet_model.generation_stats()
    assert gen["n_slots"] == 4 and len(gen["ttft"][0]) == 17
    for absent in ("ring", "prefill_lane", "kv_paged", "kv_tier",
                   "scheduler", "speculation", "slo"):
        assert gen[absent] is None
    eng = fleet_model.fleet.replicas[1].engine
    eng.set_dispatch_duty(0.4)
    try:
        assert fleet_model.generation_stats()["dispatch_duty"] == 0.4
    finally:
        eng.set_dispatch_duty(1.0)
    dbg = fleet_model.engine_debug()
    assert [set(r["engine"]) >= {"slo", "scheduler"}
            for r in dbg["replicas"]] == [True, True]
    rt = fleet_model.runtime_observability()
    assert rt["engine_up"] is True and "memory" in rt


def test_fleet_route_span_rides_the_trace(fleet_model):
    trace = ttrace.Trace("t1", "fleet_lm", "1")
    list(fleet_model.fleet.submit(PROMPT, 2, tenant_id="tr", trace=trace))
    routes = [e for e in trace.timestamps if e[0] == ttrace.FLEET_ROUTE]
    assert len(routes) == 1
    assert set(routes[0][2]) == {"replica", "replica_name", "leg",
                                 "affinity_hit", "affinity_depth", "load",
                                 "tolerance"}


def test_served_metrics_lint_and_debug_fleet(fleet_model):
    core = TorchInferenceServer()
    core.register_model(fleet_model)
    srvs = [HttpInferenceServer(core, port=0, debug_endpoints=on).start()
            for on in (True, False)]
    try:
        got = []

        def cb(resp, final):
            if resp.outputs:
                got.append(int(np.asarray(resp.outputs[0].data)[0]))

        from client_tpu_torch.server.types import InferRequest, InferTensor

        for _ in range(2):
            core.infer(InferRequest(model_name="fleet_lm", inputs=[
                InferTensor("PROMPT", "INT32", (40,), data=PROMPT),
                InferTensor("MAX_TOKENS", "INT32", (1,),
                            data=np.array([3], np.int32))]),
                response_callback=cb)
        assert len(got) == 6
        text = core.metrics_text()
        assert check_metrics_names.check(text) == []
        parsed = tmetrics.parse_prometheus_text(text)
        assert tmetrics.sample_value(parsed, "client_tpu_fleet_replicas",
                                     {"model": "fleet_lm"}) == 2
        assert {labels["replica"] for n, labels, _ in parsed["samples"]
                if n == "client_tpu_fleet_healthy"} == {"0", "1"}
        bodies = []
        for srv in srvs:
            host, port = srv.url.split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            conn.request("GET", "/v2/debug/fleet")
            resp = conn.getresponse()
            bodies.append((resp.status, resp.read()))
            conn.close()
        assert bodies[1][0] == 404
        assert bodies[0][0] == 200
        body = json.loads(bodies[0][1])
        assert body["models"][0]["model"] == "fleet_lm"
        rows = body["models"][0]["fleet"]["rows"]
        assert len(rows) == 2 and sum(r["routed"] for r in rows) >= 2
        assert core.debug_fleet()["models"][0]["fleet"]["replicas"] == 2
    finally:
        for srv in srvs:
            srv.stop()
        with core._lock:
            for versions in core._models.values():
                for e in versions.values():
                    if e.scheduler:
                        e.scheduler.stop()
            core._models.clear()


def test_fleet_families_absent_without_a_fleet(tiny):
    _, _, tcfg, tparams = tiny
    core = TorchInferenceServer()
    core.register_model(tlm.make_continuous_generator(
        "solo_lm", cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        device="cpu"))
    try:
        text = core.metrics_text()
        assert "client_tpu_fleet_" not in text
        assert check_metrics_names.check(text) == []
        assert core.debug_fleet() == {"models": []}
    finally:
        core.stop()


def _expo(routed, rerouted, hits, drains) -> str:
    head = ('{model="fleet_lm",version="1"')
    return (
        "# HELP client_tpu_fleet_replicas r\n"
        "# TYPE client_tpu_fleet_replicas gauge\n"
        f"client_tpu_fleet_replicas{head}}} 2\n"
        "# HELP client_tpu_fleet_healthy h\n"
        "# TYPE client_tpu_fleet_healthy gauge\n"
        f'client_tpu_fleet_healthy{head},replica="0"}} 1\n'
        f'client_tpu_fleet_healthy{head},replica="1"}} 1\n'
        "# HELP client_tpu_fleet_queue_depth q\n"
        "# TYPE client_tpu_fleet_queue_depth gauge\n"
        f'client_tpu_fleet_queue_depth{head},replica="0"}} 3\n'
        + "".join(
            f"# HELP client_tpu_fleet_{n}_total x\n"
            f"# TYPE client_tpu_fleet_{n}_total counter\n"
            f'client_tpu_fleet_{n}_total{head},replica="0"}} {v}\n'
            for n, v in (("routed", routed), ("rerouted", rerouted),
                         ("affinity_hits", hits), ("drains", drains))))


def test_profiler_reads_the_fleet_families_and_the_report_block():
    from types import SimpleNamespace

    prof = TProfiler.__new__(TProfiler)
    prof.parser = SimpleNamespace(model_name="fleet_lm")
    out = prof._metrics_delta(
        tmetrics.parse_prometheus_text(_expo(10, 1, 5, 0)),
        tmetrics.parse_prometheus_text(_expo(30, 3, 17, 2)), [], 1.0)
    assert out.fleet_scraped
    assert (out.fleet_replicas, out.fleet_healthy, out.fleet_queue_depth,
            out.fleet_routed, out.fleet_rerouted, out.fleet_affinity_hits,
            out.fleet_drains) == (2, 2, 3, 20, 2, 12, 2)
    texts = []
    for status_cls, render in ((JPerfStatus, jreport.render_report),
                               (TPerfStatus, treport.render_report)):
        st = status_cls(concurrency=1, stabilized=True)
        st.metrics.scraped = True
        st.metrics.fleet_scraped = True
        st.metrics.fleet_replicas = 2
        st.metrics.fleet_healthy = 1
        st.metrics.fleet_routed = 42
        st.metrics.fleet_affinity_hits = 30
        st.metrics.fleet_rerouted = 4
        st.metrics.fleet_drains = 1
        texts.append(render([st], SimpleNamespace(model_name="fleet_lm")))
    block = [t[t.index("  Fleet (replica router)"):].split("\n")[:3]
             for t in texts]
    assert block[1] == block[0]
    assert "1/2 healthy" in texts[1]
    assert "42 (30 affinity hits, 4 re-routed, 1 drain-swaps)" in texts[1]
