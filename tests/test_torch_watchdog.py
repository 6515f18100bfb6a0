"""The watchdog and incident plane: the port against the JAX package, on
the CPU.

- Units: the same synthetic signal windows go through both packages'
  ``MetricHistory``, the eight detectors, the episode machine (fire once,
  clear, cooldown, suppression, the idle mark, a broken evidence hook),
  ``IncidentStore`` (ring bound, drops, JSONL spill, a failing spill) and
  ``merge_watchdog``, and give equal outputs.
- Engines: the same small generator (weights carried across by
  ``params_from_jax``) in each package: a ``kernel_delay`` wedge fires
  ``engine_stall`` once with the reference's bundle keys; an engine death
  records an ``engine_death`` bundle that outlives the supervised restart;
  a clean run with every feature on (paged KV, the dedicated lane,
  speculation, the scheduler with preemption) records no incident; the
  watchdog off is fully off; ``incident_file`` without the watchdog
  raises; the ``client_tpu_watchdog_*`` families are seeded over every
  detector and the reference's lint finds nothing.
"""

import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.server import TpuInferenceServer
from client_tpu.server import faultinject as jfi
from client_tpu.server import trace as jtrace
from client_tpu.server import watchdog as jwd
from client_tpu.server.config import SpeculativeConfig as JSpecConfig
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import faultinject as tfi
from client_tpu_torch.server import trace as ttrace
from client_tpu_torch.server import watchdog as twd
from client_tpu_torch.server.config import SpeculativeConfig as TSpecConfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_metrics_names  # noqa: E402  (the reference's lint)

WD = {"ref": jwd, "port": twd}
FI = {"ref": jfi, "port": tfi}
SIDES = ("ref", "port")
STEP_NS = 250_000_000


@pytest.fixture(autouse=True)
def _clear_global_faults():
    yield
    jfi.get_injector().clear()
    tfi.get_injector().clear()


def _window(n, start_ns=1_000_000_000, step_ns=STEP_NS, **signals):
    out = []
    for i in range(n):
        entry = {"ns": start_ns + i * step_ns}
        for key, val in signals.items():
            entry[key] = val[i] if isinstance(val, list) else val
        out.append(entry)
    return out


def _wait(predicate, timeout=30.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def test_the_constants_are_the_reference_s():
    for name in ("DETECTORS", "INCIDENT_KINDS", "DEFAULT_THRESHOLDS",
                 "HISTORY_CAP", "INCIDENT_RING_CAP", "EVIDENCE_FLIGHT_TAIL",
                 "EVIDENCE_HISTORY_TAIL", "ENGINE_DEATH"):
        assert getattr(twd, name) == getattr(jwd, name), name
    assert tuple(twd.DETECTOR_FNS) == twd.DETECTORS


# ------------------------------------------------------------ history

def _history(wd):
    out = []
    h = wd.MetricHistory(capacity=8, interval_s=0.25)
    out.append([h.sample(1_000_000_000, {"x": 1}),
                h.sample(1_100_000_000, {"x": 2}),
                h.sample(1_250_000_000, {"x": 3}),
                [s["x"] for s in h.window()], h.snapshot()])
    h = wd.MetricHistory(capacity=4, interval_s=0.0)
    for i in range(10):
        h.sample(i * STEP_NS, {"i": i})
    out.append([len(h), h.window(), h.window(2), h.snapshot()])
    h = wd.MetricHistory(capacity=4, interval_s=0.0)
    sig = {"x": 1}
    h.sample(123, sig)
    sig["x"] = 99
    out.append(h.window())
    for kw in ({"capacity": 1}, {"capacity": 0}, {"interval_s": -1.0}):
        with pytest.raises(ValueError):
            wd.MetricHistory(**{"capacity": 8, "interval_s": 0.25, **kw})
    return out


def test_metric_history_matches_the_reference():
    got = {side: _history(WD[side]) for side in SIDES}
    assert got["port"] == got["ref"]


# ------------------------------------------------------------ detectors

TH = jwd.DEFAULT_THRESHOLDS
N_STALL, N_STAG = TH["stall_samples"], TH["stagnation_samples"]
N_LEAK, N_LAG = TH["leak_samples"], TH["ring_lag_samples"]
N_BURN, N_ACC = TH["burn_samples"], TH["acceptance_samples"]
N_TIER = TH["tier_thrash_samples"]
# (detector, window) pairs: each detector's breaching and healthy windows
# from the reference's detector tests, plus None signals (a plane the
# engine does not run) and windows one sample short
WINDOWS = {
    "stall_gap": ("engine_stall", _window(
        2, step_ns=int(6.0e9), slots_active=1, chunks_dispatched=5,
        tokens_emitted=5)),
    "stall_gap_idle": ("engine_stall", _window(
        2, step_ns=int(6.0e9), slots_active=0)),
    "stall_frozen": ("engine_stall", _window(
        N_STALL, slots_active=1, chunks_dispatched=7, tokens_emitted=7)),
    "stall_short": ("engine_stall", _window(
        N_STALL - 1, slots_active=1, chunks_dispatched=7,
        tokens_emitted=7)),
    "stall_moving": ("engine_stall", _window(
        N_STALL, slots_active=1, chunks_dispatched=list(range(N_STALL)),
        tokens_emitted=7)),
    "stagnation": ("queue_stagnation", _window(
        N_STAG, queue_depth=3, admissions=2, tokens_emitted=9)),
    "stagnation_busy": ("queue_stagnation", _window(
        N_STAG, queue_depth=3, admissions=2,
        tokens_emitted=list(range(9, 9 + N_STAG)))),
    "stagnation_empty": ("queue_stagnation", _window(
        N_STAG, queue_depth=0, admissions=2, tokens_emitted=9)),
    "leak": ("pool_leak", _window(
        N_LEAK, pool_orphan_blocks=list(range(2, 2 + N_LEAK)))),
    "leak_churn": ("pool_leak", _window(
        N_LEAK, pool_orphan_blocks=[2, 3, 4, 3, 4, 5][:N_LEAK])),
    "leak_off": ("pool_leak", _window(N_LEAK, pool_orphan_blocks=None)),
    "leak_small": ("pool_leak", _window(N_LEAK, pool_orphan_blocks=1)),
    "lag": ("ring_lag_runaway", _window(N_LAG, ring_lag=2000)),
    "lag_dip": ("ring_lag_runaway", _window(
        N_LAG, ring_lag=[2000] * (N_LAG - 1) + [3])),
    "burn": ("burn_spike", _window(N_BURN, max_class_burn=9.0)),
    "burn_low": ("burn_spike", _window(N_BURN, max_class_burn=1.0)),
    "burn_off": ("burn_spike", _window(N_BURN, max_class_burn=None)),
    "compile_new": ("compile_violation", _window(
        3, unexpected_compiles=[0, 0, 1])),
    "compile_flat": ("compile_violation", _window(
        3, unexpected_compiles=1)),
    # a None signal (an engine without a compile set) never breaches
    "compile_none": ("compile_violation", _window(
        3, unexpected_compiles=None)),
    "acceptance_cold": ("acceptance_collapse", _window(
        N_ACC, spec_acceptance=0.01, spec_rounds=8)),
    "acceptance_dead": ("acceptance_collapse", _window(
        N_ACC, spec_acceptance=0.01, spec_rounds=100)),
    "acceptance_fine": ("acceptance_collapse", _window(
        N_ACC, spec_acceptance=0.5, spec_rounds=100)),
    "acceptance_off": ("acceptance_collapse", _window(
        N_ACC, spec_acceptance=None, spec_rounds=None)),
    "thrash": ("tier_thrash", _window(
        N_TIER, tier_spills=[i * 100 for i in range(N_TIER)],
        tier_restores=[i * 100 for i in range(N_TIER)])),
    "thrash_calm": ("tier_thrash", _window(
        N_TIER, tier_spills=list(range(N_TIER)), tier_restores=0)),
    "thrash_off": ("tier_thrash", _window(
        N_TIER, tier_spills=None, tier_restores=None)),
}
FIRES = {"stall_gap", "stall_frozen", "stagnation", "leak", "lag", "burn",
         "compile_new", "acceptance_dead", "thrash"}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_detectors_match_the_reference(case):
    detector, window = WINDOWS[case]
    got = {side: WD[side].DETECTOR_FNS[detector](window, TH)
           for side in SIDES}
    assert got["port"] == got["ref"]
    assert (got["port"] is not None) == (case in FIRES)


# ------------------------------------------------------- episode machine

def _burn_signals(burn):
    return {"slots_active": 0, "queue_depth": 0, "admissions": 0,
            "chunks_dispatched": 0, "tokens_emitted": 0,
            "max_class_burn": burn, "unexpected_compiles": 0}


def _fired(fired):
    return [(f["detector"], f["breach"], f["id"]) for f in fired]


def _episode(wd):
    w = wd.Watchdog("ep_lm", wd.IncidentStore(), interval_s=0.0,
                    thresholds={"burn_samples": 2, "clear_samples": 2,
                                "cooldown_s": 10.0})
    ns = 1_000_000_000
    trail = []
    # breach, heal, re-breach inside the cooldown, heal, re-breach after
    for burn, dt in ([(9.0, STEP_NS)] * 4 + [(0.0, STEP_NS)] * 2
                     + [(9.0, STEP_NS)] * 2 + [(0.0, STEP_NS)] * 2
                     + [(9.0, int(11e9)), (9.0, STEP_NS)]):
        ns += dt
        trail.append((_fired(w.observe(ns, _burn_signals(burn))),
                      w.snapshot()["detectors"]["burn_spike"]))
    return trail, w.store.summary()


def _suppress(wd):
    w = wd.Watchdog("ep_lm", wd.IncidentStore(), interval_s=0.0,
                    thresholds={"burn_samples": 2})
    w.suppress("burn_spike")
    ns = 1_000_000_000
    quiet = [w.observe(ns + i * STEP_NS, _burn_signals(9.0))
             for i in range(4)]
    snap = w.snapshot()["detectors"]["burn_spike"]
    w.suppress("burn_spike", False)
    fired = _fired(w.observe(ns + 5 * STEP_NS, _burn_signals(9.0)))
    with pytest.raises(ValueError, match="unknown watchdog"):
        wd.Watchdog("x", wd.IncidentStore(), thresholds={"stall_walls": 1})
    with pytest.raises(ValueError, match="unknown detector"):
        w.suppress("burn_spik")
    return quiet, snap, fired


def _idle_mark(wd):
    def active(n=1):
        return dict(_burn_signals(0.0), slots_active=n, tokens_emitted=5)

    ns = 1_000_000_000
    out = []
    for mark in (True, False):
        w = wd.Watchdog("idle_lm", wd.IncidentStore(), interval_s=5.0,
                        thresholds={"stall_wall_s": 2.0})
        w.observe(ns, active())
        if mark:
            w.mark_idle(ns + 100_000_000, active(0))
        out.append(_fired(w.observe(ns + int(20e9), active())))
    return out


def _broken_hook(wd):
    w = wd.Watchdog("ep_lm", wd.IncidentStore(), interval_s=0.0,
                    thresholds={"burn_samples": 2})
    ns = 1_000_000_000
    w.observe(ns, _burn_signals(9.0))

    def boom(detector, breach):
        raise RuntimeError("snapshot plane on fire")

    fired = _fired(w.observe(ns + STEP_NS, _burn_signals(9.0),
                             evidence_fn=boom))
    bundle = w.store.incidents()[-1]
    return fired, {k: v for k, v in bundle.items() if k != "ns"}


def _death(wd):
    w = wd.Watchdog("d_lm", wd.IncidentStore(), interval_s=0.0)
    w.observe(1_000_000_000, _burn_signals(0.0))
    iid = w.record_death(RuntimeError("gone"), ns=5,
                         evidence={"flight_tail": [{"iteration": 1}]})
    return iid, w.store.snapshot(), w.snapshot()


EPISODE_CASES = {"episode": _episode, "suppress": _suppress,
                 "idle_mark": _idle_mark, "broken_hook": _broken_hook,
                 "death": _death}


@pytest.mark.parametrize("case", sorted(EPISODE_CASES))
def test_the_episode_machine_matches_the_reference(case):
    got = {side: EPISODE_CASES[case](WD[side]) for side in SIDES}
    assert got["port"] == got["ref"]


# ---------------------------------------------------------- incident store

def _ring(wd, tmp):
    store = wd.IncidentStore(capacity=2)
    ids = [store.record("engine_stall", engine="e", ns=i) for i in range(3)]
    return ids, store.summary(), store.incidents()


def _bundle(wd, tmp):
    store = wd.IncidentStore()
    store.record("pool_leak", engine="e", ns=7, breach={"orphan_blocks": 4},
                 history=[{"ns": 1}], evidence={"flight_tail": []})
    return store.snapshot()


def _spill(wd, tmp):
    path = os.path.join(tmp, "incidents.jsonl")
    store = wd.IncidentStore(capacity=2, spill_path=path)
    for i in range(3):
        store.record("engine_stall", engine="e", ns=i, breach={"i": i})
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


def _spill_failure(wd, tmp):
    store = wd.IncidentStore(spill_path=tmp)   # a directory
    store.record("engine_stall", engine="e")
    store.record("engine_stall", engine="e")
    with pytest.raises(ValueError):
        wd.IncidentStore(capacity=0)
    return store._spill_failed, store.summary()["recorded_total"]


STORE_CASES = {"ring": _ring, "bundle": _bundle, "spill": _spill,
               "spill_failure": _spill_failure}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_the_incident_store_matches_the_reference(case, tmp_path):
    got = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        got[side] = STORE_CASES[case](WD[side], str(d))
    assert got["port"] == got["ref"]


def test_merge_watchdog_matches_the_reference():
    store = {"counts": {k: 0 for k in jwd.INCIDENT_KINDS}, "depth": 0}
    a = {"interval_s": 0.25, "samples": 10, "store": store,
         "detectors": {"engine_stall": {"fires": 1, "active": True,
                                        "suppressed": False}}}
    b = {"interval_s": 0.25, "samples": 5, "store": store,
         "detectors": {"engine_stall": {"fires": 2, "active": False,
                                        "suppressed": True}}}
    for snaps in ([], [None, None], [a, None, b], [b]):
        assert twd.merge_watchdog(snaps) == jwd.merge_watchdog(snaps)
    assert twd.merge_watchdog([a, b])["store"] is store


# ---------------------------------------------------------------- engines

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
PROMPT = np.array([3, 17, 42], np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


def _gen(side, model, name, **knobs):
    jcfg, jparams, tcfg, tparams = model
    if side == "ref":
        return jlm.make_continuous_generator(
            name, cfg=jcfg, params=dict(jparams), n_slots=2, chunk_size=4,
            **knobs)
    return tlm.make_continuous_generator(
        name, cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        device="cpu", **knobs)


def test_a_kernel_delay_fires_engine_stall_like_the_reference(model):
    """One dispatch wedged (2 s) past a tightened stall wall (1 s, well
    above a loaded CPU's slowest iteration) fires
    ``engine_stall`` once, on the wall-gap path, with the reference's
    bundle keys and evidence keys, a non-empty flight tail, and an
    INCIDENT span on the traced stream; the stream survives."""
    got = {}
    for side, trace_mod in (("ref", jtrace), ("port", ttrace)):
        gen = _gen(side, model, "stall_lm", watchdog_interval_s=0.0,
                   watchdog_thresholds={"stall_wall_s": 1.0})
        try:
            list(gen.engine.submit(PROMPT, 4))
            FI[side].get_injector().arm([{
                "point": "kernel_delay", "after": 2, "times": 1,
                "delay_s": 2.0, "match": {"engine": "stall_lm"}}])
            trace = trace_mod.Trace("t-stall", "stall_lm", "1")
            tokens = list(gen.engine.submit(PROMPT, 16, trace=trace))
            FI[side].get_injector().clear()
            assert _wait(lambda: gen.engine.incidents.summary()
                         ["counts"]["engine_stall"] >= 1, timeout=10)
            bundle = next(i for i in gen.engine.incidents.incidents()
                          if i["detector"] == "engine_stall")
            ev = bundle["evidence"]
            incident_spans = [t[2] for t in trace.timestamps
                              if t[0] == trace_mod.INCIDENT]
            got[side] = {
                "tokens": tokens,
                "keys": sorted(bundle),
                "breach": (bundle["breach"]["path"],
                           bundle["breach"]["gap_s"] >= 1.5,
                           bundle["engine"], bundle["kind"]),
                "evidence": sorted(ev),
                "flight_keys": sorted(ev["flight_tail"][-1]),
                "history": bool(bundle["history"]),
                "fires": gen.engine.watchdog_snapshot()["detectors"]
                ["engine_stall"]["fires"],
                "counts": gen.incident_snapshot()["counts"],
                "spans": [(s["detector"], s["incident_id"])
                          for s in incident_spans],
            }
            # the port's bundle holds no tensor: it outlives the engine
            if side == "port":
                assert "Tensor" not in json.dumps(bundle, default=lambda o:
                                                  type(o).__name__)
        finally:
            FI[side].get_injector().clear()
            gen.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"]["fires"] == 1 and len(got["port"]["tokens"]) == 16
    assert got["port"]["breach"][:2] == ("wall_gap", True)
    assert got["port"]["spans"] == [("engine_stall", "inc-000001")]


def test_the_death_bundle_survives_a_supervised_restart(model):
    got = {}
    for side in SIDES:
        gen = _gen(side, model, "death_lm", watchdog_interval_s=0.0,
                   supervision={"backoff_base_s": 0.05, "max_failures": 5,
                                "window_s": 300.0})
        sup = gen.engine_supervisor
        try:
            crashed = gen.engine
            FI[side].get_injector().arm([{"point": "engine_loop",
                                          "after": 1, "times": 1}])
            with pytest.raises(Exception) as ei:
                list(gen.engine.submit(PROMPT, 32))
            FI[side].get_injector().clear()
            assert _wait(sup.healthy, timeout=60)
            snap = gen.incident_snapshot()
            bundle = next(i for i in snap["incidents"]
                          if i["detector"] == "engine_death")
            n = len(list(gen.engine.submit(PROMPT, 4)))
            got[side] = (ei.value.status, gen.engine is not crashed,
                         gen.engine.incidents is crashed.incidents,
                         bundle["kind"], bundle["engine"],
                         bundle["breach"], sorted(bundle["evidence"]),
                         bool(bundle["evidence"]["flight_tail"]), n,
                         gen.incident_snapshot()["counts"])
        finally:
            FI[side].get_injector().clear()
            gen.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"][:5] == (503, True, True, "engine_death", "death_lm")
    assert got["port"][9]["engine_death"] == 1


def test_a_clean_run_with_every_feature_records_no_incident(model):
    """Paged KV, the prefix cache, the dedicated lane, a draft and the
    scheduler with preemption, sampled every iteration: both watchdogs
    take samples and neither fires (the false-positive gate)."""
    got = {}
    for side, spec in (("ref", JSpecConfig), ("port", TSpecConfig)):
        gen = _gen(side, model, "clean_lm", watchdog_interval_s=0.0,
                   kv_layout="paged", kv_pool_blocks=48, kv_block_len=8,
                   prefix_cache=True, prefix_blocks=48, prefix_block_len=8,
                   prefill_mode="chunked", prefill_chunk=8, prefill_slots=1,
                   prefill_lane_width=8,
                   speculative_draft=spec(
                       enabled=True, gamma=3,
                       draft={"n_layers": 1, "d_model": 32, "n_heads": 2,
                              "head_dim": 16, "d_ff": 64}),
                   speculative_gamma=3, scheduler={"preemption": True})
        try:
            threads = [threading.Thread(
                target=lambda: list(gen.engine.submit(PROMPT, 12)))
                for _ in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            wd = gen.engine.watchdog_snapshot()
            got[side] = (gen.engine.stats()["speculation"]["rounds"] > 0,
                         wd["samples"] > 0,
                         gen.incident_snapshot()["recorded_total"],
                         [(d["fires"], d["active"])
                          for d in wd["detectors"].values()])
        finally:
            gen.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"][:3] == (True, True, 0)


def test_the_watchdog_off_is_fully_off(model):
    got = {}
    for side in SIDES:
        gen = _gen(side, model, "nowd_lm", watchdog=False)
        try:
            list(gen.engine.submit(PROMPT, 4))
            gen.engine.watchdog_suppress("burn_spike")  # a no-op
            got[side] = (gen.engine.watchdog_snapshot(),
                         gen.incident_snapshot(),
                         gen.engine.generation_snapshot()["watchdog"],
                         gen.config.to_json()["generation_engine"]
                         ["watchdog"])
        finally:
            gen.shutdown()
    assert got["port"] == got["ref"] == (None, None, None, False)


def test_incident_file_without_the_watchdog_raises(model, tmp_path):
    for side in SIDES:
        with pytest.raises(ValueError, match="incident_file"):
            _gen(side, model, "bad_lm", watchdog=False,
                 incident_file=str(tmp_path / "never.jsonl"))


def test_the_watchdog_families_are_seeded_like_the_reference(model):
    from client_tpu.server.metrics import parse_prometheus_text, sample_value

    got = {}
    for side in SIDES:
        core = TpuInferenceServer() if side == "ref" \
            else TorchInferenceServer()
        gen = _gen(side, model, "wd_m_lm", watchdog_interval_s=0.0)
        core.register_model(gen)
        try:
            list(gen.engine.submit(PROMPT, 4))
            gen.engine.incidents.record("pool_leak", engine="wd_m_lm")
            text = core.metrics_text()
            assert check_metrics_names.check(text) == []
            parsed = parse_prometheus_text(text)
            ml = {"model": "wd_m_lm", "version": "1"}
            rows = {}
            for kind in jwd.INCIDENT_KINDS:
                rows[("incidents", kind)] = sample_value(
                    parsed, "client_tpu_watchdog_incidents_total",
                    dict(ml, detector=kind))
            for det in jwd.DETECTORS:
                rows[("active", det)] = sample_value(
                    parsed, "client_tpu_watchdog_detector_active",
                    dict(ml, detector=det))
            got[side] = (rows, sample_value(
                parsed, "client_tpu_watchdog_incident_ring_depth", ml),
                sample_value(parsed,
                             "client_tpu_watchdog_incidents_dropped_total",
                             ml),
                sample_value(parsed, "client_tpu_watchdog_samples_total",
                             ml) > 0,
                sorted(f for f in parsed["families"]
                       if f.startswith("client_tpu_watchdog_")))
        finally:
            core.stop()
    assert got["port"] == got["ref"]
    assert got["port"][0][("incidents", "pool_leak")] == 1
    assert got["port"][1] == 1 and len(got["port"][4]) == 5
