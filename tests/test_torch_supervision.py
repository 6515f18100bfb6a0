"""Engine supervision and fault injection: the port against the JAX
package, on the CPU.

- The fault injector: the reference's ``TestFaultInjector`` cases run
  against both packages' ``faultinject`` (each its own process-global);
  the same seeds give the same firings in both.
- The supervisor: the reference's ``TestSupervisorUnit`` cases (backoff,
  swap, breaker and operator reset, failed rebuilds, ``replace_clean``,
  ``shutdown``, a stale engine's failure) against both packages'
  ``EngineSupervisor`` over a stub engine.
- The engines: the same small generator (weights carried across by
  ``params_from_jax``) crashed by each package's own ``engine_loop`` or
  ``ring_fetch`` fault: three crash-restart cycles give greedy tokens
  identical to the JAX engine's and the same 503 with ``Retry-After`` at
  each crash; the breaker leaves the model not ready (``/v2/health/ready``
  400) with the same statuses and the restart families on ``/metrics``;
  a traced stream gets ENGINE_RESTART; an unsupervised engine keeps its
  raw terminal; a forced ``queue_full`` sheds with ``Retry-After``; a
  wedged thread's ``stop()`` reports the flight tail; ``core.stop()``
  cancels a restart still in its backoff.
- The reference's failure-path lint (``scripts/check_failure_paths.py``,
  imported, not edited) finds nothing in ``client_tpu_torch/server/``.
"""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.server import TpuInferenceServer
from client_tpu.server import faultinject as jfi
from client_tpu.server import http_server as jhttp
from client_tpu.server import supervision as jsup
from client_tpu.server import trace as jtrace
from client_tpu.server import types as jtypes
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import faultinject as tfi
from client_tpu_torch.server import http_server as thttp
from client_tpu_torch.server import supervision as tsup
from client_tpu_torch.server import trace as ttrace
from client_tpu_torch.server import types as ttypes
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.metrics import parse_prometheus_text, sample_value

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_failure_paths  # noqa: E402  (the reference's lint)
import check_metrics_names  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FI = {"ref": jfi, "port": tfi}
SUP = {"ref": jsup, "port": tsup}
SIDES = ("ref", "port")


@pytest.fixture(autouse=True)
def _clear_global_faults():
    """Every test leaves both injectors disarmed."""
    yield
    jfi.get_injector().clear()
    tfi.get_injector().clear()


def _wait(predicate, timeout=30.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


# ---------------------------------------------------------------- injector

def _after_and_times(fi):
    inj = fi.FaultInjector()
    inj.arm([fi.FaultSpec(point="engine_loop", after=2, times=2)])
    return [inj.check("engine_loop") is not None for _ in range(6)]


def _per_point(fi):
    inj = fi.FaultInjector()
    inj.arm([fi.FaultSpec(point="ring_fetch", after=1, times=1)])
    return [inj.check("engine_loop") is None, inj.check("ring_fetch") is None,
            inj.check("ring_fetch") is not None]


def _seeded(fi):
    def run(seed):
        inj = fi.FaultInjector(seed=seed)
        inj.arm([fi.FaultSpec(point="engine_loop", probability=0.5,
                              times=0)])
        return [inj.check("engine_loop") is not None for _ in range(32)]

    assert run(7) == run(7) and run(7) != run(8)
    return [run(7), run(8)]


def _rearm(fi):
    inj = fi.FaultInjector()
    out = []
    for _ in range(2):
        inj.arm([fi.FaultSpec(point="engine_loop", after=1, times=1)])
        out.append([inj.check("engine_loop") is not None for _ in range(3)])
    return out


def _unknown_point(fi):
    with pytest.raises(ValueError, match="unknown fault point"):
        fi.FaultSpec(point="warp_core_breach")
    return "raised"


def _disarmed(fi):
    inj = fi.FaultInjector()
    return [inj.check("engine_loop"), inj.snapshot()["armed"]]


def _kernel_delay(fi):
    inj = fi.FaultInjector()
    inj.arm([fi.FaultSpec(point="kernel_delay", delay_s=0.15)])
    t0 = time.monotonic()
    fired = inj.check("kernel_delay") is not None
    return [fired, time.monotonic() - t0 >= 0.14]


def _env(fi):
    # the module's own env schedule: a fresh module-global injector reads
    # CLIENT_TPU_FAULTS / CLIENT_TPU_FAULT_SEED at first use
    saved = fi._INJECTOR
    env = {fi.ENV_FAULTS: os.environ.get(fi.ENV_FAULTS),
           fi.ENV_SEED: os.environ.get(fi.ENV_SEED)}
    os.environ[fi.ENV_FAULTS] = json.dumps([{"point": "queue_full",
                                             "times": 1}])
    os.environ[fi.ENV_SEED] = "11"
    fi._INJECTOR = None
    try:
        inj = fi.get_injector()
        return [inj.snapshot()["seed"], fi.fire("queue_full") is not None,
                fi.fire("queue_full") is None]
    finally:
        fi._INJECTOR = saved
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _snapshot(fi):
    inj = fi.FaultInjector(seed=3)
    inj.arm([fi.FaultSpec(point="engine_loop", times=1)])
    inj.check("engine_loop")
    return inj.snapshot()


def _match(fi):
    inj = fi.FaultInjector()
    inj.arm([{"point": "kernel_delay", "after": 1, "times": 1,
              "match": {"engine": "a"}}])
    return [inj.check("kernel_delay", engine=e) is not None
            for e in ("b", "a", "b", "a", "a")]


def _fire_or_raise(fi):
    fi.get_injector().arm([{"point": "ring_fetch", "times": 1,
                            "message": "boom"}])
    with pytest.raises(fi.InjectedFault, match="boom"):
        fi.fire_or_raise("ring_fetch", engine="x")
    fi.fire_or_raise("ring_fetch", engine="x")  # the budget is spent
    return fi.get_injector().snapshot()["hits"]


INJECTOR_CASES = {
    "after_and_times": _after_and_times, "per_point": _per_point,
    "seeded": _seeded, "rearm": _rearm, "unknown_point": _unknown_point,
    "disarmed": _disarmed, "kernel_delay": _kernel_delay, "env": _env,
    "snapshot": _snapshot, "match": _match, "fire_or_raise": _fire_or_raise,
}


@pytest.mark.parametrize("case", sorted(INJECTOR_CASES))
def test_fault_injector_matches_the_reference(case):
    got = {side: INJECTOR_CASES[case](FI[side]) for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"] is not None
    assert tfi.POINTS == jfi.POINTS
    # the port's injector is a global of its own
    assert tfi.get_injector() is not jfi.get_injector()


# -------------------------------------------------------------- supervisor

class _StubEngine:
    def __init__(self, fail_start=False):
        self.fail_start = fail_start
        self.started = False
        self.stopped = False
        self.supervisor = None

    def start(self):
        if self.fail_start:
            raise RuntimeError("stub start failure")
        self.started = True

    def stop(self):
        self.stopped = True

    def healthy(self):
        return not self.stopped


def _backoff(mod):
    p = mod.RestartPolicy(backoff_base_s=0.5, backoff_mult=2.0,
                          backoff_max_s=3.0)
    for bad in ({"backoff_base_s": 0}, {"backoff_mult": 0.5},
                {"max_failures": 0}, {"window_s": 0}):
        with pytest.raises(ValueError):
            mod.RestartPolicy(**bad)
    return [p.backoff_for(n) for n in (1, 2, 3, 4, 5)]


def _swap(mod):
    sup = mod.EngineSupervisor(
        _StubEngine, mod.RestartPolicy(backoff_base_s=0.01), name="stub")
    first = sup.engine
    hint = sup.retry_after_hint()
    sup.notify_failure(first, RuntimeError("boom"))
    assert _wait(lambda: sup.engine is not first, timeout=5)
    return [hint, sup.restarts, sup.crash_looped, sup.engine.started,
            sup.engine.supervisor is sup, sup.snapshot()["last_error"]]


def _breaker(mod):
    sup = mod.EngineSupervisor(
        _StubEngine, mod.RestartPolicy(backoff_base_s=0.01, max_failures=2,
                                       window_s=60.0), name="stub")
    sup.notify_failure(sup.engine, RuntimeError("boom 1"))
    assert _wait(lambda: sup.restarts == 1, timeout=5)
    would = sup.would_restart()
    sup.notify_failure(sup.engine, RuntimeError("boom 2"))
    time.sleep(0.1)
    tripped = [sup.crash_looped, sup.restarts, sup.healthy()]
    sup.notify_failure(sup.engine, RuntimeError("boom 3"))
    time.sleep(0.1)
    sup.replace_clean()
    return [would, tripped, sup.restarts, sup.crash_looped, sup.healthy(),
            sup.would_restart()]


def _failed_rebuild(mod):
    calls = []

    def factory():
        calls.append(1)
        return _StubEngine(fail_start=len(calls) > 1)

    sup = mod.EngineSupervisor(
        factory, mod.RestartPolicy(backoff_base_s=0.01, max_failures=3,
                                   window_s=60.0), name="stub")
    sup.notify_failure(sup.engine, RuntimeError("boom"))
    assert _wait(lambda: sup.crash_looped, timeout=10)
    return [sup.restarts, len(calls), sup.snapshot()["last_error"]]


def _replace_clean(mod):
    engines = []

    def factory():
        e = _StubEngine()
        engines.append(e)
        return e

    sup = mod.EngineSupervisor(
        factory, mod.RestartPolicy(backoff_base_s=0.3), name="stub")
    sup.notify_failure(sup.engine, RuntimeError("boom"))
    sup.replace_clean()
    staged = sup.engine
    time.sleep(0.5)
    return [sup.engine is staged, sup.restarts,
            all(e.stopped for e in engines if e is not staged and e.started)]


def _shutdown(mod):
    built = []

    def factory():
        e = _StubEngine()
        built.append(e)
        return e

    sup = mod.EngineSupervisor(
        factory, mod.RestartPolicy(backoff_base_s=0.2), name="stub")
    sup.notify_failure(sup.engine, RuntimeError("boom"))
    sup.shutdown()
    time.sleep(0.4)
    return [sup.restarts, all(e.stopped or not e.started for e in built),
            sup.would_restart()]


def _stale(mod):
    sup = mod.EngineSupervisor(
        _StubEngine, mod.RestartPolicy(backoff_base_s=0.01), name="stub")
    current = sup.engine
    sup.notify_failure(_StubEngine(), RuntimeError("old news"))
    time.sleep(0.05)
    return [sup.restarts, sup.crash_looped, sup.engine is current]


SUPERVISOR_CASES = {"backoff": _backoff, "swap": _swap, "breaker": _breaker,
                    "failed_rebuild": _failed_rebuild,
                    "replace_clean": _replace_clean, "shutdown": _shutdown,
                    "stale": _stale}


@pytest.mark.parametrize("case", sorted(SUPERVISOR_CASES))
def test_supervisor_matches_the_reference(case):
    got = {side: SUPERVISOR_CASES[case](SUP[side]) for side in SIDES}
    assert got["port"] == got["ref"]


def test_supervisor_snapshot_has_the_reference_keys():
    snaps = {}
    for side in SIDES:
        mod = SUP[side]
        sup = mod.EngineSupervisor(_StubEngine, mod.RestartPolicy(),
                                   name="stub")
        snaps[side] = sup.snapshot()
        sup.shutdown()
    assert snaps["port"] == snaps["ref"]


# ---------------------------------------------------------------- engines

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=96, causal=True)
PROMPT = np.array([1, 2, 3], np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


def _gen(side, model, name="ft_lm", **knobs):
    jcfg, jparams, tcfg, tparams = model
    if side == "ref":
        return jlm.make_continuous_generator(
            name, cfg=jcfg, params=dict(jparams), n_slots=2, chunk_size=4,
            max_new_tokens=8, **knobs)
    return tlm.make_continuous_generator(
        name, cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        max_new_tokens=8, device="cpu", **knobs)


def _crash(side, gen, point="engine_loop", after=1, budget=32, **kw):
    """Arm ``point`` once on the side's own injector and run one stream
    into it: the (type, status, Retry-After) it ends with."""
    FI[side].get_injector().arm([{"point": point, "after": after,
                                  "times": 1}])
    try:
        list(gen.engine.submit(PROMPT, budget, **kw))
    except Exception as e:  # noqa: BLE001 — the terminal is the datum
        return (type(e).__name__, getattr(e, "status", None),
                getattr(e, "retry_after", None))
    finally:
        FI[side].get_injector().clear()
    return None


def _live_refs(index) -> int:
    total = 0
    stack = list(index._root.children.values())
    while stack:
        n = stack.pop()
        total += max(0, n.refs)
        stack.extend(n.children.values())
    return total


def test_three_crash_restart_cycles_match_the_jax_engine(model):
    """Each side's engine crashes three times mid-stream under supervision
    (the reference's chaos test): every crash answers with a retryable
    503 whose ``Retry-After`` is the next backoff, the restart waits its
    backoff, and after each restart greedy decode is token-identical to
    the JAX engine's uncrashed baseline, with no held slot, no prefix pin
    and the drain invariant on the fresh engine."""
    got = {}
    for side in SIDES:
        gen = _gen(side, model, prefix_cache=True, prefix_blocks=16,
                   prefix_block_len=4,
                   supervision={"backoff_base_s": 0.05, "backoff_mult": 2.0,
                                "max_failures": 10, "window_s": 300.0})
        sup = gen.engine_supervisor
        runs = []
        try:
            baseline = list(gen.engine.submit(PROMPT, 8))
            for cycle in range(3):
                crashed = gen.engine
                t0 = time.monotonic()
                terminal = _crash(side, gen)
                assert not crashed.healthy()
                assert _wait(lambda: sup.healthy() and sup.restarts
                             == cycle + 1, timeout=60), (side, cycle)
                assert time.monotonic() - t0 \
                    >= 0.9 * sup.policy.backoff_for(cycle + 1)
                tokens = list(gen.engine.submit(PROMPT, 8))
                eng = gen.engine
                assert _wait(lambda: all(s.req is None for s in eng._slots),
                             timeout=10)
                assert _live_refs(eng._prefix_index) == 0
                with eng._lock:
                    assert eng._requests_accepted == eng._requests_closed
                runs.append((terminal, tokens, gen.engine is not crashed))
            got[side] = (baseline, runs, sup.restarts, sup.crash_looped)
        finally:
            sup.shutdown()
    assert got["port"] == got["ref"]
    baseline, runs, restarts, looped = got["port"]
    assert len(baseline) == 8 and restarts == 3 and not looped
    for i, (terminal, tokens, swapped) in enumerate(runs):
        assert terminal == ("ServerError", 503, 0.05 * 2 ** i)
        assert tokens == baseline and swapped


def test_a_ring_fetch_crash_recovers_like_the_reference(model):
    got = {}
    for side in SIDES:
        gen = _gen(side, model, supervision={"backoff_base_s": 0.05,
                                             "max_failures": 5,
                                             "window_s": 300.0})
        sup = gen.engine_supervisor
        try:
            baseline = list(gen.engine.submit(PROMPT, 8))
            terminal = _crash(side, gen, point="ring_fetch", after=0,
                              budget=8)
            assert _wait(sup.healthy, timeout=60)
            got[side] = (baseline, terminal,
                         list(gen.engine.submit(PROMPT, 8)), sup.restarts)
        finally:
            sup.shutdown()
    assert got["port"] == got["ref"]
    baseline, terminal, after, restarts = got["port"]
    assert terminal[:2] == ("ServerError", 503) and after == baseline
    assert restarts == 1


def _status(url: str, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://{url}{path}", timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_the_breaker_leaves_the_model_not_ready_like_the_reference(model):
    """Two crashes inside the window trip a two-failure breaker: the second
    crash's terminal promises no restart, the model reads not ready (and
    ``/v2/health/ready`` 400), a submit gets a 503 with no hint, the
    restart and breaker families say so on ``/metrics`` (the lint clean),
    and an unload and a load make the model ready and serving again."""
    got = {}
    for side in SIDES:
        core = TpuInferenceServer() if side == "ref" \
            else TorchInferenceServer()
        gen = _gen(side, model, supervision={"backoff_base_s": 0.02,
                                             "max_failures": 2,
                                             "window_s": 60.0})
        core.register_model(gen)
        mod = jhttp if side == "ref" else thttp
        srv = mod.HttpInferenceServer(core, port=0).start()
        sup = gen.engine_supervisor
        try:
            ready0 = (core.model_ready("ft_lm"),
                      _status(srv.url, "/v2/health/ready"))
            first = _crash(side, gen, after=0, budget=8)
            assert _wait(lambda: sup.restarts == 1 and sup.healthy(),
                         timeout=60)
            second = _crash(side, gen, after=0, budget=8)
            assert _wait(lambda: sup.crash_looped, timeout=10)
            try:
                list(gen.engine.submit(PROMPT, 4))
                gate = None
            except Exception as e:  # noqa: BLE001 — the answer is the datum
                gate = (e.status, e.retry_after, str(e))
            text = core.metrics_text()
            assert check_metrics_names.check(text) == []
            parsed = parse_prometheus_text(text)
            labels = {"model": "ft_lm", "version": "1"}
            families = [sample_value(parsed, f, labels) for f in (
                "client_tpu_engine_restarts_total",
                "client_tpu_engine_crash_looped", "client_tpu_engine_up")]
            dead = (core.model_ready("ft_lm"),
                    _status(srv.url, "/v2/health/ready"))
            gen.unload()
            gen.load()
            back = (core.model_ready("ft_lm"),
                    _status(srv.url, "/v2/health/ready"),
                    len(list(gen.engine.submit(PROMPT, 4))))
            got[side] = (ready0, first, second, gate, families, dead, back)
        finally:
            srv.stop()
            core.stop()
    assert got["port"] == got["ref"]
    ready0, first, second, gate, families, dead, back = got["port"]
    assert ready0 == (True, 200) and dead == (False, 400)
    assert first == ("ServerError", 503, 0.02)
    assert second == ("ServerError", 503, None)
    assert gate[:2] == (503, None) and "crash-loop breaker" in gate[2]
    assert families == [1, 1, 0]
    assert back == (True, 200, 4)


def test_engine_restart_span_on_a_traced_stream(model):
    got = {}
    for side, trace_mod in (("ref", jtrace), ("port", ttrace)):
        gen = _gen(side, model, supervision={"backoff_base_s": 0.02,
                                             "max_failures": 5,
                                             "window_s": 60.0})
        try:
            list(gen.engine.submit(PROMPT, 4))
            trace = trace_mod.Trace("t-restart", "ft_lm", "1")
            _crash(side, gen, after=0, trace=trace)
            spans = {t[0]: t for t in trace.timestamps}
            fields = spans[trace_mod.ENGINE_RESTART][2]
            got[side] = (fields["retryable"], fields["retry_after_s"],
                         fields["failure"])
        finally:
            gen.engine_supervisor.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"][0] is True and got["port"][1] == 0.02


def test_an_unsupervised_engine_keeps_its_raw_terminal(model):
    got = {}
    for side in SIDES:
        gen = _gen(side, model)
        try:
            list(gen.engine.submit(PROMPT, 4))
            FI[side].get_injector().arm([{"point": "engine_loop",
                                          "after": 0, "times": 1,
                                          "message": "raw boom"}])
            with pytest.raises(FI[side].InjectedFault, match="raw boom"):
                list(gen.engine.submit(PROMPT, 8))
            FI[side].get_injector().clear()
            got[side] = (gen.engine.healthy(), gen.engine_healthy(),
                         gen.engine_supervisor)
        finally:
            gen.engine.stop()
    assert got["port"] == got["ref"] == (False, False, None)


def test_a_forced_queue_full_sheds_like_the_reference(model):
    got = {}
    for side in SIDES:
        eng = _gen(side, model).engine
        try:
            list(eng.submit(PROMPT, 4))
            FI[side].get_injector().arm([{"point": "queue_full",
                                          "after": 0, "times": 1}])
            with pytest.raises(Exception) as ei:
                list(eng.submit(PROMPT, 4))
            FI[side].get_injector().clear()
            with eng._lock:
                drained = eng._requests_accepted == eng._requests_closed
            got[side] = (ei.value.status, ei.value.retry_after,
                         str(ei.value), drained, len(list(eng.submit(
                             PROMPT, 4))))
        finally:
            eng.stop()
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (503, 1.0) and "queue is full" in got["port"][2]


class _WedgedThread:
    def join(self, timeout=None):
        pass

    def is_alive(self):
        return True


def test_a_wedged_thread_is_reported_with_the_flight_tail(model, caplog):
    jcfg, jparams, tcfg, tparams = model
    got = {}
    for side, eng, logger in (
            ("ref", JaxEngine(jcfg, dict(jparams), n_slots=2, chunk=4),
             "client_tpu.server.generation"),
            ("port", ContinuousBatchingEngine(tcfg, tparams, n_slots=2,
                                              chunk=4, device="cpu"),
             "client_tpu_torch.server.generation")):
        eng._started = True
        eng._thread = _WedgedThread()
        eng.flight.record(ns=1, phase="dispatch", slots_active=2)
        caplog.clear()
        with caplog.at_level("ERROR", logger=logger):
            eng.stop()
        got[side] = next(r.getMessage() for r in caplog.records
                         if "did not exit within" in r.getMessage())
    assert got["port"] == got["ref"]
    assert "slots_active" in got["port"]


def test_the_failure_path_lint_passes_on_the_port():
    """The reference's ``check_tree`` over the port's server package: no
    bare except, no BaseException catch outside ``generation.py::_run``
    and ``supervision.py::_restart``, no unmarked silent swallow."""
    root = os.path.join(REPO, "client_tpu_torch", "server")
    assert check_failure_paths.check_tree(root) == []
    assert ContinuousBatchingEngine._run.__name__ == "_run"
    assert tsup.EngineSupervisor._restart.__name__ == "_restart"


def test_the_supervision_block_matches_the_reference(model):
    """The generator's config carries the reference's ``supervision`` block
    (a dict, True, or a disabled block, which drops it), and the
    ``generation_engine`` block the watchdog's two fields."""
    got = {}
    for side in SIDES:
        rows = []
        for knob in ({"backoff_base_s": 0.25, "max_failures": 3}, True,
                     {"enabled": False}, None):
            gen = _gen(side, model, supervision=knob)
            j = gen.config.to_json()
            rows.append((j.get("supervision"),
                         j["generation_engine"]["watchdog"],
                         j["generation_engine"]["watchdog_interval_s"],
                         gen.engine_supervisor is not None))
            gen.shutdown()
        got[side] = rows
    assert got["port"] == got["ref"]
    assert got["port"][0][0]["max_failures"] == 3
    assert got["port"][2][0] is None and got["port"][3][3] is False
    with pytest.raises(ValueError, match="unknown SupervisionConfig"):
        _gen("port", model, supervision={"backoff": 1})


def test_core_stop_cancels_a_pending_restart(model):
    """An engine dies under a supervisor whose backoff is still running
    when the server stops: the stop is terminal, so no engine is rebuilt
    after it, in either package."""
    got = {}
    for side in SIDES:
        core = TpuInferenceServer() if side == "ref" \
            else TorchInferenceServer()
        gen = _gen(side, model, supervision={"backoff_base_s": 0.3,
                                             "max_failures": 5})
        core.register_model(gen)
        sup = gen.engine_supervisor
        dead = gen.engine
        terminal = _crash(side, gen, after=0, budget=8)
        dead._thread.join(timeout=30)
        restarting = sup.snapshot()["restarting"]
        core.stop()
        time.sleep(0.6)
        got[side] = (terminal, restarting, sup.restarts,
                     gen.engine is dead, sup.healthy())
    assert got["port"] == got["ref"]
    assert got["port"] == (("ServerError", 503, 0.3), True, 0, True, False)
