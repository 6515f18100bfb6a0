"""Faults of the port found against the JAX package, each held by a test
that sends both packages the same input (ROADMAP, section C):

- C1: a decoupled request that carries the wire ``timeout``. Both packages
  turn it into the stream's deadline: the stream runs under it and ends
  with a 504 once it passes. (The port first refused such a request with
  a 400 until its streaming context was ported; the test keeps its name.
  ``tests/test_torch_stream_context.py`` drives the deadline mid-decode
  under a controlled clock.)
- C2: the ``tenant_id`` and ``slo_class`` labels are parsed and validated
  by both HTTP front ends: the same statuses and the same parsed labels.
- C3: the continuous generator's model config carries the
  ``generation_engine`` and ``prefix_cache`` blocks with the effective
  knobs, equal to the reference's over the ported keys (``backend`` and
  ``platform`` say ``"pytorch"`` in the port and ``"python"`` in the
  reference, and the instance kind names the card, by design).
- C4: the tenant and class labels a request carries are resolved through
  the SLO statistics' cardinality cap before the request is built (past
  32 distinct tenants later ones become ``__other__``), so both default
  engines' slot tables show the same labels, and both report the same
  per-label counts and overflow counters.
- C5: a generator whose engine thread died is not ready: ``model_ready``,
  ``ready`` and ``/v2/health/ready`` say so in both packages, the port's
  ``client_tpu_engine_up`` reads 0, and an unload and reload of the model
  makes it ready again.
- C6: the HTTP statistics of a generator carry the engine's counters
  under ``runtime``, as the reference's do.
- C7: ``core.stop()`` stops a generator's engine and stages no fresh one,
  and a model whose ``unload`` raises keeps neither the other models nor
  the shared-memory cleanup from running.
- The dead engine's gate (repaired with the supervision slice): a submit
  to an engine whose thread died gets the reference's answer in each
  state — restarting (503 with ``Retry-After``), crash-loop breaker
  tripped (503, no hint), unsupervised (503, no hint, the reference's
  text) — where the port had one message for all three.
- C10: ``models/resnet.params_from_jax`` defaulted to the CPU; like
  ``transformer.params_from_jax`` it now takes ``device`` with no
  default, so a caller that names no device gets a ``TypeError`` instead
  of host tensors.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import add_sub as jadd
from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.server import TpuInferenceServer
from client_tpu.server import http_server as jhttp
from client_tpu.server import types as jtypes
from client_tpu.server.generation import (
    ContinuousBatchingEngine as JaxEngine,
)
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import http_server as thttp
from client_tpu_torch.server import types as ttypes
from client_tpu_torch.server.generation import ContinuousBatchingEngine

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


# ---------------------------------------------------------------- C1

def _stream(core, types, timeout_us: int) -> list:
    """One decoupled request through ``core.infer`` with a callback: the
    (error status or None, final) of every response, or the status the
    call itself raised with."""
    prompt = np.arange(1, 9, dtype=np.int32)
    req = types.InferRequest(
        model_name="lm", timeout_us=timeout_us,
        inputs=[types.InferTensor("PROMPT", "INT32", (8,), data=prompt),
                types.InferTensor("MAX_TOKENS", "INT32", (1,),
                                  data=np.asarray([40], np.int32))])
    got, done = [], threading.Event()

    def cb(resp, final):
        got.append((resp.error_status if resp.error is not None else None,
                    final))
        if final:
            done.set()

    try:
        core.infer(req, response_callback=cb)
    except types.ServerError as e:
        return [("raised", e.status, str(e))]
    assert done.wait(timeout=120)
    return got


def test_c1_a_stream_with_a_timeout_is_refused_not_ignored(model):
    """The wire timeout is a deadline in both packages: no longer refused
    by the port, never ignored."""
    jcfg, jparams, tcfg, tparams = model
    ref = TpuInferenceServer()
    ref.register_model(jlm.make_continuous_generator(
        "lm", cfg=jcfg, params=dict(jparams), n_slots=2, chunk_size=4))
    port = TorchInferenceServer()
    port.register_model(tlm.make_continuous_generator(
        "lm", cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        device="cpu"))
    try:
        # 1 us: the deadline has passed before the first token; 10 min and
        # none: the stream runs to its budget under the deadline
        runs = {us: (_stream(ref, jtypes, us), _stream(port, ttypes, us))
                for us in (1, 600_000_000, 0)}
    finally:
        ref.stop()
        port.stop()
    for us, (want, got) in runs.items():
        assert got == want, us
    assert runs[1][1] == [(504, True)]
    assert runs[600_000_000][1] == [(None, False)] * 40 + [(None, True)]


# ---------------------------------------------------------------- C2

LABELS = {
    "none": {},
    "well_formed": {"tenant_id": "acme-1", "slo_class": "gold.tier:2"},
    "empty_is_default": {"tenant_id": "", "slo_class": ""},
    "leading_underscore": {"tenant_id": "__other__"},
    "too_long": {"slo_class": "x" * 65},
    "not_a_string": {"tenant_id": 7},
    "space": {"slo_class": "gold tier"},
}


@pytest.fixture(scope="module")
def http_servers():
    ref_core = TpuInferenceServer()
    ref_core.register_model(jadd.make_add_sub("add_sub", 4, "INT32"))
    port_core = TorchInferenceServer()
    port_core.register_model(make_add_sub("add_sub", 4, "INT32",
                                          device="cpu"))
    ref_http = jhttp.HttpInferenceServer(ref_core, port=0).start()
    port_http = thttp.HttpInferenceServer(port_core, port=0).start()
    yield {"ref": ref_http.url, "port": port_http.url}
    ref_http.stop()
    port_http.stop()
    ref_core.stop()
    port_core.stop()


def _header(labels: dict) -> dict:
    x = [0, 1, 2, 3]
    return {"inputs": [
        {"name": "INPUT0", "shape": [4], "datatype": "INT32", "data": x},
        {"name": "INPUT1", "shape": [4], "datatype": "INT32", "data": x}],
        "parameters": dict(labels)}


def _post(url: str, header: dict) -> int:
    req = urllib.request.Request(
        f"http://{url}/v2/models/add_sub/infer", method="POST",
        data=json.dumps(header).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _parsed(mod, types, header: dict):
    try:
        req = mod._wire_to_request("add_sub", "", header, {})
    except types.ServerError as e:
        return ("error", e.status)
    return (req.tenant_id, req.slo_class)


@pytest.mark.parametrize("case", sorted(LABELS))
def test_c2_labels_are_parsed_like_the_reference(http_servers, case):
    header = _header(LABELS[case])
    statuses = {side: _post(url, header)
                for side, url in http_servers.items()}
    assert statuses["port"] == statuses["ref"]
    assert _parsed(thttp, ttypes, header) == _parsed(jhttp, jtypes, header)
    assert (statuses["port"] == 400) == (
        case in ("leading_underscore", "too_long", "not_a_string", "space"))


# ---------------------------------------------------------------- C3

CONFIGS = {
    "slot_plain": dict(),
    "slot_prefix": dict(prefix_cache=True, prefix_blocks=32,
                        prefix_block_len=8, prefix_commit_policy="no-evict"),
    "slot_chunked_prefix": dict(prefill_mode="chunked", prefill_chunk=32,
                                prefill_token_budget=0, prefix_cache=True),
    "slot_batched_no_overlap": dict(prefill=True, overlap=False,
                                    ring_entries=0),
    "paged_plain": dict(kv_layout="paged", kv_block_len=8),
    "paged_prefix": dict(kv_layout="paged", kv_block_len=8,
                         kv_pool_blocks=40, prefix_cache=True,
                         prefix_block_len=8, fetch_stride=2,
                         ring_entries=9),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_c3_generator_config_matches_the_reference(model, case):
    jcfg, jparams, tcfg, tparams = model
    kw = dict(n_slots=3, chunk_size=4, **CONFIGS[case])
    ref = jlm.make_continuous_generator("lm", cfg=jcfg, params=dict(jparams),
                                        **kw)
    port = tlm.make_continuous_generator("lm", cfg=tcfg, params=tparams,
                                         device="cpu", **kw)
    want, got = ref.config.to_json(), port.config.to_json()
    ref.engine.stop()
    port.engine.stop()
    assert (got["backend"], got["platform"]) == ("pytorch", "pytorch")
    assert (want["backend"], want["platform"]) == ("python", "python")
    engine = got.pop("generation_engine")
    assert engine == {k: want["generation_engine"][k] for k in engine}
    assert got.get("prefix_cache") == want.get("prefix_cache")
    assert ("prefix_cache" in got) == bool(kw.get("prefix_cache"))
    for key in ("name", "max_batch_size", "input", "output",
                "model_transaction_policy"):
        assert got[key] == want[key], key
    # the instance kind names the card (KIND_GPU, KIND_TPU); the count is
    # the stream cap
    assert got["instance_group"][0]["count"] \
        == want["instance_group"][0]["count"]


# ---------------------------------------------------------------- C4

def _held_slot_table(engine, table) -> list:
    """Submit four long streams for tenants t36-t39 and read the slot
    table while all four hold a slot. The engine is held at its sweep
    twice: once the first request reached it (until the other three are
    queued), then once every slot is held (while the table is read)."""
    held = [threading.Event(), threading.Event()]
    go = [threading.Event(), threading.Event()]
    sweep = engine._reap_slots

    def reap():
        if not go[0].is_set() and (
                engine._held is not None or engine._pending.qsize()
                or any(s.req is not None for s in engine._slots)):
            held[0].set()
            go[0].wait(60)
        elif go[0].is_set() and not go[1].is_set() and all(
                s.req is not None for s in engine._slots):
            held[1].set()
            go[1].wait(60)
        sweep()

    engine._reap_slots = reap
    outs = [[] for _ in range(4)]

    def submit(i):
        return engine.submit(np.asarray([3, 1 + i, 7], np.int32), 20,
                             tenant_id=f"t{36 + i}",
                             slo_class=f"c{(36 + i) % 10}")

    its = [submit(0)]
    assert held[0].wait(60)
    its += [submit(i) for i in range(1, 4)]
    go[0].set()
    threads = [threading.Thread(target=lambda it=it, o=o: o.extend(it))
               for it, o in zip(its, outs)]
    for th in threads:
        th.start()
    assert held[1].wait(60)
    rows = sorted(({k: r.get(k) for k in ("slot", "active", "tenant",
                                          "slo_class", "prompt_tokens")}
                   for r in table()), key=lambda r: r["slot"])
    go[1].set()
    for th in threads:
        th.join(60)
    assert [len(o) for o in outs] == [20] * 4
    return rows


def _slo_counts(snap: dict) -> dict:
    rows = [{k: r[k] for k in ("tenant", "slo_class", "admitted",
                               "completed", "failed", "shed", "cancelled",
                               "deadline", "violations")}
            | {"requests": r["window"]["requests"]}
            for r in snap["tenant_classes"]]
    return {k: snap[k] for k in ("max_tenants", "max_classes",
                                 "tenants_tracked", "tenant_overflow",
                                 "class_overflow")} | {"rows": rows}


def test_c4_tenant_labels_are_capped_like_the_reference(model):
    """40 distinct tenants (and 10 undeclared classes) reach both default
    engines: the first 32 tenants keep their labels, later ones are
    ``__other__`` in the slot table and the SLO statistics, classes past
    the 8 undeclared ones collapse too, and every count is equal."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(n_slots=4, chunk=4)
    ref = JaxEngine(jcfg, dict(jparams), **kw).start()
    port = ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                    **kw).start()
    got = {}
    try:
        for name, eng, table in (
                ("ref", ref, lambda: ref.debug_snapshot()["slots"]),
                ("port", port, lambda: port.stats()["slots"])):
            for i in range(36):
                toks = list(eng.submit(np.asarray([5, i % 60 + 1], np.int32),
                                       2, tenant_id=f"t{i}",
                                       slo_class=f"c{i % 10}"))
                assert len(toks) == 2
            slots = _held_slot_table(eng, table)
            assert _wait_idle(eng)
            got[name] = (slots, _slo_counts(eng.slo_snapshot()))
    finally:
        ref.stop()
        port.stop()
    assert got["port"] == got["ref"]
    slots, counts = got["port"]
    assert [r["tenant"] for r in slots] == ["__other__"] * 4
    assert counts["tenants_tracked"] == 32
    assert counts["tenant_overflow"] == 8
    assert counts["class_overflow"] > 0


def _wait_idle(engine, timeout: float = 60.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        with engine._lock:
            if engine._requests_accepted == engine._requests_closed:
                return True
        time.sleep(0.005)
    return False


# ---------------------------------------------------------------- C5

def _lm_core(pkg: str, model, http: bool = False):
    """A core serving one small generator ``lm`` (2 slots, chunk 4) of
    either package with the same weights, optionally behind its HTTP front
    end."""
    jcfg, jparams, tcfg, tparams = model
    if pkg == "ref":
        core = TpuInferenceServer()
        lm = jlm.make_continuous_generator(
            "lm", cfg=jcfg, params=dict(jparams), n_slots=2, chunk_size=4)
        mod = jhttp
    else:
        core = TorchInferenceServer()
        lm = tlm.make_continuous_generator(
            "lm", cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
            device="cpu")
        mod = thttp
    core.register_model(lm)
    srv = mod.HttpInferenceServer(core, port=0).start() if http else None
    return core, lm, srv


def _get_status(url: str, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://{url}{path}", timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _readiness(core, srv) -> tuple:
    return (core.model_ready("lm"), core.ready(),
            _get_status(srv.url, "/v2/health/ready"),
            _get_status(srv.url, "/v2/models/lm/ready"))


def test_c5_a_dead_engine_reads_as_not_ready(model):
    """An engine whose dispatch raises dies with its error; from then on
    both packages answer not ready, everywhere readiness is read."""
    from client_tpu_torch.server.metrics import (
        parse_prometheus_text,
        sample_value,
    )

    got = {}
    for pkg in ("ref", "port"):
        core, lm, srv = _lm_core(pkg, model, http=True)
        try:
            _stream(core, jtypes if pkg == "ref" else ttypes, 0)
            before = _readiness(core, srv)
            engine = lm.engine

            def boom(*a, **k):
                raise RuntimeError("injected dispatch failure")

            engine._dispatch = boom
            with pytest.raises(RuntimeError, match="injected"):
                list(engine.submit(np.asarray([1, 2, 3], np.int32), 4))
            engine._thread.join(timeout=30)
            assert not engine._thread.is_alive()
            got[pkg] = (before, engine.healthy(), _readiness(core, srv))
            if pkg == "port":
                parsed = parse_prometheus_text(core.metrics_text())
                assert sample_value(
                    parsed, "client_tpu_engine_up",
                    {"model": "lm", "version": "1"}) == 0
        finally:
            srv.stop()
            core.stop()
    assert got["port"] == got["ref"]
    assert got["port"] == ((True, True, 200, 200), False,
                           (False, False, 400, 400))


def test_c5_unload_and_reload_restore_readiness(model):
    """The model's unload stages a fresh engine: after an unload and a
    load the dead model is ready again and serves."""
    got = {}
    for pkg in ("ref", "port"):
        core, lm, srv = _lm_core(pkg, model, http=True)
        types = jtypes if pkg == "ref" else ttypes
        try:
            lm.engine._fail_all(RuntimeError("dead"))
            dead = _readiness(core, srv)
            lm.unload()
            lm.load()
            got[pkg] = (dead, _readiness(core, srv),
                        _stream(core, types, 0)[-1])
        finally:
            srv.stop()
            core.stop()
    assert got["port"] == got["ref"]
    assert got["port"] == ((False, False, 400, 400), (True, True, 200, 200),
                           (None, True))


# ---------------------------------------------------------------- C6

def test_c6_http_statistics_carry_the_engine_block(model):
    """The reference's ``test_engine_runtime_stats``, read over HTTP: the
    same greedy stream through both packages, and the same engine counters
    under ``runtime``."""
    keys = ("n_slots", "chunk", "slots_active", "queue_depth",
            "tokens_emitted", "requests_completed", "requests_failed")
    got = {}
    for pkg in ("ref", "port"):
        core, _lm, srv = _lm_core(pkg, model, http=True)
        try:
            assert _stream(core, jtypes if pkg == "ref" else ttypes, 0) \
                == [(None, False)] * 40 + [(None, True)]
            with urllib.request.urlopen(
                    f"http://{srv.url}/v2/models/lm/stats",
                    timeout=60) as r:
                rt = json.loads(r.read())["model_stats"][0]["runtime"]
        finally:
            srv.stop()
            core.stop()
        assert rt["chunks_dispatched"] >= 1
        got[pkg] = {k: rt[k] for k in keys}
    assert got["port"] == got["ref"]
    assert got["port"]["tokens_emitted"] == 40
    assert got["port"]["requests_completed"] == 1


# ---------------------------------------------------------------- C7

def test_c7_stop_stages_no_fresh_engine(model, monkeypatch):
    """``core.stop()`` ends the generator's engine: one engine built in
    all, the one serving, and it is stopped."""
    built = []

    class Counting(tlm.ContinuousBatchingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(tlm, "ContinuousBatchingEngine", Counting)
    core, lm, _ = _lm_core("port", model)
    assert _stream(core, ttypes, 0)[-1] == (None, True)
    assert len(built) == 1
    core.stop()
    assert len(built) == 1
    assert built[0]._stopping and not built[0]._thread.is_alive()


def test_c7_a_failing_unload_keeps_stop_going(model, tmp_path):
    """A model whose ``unload`` raises: the models after it still stop
    and every shared-memory region is still unregistered."""
    from client_tpu_torch.utils import shared_memory as shm

    def fail():
        raise RuntimeError("unload failed")

    broken = make_add_sub("broken", 4, "INT32", device="cpu")
    broken.unload = fail
    other = make_add_sub("add_sub", 4, "INT32", device="cpu")
    stopped = []
    other.unload = lambda: stopped.append(1)
    core = TorchInferenceServer()
    core.register_model(broken)
    core.register_model(other)
    region = shm.create_shared_memory_region("c7", "/c7_region", 64)
    try:
        core.system_shm.register("c7", "/c7_region", 0, 64)
        assert core.system_shm.metrics() == (1, 64)
        core.stop()
        assert stopped == [1]
        assert core.system_shm.metrics() == (0, 0)
        assert core.system_shm.status() == []
    finally:
        shm.destroy_shared_memory_region(region)


# ------------------------------------------------ the dead engine's gate

GATES = {
    # a restart is pending (a long backoff keeps the engine dead while the
    # gate is asked): 503 with the next backoff as Retry-After
    "restarting": {"supervision": {"backoff_base_s": 5.0,
                                   "max_failures": 5}},
    # this death trips the breaker: 503 with no hint
    "breaker": {"supervision": {"backoff_base_s": 5.0, "max_failures": 1}},
    # no supervisor: the raw terminal, then a 503 with no hint
    "unsupervised": {},
}


def _answer(call) -> tuple:
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the answer is the datum
        return (type(e).__name__, getattr(e, "status", None),
                getattr(e, "retry_after", None), str(e))
    return None


@pytest.mark.parametrize("case", sorted(GATES))
def test_a_dead_engine_answers_a_submit_like_the_reference(model, case):
    """An engine killed by an ``engine_loop`` fault answers its in-flight
    stream and then a new submit as the reference does, in each of the
    three states: restarting (503 with ``Retry-After``), the crash-loop
    breaker tripped (503, no hint) and unsupervised (the raw error, then
    the reference's 503 with no hint). Each package's own fault injector
    is armed for its run."""
    from client_tpu.server import faultinject as jfi
    from client_tpu_torch.server import faultinject as tfi

    jcfg, jparams, tcfg, tparams = model
    prompt = np.arange(1, 9, dtype=np.int32)
    got = {}
    for pkg, lm, fi, kw in (
            ("ref", jlm, jfi, dict(cfg=jcfg, params=dict(jparams))),
            ("port", tlm, tfi, dict(cfg=tcfg, params=tparams,
                                    device="cpu"))):
        gen = lm.make_continuous_generator("lm", n_slots=2, chunk_size=4,
                                           **kw, **GATES[case])
        try:
            fi.get_injector().arm([{"point": "engine_loop", "after": 1,
                                    "times": 1}])
            dead = gen.engine
            stream = _answer(lambda: list(dead.submit(prompt, 30)))
            fi.get_injector().clear()
            # the thread's last act notifies the supervisor: ask the gate
            # once that happened
            dead._thread.join(timeout=30)
            gate = _answer(lambda: list(dead.submit(prompt, 4)))
            got[pkg] = (stream, gate, gen.engine_healthy())
        finally:
            fi.get_injector().clear()
            gen.shutdown()
    assert got["port"] == got["ref"]
    stream, gate, healthy = got["port"]
    assert not healthy
    if case == "restarting":
        assert stream[:3] == ("ServerError", 503, 5.0)
        assert gate == ("ServerError", 503, 5.0,
                        "generation engine is restarting")
    elif case == "breaker":
        assert stream[:3] == ("ServerError", 503, None)
        assert "crash-loop breaker" in stream[3]
        assert gate[:3] == ("ServerError", 503, None)
        assert "crash-loop breaker tripped" in gate[3]
    else:
        assert stream[0] == "InjectedFault"
        assert gate == ("ServerError", 503, None,
                        "generation engine is down (engine failure, no "
                        "supervisor); unavailable until an operator reload")


def test_c10_resnet_params_from_jax_names_no_default_device():
    from client_tpu.models import resnet as jr
    from client_tpu_torch.models import resnet as tr

    tree = jr.init_params(0, 10, jnp.float32)
    with pytest.raises(TypeError):
        tr.params_from_jax(tree)
    with pytest.raises(TypeError):
        tt.params_from_jax(jt.init_params(jt.TransformerConfig(
            vocab=16, d_model=8, n_heads=2, n_layers=1, d_ff=16,
            max_seq=8), jax.random.PRNGKey(0)))
    carried = tr.params_from_jax(tree, device="cpu")
    assert carried["fc"]["w"].device.type == "cpu"
