"""The port's tracer against the JAX package's, on the CPU.

- ``Tracer`` unit semantics: the reference's ``TestTracerSampling`` cases
  (``tests/test_observability.py``) run against both packages' tracers,
  with equal outcomes; the parent link and the unsampled-parent sentinel.
- Export through the serving core: the reference's ``TestTraceExport``
  cases that apply to the port (the direct and the dynamic-batching paths,
  the TENSORS level, a request that fails before a sink exists, the
  ``log_frequency`` buffer); both packages' JSONL exports are equal apart
  from timestamps and random trace ids.
- A traced generation request (``tests/test_generation_observability.py``)
  gives the same span names in the same order in both packages, with the
  same fields, in each engine configuration that stamps a span of its own.
  Spans come from two threads, the engine's and the stream consumer's, so
  each thread's sequence is compared on its own.
- The HTTP front ends: the trace-settings routes (server and model scope)
  answer the same JSON; ``triton-trace-id`` propagates and is echoed; the
  structured access log.
"""

import json
import logging
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
from client_tpu.server import trace as jtrace
from client_tpu.server import types as jtypes
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import http_server as thttp
from client_tpu_torch.server import trace as ttrace
from client_tpu_torch.server import types as ttypes

TRACERS = {"ref": jtrace.Tracer, "port": ttrace.Tracer}
SPAN_ORDER = ["REQUEST_START", "QUEUE_START", "COMPUTE_START",
              "COMPUTE_INPUT_END", "COMPUTE_OUTPUT_START", "REQUEST_END"]
ON = {"trace_level": ["TIMESTAMPS"], "trace_rate": "1"}


# ---------------------------------------------------------------- sampling

def _off_by_default(t):
    return t.sample("m", "1") is None


def _rate_samples_every_nth(t):
    t.update_settings(settings={"trace_level": ["TIMESTAMPS"],
                                "trace_rate": "3"})
    return [t.sample("m", "1") is not None for _ in range(9)]


def _count_budget_exhausts(t):
    t.update_settings(settings={"trace_level": ["TIMESTAMPS"],
                                "trace_rate": "1", "trace_count": "2"})
    return [t.sample("m", "1") is not None for _ in range(5)]


def _per_model_override(t):
    t.update_settings(settings={"trace_level": ["TIMESTAMPS"],
                                "trace_rate": "1"})
    t.update_settings("quiet", {"trace_level": ["OFF"]})
    got = [t.sample("quiet", "1") is None, t.sample("other", "1") is not None]
    # clearing the override falls back to the global level
    t.update_settings("quiet", {"trace_level": None})
    return got + [t.sample("quiet", "1") is not None,
                  t.get_settings("quiet")]


def _propagated_id_bypasses_rate(t):
    t.update_settings(settings={"trace_level": ["TIMESTAMPS"],
                                "trace_rate": "1000000"})
    tr = t.sample("m", "1", propagated_id="deadbeef")
    return [tr.id, t.sample("m", "1") is None]


def _child_rides_parent(t):
    t.update_settings(settings={"trace_level": ["TIMESTAMPS"],
                                "trace_rate": "1", "trace_count": "1"})
    parent = t.sample("ens", "1")
    child = t.sample("step", "1", parent=parent)
    return [child.parent_id == parent.id, t.sample("x", "1") is None]


def _unsampled_parent(t):
    t.update_settings(settings={"trace_level": ["TIMESTAMPS"],
                                "trace_rate": "1"})
    mod = ttrace if isinstance(t, ttrace.Tracer) else jtrace
    return [t.sample("step", "1", parent=mod.UNSAMPLED_PARENT) is None,
            t.sample("top", "1") is not None]


def _settings_round_trip(t):
    merged = t.update_settings(settings={"trace_rate": 7,
                                         "trace_file": "/x.jsonl"})
    model = t.update_settings("m", {"trace_level": ["TENSORS"]})
    reset = t.update_settings(settings={"trace_rate": None})
    return [merged, model, reset, t.get_settings()]


SAMPLING = {
    "off_by_default": (_off_by_default, True),
    "rate_samples_every_nth": (_rate_samples_every_nth,
                               [False, False, True] * 3),
    "count_budget_exhausts": (_count_budget_exhausts,
                              [True, True, False, False, False]),
    "per_model_override": (_per_model_override, None),
    "propagated_id_bypasses_rate": (_propagated_id_bypasses_rate,
                                    ["deadbeef", True]),
    "child_rides_parent": (_child_rides_parent, [True, True]),
    "unsampled_parent": (_unsampled_parent, [True, True]),
    "settings_round_trip": (_settings_round_trip, None),
}


@pytest.mark.parametrize("case", sorted(SAMPLING))
def test_tracer_sampling_matches_the_reference(case):
    fn, want = SAMPLING[case]
    got = {side: fn(cls()) for side, cls in TRACERS.items()}
    assert got["port"] == got["ref"]
    if want is not None:
        assert got["port"] == want


def test_span_constants_and_defaults_match_the_reference():
    names = [n for n in dir(jtrace) if n.isupper()
             and isinstance(getattr(jtrace, n), (str, int, tuple, dict))]
    for n in names:
        assert getattr(ttrace, n) == getattr(jtrace, n), n
    assert ttrace.TOKEN_EMIT_SAMPLE_EVERY == 8


def test_flush_all_reaches_every_live_tracer(tmp_path):
    t = ttrace.Tracer()
    tf = str(tmp_path / "t.jsonl")
    t.update_settings(settings=dict(ON, log_frequency="100", trace_file=tf))
    tr = t.sample("m", "1")
    tr.event(ttrace.REQUEST_START)
    t.release(tr)
    ttrace.flush_all()
    (line,) = open(tf).read().splitlines()
    assert json.loads(line)["timestamps"][0]["name"] == "REQUEST_START"


# ------------------------------------------------------------------ export

def _normalize(trace: dict) -> dict:
    """A trace without its clock readings and its random id."""
    t = dict(trace)
    t.pop("id")
    t["timestamps"] = [{k: v for k, v in s.items()
                        if k not in ("ns", "dur_ns")}
                       for s in trace["timestamps"]]
    return t


def _add_sub_core(side: str, **kw):
    if side == "ref":
        core = TpuInferenceServer()
        core.register_model(jadd.make_add_sub("add_sub", 4, "INT32", **kw))
    else:
        core = TorchInferenceServer()
        core.register_model(make_add_sub("add_sub", 4, "INT32",
                                         device="cpu", **kw))
    return core


def _req(types, batched: bool = False, name: str = "INPUT0"):
    a = np.arange(4, dtype=np.int32)
    shape = (4,)
    if batched:
        a, shape = a.reshape(1, 4), (1, 4)
    return types.InferRequest(model_name="add_sub", inputs=[
        types.InferTensor(name, "INT32", shape, data=a),
        types.InferTensor("INPUT1", "INT32", shape, data=a)])


def _direct(core, types, tf):
    core.update_trace_settings(settings=dict(ON, trace_file=tf))
    for _ in range(3):
        core.infer(_req(types))


def _batched(core, types, tf):
    core.update_trace_settings(settings=dict(ON, trace_file=tf))
    core.infer(_req(types, batched=True))


def _tensors(core, types, tf):
    core.update_trace_settings(settings={
        "trace_level": ["TENSORS"], "trace_rate": "1", "trace_file": tf})
    core.infer(_req(types))


def _failed(core, types, tf):
    core.update_trace_settings(settings=dict(ON, trace_file=tf))
    with pytest.raises(types.ServerError):
        core.infer(_req(types, name="NOT_AN_INPUT"))
    core.infer(_req(types))


def _log_frequency(core, types, tf):
    import os

    core.update_trace_settings(settings=dict(ON, log_frequency="3",
                                             trace_file=tf))
    core.infer(_req(types))
    core.infer(_req(types))
    assert not os.path.exists(tf)   # buffered below log_frequency
    core.infer(_req(types))
    assert len(open(tf).readlines()) == 3


EXPORT = {"direct": (_direct, {}, [SPAN_ORDER] * 3),
          "dynamic_batching": (_batched, dict(max_batch_size=4,
                                              dynamic_batching=True),
                               [SPAN_ORDER]),
          "tensors": (_tensors, {}, [SPAN_ORDER]),
          "failed_request": (_failed, {}, [["REQUEST_START", "REQUEST_END"],
                                           SPAN_ORDER]),
          "log_frequency": (_log_frequency, {}, [SPAN_ORDER] * 3)}


@pytest.mark.parametrize("case", sorted(EXPORT))
def test_trace_export_matches_the_reference(case, tmp_path):
    fn, kw, want = EXPORT[case]
    got = {}
    for side, types in (("ref", jtypes), ("port", ttypes)):
        tf = str(tmp_path / f"{side}.jsonl")
        core = _add_sub_core(side, **kw)
        try:
            fn(core, types, tf)
        finally:
            core.stop()
        got[side] = [json.loads(line) for line in open(tf)]
    assert [_normalize(t) for t in got["port"]] == \
        [_normalize(t) for t in got["ref"]]
    assert [[s["name"] for s in t["timestamps"]] for t in got["port"]] \
        == want
    for t in got["port"]:
        stamps = [s["ns"] for s in t["timestamps"]]
        assert stamps == sorted(stamps)
    if case == "tensors":
        kinds = {(t["kind"], t["name"]) for t in got["port"][0]["tensors"]}
        assert {("input", "INPUT0"), ("output", "OUTPUT0")} <= kinds


# -------------------------------------------------------- generation spans

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)
PAGED = dict(kv_layout="paged", kv_block_len=8, prefix_cache=True,
             prefix_block_len=8)
LANE = dict(prefill_mode="chunked", prefill_chunk=8, prefill_slots=2,
            prefill_lane_width=8)
GEN_CONFIGS = {
    "slot_token": {},
    "slot_batched": dict(prefill_mode="batched"),
    "paged_chunked_prefix": dict(prefill_mode="chunked", prefill_chunk=8,
                                 **PAGED),
    "lane_paged": dict(LANE, **PAGED),
    "lane_batch_slot": dict(LANE, prefill_lane_batch=2, prefix_cache=True,
                            prefix_block_len=8, prefix_blocks=32),
    "speculation": dict(speculative_gamma=2, draft=True),
}
# the spans the engine thread stamps; the rest are the stream consumer's
ENGINE_SPANS = {"GENERATION_ENQUEUE", "QUEUE_WAIT", "PREFIX_HIT",
                "PREFILL_CHUNK", "PREFILL_END", "LANE_HANDOFF",
                "RING_DELIVER", "SPEC_VERIFY", "SCHED_PREEMPT", "DECODE"}
RNG = np.random.default_rng(5)
PROMPT = RNG.integers(0, 64, size=21).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


def _gen_core(side: str, weights, config: dict):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(config)
    if side == "ref":
        core, lm, cfg, params = TpuInferenceServer(), jlm, jcfg, \
            dict(jparams)
        extra = {}
    else:
        core, lm, cfg, params = TorchInferenceServer(), tlm, tcfg, tparams
        extra = {"device": "cpu"}
    if kw.pop("draft", False):
        kw["speculative_draft"] = (cfg, params)
    core.register_model(lm.make_continuous_generator(
        "lm", cfg=cfg, params=params, n_slots=2, chunk_size=4, **kw,
        **extra))
    return core


def _generate(core, types, prompt, budget: int, trace_id: str = ""):
    toks = []

    def cb(resp, final):
        assert resp.error is None, resp.error
        if resp.outputs:
            toks.append(int(np.asarray(resp.outputs[0].data)[0]))

    req = types.InferRequest(model_name="lm", trace_id=trace_id, inputs=[
        types.InferTensor("PROMPT", "INT32", (len(prompt),), data=prompt),
        types.InferTensor("MAX_TOKENS", "INT32", (1,),
                          data=np.asarray([budget], np.int32))])
    core.infer(req, response_callback=cb)
    return toks


def _split(trace: dict) -> tuple:
    stamps = _normalize(trace)["timestamps"]
    return ([s for s in stamps if s["name"] in ENGINE_SPANS],
            [s for s in stamps if s["name"] not in ENGINE_SPANS])


@pytest.mark.parametrize("config", list(GEN_CONFIGS))
def test_generation_spans_match_the_reference(weights, config, tmp_path):
    """Two traced requests with the same prompt (the second hits the
    prefix cache where there is one), each 18 tokens."""
    got = {}
    for side, types in (("ref", jtypes), ("port", ttypes)):
        tf = str(tmp_path / f"{side}.jsonl")
        core = _gen_core(side, weights, GEN_CONFIGS[config])
        try:
            core.update_trace_settings(settings=dict(ON, trace_file=tf))
            toks = [_generate(core, types, PROMPT, 18, trace_id=f"t{i}")
                    for i in range(2)]
        finally:
            core.stop()
        got[side] = (toks, [json.loads(line) for line in open(tf)])
    assert got["port"][0] == got["ref"][0]
    traces = {side: got[side][1] for side in got}
    assert [t["id"] for t in traces["port"]] == ["t0", "t1"]
    for ref, port in zip(traces["ref"], traces["port"]):
        assert _split(port) == _split(ref)
        names = [s["name"] for s in port["timestamps"]]
        assert names[0] == "REQUEST_START" and names[-1] == "REQUEST_END"
        # FIRST_TOKEN, then TOKEN_EMIT on the 8th and the 16th response
        assert [n for n in names if n in ("FIRST_TOKEN", "TOKEN_EMIT")] == \
            ["FIRST_TOKEN", "TOKEN_EMIT", "TOKEN_EMIT"]
        assert {"GENERATION_ENQUEUE", "QUEUE_WAIT", "DECODE",
                "RING_DELIVER"} <= set(names)
    second = {s["name"] for s in traces["port"][1]["timestamps"]}
    first = {s["name"] for s in traces["port"][0]["timestamps"]}
    expect = {"slot_batched": ("PREFILL_END", first),
              "paged_chunked_prefix": ("PREFIX_HIT", second),
              "lane_paged": ("LANE_HANDOFF", first),
              "lane_batch_slot": ("PREFILL_CHUNK", first),
              "speculation": ("SPEC_VERIFY", first)}
    if config in expect:
        name, seen = expect[config]
        assert name in seen


# ------------------------------------------------------------- front ends

@pytest.fixture(scope="module")
def http_servers():
    out = {}
    for side, mod in (("ref", jhttp), ("port", thttp)):
        core = _add_sub_core(side)
        out[side] = (core, mod.HttpInferenceServer(core, port=0).start())
    yield {side: srv.url for side, (_core, srv) in out.items()}
    for core, srv in out.values():
        srv.stop()
        core.stop()


def _call(url: str, path: str, body=None, headers=None) -> tuple:
    req = urllib.request.Request(
        f"http://{url}{path}", method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


TRACE_CALLS = [
    ("/v2/trace/setting", None),
    ("/v2/models/add_sub/trace/setting", None),
    ("/v2/trace/setting", {"trace_level": ["TIMESTAMPS"], "trace_rate": "2",
                           "log_frequency": "0"}),
    ("/v2/models/add_sub/trace/setting", {"trace_rate": "1",
                                          "trace_count": 5}),
    ("/v2/models/add_sub/trace/setting", None),
    ("/v2/trace/setting", None),
    ("/v2/models/add_sub/trace/setting", {"trace_rate": None}),
    ("/v2/trace/setting", {"trace_level": None, "trace_rate": None}),
]


def test_trace_settings_routes_answer_like_the_reference(http_servers):
    got = {side: [_call(url, path, body)[:2] for path, body in TRACE_CALLS]
           for side, url in http_servers.items()}
    assert got["port"] == got["ref"]
    status, body = got["port"][3]
    assert status == 200
    assert json.loads(body)["trace_count"] == ["5"]
    assert json.loads(got["port"][-1][1])["trace_level"] == ["OFF"]


def _infer_body() -> dict:
    x = [0, 1, 2, 3]
    return {"inputs": [
        {"name": "INPUT0", "shape": [4], "datatype": "INT32", "data": x},
        {"name": "INPUT1", "shape": [4], "datatype": "INT32", "data": x}]}


def test_trace_id_header_propagates_and_echoes(http_servers):
    got = {}
    for side, url in http_servers.items():
        path = "/v2/models/add_sub/infer"
        _call(url, "/v2/trace/setting", {"trace_level": ["TIMESTAMPS"],
                                         "trace_rate": "1000000"})
        # a propagated id forces sampling past the rate
        _s, _b, forced = _call(url, path, _infer_body(),
                               {"triton-trace-id": "cafe01"})
        _s, _b, unsampled = _call(url, path, _infer_body())
        _call(url, "/v2/trace/setting", {"trace_rate": "1"})
        _s, _b, sampled = _call(url, path, _infer_body())
        _call(url, "/v2/trace/setting", {"trace_level": None,
                                         "trace_rate": None})
        _s, _b, off = _call(url, path, _infer_body(),
                            {"triton-trace-id": "cafe02"})
        got[side] = (forced.get("triton-trace-id"),
                     unsampled.get("triton-trace-id"),
                     len(sampled.get("triton-trace-id", "")),
                     off.get("triton-trace-id"))
    assert got["port"] == got["ref"]
    assert got["port"] == ("cafe01", None, 16, None)


def _access(caplog) -> list:
    return [r.getMessage() for r in caplog.records
            if r.name == "client_tpu_torch.server.http.access"]


def test_access_log_records_each_request(caplog):
    core = _add_sub_core("port")
    srv = thttp.HttpInferenceServer(core, port=0, access_log=True).start()
    try:
        with caplog.at_level(logging.INFO,
                             logger="client_tpu_torch.server.http.access"):
            calls = (("/v2/health/live", None),
                     ("/v2/models/nope/ready", None),
                     ("/v2/models/add_sub/infer", _infer_body()))
            for k, (path, body) in enumerate(calls, start=1):
                _call(srv.url, path, body)
                # the handler writes its record once the response is sent,
                # so the client can return first, and each call opens its
                # own connection (its own handler thread): wait for record
                # k before request k + 1, or two records can swap places
                end = time.monotonic() + 10
                while time.monotonic() < end and len(_access(caplog)) < k:
                    time.sleep(0.01)
    finally:
        srv.stop()
        core.stop()
    lines = _access(caplog)
    assert [line.split(" latency_us=")[0] for line in lines] == [
        "method=GET path=/v2/health/live status=200",
        "method=GET path=/v2/models/nope/ready status=400",
        "method=POST path=/v2/models/add_sub/infer status=200"]
