"""The port's Chrome-trace timeline (client_tpu_torch.server.timeline), its
debug routes and the OpenMetrics exemplars, held against the JAX package on
the CPU.

- The validator: the reference test's documents get the same verdicts
  from both packages' ``validate_chrome_trace``.
- The layout: the same traces, flight ring and incidents give the same
  document from both packages' ``build_timeline`` (the reference test's
  synthetic fleet model, and a traced run of the port's engine with the
  dedicated lane), with the reference test's process, track and async
  checks.
- Stride honesty: the port's DECODE spans are bounded by emit stamps at
  fetch stride 1 and 4; the fetch lag lives in RING_DELIVER.
- ``/v2/debug/timeline`` and ``/v2/debug/traces``: 404 without
  ``--debug-endpoints`` and (the timeline) for an unknown model; with the
  flag a valid document with the decode-lane track and one track per
  traced request, and the completed traces; the gRPC
  ``client-tpu-debug-traces`` trailer only with the flag.
- Exemplars (the reference's ``TestMetricExemplars``, which the port's
  metrics tests did not cover): present, capped and resolvable to real
  traces while tracing, absent when it is off, and never rendered outside
  the exemplar registry, past the cap or with a malformed trace id.
- A routed fleet (the reference's ``TestFleetTimelineExport``): two
  traced tenants' requests through a two-replica fleet with the dedicated
  lane and the prefix cache on each package's server; both exports are
  valid under both validators and carry the same processes, the same
  span names, FLEET_ROUTE decisions, handoff aggregates and request
  tracks inside the replica processes.
"""

import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import transformer as jt
from client_tpu.server import timeline as jtl
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.models.decoder_lm import make_continuous_generator
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import metrics as tm
from client_tpu_torch.server import timeline as ttl
from client_tpu_torch.server import trace as trace_mod
from client_tpu_torch.server.generation import ContinuousBatchingEngine
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.server.types import (
    InferRequest,
    InferTensor,
    ServerError,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_metrics_names  # noqa: E402  (the reference's lint)

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **KW)
    return tcfg, tparams


def test_the_track_constants_are_the_references():
    for name in ("TID_DECODE_LANE", "TID_PREFILL_LANE", "TID_SPEC_RUNGS",
                 "TID_HANDOFFS", "TID_PREEMPTIONS", "TID_LIFECYCLE",
                 "TID_INCIDENTS", "REQUEST_TID_BASE", "_TRACK_NAMES",
                 "_ASYNC_SPANS"):
        assert getattr(ttl, name) == getattr(jtl, name), name


# ---------------------------------------------------------------- validator

VALID = {"traceEvents": [
    {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "r0"}},
    {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
     "args": {"name": "decode lane"}},
    {"ph": "X", "pid": 1, "tid": 1, "name": "decode", "ts": 10.0,
     "dur": 5.0, "args": {}},
    {"ph": "i", "pid": 1, "tid": 1, "name": "stamp", "ts": 11.0, "s": "t",
     "args": {}},
    {"ph": "C", "pid": 1, "name": "occupancy", "ts": 10.0,
     "args": {"slots_active": 1}},
    {"ph": "b", "pid": 1, "tid": 1, "name": "DECODE", "cat": "device",
     "id": "t:1", "ts": 10.0, "args": {}},
    {"ph": "e", "pid": 1, "tid": 1, "name": "DECODE", "cat": "device",
     "id": "t:1", "ts": 20.0, "args": {}},
], "displayTimeUnit": "ms"}
BAD_EVENTS = {
    "unknown_ph": ({"ph": "Z", "pid": 1, "name": "x", "ts": 1.0},
                   "unknown ph"),
    "no_pid": ({"ph": "X", "name": "x", "ts": 1.0, "dur": 1.0},
               "missing pid/name"),
    "no_dur": ({"ph": "X", "pid": 1, "name": "x", "ts": 1.0},
               "X without valid dur"),
    "bad_ts": ({"ph": "X", "pid": 1, "name": "x", "ts": -5.0, "dur": 1.0},
               "bad ts"),
    "scope": ({"ph": "i", "pid": 1, "name": "x", "ts": 1.0, "s": "q"},
              "instant scope"),
    "async": ({"ph": "b", "pid": 1, "name": "x", "ts": 1.0},
              "without id/cat"),
    "meta": ({"ph": "M", "pid": 1, "name": "window_name",
              "args": {"name": "?"}}, "bad metadata"),
    "not_object": ("x", "not an object"),
}
DOCS = {
    "valid": VALID,
    "not_a_document": {"events": []},
    "partial_overlap": {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "b", "ts": 5.0,
         "dur": 10.0}]},
    "nested_and_back_to_back": {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 1, "name": "outer", "ts": 0.0,
         "dur": 10.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "inner", "ts": 2.0,
         "dur": 3.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "next", "ts": 10.0000001,
         "dur": 4.0},
        {"ph": "X", "pid": 1, "tid": 2, "name": "other", "ts": 1.0,
         "dur": 100.0}]},
}


@pytest.mark.parametrize("case", sorted(BAD_EVENTS))
def test_malformed_events_get_the_references_verdict(case):
    ev, want = BAD_EVENTS[case]
    doc = {"traceEvents": [ev]}
    got = ttl.validate_chrome_trace(doc)
    assert got == jtl.validate_chrome_trace(doc)
    assert got and want in got[0]


@pytest.mark.parametrize("case", sorted(DOCS))
def test_documents_get_the_references_verdict(case):
    got = ttl.validate_chrome_trace(DOCS[case])
    assert got == jtl.validate_chrome_trace(DOCS[case])
    if case in ("valid", "nested_and_back_to_back"):
        assert got == []
    elif case == "partial_overlap":
        assert "partially overlaps" in got[0]
    else:
        assert got == ["document must be {'traceEvents': [...]}"]


# ------------------------------------------------------------------- layout

def _flight_entry(ns, i, **kw):
    e = {"ns": ns, "iteration": i, "phase": "decode", "slots_active": 1,
         "queue_depth": 0}
    e.update(kw)
    return e


def _fleet_model():
    """The reference test's synthetic two-replica model."""
    return {
        "model": "m", "version": "1",
        "traces": [
            {"id": "abc123", "model_name": "m", "model_version": "1",
             "timestamps": [
                 {"name": "FLEET_ROUTE", "ns": 1_000, "replica": 1,
                  "leg": "affinity"},
                 {"name": "QUEUE_WAIT", "ns": 1_000, "dur_ns": 500,
                  "tenant": "t0"},
                 {"name": "LANE_HANDOFF", "ns": 2_000, "dur_ns": 100,
                  "decode_slot": 0},
                 {"name": "DECODE", "ns": 3_000, "dur_ns": 4_000,
                  "emitted": 8},
                 {"name": "RING_DELIVER", "ns": 3_000, "dur_ns": 5_000,
                  "tokens": 4},
                 {"name": "PREFILL_END", "ns": 2_500}]},
            {"id": "def456", "model_name": "m", "model_version": "1",
             "timestamps": [{"name": "QUEUE_WAIT", "ns": 4_000,
                             "dur_ns": 200}]}],
        "replicas": [
            {"replica": 0, "name": "m/r0", "flight": [
                _flight_entry(10_000, 0, lane={"active": 1, "handoffs": 1}),
                _flight_entry(20_000, 1, spec_rungs=[2, 4], spec_gamma=2),
                _flight_entry(30_000, 2)]},
            {"replica": 1, "name": "m/r1", "flight": []}],
        "fleet": {"lifecycle_events": [
            {"event": "FLEET_DRAIN", "verb": "drain", "replica": 1,
             "ns": 50_000}]},
        "incidents": {"incidents": [
            {"id": "inc-1", "detector": "engine_stall", "kind": "stall",
             "engine": "m/r1", "ns": 40_000, "breach": {"gap_s": 6}}]},
    }


def test_the_synthetic_fleet_model_lays_out_like_the_reference():
    doc = ttl.build_timeline([_fleet_model()])
    assert doc == jtl.build_timeline([_fleet_model()])
    assert ttl.validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    procs = [e for e in evs if e["ph"] == "M" and e["name"] == "process_name"]
    assert [p["args"]["name"] for p in procs] == ["m/r0", "m/r1"]
    first_real = next(i for i, e in enumerate(evs) if e["ph"] != "M")
    assert all(e["ph"] != "M" for e in evs[first_real:])
    routed = [e for e in evs if e.get("args", {}).get("trace_id") == "abc123"]
    assert routed and all(e["pid"] == 2 for e in routed)
    unrouted = [e for e in evs
                if e.get("args", {}).get("trace_id") == "def456"]
    assert unrouted and all(e["pid"] == 1 for e in unrouted)
    for name in ("DECODE", "RING_DELIVER"):
        pair = [e for e in evs if e["name"] == name]
        assert sorted(e["ph"] for e in pair) == ["b", "e"], name
    assert [e for e in evs if e.get("tid") == ttl.TID_HANDOFFS
            and e["ph"] != "M"][0]["name"] == "LANE_HANDOFF"
    assert any(e["name"] == "FLEET_DRAIN:drain" and e["pid"] == 2
               for e in evs if e.get("tid") == ttl.TID_LIFECYCLE)
    assert any(e["name"] == "INCIDENT:engine_stall" and e["pid"] == 2
               for e in evs if e.get("tid") == ttl.TID_INCIDENTS)
    decode = [e for e in evs if e["pid"] == 1
              and e.get("tid") == ttl.TID_DECODE_LANE and e["ph"] != "M"]
    assert [e["ph"] for e in decode] == ["X", "X", "i"]
    assert decode[0]["dur"] == pytest.approx(10.0)


def test_a_single_engine_model_without_replicas():
    model = {"model": "solo", "version": "1",
             "traces": [{"id": "x", "model_name": "solo",
                         "model_version": "1",
                         "timestamps": [{"name": "FIRST_TOKEN",
                                         "ns": 100}]}],
             "replicas": None, "fleet": None}
    doc = ttl.build_timeline([model])
    assert doc == jtl.build_timeline([model])
    assert ttl.validate_chrome_trace(doc) == []
    procs = [e for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"]
    assert [p["args"]["name"] for p in procs] == ["solo"]


def _traced_engine_run(tiny, n_streams=3, **kw):
    """A port engine serving ``n_streams`` traced streams concurrently:
    its traces (to_json) and its flight ring."""
    tcfg, tparams = tiny
    tracer = trace_mod.Tracer()
    tracer.update_settings("", {"trace_rate": "1",
                                "trace_level": "TIMESTAMPS"})
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", n_slots=2,
                                   chunk=4, name="tl", **kw).start()
    traces = [tracer.sample("tl", "1") for _ in range(n_streams)]
    prompts = [np.arange(1, 4 + 7 * i, dtype=np.int32) % 60
               for i in range(n_streams)]
    out = [None] * n_streams

    def run(i):
        out[i] = list(eng.submit(prompts[i], 9, trace=traces[i]))
        tracer.release(traces[i])

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_streams)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        flight = eng.flight.dump()
    finally:
        eng.stop()
    assert [len(o) for o in out] == [9] * n_streams
    return [t.to_json() for t in traces], flight


LANE = dict(prefill_mode="chunked", prefill_chunk=8, prefill_slots=1,
            prefill_lane_width=8, kv_layout="paged", kv_block_len=8,
            prefix_cache=True, prefix_block_len=8)


@pytest.mark.parametrize("config", ["slot", "paged_lane"])
def test_an_engine_run_lays_out_like_the_reference(tiny, config):
    traces, flight = _traced_engine_run(
        tiny, **(LANE if config == "paged_lane" else {}))
    model = {"model": "tl", "version": "1", "traces": traces,
             "replicas": [{"replica": 0, "name": "tl", "flight": flight}],
             "fleet": None, "incidents": None}
    doc = ttl.build_timeline([model])
    assert doc == jtl.build_timeline([model])
    assert ttl.validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    req_tids = {e["tid"] for e in evs
                if e.get("tid", 0) >= ttl.REQUEST_TID_BASE}
    assert req_tids == {ttl.REQUEST_TID_BASE + i for i in range(3)}
    assert any(e.get("tid") == ttl.TID_DECODE_LANE and e["ph"] == "X"
               for e in evs)
    names = {e["name"] for e in evs if e["ph"] != "M"}
    assert {"QUEUE_WAIT", "DECODE", "RING_DELIVER"} <= names
    if config == "paged_lane":
        assert {"PREFILL_CHUNK", "LANE_HANDOFF"} <= names
        assert [e for e in evs if e.get("tid") == ttl.TID_HANDOFFS
                and e["ph"] != "M"]
        assert [e for e in evs if e.get("tid") == ttl.TID_PREFILL_LANE
                and e["ph"] == "X"]


@pytest.mark.parametrize("stride", [1, 4])
def test_decode_span_bounds_are_emit_stamps(tiny, stride):
    """At stride 1 and 4 the DECODE span starts at the first emit stamp
    (the first RING_DELIVER's start) and the fetch lag lives only in the
    RING_DELIVER spans; a stride-4 document renders valid."""
    traces, flight = _traced_engine_run(tiny, n_streams=1,
                                        fetch_stride=stride)
    (tj,) = traces
    decode = [st for st in tj["timestamps"] if st["name"] == "DECODE"]
    rings = [st for st in tj["timestamps"] if st["name"] == "RING_DELIVER"]
    assert len(decode) == 1 and len(rings) >= 2
    decode = decode[0]
    assert decode["ns"] == min(r["ns"] for r in rings)
    assert decode["emitted"] == 9 and decode["dur_ns"] >= 0
    assert all(r["dur_ns"] >= 0 for r in rings)
    assert decode["ns"] + decode["dur_ns"] >= max(r["ns"] for r in rings)
    doc = ttl.build_timeline([{"model": "tl", "version": "1",
                               "traces": [tj], "replicas": [
                                   {"replica": 0, "name": "tl",
                                    "flight": flight}], "fleet": None}])
    assert ttl.validate_chrome_trace(doc) == []
    assert {"DECODE", "RING_DELIVER"} <= {
        e["name"] for e in doc["traceEvents"] if e["ph"] in ("b", "e")}


# --------------------------------------------------------------- the routes

def _lm_core(tiny, name="tl_lm", **kw):
    tcfg, tparams = tiny
    core = TorchInferenceServer()
    core.register_model(make_continuous_generator(
        name, cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        max_new_tokens=5, device="cpu", **kw))
    return core


def _drive(core, model, n, budget=3, prompt=(3, 17, 42)):
    for i in range(n):
        done = threading.Event()
        req = InferRequest(
            model_name=model, model_version="", id=f"r{i}",
            inputs=[InferTensor("PROMPT", "INT32", (len(prompt),),
                                data=np.asarray(prompt, np.int32)),
                    InferTensor("MAX_TOKENS", "INT32", (1,),
                                data=np.array([budget], np.int32))],
            outputs=[])
        core.infer(req, response_callback=lambda resp, final:
                   done.set() if final else None)
        assert done.wait(timeout=60)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_debug_routes_answer_404_without_the_flag(tiny):
    core = _lm_core(tiny)
    srv = HttpInferenceServer(core, port=0).start()
    try:
        for path in ("/v2/debug/timeline", "/v2/debug/traces",
                     "/v2/debug/timeline?model=tl_lm"):
            assert _get(f"http://{srv.url}{path}")[0] == 404, path
    finally:
        srv.stop()
        core.stop()


def test_debug_routes_serve_the_timeline_and_the_traces(tiny):
    core = _lm_core(tiny)
    core.update_trace_settings(settings={"trace_level": ["TIMESTAMPS"],
                                         "trace_rate": "1"})
    srv = HttpInferenceServer(core, port=0, debug_endpoints=True).start()
    try:
        _drive(core, "tl_lm", 4)
        code, doc = _get(f"http://{srv.url}/v2/debug/timeline")
        code_m, doc_m = _get(f"http://{srv.url}/v2/debug/timeline"
                             "?model=tl_lm")
        code_x, body_x = _get(f"http://{srv.url}/v2/debug/timeline"
                              "?model=nope")
        code_t, traces = _get(f"http://{srv.url}/v2/debug/traces")
        code_tm, traces_m = _get(f"http://{srv.url}/v2/debug/traces"
                                 "?model=nope")
        completed = [t.to_json() for t in core.tracer.completed]
    finally:
        srv.stop()
        core.stop()
    assert (code, code_m, code_t, code_tm) == (200, 200, 200, 200)
    assert code_x == 404 and "no timeline" in body_x["error"]
    assert ttl.validate_chrome_trace(doc) == []
    assert doc_m["traceEvents"] and ttl.validate_chrome_trace(doc_m) == []
    evs = doc["traceEvents"]
    tracks = {(e.get("tid"), e["args"]["name"]) for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert (ttl.TID_DECODE_LANE, "decode lane") in tracks
    req = {e["tid"] for e in evs if e.get("tid", 0) >= ttl.REQUEST_TID_BASE}
    assert len(req) == 4
    assert traces["traces"] == completed and len(completed) == 4
    assert traces_m == {"traces": []}


def test_core_debug_timeline_404s_for_an_unknown_model():
    core = TorchInferenceServer()
    try:
        with pytest.raises(ServerError) as err:
            core.debug_timeline("no_such_model")
        assert err.value.status == 404
        assert core.debug_timeline() == {"traceEvents": [],
                                         "displayTimeUnit": "ms"}
    finally:
        core.stop()


def test_grpc_debug_traces_trailer_respects_the_gate(tiny):
    pytest.importorskip("grpc")
    from client_tpu.client import grpc as grpcclient
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer

    core = _lm_core(tiny)
    core.update_trace_settings(settings={"trace_level": ["TIMESTAMPS"],
                                         "trace_rate": "1"})
    t = core.tracer.sample("tl_lm", "1")
    t.event("REQUEST_START")
    core.tracer.release(t)
    srv = GrpcInferenceServer(core, port=0, debug_endpoints=True).start()
    gated = GrpcInferenceServer(core, port=0).start()
    try:
        client = grpcclient.InferenceServerClient(srv.address)
        doc = client.get_debug_traces("tl_lm")
        none = client.get_debug_traces("other")
        client.close()
        client = grpcclient.InferenceServerClient(gated.address)
        gated_doc = client.get_debug_traces("tl_lm")
        client.close()
    finally:
        srv.stop()
        gated.stop()
        core.stop()
    assert doc is not None and [d["id"] for d in doc["traces"]] == [t.id]
    assert none == {"traces": []}
    assert gated_doc is None


# ---------------------------------------------------------------- exemplars

def test_exemplars_present_capped_and_resolvable_while_tracing(tiny):
    core = _lm_core(tiny, name="ex_on")
    core.update_trace_settings(settings={"trace_level": ["TIMESTAMPS"],
                                         "trace_rate": "1"})
    try:
        _drive(core, "ex_on", tm.EXEMPLAR_CAP + 2)
        text = core.metrics_text()
        completed = {t.id for t in core.tracer.completed}
    finally:
        core.stop()
    parsed = tm.parse_prometheus_text(text)
    assert check_metrics_names.check(text) == []
    by_family: dict = {}
    for name, _labels, ex in parsed["exemplars"]:
        by_family.setdefault(name[:-len("_bucket")], []).append(ex)
        assert list(ex["labels"]) == ["trace_id"]
        assert tm.EXEMPLAR_TRACE_ID_RE.match(ex["labels"]["trace_id"])
        assert ex["labels"]["trace_id"] in completed
        assert ex["value"] >= 0
    assert set(by_family) == set(tm.EXEMPLAR_FAMILIES)
    for family, exs in by_family.items():
        assert len(exs) <= tm.EXEMPLAR_CAP, family


def test_exemplars_absent_when_tracing_is_off(tiny):
    core = _lm_core(tiny, name="ex_off")
    try:
        _drive(core, "ex_off", 2)
        text = core.metrics_text()
    finally:
        core.stop()
    parsed = tm.parse_prometheus_text(text)
    assert parsed["exemplars"] == []
    assert any(name == "client_tpu_generation_ttft_seconds_count" and v > 0
               for name, _labels, v in parsed["samples"])


def test_exemplars_never_render_outside_the_contract():
    """The registry renders no exemplar outside EXEMPLAR_FAMILIES, at most
    EXEMPLAR_CAP per family and none with a malformed trace id, so its
    text lints clean; the same violations written by hand are what the
    reference's lint flags."""
    reg = tm.MetricsRegistry()
    ttft = reg.histogram("client_tpu_generation_ttft_seconds", "t",
                         ("model",))
    for i in range(tm.EXEMPLAR_CAP + 3):
        ttft.labels(f"m{i}").load_exemplars(
            {1: (f"id{i}", 0.0002, 1700000000.0 + i),
             3: ("has space", 0.001, 1700000000.0)})
    other = reg.histogram("client_tpu_request_seconds", "r")
    other.labels().load_exemplars({0: ("abc", 0.00005, 1700000000.0)})
    text = reg.render()
    assert check_metrics_names.check(text) == []
    parsed = tm.parse_prometheus_text(text)
    names = [n for n, _l, _e in parsed["exemplars"]]
    assert names == ["client_tpu_generation_ttft_seconds_bucket"] * \
        tm.EXEMPLAR_CAP
    assert all(e["labels"]["trace_id"] != "has space"
               for _n, _l, e in parsed["exemplars"])
    base = ("# HELP client_tpu_generation_ttft_seconds t\n"
            "# TYPE client_tpu_generation_ttft_seconds histogram\n")
    bad = base + ('client_tpu_generation_ttft_seconds_sum 1 '
                  '# {trace_id="abc"} 1 1.0\n')
    assert any("bucket" in e.lower() for e in check_metrics_names.check(bad))
    bad = (base + 'client_tpu_generation_ttft_seconds_bucket{le="+Inf"} 1 '
           '# {trace_id="has space"} 0.5 1.0\n'
           "client_tpu_generation_ttft_seconds_sum 1\n"
           "client_tpu_generation_ttft_seconds_count 1\n")
    assert any("trace_id" in e for e in check_metrics_names.check(bad))


# ---------------------------------------------------------------- routed fleet

FLEET_TL = dict(n_slots=2, chunk_size=4, prefill_mode="chunked",
                prefill_chunk=8, prefill_slots=1, prefill_lane_width=8,
                kv_layout="paged", kv_block_len=8, prefix_cache=True,
                prefix_block_len=8)


def _routed_fleet_export(core, make_fleet, cfg_vocab: int) -> tuple:
    """The reference test's scenario on one package: a traced two-replica
    affinity fleet, two tenants each sending two prompts of their own
    16-token prefix and 4 random tokens, budget 6, from two threads.
    Returns (timeline document, completed traces)."""
    core.tracer.update_settings(
        "", {"trace_rate": "1", "trace_level": "TIMESTAMPS"})
    model = make_fleet("tl_fleet", replicas=2,
                       fleet={"replicas": 2, "policy": "affinity",
                              "affinity_block_len": 8}, **FLEET_TL)
    core.register_model(model)
    rng = np.random.default_rng(7)
    budget, errors, lock = 6, [], threading.Lock()

    def tenant_worker(tenant, prefix):
        for _ in range(2):
            prompt = np.concatenate(
                [prefix, rng.integers(0, cfg_vocab, 4)]).astype(np.int32)
            try:
                trace = core.tracer.sample("tl_fleet", "1")
                toks = list(model.fleet.submit(
                    prompt, budget, tenant_id=tenant, trace=trace))
                assert len(toks) == budget
                core.tracer.release(trace)
            except Exception as e:  # noqa: BLE001 — asserted below
                with lock:
                    errors.append((tenant, repr(e)))

    try:
        prefixes = {f"t{i}": rng.integers(0, cfg_vocab, 16)
                    for i in range(2)}
        threads = [threading.Thread(target=tenant_worker, args=(t, p))
                   for t, p in prefixes.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        return core.debug_timeline("tl_fleet"), \
            core.debug_traces("tl_fleet")["traces"]
    finally:
        model.shutdown()


def _fleet_shape(doc: dict, traces: list, tl) -> dict:
    """The reference test's checks on one export; returns what the two
    packages' exports must share."""
    assert len(traces) == 4
    for tj in traces:
        (route,) = [s for s in tj["timestamps"]
                    if s["name"] == "FLEET_ROUTE"]
        assert route["replica"] in (0, 1)
        assert route["leg"] in ("affinity", "load", "fallback")
    assert tl.validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    procs = [e["args"]["name"] for e in evs if e["ph"] == "M"
             and e["name"] == "process_name"]
    names = {e["name"] for e in evs if e["ph"] != "M"}
    assert {"QUEUE_WAIT", "PREFILL_CHUNK", "DECODE"} <= names
    assert [e for e in evs if e.get("tid") == tl.TID_HANDOFFS
            and e["ph"] != "M"]
    req = [e for e in evs if e.get("tid", 0) >= tl.REQUEST_TID_BASE
           and e["ph"] != "M"]
    assert req and {e["pid"] for e in req} <= {1, 2}
    return {"processes": procs, "names": names}


def test_a_routed_fleet_exports_a_valid_document_like_the_reference():
    from client_tpu.models.decoder_lm import make_replica_fleet as j_fleet
    from client_tpu.server.core import TpuInferenceServer
    from client_tpu_torch.models.decoder_lm import make_replica_fleet

    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **KW)
    ref = _routed_fleet_export(
        TpuInferenceServer(),
        lambda *a, **k: j_fleet(*a, cfg=jcfg, params=jparams, **k),
        KW["vocab_size"])
    mine = _routed_fleet_export(
        TorchInferenceServer(),
        lambda *a, **k: make_replica_fleet(*a, cfg=tcfg, params=tparams,
                                           device="cpu", **k),
        KW["vocab_size"])
    assert jtl.validate_chrome_trace(mine[0]) == []
    want = _fleet_shape(*ref, jtl)
    got = _fleet_shape(*mine, ttl)
    assert got["processes"] == want["processes"] == \
        ["tl_fleet/r0", "tl_fleet/r1"]
    assert got["names"] == want["names"]
