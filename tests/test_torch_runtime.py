"""The runtime plane and the debug surface: the port against the JAX
package, on the CPU.

- ``runtime_stats``: the flight recorder's ring, ``pytree_nbytes`` over
  nested tensors, and ``device_memory_stats`` empty without CUDA (a scrape
  creates no CUDA context).
- The engines' flight records carry the reference's keys (nested ones
  too) in the slot, paged, speculating and scheduler-with-lane
  configurations, and the memory ledger has the reference's components
  and byte counts.
- The debug routes: every ``/v2/debug/*`` path answers 404 without the
  flag on both HTTP servers; with it, the runtime, engine, incidents and
  faults JSON carry the reference's keys (the runtime rows with the
  compile table, whose counts and kinds equal the reference's), a bad
  fault spec is a 400 with the reference's text, the profile capture's input errors are the
  reference's (400, 400, 409), and a capture writes a trace.
- gRPC (``importorskip("grpc")``): an armed ``transport_reset`` aborts
  ``ModelInfer`` with UNAVAILABLE and a ``retry-after`` trailer on both
  servers, and the ``client-tpu-debug-incidents-bin`` trailer is sent
  only by a server with debug endpoints.
"""

import json
import os
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
from client_tpu.server import faultinject as jfi
from client_tpu.server import http_server as jhttp
from client_tpu.server import runtime_stats as jrs
from client_tpu.server.config import SpeculativeConfig as JSpecConfig
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import faultinject as tfi
from client_tpu_torch.server import http_server as thttp
from client_tpu_torch.server import runtime_stats as trs
from client_tpu_torch.server.config import SpeculativeConfig as TSpecConfig
from client_tpu_torch.server.types import ServerError

SIDES = ("ref", "port")
FI = {"ref": jfi, "port": tfi}
# the reference's compile table, which the port's runtime rows carry
COMPILE_KEYS = {"sealed", "total_compiles", "unexpected_compiles",
                "warmup_compiles", "warmup_compile_seconds", "compiles",
                "hist"}


@pytest.fixture(autouse=True)
def _clear_global_faults():
    yield
    jfi.get_injector().clear()
    tfi.get_injector().clear()


# ------------------------------------------------------------ runtime_stats

def test_the_flight_recorder_matches_the_reference():
    got = {}
    for side, rs in (("ref", jrs), ("port", trs)):
        fr = rs.FlightRecorder(capacity=4)
        for i in range(10):
            fr.record(tokens=i)
        got[side] = (len(fr), fr.dump(), fr.tail(2), fr.tail(0))
    assert got["port"] == got["ref"]
    assert trs.FLIGHT_RECORDER_CAP == jrs.FLIGHT_RECORDER_CAP == 256


def test_pytree_nbytes_sums_nested_tensors():
    tree = {"w": torch.zeros((4, 4), dtype=torch.float32),
            "inner": [torch.zeros((2,), dtype=torch.int8),
                      (torch.zeros((3,), dtype=torch.float64),)],
            "scalar": 1.0, "pos": None}
    assert trs.pytree_nbytes(tree) == 64 + 2 + 24
    assert trs.pytree_nbytes(None) == 0
    as_numpy = {"w": np.zeros((4, 4), np.float32),
                "inner": [np.zeros((2,), np.int8),
                          (np.zeros((3,), np.float64),)], "scalar": 1.0}
    assert trs.pytree_nbytes(as_numpy) == jrs.pytree_nbytes(as_numpy)


def test_device_memory_stats_is_empty_without_cuda(monkeypatch):
    assert trs.device_memory_stats() == []
    # CUDA present but never initialised here: still no row, no context
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert trs.device_memory_stats() == []


# ---------------------------------------------------------------- engines

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=64, causal=True)
PROMPT = np.array([3, 17, 42, 5, 9, 11, 2, 8, 30, 31, 1], np.int32)
PAGED = dict(kv_layout="paged", kv_block_len=8)
DRAFT = {"n_layers": 1, "d_model": 32, "n_heads": 2, "head_dim": 16,
         "d_ff": 64}
CONFIGS = {
    "slot": {},
    "paged": dict(PAGED),
    "speculation": dict(speculative_gamma=2, draft=True),
    "scheduler_lane": dict(prefill_mode="chunked", prefill_chunk=8,
                           prefill_slots=2, prefill_lane_width=8,
                           prefill_lane_batch=2, prefix_cache=True,
                           prefix_block_len=8, scheduler=True,
                           kv_pool_blocks=24, **PAGED),
}


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


def _gen(side, model, name="lm", **knobs):
    jcfg, jparams, tcfg, tparams = model
    knobs = dict(knobs)
    draft = knobs.pop("draft", False)
    if side == "ref":
        if draft:
            knobs["speculative_draft"] = JSpecConfig(enabled=True, gamma=2,
                                                     draft=DRAFT)
        return jlm.make_continuous_generator(
            name, cfg=jcfg, params=dict(jparams), n_slots=2, chunk_size=4,
            **knobs)
    if draft:
        knobs["speculative_draft"] = TSpecConfig(enabled=True, gamma=2,
                                                 draft=DRAFT)
    return tlm.make_continuous_generator(
        name, cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        device="cpu", **knobs)


def _shape(entry):
    """An entry's keys, with a nested dict's keys in place of its value."""
    return {k: (_shape(v) if isinstance(v, dict) and k != "slot_tenants"
                else None) for k, v in entry.items()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_flight_records_and_the_memory_ledger_match_the_reference(model,
                                                                  config):
    got = {}
    for side in SIDES:
        gen = _gen(side, model, **CONFIGS[config])
        try:
            toks = list(gen.engine.submit(PROMPT, 10))
            dump = gen.engine.flight.dump()
            busy = [e for e in dump if e["phase"] == "dispatch"]
            mem = gen.runtime_observability()["memory"]
            got[side] = (toks, _shape(busy[-1]),
                         {"default/best_effort": 1} in [
                             e["slot_tenants"] for e in busy], sorted(mem),
                         {k: v for k, v in mem.items()
                          if not k.startswith("kv_pool_")})
        finally:
            gen.shutdown()
    assert got["port"] == got["ref"]
    toks, shape, tenants, comps, mem = got["port"]
    assert len(toks) == 10 and tenants
    assert mem["weights"] > 0
    assert ("kv_pool" in comps) == ("kv_layout" in CONFIGS[config])


# ------------------------------------------------------------ debug routes

DEBUG_PATHS = (("GET", "/v2/debug/runtime"),
               ("GET", "/v2/debug/models/lm/engine"),
               ("GET", "/v2/debug/models/lm/versions/1/engine"),
               ("GET", "/v2/debug/slo"), ("GET", "/v2/debug/scheduler"),
               ("GET", "/v2/debug/incidents"), ("GET", "/v2/debug/faults"),
               ("POST", "/v2/debug/faults"), ("POST", "/v2/debug/profile"))


def _http(url, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{url}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


@pytest.fixture(scope="module")
def stacks(model):
    """Each package's core serving the generator ``lm`` (one stream run)
    and an add_sub, behind an HTTP server with the debug flag and one
    without."""
    out = {}
    for side in SIDES:
        if side == "ref":
            core, mod = TpuInferenceServer(), jhttp
            core.register_model(jadd.make_add_sub("add_sub", 4, "INT32"))
        else:
            core, mod = TorchInferenceServer(), thttp
            core.register_model(make_add_sub("add_sub", 4, "INT32",
                                             device="cpu"))
        gen = _gen(side, model, scheduler=True)
        core.register_model(gen)
        list(gen.engine.submit(PROMPT[:3], 4))
        on = mod.HttpInferenceServer(core, port=0,
                                     debug_endpoints=True).start()
        off = mod.HttpInferenceServer(core, port=0).start()
        out[side] = (core, gen, on, off)
    yield out
    for core, _gen_, on, off in out.values():
        on.stop()
        off.stop()
        core.stop()


def test_every_debug_path_is_404_without_the_flag(stacks):
    got = {side: [_http(stacks[side][3].url, m, p, {} if m == "POST"
                        else None)[0] for m, p in DEBUG_PATHS]
           for side in SIDES}
    assert got["port"] == got["ref"] == [404] * len(DEBUG_PATHS)
    # the rest of the surface does not depend on the flag
    assert _http(stacks["port"][3].url, "GET", "/v2/health/live")[0] == 200


def test_the_debug_json_has_the_reference_keys(stacks):
    got = {}
    for side in SIDES:
        url = stacks[side][2].url
        rt = _http(url, "GET", "/v2/debug/runtime")
        eng = _http(url, "GET", "/v2/debug/models/lm/engine")
        inc = _http(url, "GET", "/v2/debug/incidents")
        slo = _http(url, "GET", "/v2/debug/slo")
        sched = _http(url, "GET", "/v2/debug/scheduler")
        none = _http(url, "GET", "/v2/debug/models/add_sub/engine")
        rows = {m["model"]: m for m in rt[1]["models"]}
        got[side] = {
            "status": (rt[0], eng[0], inc[0], slo[0], sched[0], none[0]),
            "runtime": sorted(rt[1]),
            "devices": rt[1]["devices"],
            "runtime_rows": {n: sorted(r) for n, r in rows.items()},
            "compile_counts": {n: [r[k] for k in sorted(COMPILE_KEYS - {
                "compiles", "hist", "warmup_compile_seconds"})]
                for n, r in rows.items()},
            "compile_kinds": {n: sorted(e["kind"] for e in r["compiles"])
                              for n, r in rows.items()},
            "weights": {n: r["memory"]["weights"] for n, r in rows.items()},
            "engine_up": {n: r["engine_up"] for n, r in rows.items()},
            "engine": sorted(eng[1]),
            "engine_runtime": sorted(eng[1]["runtime"]),
            "slots": eng[1]["slots"],
            "flight": bool(eng[1]["flight_recorder"]),
            "timeline": sorted(stacks[side][1].timeline_snapshot()),
            "timeline_replica": sorted(
                stacks[side][1].timeline_snapshot()["replicas"][0]),
            "incidents": [sorted(m) for m in inc[1]["models"]],
            "incident_store": sorted(inc[1]["models"][0]["incidents"]),
            "slo_rows": [sorted(m) for m in slo[1]["models"]],
            "sched_rows": [sorted(m) for m in sched[1]["models"]],
        }
    assert got["port"] == got["ref"]
    assert got["port"]["status"] == (200, 200, 200, 200, 200, 404)
    assert got["port"]["devices"] == []
    assert got["port"]["engine_up"] == {"add_sub": None, "lm": True}


def test_the_fault_routes_match_the_reference(stacks):
    got = {}
    for side in SIDES:
        url = stacks[side][2].url
        armed = _http(url, "POST", "/v2/debug/faults",
                      {"faults": [{"point": "queue_full", "after": 5}],
                       "seed": 4})
        read = _http(url, "GET", "/v2/debug/faults")
        bad_point = _http(url, "POST", "/v2/debug/faults",
                          {"faults": [{"point": "warp_core_breach"}]})
        bad_key = _http(url, "POST", "/v2/debug/faults",
                        {"faults": [{"point": "queue_full", "nope": 1}]})
        empty = _http(url, "POST", "/v2/debug/faults", {"faults": []})
        cleared = _http(url, "POST", "/v2/debug/faults", {"clear": True})
        got[side] = (armed, read, bad_point, bad_key, empty, cleared)
    assert got["port"] == got["ref"]
    armed, _read, bad_point, _bad_key, empty, cleared = got["port"]
    assert armed[0] == 200 and armed[1]["armed"] and armed[1]["seed"] == 4
    assert bad_point[0] == 400 and "unknown fault point" in \
        bad_point[1]["error"]
    assert empty[0] == 400 and cleared[1]["armed"] is False


def test_the_profile_capture_matches_the_reference(stacks, tmp_path):
    got = {}
    for side in SIDES:
        core, _gen_, on, _off = stacks[side]
        url = on.url
        missing = _http(url, "POST", "/v2/debug/profile",
                        {"duration_s": 0.05})
        long = _http(url, "POST", "/v2/debug/profile",
                     {"log_dir": str(tmp_path), "duration_s": 600})
        zero = _http(url, "POST", "/v2/debug/profile",
                     {"log_dir": str(tmp_path), "duration_s": 0})
        assert core._profile_lock.acquire(blocking=False)
        try:
            with pytest.raises(ServerError if side == "port"
                               else Exception) as ei:
                core.debug_profile(str(tmp_path), 0.05)
            busy = ei.value.status
        finally:
            core._profile_lock.release()
        got[side] = (missing, long, zero, busy)
    assert got["port"] == got["ref"]
    assert [r[0] for r in got["port"][:3]] == [400, 400, 400]
    assert got["port"][3] == 409
    # a capture on the port writes a Chrome trace into log_dir
    log_dir = str(tmp_path / "capture")
    status, doc = _http(stacks["port"][2].url, "POST", "/v2/debug/profile",
                        {"log_dir": log_dir, "duration_s": 0.05})
    assert status == 200 and doc["log_dir"] == log_dir
    assert sorted(doc) == ["duration_s", "log_dir"]
    files = [f for _r, _d, fs in os.walk(log_dir) for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files


def test_an_http_transport_reset_drops_the_connection(stacks):
    got = {}
    for side in SIDES:
        url = stacks[side][3].url
        FI[side].get_injector().arm([{"point": "transport_reset",
                                      "times": 1}])
        try:
            _http(url, "GET", "/v2/health/live")
            dropped = False
        except (urllib.error.URLError, ConnectionError, OSError):
            dropped = True
        FI[side].get_injector().clear()
        got[side] = (dropped, _http(url, "GET", "/v2/health/live")[0])
    assert got["port"] == got["ref"] == (True, 200)


# -------------------------------------------------------------------- gRPC

def test_grpc_transport_reset_and_the_incidents_trailer(stacks):
    grpc = pytest.importorskip("grpc")
    from client_tpu.server.grpc_server import (
        GrpcInferenceServer as RefGrpcServer,
    )
    from client_tpu_torch.protocol import kserve_pb2 as tpb
    from client_tpu_torch.protocol.grpc_defs import (
        CLIENT_CHANNEL_OPTIONS,
        METHODS,
        method_path,
    )
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer

    def stub(channel, name):
        _kind, req_cls, resp_cls = METHODS[name]
        return channel.unary_unary(
            method_path(name), request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString)

    req = tpb.ModelInferRequest(model_name="add_sub")
    for name in ("INPUT0", "INPUT1"):
        t = req.inputs.add()
        t.name, t.datatype = name, "INT32"
        t.shape.extend([4])
        req.raw_input_contents.append(
            np.arange(4, dtype=np.int32).tobytes())
    got = {}
    for side, cls in (("ref", RefGrpcServer), ("port", GrpcInferenceServer)):
        core = stacks[side][0]
        rows = []
        for debug in (True, False):
            srv = cls(core, port=0, debug_endpoints=debug).start()
            try:
                with grpc.insecure_channel(
                        f"127.0.0.1:{srv.port}",
                        options=CLIENT_CHANNEL_OPTIONS) as ch:
                    FI[side].get_injector().arm([{
                        "point": "transport_reset", "times": 1}])
                    with pytest.raises(grpc.RpcError) as ei:
                        stub(ch, "ModelInfer")(req)
                    FI[side].get_injector().clear()
                    reset = (ei.value.code(), ei.value.details(), dict(
                        ei.value.trailing_metadata() or ()).get(
                            "retry-after"))
                    served = len(stub(ch, "ModelInfer")(req).outputs)
                    _r, call = stub(ch, "ServerMetadata").with_call(
                        tpb.ServerMetadataRequest(),
                        metadata=(("client-tpu-debug-incidents", ""),))
                    trailer = dict(call.trailing_metadata()).get(
                        "client-tpu-debug-incidents-bin")
            finally:
                srv.stop()
            doc = None if trailer is None else json.loads(trailer)
            rows.append((reset, served, None if doc is None else
                         [(m["model"], sorted(m["incidents"]))
                          for m in doc["models"]]))
        got[side] = rows
    assert got["port"] == got["ref"]
    (reset, served, doc), (_r2, _s2, no_doc) = got["port"]
    assert reset == (grpc.StatusCode.UNAVAILABLE,
                     "injected transport reset", "1")
    assert served == 2 and doc and doc[0][0] == "lm" and no_doc is None
