"""The port's gRPC front end against the JAX package's, on the CPU.

Both servers are driven by the JAX package's own gRPC client
(``client_tpu.client.grpc``): the cases of ``tests/test_grpc.py`` that
apply to the port run against both, with equal outputs and equal status
codes; the port's ``CudaSharedMemory*`` RPCs are called through its own
``METHODS`` table; ``ModelStreamInfer`` on a small continuous generator
gives the same greedy token streams as the JAX engine with the same
weights. grpcio is not installed on the card's host, which skips the file.
"""

import queue
import threading
import time

import pytest

grpc = pytest.importorskip("grpc")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from client_tpu.client import grpc as grpcclient  # noqa: E402
from client_tpu.models import add_sub as jadd  # noqa: E402
from client_tpu.models import decoder_lm as jlm  # noqa: E402
from client_tpu.models import transformer as jt  # noqa: E402
from client_tpu.server import TpuInferenceServer  # noqa: E402
from client_tpu.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer as RefGrpcServer,
)
from client_tpu.utils import InferenceServerException  # noqa: E402
from client_tpu.utils import shared_memory as sysshm  # noqa: E402
from client_tpu_torch.models import decoder_lm as tlm  # noqa: E402
from client_tpu_torch.models import make_add_sub  # noqa: E402
from client_tpu_torch.models import transformer as tt  # noqa: E402
from client_tpu_torch.protocol import kserve_pb2 as tpb  # noqa: E402
from client_tpu_torch.protocol.grpc_defs import (  # noqa: E402
    CLIENT_CHANNEL_OPTIONS,
    METHODS,
    method_path,
)
from client_tpu_torch.server import TorchInferenceServer  # noqa: E402
from client_tpu_torch.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer,
)
from client_tpu_torch.utils import cuda_shared_memory as cudashm  # noqa: E402

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)
SIDES = ("ref", "port")
# what differs between the two servers by design
NAME = {"ref": "client-tpu-server", "port": "client-tpu-torch-server"}
DEVICE_SHM = {"ref": "tpu_shared_memory", "port": "cuda_shared_memory"}
KIND = {"ref": "KIND_TPU", "port": "KIND_GPU"}


@pytest.fixture(scope="module")
def servers():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    ref = TpuInferenceServer()
    port = TorchInferenceServer()
    for dtype, name in (("INT32", "add_sub"), ("FP32", "add_sub_fp32")):
        ref.register_model(jadd.make_add_sub(name, 16, dtype))
        port.register_model(make_add_sub(name, 16, dtype, device="cpu"))
    ref.register_model(jlm.make_continuous_generator(
        "lm", cfg=jcfg, params=dict(jparams), n_slots=2, chunk_size=4))
    port.register_model(tlm.make_continuous_generator(
        "lm", cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        device="cpu"))
    # one fetch per dispatch: a token reaches the client while its stream
    # still holds its slot
    port.register_model(tlm.make_continuous_generator(
        "lm_stride1", cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        fetch_stride=1, device="cpu"))
    srv = {"ref": RefGrpcServer(ref, port=0).start(),
           "port": GrpcInferenceServer(port, port=0).start()}
    yield {"ref": (ref, srv["ref"]), "port": (port, srv["port"])}
    for side in SIDES:
        srv[side].stop()
    ref.stop()
    port.stop()


@pytest.fixture(scope="module")
def clients(servers):
    c = {side: grpcclient.InferenceServerClient(servers[side][1].address)
         for side in SIDES}
    yield c
    for x in c.values():
        x.close()


def _inputs(a, b, dtype="INT32", use_raw=True):
    i0 = grpcclient.InferInput("INPUT0", a.shape, dtype)
    i0.set_data_from_numpy(a, use_raw=use_raw)
    i1 = grpcclient.InferInput("INPUT1", b.shape, dtype)
    i1.set_data_from_numpy(b, use_raw=use_raw)
    return [i0, i1]


def _status(fn) -> tuple:
    """The status name and message of the error ``fn`` raises."""
    with pytest.raises(InferenceServerException) as ei:
        fn()
    return ei.value.status(), str(ei.value)


# ---------------------------------------------------------- control plane

@pytest.mark.parametrize("side", SIDES)
def test_health(clients, side):
    c = clients[side]
    assert c.is_server_live()
    assert c.is_server_ready()
    assert c.is_model_ready("add_sub")
    assert not c.is_model_ready("ghost")


@pytest.mark.parametrize("side", SIDES)
def test_metadata(clients, side):
    md = clients[side].get_server_metadata()
    assert md.name == NAME[side]
    assert DEVICE_SHM[side] in md.extensions
    assert "system_shared_memory" in md.extensions
    assert clients[side].get_server_metadata(as_json=True)["name"] \
        == NAME[side]


def test_model_metadata_is_equal(clients):
    got = {side: clients[side].get_model_metadata("add_sub", as_json=True)
           for side in SIDES}
    for side in SIDES:
        got[side].pop("platform")
    assert got["port"] == got["ref"]
    md = clients["port"].get_model_metadata("add_sub")
    assert [t.name for t in md.inputs] == ["INPUT0", "INPUT1"]
    assert list(md.inputs[0].shape) == [16]


@pytest.mark.parametrize("side", SIDES)
def test_model_config(clients, side):
    cfg = clients[side].get_model_config("add_sub").config
    assert cfg.name == "add_sub"
    assert cfg.instance_group[0].kind == KIND[side]
    assert [t.name for t in cfg.input] == ["INPUT0", "INPUT1"]
    assert list(cfg.output[0].dims) == [16]
    assert clients[side].get_model_config(
        "lm").config.model_transaction_policy.decoupled


@pytest.mark.parametrize("side", SIDES)
def test_statistics_count_each_inference(clients, side):
    c = clients[side]

    def count():
        st = c.get_inference_statistics("add_sub_fp32")
        (m,) = st.model_stats
        assert (m.name, m.version) == ("add_sub_fp32", "1")
        return m.inference_count, m.inference_stats.success.count

    before = count()
    a = np.ones(16, np.float32)
    for _ in range(3):
        c.infer("add_sub_fp32", _inputs(a, a, "FP32"))
    after = count()
    assert (after[0] - before[0], after[1] - before[1]) == (3, 3)


# ---------------------------------------------------------- infer

@pytest.mark.parametrize("use_raw", [True, False], ids=["raw", "typed"])
@pytest.mark.parametrize("dtype", ["INT32", "FP32"])
def test_infer_outputs_are_equal(clients, use_raw, dtype):
    rng = np.random.default_rng(3)
    np_dtype = np.int32 if dtype == "INT32" else np.float32
    a = rng.integers(-50, 50, 16).astype(np_dtype)
    b = rng.integers(-50, 50, 16).astype(np_dtype)
    model = "add_sub" if dtype == "INT32" else "add_sub_fp32"
    got = {side: clients[side].infer(model, _inputs(a, b, dtype, use_raw))
           for side in SIDES}
    for name, want in (("OUTPUT0", a + b), ("OUTPUT1", a - b)):
        np.testing.assert_array_equal(got["ref"].as_numpy(name), want)
        np.testing.assert_array_equal(got["port"].as_numpy(name), want)


@pytest.mark.parametrize("side", SIDES)
def test_requested_outputs_filter(clients, side):
    a = np.zeros(16, np.int32)
    outputs = [grpcclient.InferRequestedOutput("OUTPUT1")]
    result = clients[side].infer("add_sub", _inputs(a, a), outputs=outputs)
    assert result.as_numpy("OUTPUT0") is None
    np.testing.assert_array_equal(result.as_numpy("OUTPUT1"), np.zeros(16))


@pytest.mark.parametrize("side", SIDES)
def test_classification(clients, side):
    a = np.arange(16, dtype=np.int32)
    outputs = [grpcclient.InferRequestedOutput("OUTPUT0", class_count=2)]
    result = clients[side].infer(
        "add_sub", _inputs(a, np.zeros(16, np.int32)), outputs=outputs)
    cls = result.as_numpy("OUTPUT0")
    assert cls.shape == (2,)
    assert bytes(cls[0]).decode().endswith(":15")


@pytest.mark.parametrize("side", SIDES)
def test_request_id(clients, side):
    a = np.zeros(16, np.int32)
    result = clients[side].infer("add_sub", _inputs(a, a), request_id="rq-7")
    assert result.get_response().id == "rq-7"


@pytest.mark.parametrize("side", SIDES)
def test_async_infer(clients, side):
    a = np.arange(16, dtype=np.int32)
    done = threading.Event()
    holder = {}

    def cb(result, error):
        holder["r"], holder["e"] = result, error
        done.set()

    clients[side].async_infer("add_sub", _inputs(a, a), cb)
    assert done.wait(30)
    assert holder["e"] is None
    np.testing.assert_array_equal(holder["r"].as_numpy("OUTPUT0"), 2 * a)


def _bad_label(c):
    a = np.zeros(16, np.int32)
    c.infer("add_sub", _inputs(a, a), parameters={"tenant_id": "bad tenant"})


def _short_raw(c):
    i0 = grpcclient.InferInput("INPUT0", [16], "INT32")
    i0.set_data_from_numpy(np.zeros(16, np.int32))
    i0._raw = b"\x00" * 8  # corrupt the payload
    i1 = grpcclient.InferInput("INPUT1", [16], "INT32")
    i1.set_data_from_numpy(np.zeros(16, np.int32))
    c.infer("add_sub", [i0, i1])


def _decoupled_unary(c):
    p = grpcclient.InferInput("PROMPT", [4], "INT32")
    p.set_data_from_numpy(np.arange(4, dtype=np.int32))
    c.infer("lm", [p])


def _wrong_shape(c):
    a = np.zeros(8, np.int32)
    c.infer("add_sub", _inputs(a, a))


ERRORS = {
    "unknown_model_metadata": lambda c: c.get_model_metadata("ghost"),
    "unknown_model_infer": lambda c: c.infer(
        "ghost", _inputs(np.zeros(16, np.int32), np.zeros(16, np.int32))),
    "unknown_model_stats": lambda c: c.get_inference_statistics("ghost"),
    "wrong_shape": _wrong_shape,
    "short_raw": _short_raw,
    "bad_label": _bad_label,
    "decoupled_unary": _decoupled_unary,
    "unregistered_region": lambda c: c.register_system_shared_memory(
        "nope", "/client_tpu_torch_no_such_region", 64),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_statuses_are_equal(clients, case):
    got = {side: _status(lambda: ERRORS[case](clients[side]))
           for side in SIDES}
    assert got["port"][0] == got["ref"][0], got
    assert got["port"][0] in ("NOT_FOUND", "INVALID_ARGUMENT"), got


def test_async_infer_error(clients):
    errors = {}
    for side in SIDES:
        done = threading.Event()

        def cb(result, error, side=side, done=done):
            errors[side] = error
            done.set()

        a = np.zeros(16, np.int32)
        clients[side].async_infer("ghost_model", _inputs(a, a), cb)
        assert done.wait(30)
    assert errors["port"].status() == errors["ref"].status() == "NOT_FOUND"


@pytest.mark.parametrize("side", SIDES)
def test_system_shm_verbs_and_mixed_inputs(clients, side):
    """Register, status, a shm input beside a raw one (the raw contents
    are a subsequence over the non-shm inputs), unregister."""
    c = clients[side]
    key = f"/client_tpu_torch_grpc_{side}"
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 9, np.int32)
    region = sysshm.create_shared_memory_region(f"mix_{side}", key, 64)
    try:
        sysshm.set_shared_memory_region(region, [a])
        c.register_system_shared_memory(f"mix_{side}", key, 64)
        st = c.get_system_shared_memory_status()
        assert st.regions[f"mix_{side}"].byte_size == 64
        i0 = grpcclient.InferInput("INPUT0", [16], "INT32")
        i0.set_shared_memory(f"mix_{side}", 64, 0)
        i1 = grpcclient.InferInput("INPUT1", [16], "INT32")
        i1.set_data_from_numpy(b)
        result = c.infer("add_sub", [i0, i1])
        np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + b)
        c.unregister_system_shared_memory(f"mix_{side}")
        assert not c.get_system_shared_memory_status().regions
    finally:
        sysshm.destroy_shared_memory_region(region)


# ---------------------------------------------------------- CUDA shm verbs

def _stub(channel, name):
    _kind, req_cls, resp_cls = METHODS[name]
    return channel.unary_unary(method_path(name),
                               request_serializer=req_cls.SerializeToString,
                               response_deserializer=resp_cls.FromString)


def test_cuda_shm_verbs_through_the_ports_methods(servers, clients):
    port_srv = servers["port"][1]
    h = cudashm.create_shared_memory_region("grpc_cuda", 128, device="cpu")
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 4, np.int32)
    with grpc.insecure_channel(port_srv.address,
                               options=CLIENT_CHANNEL_OPTIONS) as ch:
        try:
            cudashm.set_shared_memory_region(h, [a])
            _stub(ch, "CudaSharedMemoryRegister")(
                tpb.CudaSharedMemoryRegisterRequest(
                    name="grpc_cuda", raw_handle=cudashm.get_raw_handle(h),
                    device_id=0, byte_size=128))
            st = _stub(ch, "CudaSharedMemoryStatus")(
                tpb.CudaSharedMemoryStatusRequest())
            assert (st.regions["grpc_cuda"].byte_size,
                    st.regions["grpc_cuda"].device_id) == (128, 0)
            # the reference's client sends the region by name; the port's
            # core reads it zero-copy from the CUDA registry
            i0 = grpcclient.InferInput("INPUT0", [16], "INT32")
            i0.set_shared_memory("grpc_cuda", 64, 0)
            i1 = grpcclient.InferInput("INPUT1", [16], "INT32")
            i1.set_data_from_numpy(b)
            out = grpcclient.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory("grpc_cuda", 64, 64)
            result = clients["port"].infer("add_sub", [i0, i1],
                                           outputs=[out])
            assert result.as_numpy("OUTPUT0") is None
            np.testing.assert_array_equal(
                cudashm.get_contents_as_numpy(h, np.int32, (16,),
                                              offset=64), a + b)
            # registering a name twice is a 400, as over HTTP
            with pytest.raises(grpc.RpcError) as ei:
                _stub(ch, "CudaSharedMemoryRegister")(
                    tpb.CudaSharedMemoryRegisterRequest(
                        name="grpc_cuda",
                        raw_handle=cudashm.get_raw_handle(h),
                        byte_size=128))
            assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            _stub(ch, "CudaSharedMemoryUnregister")(
                tpb.CudaSharedMemoryUnregisterRequest(name="grpc_cuda"))
            assert not _stub(ch, "CudaSharedMemoryStatus")(
                tpb.CudaSharedMemoryStatusRequest()).regions
        finally:
            cudashm.destroy_shared_memory_region(h)


def test_tpu_shm_verbs_name_cuda_shm_on_the_port(clients):
    status, msg = _status(clients["port"].get_tpu_shared_memory_status)
    assert status == "INVALID_ARGUMENT" and "CudaSharedMemory" in msg
    status, msg = _status(lambda: clients["port"].register_tpu_shared_memory(
        "r", b"{}", 0, 8))
    assert status == "INVALID_ARGUMENT" and "CudaSharedMemory" in msg


@pytest.mark.parametrize("call", ["index", "load", "unload"])
def test_unported_rpcs_are_unimplemented_with_their_item(clients, call):
    """The repository RPCs were answered UNIMPLEMENTED until the
    repository was ported; now both servers answer them alike: the index
    (the port's extra ``lm_stride1`` aside), a reload of a programmatic
    model, and an unknown model's load and unload (INVALID_ARGUMENT with
    the reference's text). tests/test_torch_repository.py holds the
    rest."""
    def outcome(side):
        c = clients[side]
        fn = {"index": lambda: [
                  (m.name, m.version, m.state, m.reason)
                  for m in c.get_model_repository_index().models
                  if m.name != "lm_stride1"],
              "load": lambda: (c.load_model("add_sub"),
                               _status(lambda: c.load_model("ghost"))),
              "unload": lambda: _status(lambda: c.unload_model("ghost"))
              }[call]
        return fn()

    assert outcome("port") == outcome("ref")
    if call == "unload":
        assert outcome("port")[0] == "INVALID_ARGUMENT"


# ------------------------------------------------- trace and metrics

def _trace_calls(c) -> list:
    """Reads and updates of the trace settings through the JAX package's
    client, ending with every setting back at its default."""
    out = [c.get_trace_settings(as_json=True),
           c.update_trace_settings(settings={
               "trace_level": ["TIMESTAMPS"], "trace_rate": "3"},
               as_json=True),
           c.update_trace_settings("add_sub", {"trace_count": "4"},
                                   as_json=True),
           c.get_trace_settings("add_sub", as_json=True),
           c.update_trace_settings("add_sub", {"trace_count": None},
                                   as_json=True),
           c.update_trace_settings(settings={"trace_level": None,
                                             "trace_rate": None},
                                   as_json=True)]
    return out


def test_trace_setting_answers_like_the_reference(clients):
    got = {side: _trace_calls(clients[side]) for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"][3]["settings"]["trace_count"]["value"] == ["4"]
    assert got["port"][-1]["settings"]["trace_level"]["value"] == ["OFF"]


def test_trace_id_trailer_and_stream_parameter(servers):
    """A propagated ``triton_trace_id`` comes back as the ModelInfer
    trailer and as a parameter of every streamed response; untraced
    requests carry neither."""
    a = np.arange(16, dtype=np.int32)
    req = tpb.ModelInferRequest(model_name="add_sub")
    for name in ("INPUT0", "INPUT1"):
        req.inputs.add(name=name, datatype="INT32", shape=[16])
        req.raw_input_contents.append(a.tobytes())
    got = {}
    for side in SIDES:
        core, srv = servers[side]
        core.update_trace_settings(settings={"trace_level": ["TIMESTAMPS"],
                                             "trace_rate": "1000000"})
        try:
            with grpc.insecure_channel(srv.address) as ch:
                call = _stub(ch, "ModelInfer")
                tagged = tpb.ModelInferRequest()
                tagged.CopyFrom(req)
                tagged.parameters["triton_trace_id"].string_param = "beef01"
                _resp, c1 = call.with_call(tagged)
                _resp, c2 = call.with_call(req)
            stream = _trace_ids_on_stream(srv.address)
        finally:
            core.update_trace_settings(settings={"trace_level": None,
                                                 "trace_rate": None})
        got[side] = (dict(c1.trailing_metadata()).get("triton-trace-id"),
                     dict(c2.trailing_metadata()).get("triton-trace-id"),
                     stream)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == ("beef01", None)
    assert got["port"][2] == ["feed02"] * 5


def _trace_ids_on_stream(address) -> list:
    """The ``triton_trace_id`` of each response of one traced stream (4
    tokens and the final flag)."""
    c = grpcclient.InferenceServerClient(address)
    results: queue.Queue = queue.Queue()
    c.start_stream(lambda r, e: results.put((r, e)))
    ids = []
    try:
        p = grpcclient.InferInput("PROMPT", [3], "INT32")
        p.set_data_from_numpy(np.array([7, 8, 9], np.int32))
        m = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
        m.set_data_from_numpy(np.array([4], np.int32))
        c.async_stream_infer("lm", [p, m], request_id="t",
                             parameters={"triton_trace_id": "feed02"})
        while True:
            r, e = results.get(timeout=120)
            assert e is None, e
            resp = r.get_response()
            ids.append(resp.parameters["triton_trace_id"].string_param)
            if resp.parameters["triton_final_response"].bool_param:
                break
    finally:
        c.stop_stream()
        c.close()
    return ids


def test_server_metadata_returns_the_metrics_trailer(servers):
    from client_tpu_torch.server.metrics import parse_prometheus_text

    got = {}
    for side in SIDES:
        with grpc.insecure_channel(servers[side][1].address,
                                   options=CLIENT_CHANNEL_OPTIONS) as ch:
            call = _stub(ch, "ServerMetadata")
            _r, asked = call.with_call(
                tpb.ServerMetadataRequest(),
                metadata=(("client-tpu-metrics", "request"),))
            _r, plain = call.with_call(tpb.ServerMetadataRequest())
        text = dict(asked.trailing_metadata())["client-tpu-metrics-bin"]
        fams = set(parse_prometheus_text(text.decode())["families"])
        got[side] = ("client-tpu-metrics-bin" in dict(
            plain.trailing_metadata()),
            {f for f in fams if f.startswith("client_tpu_generation_")
             or f.startswith("client_tpu_inference_")})
    assert got["port"] == got["ref"]
    assert got["port"][0] is False
    assert "client_tpu_generation_tokens_total" in got["port"][1]


def test_kserve_messages_of_both_packages_share_one_process():
    """The port's messages live in a private descriptor pool, so both
    packages' ``kserve.proto`` load in one process and their messages
    parse each other's bytes."""
    from client_tpu.protocol import kserve_pb2 as jpb

    req = tpb.ModelInferRequest(model_name="m", id="7")
    t = req.inputs.add(name="IN", datatype="FP32", shape=[2, 3])
    t.parameters["binary_data_size"].int64_param = 24
    req.parameters["timeout"].int64_param = 1500
    req.parameters["tenant_id"].string_param = "acme"
    req.raw_input_contents.append(np.arange(6, dtype=np.float32).tobytes())
    o = req.outputs.add(name="OUT")
    o.parameters["classification"].int64_param = 2
    theirs = jpb.ModelInferRequest.FromString(req.SerializeToString())
    assert theirs.inputs[0].shape == [2, 3]
    assert theirs.parameters["tenant_id"].string_param == "acme"
    assert tpb.ModelInferRequest.FromString(theirs.SerializeToString()) \
        == req
    assert tpb.DESCRIPTOR.pool is not jpb.DESCRIPTOR.pool
    assert "CudaSharedMemoryStatusRequest" in tpb.DESCRIPTOR.message_types_by_name
    assert "TpuSharedMemoryStatusRequest" not in \
        tpb.DESCRIPTOR.message_types_by_name


# ---------------------------------------------------------- streaming

JOBS = [(np.arange(1, 9, dtype=np.int32), 20),
        (np.arange(30, 35, dtype=np.int32), 11),
        (np.array([5, 4, 3, 2, 1, 9, 8, 7, 6, 10, 11, 12], np.int32), 17),
        (np.array([40], np.int32), 6)]


def _stream_jobs(address, jobs, timeout_us=0, parameters=None) -> dict:
    """Send ``jobs`` on one ModelStreamInfer stream and collect, per
    request id, its tokens and final flags, and the stream's errors (a
    streamed error reaches the client as its text alone). A decoupled
    stream's requests are served one after another, as in the reference."""
    c = grpcclient.InferenceServerClient(address)
    results: queue.Queue = queue.Queue()
    c.start_stream(lambda r, e: results.put((r, e)))
    got = {str(k): {"tokens": [], "finals": 0} for k in range(len(jobs))}
    errors = []
    try:
        for k, (prompt, budget) in enumerate(jobs):
            p = grpcclient.InferInput("PROMPT", [len(prompt)], "INT32")
            p.set_data_from_numpy(prompt)
            m = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
            m.set_data_from_numpy(np.array([budget], np.int32))
            c.async_stream_infer("lm", [p, m], request_id=str(k),
                                 timeout=timeout_us, parameters=parameters)
        # every request ends with its final flag or one error
        while sum(r["finals"] for r in got.values()) + len(errors) \
                < len(jobs):
            r, e = results.get(timeout=120)
            if e is not None:
                errors.append(str(e))
                continue
            resp = r.get_response()
            out = r.as_numpy("TOKEN")
            if out is not None and out.size:
                got[resp.id]["tokens"].append(int(out[0]))
            if resp.parameters["triton_final_response"].bool_param:
                got[resp.id]["finals"] += 1
    finally:
        c.stop_stream()
        c.close()
    return {"streams": got, "errors": errors}


def test_stream_infer_greedy_tokens_equal_the_jax_engine(servers):
    got = {side: _stream_jobs(servers[side][1].address, JOBS)
           for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"]["errors"] == []
    for k, (_prompt, budget) in enumerate(JOBS):
        row = got["port"]["streams"][str(k)]
        assert (len(row["tokens"]), row["finals"]) == (budget, 1)


def test_stream_infer_carries_the_labels_and_the_deadline(servers):
    """A 1 us wire timeout has passed before the first token: both servers
    stream one deadline error and no token; well-formed labels pass."""
    engine = servers["port"][0]._entry("lm").model.engine
    expired0 = engine.gen_stats.snapshot()["deadline_expired"]
    got = {side: _stream_jobs(servers[side][1].address, JOBS[:1],
                              timeout_us=1,
                              parameters={"tenant_id": "acme",
                                          "slo_class": "gold"})
           for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"]["streams"]["0"] == {"tokens": [], "finals": 0}
    (err,) = got["port"]["errors"]
    assert "deadline exceeded" in err
    assert engine.gen_stats.snapshot()["deadline_expired"] == expired0 + 1


def test_stream_cancel_frees_the_ports_engine(servers):
    """Cancelling the RPC sets its cancel Event on the request: the
    engine's next sweep ends the stream as cancelled and frees its slot.
    The engine is held at the dispatch boundary after the stream's first
    delivery, so the stream is still in its slot when the cancel lands."""
    core, srv = servers["port"]
    engine = core._entry("lm_stride1").model.engine
    go, held = threading.Event(), threading.Event()
    sweep = engine._reap_slots

    def gated_sweep():
        if not go.is_set() and any(s.req is not None and s.req.emitted
                                   for s in engine._slots):
            held.set()
            go.wait(120)
        sweep()

    engine._reap_slots = gated_sweep
    c = grpcclient.InferenceServerClient(srv.address)
    try:
        c.start_stream(lambda r, e: None)
        p = grpcclient.InferInput("PROMPT", [4], "INT32")
        p.set_data_from_numpy(np.arange(1, 5, dtype=np.int32))
        m = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
        m.set_data_from_numpy(np.array([40], np.int32))
        c.async_stream_infer("lm_stride1", [p, m], request_id="c")
        assert held.wait(120)
        (req,) = [s.req for s in engine._slots if s.req is not None]
        assert not req.cancel_ev.is_set()
        c.stop_stream(cancel_requests=True)
        assert _wait(req.cancel_ev.is_set)
    finally:
        go.set()
        c.close()
    assert _wait(lambda: req.outcome is not None)
    engine._reap_slots = sweep
    assert req.outcome == "cancelled" and req.emitted < 40
    assert _wait(lambda: not engine.active_slots())
    with engine._lock:
        assert engine._requests_accepted == engine._requests_closed
    assert engine.gen_stats.snapshot()["cancelled"] == 1


def _wait(cond, timeout: float = 120.0) -> bool:
    """Poll ``cond`` until it holds or ``timeout`` seconds pass."""
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.005)
    return True
