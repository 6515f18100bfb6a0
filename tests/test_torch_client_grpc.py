"""The port's gRPC client (client_tpu_torch.client.grpc) against the JAX
package's, on the CPU.

Every case runs the matrix {reference client, port client} x {reference
server, port server} over gRPC and holds the port's client to what the
reference's gets from the same server: outputs, status codes and texts.
The control plane with ``as_json``, raw and typed contents,
``async_infer`` with ``client_timeout``, system shared memory, the
trace settings, the metrics trailer, keep-alive options, and the stream
trio (``start_stream`` / ``async_stream_infer`` / ``stop_stream``)
against a small continuous generator: the greedy token streams of all
four pairs are identical. The device shared-memory verbs differ by
design: the port's client calls ``CudaSharedMemory*`` (which the
reference's server does not serve), the reference's ``TpuSharedMemory*``
(which the port's server refuses by name). grpcio is not installed on
the card's host, which skips the file.
"""

import queue
import shutil
import subprocess
import threading
import time
import uuid

import pytest

grpc = pytest.importorskip("grpc")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from client_tpu.client import grpc as jgrpc  # noqa: E402
from client_tpu.models import add_sub as jadd  # noqa: E402
from client_tpu.models import decoder_lm as jlm  # noqa: E402
from client_tpu.models import transformer as jt  # noqa: E402
from client_tpu.server import TpuInferenceServer  # noqa: E402
from client_tpu.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer as RefGrpcServer,
)
from client_tpu_torch.client import grpc as tgrpc  # noqa: E402
from client_tpu_torch.models import decoder_lm as tlm  # noqa: E402
from client_tpu_torch.models import make_add_sub, make_identity  # noqa: E402
from client_tpu_torch.models import transformer as tt  # noqa: E402
from client_tpu_torch.server import TorchInferenceServer  # noqa: E402
from client_tpu_torch.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer,
)
from client_tpu_torch.utils import cuda_shared_memory as cudashm  # noqa: E402
from client_tpu_torch.utils import shared_memory as sysshm  # noqa: E402

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)
SIDES = ("ref", "port")
CLIENTS = {"ref": jgrpc, "port": tgrpc}
PAIRS = [(c, s) for s in SIDES for c in SIDES]
NAME = {"ref": "client-tpu-server", "port": "client-tpu-torch-server"}
SLOW_S = 0.5
JOBS = [(np.arange(1, 9, dtype=np.int32), 12),
        (np.array([40], np.int32), 6),
        (np.array([5, 4, 3, 2, 1, 9, 8], np.int32), 9)]


@pytest.fixture(scope="module")
def servers():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    ref, port = TpuInferenceServer(), TorchInferenceServer()
    for dtype, name in (("INT32", "add_sub"), ("FP32", "add_sub_fp32")):
        ref.register_model(jadd.make_add_sub(name, 16, dtype))
        port.register_model(make_add_sub(name, 16, dtype, device="cpu"))
    ref.register_model(jlm.make_continuous_generator(
        "lm", cfg=jcfg, params=dict(jparams), n_slots=2, chunk_size=4))
    port.register_model(tlm.make_continuous_generator(
        "lm", cfg=tcfg, params=tparams, n_slots=2, chunk_size=4,
        device="cpu"))
    # a model that answers after SLOW_S, past a short client_timeout
    from client_tpu.server.config import ModelConfig as JCfg
    from client_tpu.server.config import TensorSpec as JSpec
    from client_tpu.server.model import PyModel as JPy
    from client_tpu_torch.server.config import ModelConfig, TensorSpec
    from client_tpu_torch.server.model import PyModel

    def slow(inputs):
        time.sleep(SLOW_S)
        return {"OUTPUT0": inputs["INPUT0"]}

    for mod_cfg, spec, py, core in ((JCfg, JSpec, JPy, ref),
                                    (ModelConfig, TensorSpec, PyModel, port)):
        core.register_model(py(mod_cfg(
            name="slow", inputs=(spec("INPUT0", "INT32", (4,)),),
            outputs=(spec("OUTPUT0", "INT32", (4,)),)), slow))
    srv = {"ref": RefGrpcServer(ref, port=0).start(),
           "port": GrpcInferenceServer(port, port=0).start()}
    yield {"core": {"ref": ref, "port": port},
           "address": {s: srv[s].address for s in SIDES}}
    for s in SIDES:
        srv[s].stop()
    ref.stop()
    port.stop()


@pytest.fixture(scope="module")
def clients(servers):
    made = {(c, s): CLIENTS[c].InferenceServerClient(servers["address"][s])
            for c, s in PAIRS}
    yield made
    for x in made.values():
        x.close()


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — compared by the caller
        status = getattr(e, "status", None)
        return ("error", status() if callable(status) else None, str(e))


def _both(clients, side, fn):
    return [_outcome(lambda c=c: fn(clients[(c, side)], CLIENTS[c]))
            for c in SIDES]


def _inputs(mod, a, b, dtype="INT32", use_raw=True):
    i0 = mod.InferInput("INPUT0", list(a.shape), dtype)
    i0.set_data_from_numpy(a, use_raw=use_raw)
    i1 = mod.InferInput("INPUT1", list(b.shape), dtype)
    i1.set_data_from_numpy(b, use_raw=use_raw)
    return [i0, i1]


@pytest.mark.parametrize("side", SIDES)
def test_control_plane_reads_the_same(clients, side):
    for fn in (lambda c, m: c.is_server_live(),
               lambda c, m: c.is_server_ready(),
               lambda c, m: c.is_model_ready("add_sub"),
               lambda c, m: c.is_model_ready("ghost"),
               lambda c, m: c.get_server_metadata(as_json=True),
               lambda c, m: c.get_model_metadata("add_sub", as_json=True),
               lambda c, m: c.get_model_config("add_sub", as_json=True),
               lambda c, m: c.get_model_config("lm", as_json=True),
               lambda c, m: c.get_model_repository_index(as_json=True),
               lambda c, m: c.load_model("add_sub"),
               lambda c, m: c.get_system_shared_memory_status(as_json=True),
               lambda c, m: c.get_debug_traces(),
               lambda c, m: c.get_debug_incidents()):
        ref, port = _both(clients, side, fn)
        assert port == ref
    c = clients[("port", side)]
    assert c.get_server_metadata().name == NAME[side]
    assert c.get_model_metadata("add_sub").name == "add_sub"
    stats = c.get_inference_statistics("add_sub", as_json=True)
    assert stats["model_stats"][0]["name"] == "add_sub"
    assert "# TYPE" in c.get_server_metrics()


def _trace_calls(c) -> list:
    return [c.get_trace_settings(as_json=True),
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


@pytest.mark.parametrize("side", SIDES)
def test_trace_settings_read_the_same(clients, side):
    ref, port = _both(clients, side, lambda c, m: _trace_calls(c))
    assert port == ref


@pytest.mark.parametrize("use_raw", [True, False])
@pytest.mark.parametrize("client,side", PAIRS)
def test_infer_outputs(clients, client, side, use_raw):
    c, mod = clients[(client, side)], CLIENTS[client]
    rng = np.random.default_rng(3)
    for dtype, model, np_dtype in (("INT32", "add_sub", np.int32),
                                   ("FP32", "add_sub_fp32", np.float32)):
        a = rng.integers(-50, 50, 16).astype(np_dtype)
        b = rng.integers(-50, 50, 16).astype(np_dtype)
        r = c.infer(model, _inputs(mod, a, b, dtype, use_raw),
                    request_id="rq-9")
        np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), a + b)
        np.testing.assert_array_equal(r.as_numpy("OUTPUT1"), a - b)
        assert r.get_response().id == "rq-9"
        assert r.get_output("OUTPUT1", as_json=True)["datatype"] == dtype
    r = c.infer("add_sub", _inputs(mod, a.astype(np.int32),
                                   b.astype(np.int32)),
                outputs=[mod.InferRequestedOutput("OUTPUT1")])
    assert [o.name for o in r.get_response().outputs] == ["OUTPUT1"]


def test_set_data_from_torch_sends_the_raw_bytes(clients):
    c = clients[("port", "port")]
    a = torch.arange(16, dtype=torch.int32)
    i0 = tgrpc.InferInput("INPUT0", [16], "INT32").set_data_from_torch(a)
    i1 = tgrpc.InferInput("INPUT1", [16], "INT32").set_data_from_torch(a)
    r = c.infer("add_sub", [i0, i1])
    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), 2 * a.numpy())


@pytest.mark.parametrize("client,side", PAIRS)
def test_async_infer_and_client_timeout(clients, client, side):
    c, mod = clients[(client, side)], CLIENTS[client]
    a = np.arange(16, dtype=np.int32)
    done = threading.Event()
    holder = {}

    def cb(result, error):
        holder["r"], holder["e"] = result, error
        done.set()

    ctx = c.async_infer("add_sub", _inputs(mod, a, a), cb,
                        client_timeout=30)
    assert done.wait(30)
    assert holder["e"] is None
    np.testing.assert_array_equal(holder["r"].as_numpy("OUTPUT0"), 2 * a)
    assert ctx.result(timeout=5) is not None
    done.clear()
    c.async_infer("ghost", _inputs(mod, a, a), cb)
    assert done.wait(30)
    assert holder["r"] is None and holder["e"].status() == "NOT_FOUND"
    def slow(cc, m):
        x = m.InferInput("INPUT0", [4], "INT32")
        x.set_data_from_numpy(np.arange(4, dtype=np.int32))
        cc.infer("slow", [x], client_timeout=SLOW_S / 10)

    ref, port = _both(clients, side, slow)
    assert port == ref and port[1] == "DEADLINE_EXCEEDED"


def _wrong_shape(c, m):
    a = np.zeros(8, np.int32)
    c.infer("add_sub", _inputs(m, a, a))


def _short_raw(c, m):
    ins = _inputs(m, np.zeros(16, np.int32), np.zeros(16, np.int32))
    ins[0]._raw = b"\x00" * 8  # corrupt the payload
    c.infer("add_sub", ins)


def _decoupled_unary(c, m):
    p = m.InferInput("PROMPT", [4], "INT32")
    p.set_data_from_numpy(np.arange(4, dtype=np.int32))
    c.infer("lm", [p])


ERRORS = {
    "unknown_model_metadata": lambda c, m: c.get_model_metadata("ghost"),
    "unknown_model_infer": lambda c, m: c.infer(
        "ghost", _inputs(m, np.zeros(16, np.int32), np.zeros(16, np.int32))),
    "unknown_model_stats": lambda c, m: c.get_inference_statistics("ghost"),
    "wrong_shape": _wrong_shape,
    "short_raw": _short_raw,
    "decoupled_unary": _decoupled_unary,
    "bad_label": lambda c, m: c.infer(
        "add_sub", _inputs(m, np.zeros(16, np.int32),
                           np.zeros(16, np.int32)),
        parameters={"tenant_id": "bad tenant"}),
    "unregistered_region": lambda c, m: c.register_system_shared_memory(
        "nope", "/client_tpu_torch_no_such_region", 64),
    "unload_unknown": lambda c, m: c.unload_model("ghost"),
    "stream_not_started": lambda c, m: c.async_stream_infer(
        "lm", _inputs(m, np.zeros(16, np.int32), np.zeros(16, np.int32))),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
@pytest.mark.parametrize("side", SIDES)
def test_errors_read_the_same(clients, side, case):
    ref, port = _both(clients, side, ERRORS[case])
    assert port == ref
    assert port[0] == "error"


@pytest.mark.parametrize("client,side", PAIRS)
def test_system_shared_memory(clients, client, side):
    c, mod = clients[(client, side)], CLIENTS[client]
    tag = uuid.uuid4().hex[:8]
    a = np.arange(16, dtype=np.int32)
    ih = sysshm.create_shared_memory_region(f"gin_{tag}", f"/gin_{tag}", 64)
    oh = sysshm.create_shared_memory_region(f"gout_{tag}", f"/gout_{tag}",
                                            64)
    try:
        sysshm.set_shared_memory_region(ih, [a])
        c.register_system_shared_memory(f"gin_{tag}", f"/gin_{tag}", 64)
        c.register_system_shared_memory(f"gout_{tag}", f"/gout_{tag}", 64)
        i0 = mod.InferInput("INPUT0", [16], "INT32")
        i0.set_shared_memory(f"gin_{tag}", 64)
        i1 = mod.InferInput("INPUT1", [16], "INT32")
        i1.set_data_from_numpy(np.ones(16, np.int32))
        o0 = mod.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory(f"gout_{tag}", 64)
        r = c.infer("add_sub", [i0, i1], outputs=[
            o0, mod.InferRequestedOutput("OUTPUT1")])
        assert r.as_numpy("OUTPUT0") is None
        np.testing.assert_array_equal(r.as_numpy("OUTPUT1"), a - 1)
        np.testing.assert_array_equal(sysshm.get_contents_as_numpy(
            oh, np.int32, [16]), a + 1)
        status = c.get_system_shared_memory_status(as_json=True)
        assert {f"gin_{tag}", f"gout_{tag}"} <= set(status["regions"])
        c.unregister_system_shared_memory()
        assert c.get_system_shared_memory_status(as_json=True) == {}
    finally:
        sysshm.destroy_shared_memory_region(ih)
        sysshm.destroy_shared_memory_region(oh)


def test_device_shared_memory_verbs(clients):
    """Each client's device verbs name its own package's RPCs: the port's
    CudaSharedMemory* are served by the port's server and unimplemented on
    the reference's; the reference's TpuSharedMemory* are served by the
    reference's server and refused by name on the port's."""
    port_on_port = clients[("port", "port")]
    assert port_on_port.get_cuda_shared_memory_status(as_json=True) == {}
    status = _outcome(clients[("port", "ref")].get_cuda_shared_memory_status)
    assert status[:2] == ("error", "UNIMPLEMENTED")
    assert clients[("ref", "ref")].get_tpu_shared_memory_status(
        as_json=True) == {}
    status = _outcome(clients[("ref", "port")].get_tpu_shared_memory_status)
    assert status[:2] == ("error", "INVALID_ARGUMENT")
    assert "CudaSharedMemory" in status[2]


def test_cuda_shared_memory_through_the_port_client(clients):
    c = clients[("port", "port")]
    tag = uuid.uuid4().hex[:8]
    a = np.arange(16, dtype=np.int32)
    ih = cudashm.create_shared_memory_region(f"gcin_{tag}", 128, 0,
                                             device="cpu")
    oh = cudashm.create_shared_memory_region(f"gcout_{tag}", 64, 0,
                                             device="cpu")
    try:
        cudashm.set_shared_memory_region(ih, [a, a])
        c.register_cuda_shared_memory(f"gcin_{tag}",
                                      cudashm.get_raw_handle(ih), 0, 128)
        c.register_cuda_shared_memory(f"gcout_{tag}",
                                      cudashm.get_raw_handle(oh), 0, 64)
        i0 = tgrpc.InferInput("INPUT0", [16], "INT32")
        i0.set_shared_memory(f"gcin_{tag}", 64, 0)
        i1 = tgrpc.InferInput("INPUT1", [16], "INT32")
        i1.set_shared_memory(f"gcin_{tag}", 64, 64)
        o0 = tgrpc.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory(f"gcout_{tag}", 64)
        c.infer("add_sub", [i0, i1], outputs=[o0])
        np.testing.assert_array_equal(cudashm.get_contents_as_numpy(
            oh, np.int32, (16,)), 2 * a)
        regions = c.get_cuda_shared_memory_status(as_json=True)["regions"]
        assert set(regions) == {f"gcin_{tag}", f"gcout_{tag}"}
        c.unregister_cuda_shared_memory(f"gcin_{tag}")
        c.unregister_cuda_shared_memory()
        assert c.get_cuda_shared_memory_status(as_json=True) == {}
    finally:
        cudashm.destroy_shared_memory_region(ih)
        cudashm.destroy_shared_memory_region(oh)


def test_keepalive_options_and_channel_args(servers):
    ka = tgrpc.KeepAliveOptions(keepalive_time_ms=10_000,
                                keepalive_timeout_ms=5_000,
                                keepalive_permit_without_calls=True)
    for side in SIDES:
        c = tgrpc.InferenceServerClient(
            servers["address"][side], keepalive_options=ka,
            channel_args=[("grpc.enable_retries", 0)])
        a = np.arange(16, dtype=np.int32)
        r = c.infer("add_sub", _inputs(tgrpc, a, a))
        np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), 2 * a)
        c.close()


def _stream(mod, address, jobs) -> dict:
    """Send ``jobs`` on one stream; per request id its tokens and final
    flags, and the stream's errors."""
    c = mod.InferenceServerClient(address)
    results: queue.Queue = queue.Queue()
    c.start_stream(lambda r, e: results.put((r, e)))
    got = {str(k): {"tokens": [], "finals": 0} for k in range(len(jobs))}
    errors = []
    try:
        with pytest.raises(Exception) as ei:
            c.start_stream(lambda r, e: None)
        errors.append(("double start", str(ei.value)))
        for k, (prompt, budget) in enumerate(jobs):
            p = mod.InferInput("PROMPT", [len(prompt)], "INT32")
            p.set_data_from_numpy(prompt)
            m = mod.InferInput("MAX_TOKENS", [1], "INT32")
            m.set_data_from_numpy(np.array([budget], np.int32))
            c.async_stream_infer("lm", [p, m], request_id=str(k))
        while sum(r["finals"] for r in got.values()) < len(jobs):
            r, e = results.get(timeout=120)
            if e is not None:
                errors.append(str(e))
                break
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


def test_stream_trio_greedy_tokens_are_identical(servers):
    got = {(c, s): _stream(CLIENTS[c], servers["address"][s], JOBS)
           for c, s in PAIRS}
    first = got[("ref", "ref")]
    for pair, row in got.items():
        assert row == first, pair
    assert len(first["errors"]) == 1 and "already active" in \
        first["errors"][0][1]
    for k, (_p, budget) in enumerate(JOBS):
        assert (len(first["streams"][str(k)]["tokens"]),
                first["streams"][str(k)]["finals"]) == (budget, 1)


def test_stream_sends_after_stop_raise_the_same(servers):
    texts = []
    for c in SIDES:
        client = CLIENTS[c].InferenceServerClient(servers["address"]["port"])
        client.start_stream(lambda r, e: None)
        stream = client._stream
        client.stop_stream()
        with pytest.raises(Exception) as ei:
            stream.send(None)
        texts.append(str(ei.value))
        client.close()
    assert texts[0] == texts[1]


def _tls_core(side: str):
    """An add_sub core of ``side``: the reference's or the port's."""
    if side == "ref":
        core = TpuInferenceServer()
        core.register_model(jadd.make_add_sub("add_sub", 16, "INT32"))
    else:
        core = TorchInferenceServer()
        core.register_model(make_add_sub("add_sub", 16, "INT32",
                                         device="cpu"))
    return core


def _server_of(side: str):
    return RefGrpcServer if side == "ref" else GrpcInferenceServer


@pytest.fixture(scope="module")
def tls_files(tmp_path_factory):
    """A self-signed localhost certificate and its key (it also serves as
    the mutual-TLS root and the client's certificate)."""
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    d = tmp_path_factory.mktemp("tls")
    key, crt = d / "server.key", d / "server.crt"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    return key, crt


@pytest.fixture(scope="module", params=["ref", "port"])
def tls_server(request, tls_files):
    """The same add_sub model behind the reference's TLS gRPC server and
    behind the port's (``ssl_certfile=``, ``ssl_keyfile=``)."""
    key, crt = tls_files
    core = _tls_core(request.param)
    srv = _server_of(request.param)(core, port=0, ssl_certfile=str(crt),
                                    ssl_keyfile=str(key)).start()
    yield srv, crt.read_bytes()
    srv.stop()
    core.stop()


def test_tls_roundtrip_against_the_reference_server(tls_server):
    srv, root = tls_server
    c = tgrpc.InferenceServerClient(f"localhost:{srv.port}", ssl=True,
                                    root_certificates=root)
    assert c.is_server_live()
    a = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(
        c.infer("add_sub", _inputs(tgrpc, a, a)).as_numpy("OUTPUT0"), 2 * a)
    c.close()


def _mtls_answers(side: str, tls_files) -> list:
    """``side``'s server with a combined PEM (no ``ssl_keyfile``) and a
    root certificate (mutual TLS): the port's client with the client
    certificate, then without one."""
    key, crt = tls_files
    pem = crt.parent / f"combined_{side}.pem"
    pem.write_bytes(key.read_bytes() + crt.read_bytes())
    core = _tls_core(side)
    srv = _server_of(side)(core, port=0, ssl_certfile=str(pem),
                           ssl_root_certfile=str(crt)).start()
    a = np.arange(16, dtype=np.int32)
    out = []
    try:
        for client_kw in (dict(private_key=key.read_bytes(),
                               certificate_chain=crt.read_bytes()), {}):
            c = tgrpc.InferenceServerClient(
                f"localhost:{srv.port}", ssl=True,
                root_certificates=crt.read_bytes(), **client_kw)
            try:
                r = c.infer("add_sub", _inputs(tgrpc, a, a))
                out.append(r.as_numpy("OUTPUT0").tolist())
            except Exception as e:  # noqa: BLE001 — compared below
                out.append(type(e).__name__)
            finally:
                c.close()
    finally:
        srv.stop()
        core.stop()
    return out


@pytest.mark.parametrize("side", ["ref", "port"])
def test_mutual_tls_refuses_a_client_without_a_certificate(tls_files, side):
    """With ``ssl_root_certfile`` the server requires a client
    certificate: a client that presents one is served, one without is
    refused, by the port's server as by the reference's."""
    got = _mtls_answers(side, tls_files)
    assert got[0] == [2 * x for x in range(16)]
    assert isinstance(got[1], str)
    if side == "port":
        assert got == _mtls_answers("ref", tls_files)


def _timeout_answers(side: str) -> list:
    """What the port's gRPC client answers against ``side``'s server of
    an identity model that sleeps 0.3 s: the status under a 50 ms
    deadline, then the output without one."""
    if side == "ref":
        core = TpuInferenceServer()
        core.register_model(jadd.make_identity("identity_delay", 16,
                                               "INT32", delay_s=0.3))
    else:
        core = TorchInferenceServer()
        core.register_model(make_identity("identity_delay", 16, "INT32",
                                          delay_s=0.3))
    srv = _server_of(side)(core, port=0).start()
    a = np.arange(16, dtype=np.int32)
    out = []
    try:
        c = tgrpc.InferenceServerClient(f"localhost:{srv.port}")
        try:
            for timeout in (0.05, None):
                i0 = tgrpc.InferInput("INPUT0", [16], "INT32")
                i0.set_data_from_numpy(a)
                try:
                    r = c.infer("identity_delay", [i0],
                                client_timeout=timeout)
                    out.append(r.as_numpy("OUTPUT0").tolist())
                except Exception as e:  # noqa: BLE001 — compared below
                    out.append(e.status())
        finally:
            c.close()
    finally:
        srv.stop()
        core.stop()
    return out


def test_a_client_deadline_against_a_slow_identity_reads_as_the_reference():
    """``make_identity(delay_s=0.3)`` sleeps in a host model: a 50 ms
    deadline ends the call with DEADLINE_EXCEEDED, and no deadline
    returns the input, from the port's server as from the reference's."""
    port = _timeout_answers("port")
    assert port == _timeout_answers("ref")
    assert port == ["DEADLINE_EXCEEDED", list(range(16))]
