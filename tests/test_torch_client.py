"""The port's HTTP client (client_tpu_torch.client.http) against the JAX
package's, on the CPU.

Every case runs the matrix {reference client, port client} x {reference
server, port server} over HTTP, on ``add_sub``, ``identity`` and a tiny
encoder with the same weights in both packages, and holds the port's
client to what the reference's gets from the same server: outputs,
statuses and error texts. What differs between the two servers by design
(their names, platforms and device shared-memory verbs, the port's
missing repository routes) is asserted per server, the same for both
clients.

Also: ``generate_request_body`` byte for byte and the JSON header's size
against the reference's for binary, JSON, BYTES, BF16, shared-memory,
parameter and sequence requests; ``parse_response_body``; gzip and
deflate both ways; ``async_infer`` with callbacks; system and CUDA
shared memory (regions on ``device="cpu"``); a request with a
``sequence_id`` (both servers have no sequence batcher for these models
and answer 200); TLS against the reference's server (the port's server
has no TLS), with a self-signed certificate as ``tests/test_tls.py``
makes one; the two cudashm examples as subprocesses against the port's
server on the CPU; and a client process that sets its input region anew
before each of six requests (no read finds a stale seqno).
"""

import os
import shutil
import subprocess
import sys
import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from client_tpu.client import http as jhttp
from client_tpu.models import add_sub as jadd
from client_tpu.models import transformer as jt
from client_tpu.server import TpuInferenceServer
from client_tpu.server.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorSpec,
)
from client_tpu.server.http_server import HttpInferenceServer as RefHttp
from client_tpu.server.model import JaxModel
from client_tpu_torch.client import http as thttp
from client_tpu_torch.models import make_add_sub, make_identity
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf.bench_harness import make_encoder_model
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as sysshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("ref", "port")
CLIENTS = {"ref": jhttp, "port": thttp}
PAIRS = [(c, s) for s in SIDES for c in SIDES]
SEQ, MAX_BATCH, D = 8, 4, 32
KW = dict(vocab_size=61, d_model=D, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=SEQ, causal=False)
# f32 on the CPU, the same weights in both packages
ATOL = 1e-5
# what differs between the two servers by design
NAME = {"ref": "client-tpu-server", "port": "client-tpu-torch-server"}
PLATFORM = {"ref": "jax", "port": "pytorch"}
DEVICE_SHM = {"ref": "tpu_shared_memory", "port": "cuda_shared_memory"}


def _jax_encoder(jcfg, jparams) -> JaxModel:
    """The reference harness's encoder (client_tpu/perf/bench_harness.py
    ``build_bert_encoder``) at the tiny width."""
    def apply_fn(params, inputs):
        tokens = inputs["input_ids"]
        x = params["embed"][tokens] + params["pos_embed"][:tokens.shape[1]][
            None]
        x = x.astype(jcfg.dtype)
        x, _ = lax.scan(lambda x, lp: jt._layer(jcfg, None, x, lp), x,
                        params["layers"])
        x = jt._rmsnorm(x, params["final_norm"])
        return {"embedding": jnp.mean(x, axis=1).astype(jnp.float32)}

    config = ModelConfig(
        name="enc", max_batch_size=MAX_BATCH,
        inputs=(TensorSpec("input_ids", "INT32", (SEQ,)),),
        outputs=(TensorSpec("embedding", "FP32", (D,)),),
        dynamic_batching=DynamicBatchingConfig(
            preferred_batch_size=(MAX_BATCH,),
            max_queue_delay_microseconds=2000),
        batch_buckets_override=(MAX_BATCH,))
    return JaxModel(config, apply_fn, params=jparams)


@pytest.fixture(scope="module")
def servers():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    jparams = jt.init_params(jax.random.key(5), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    ref, port = TpuInferenceServer(), TorchInferenceServer()
    for dtype, name in (("INT32", "add_sub"), ("FP32", "add_sub_fp32")):
        ref.register_model(jadd.make_add_sub(name, 16, dtype))
        port.register_model(make_add_sub(name, 16, dtype, device="cpu"))
    ref.register_model(jadd.make_identity("identity", 16, "INT32"))
    port.register_model(make_identity("identity", 16, "INT32", device="cpu"))
    ref.register_model(_jax_encoder(jcfg, jparams), warmup=True)
    port.register_model(make_encoder_model(
        tcfg, tparams, SEQ, MAX_BATCH, name="enc", max_queue_delay_us=2000,
        device="cpu"), warmup=True)
    http = {"ref": RefHttp(ref, port=0).start(),
            "port": HttpInferenceServer(port, port=0).start()}
    yield {"core": {"ref": ref, "port": port},
           "url": {s: http[s].url for s in SIDES}}
    for s in SIDES:
        http[s].stop()
    ref.stop()
    port.stop()


@pytest.fixture(scope="module")
def clients(servers):
    made = {(c, s): CLIENTS[c].InferenceServerClient(servers["url"][s],
                                                     concurrency=4)
            for c, s in PAIRS}
    yield made
    for x in made.values():
        x.close()


def _both(clients, side, fn):
    """``fn(client, module)`` through each client against server ``side``:
    (the reference client's outcome, the port client's). An outcome is the
    value, or ("error", status, message)."""
    out = []
    for c in SIDES:
        try:
            out.append(fn(clients[(c, side)], CLIENTS[c]))
        except Exception as e:  # noqa: BLE001 — compared below
            status = getattr(e, "status", None)
            out.append(("error", status() if callable(status) else None,
                        str(e)))
    return out


def _add_sub_inputs(mod, a, b, binary=True, dtype="INT32"):
    i0 = mod.InferInput("INPUT0", list(a.shape), dtype)
    i0.set_data_from_numpy(a, binary_data=binary)
    i1 = mod.InferInput("INPUT1", list(b.shape), dtype)
    i1.set_data_from_numpy(b, binary_data=binary)
    return [i0, i1]


# ---------------------------------------------------------- control plane

@pytest.mark.parametrize("side", SIDES)
def test_control_plane_reads_the_same(clients, side):
    for fn in (lambda c, m: c.is_server_live(),
               lambda c, m: c.is_server_ready(),
               lambda c, m: c.is_model_ready("add_sub"),
               lambda c, m: c.is_model_ready("nope"),
               lambda c, m: c.get_server_metadata(),
               lambda c, m: c.get_model_metadata("enc"),
               lambda c, m: c.get_model_config("enc"),
               lambda c, m: c.get_model_metadata("add_sub", "1"),
               lambda c, m: c.get_trace_settings(),
               lambda c, m: c.get_trace_settings("add_sub"),
               lambda c, m: c.get_system_shared_memory_status()):
        ref, port = _both(clients, side, fn)
        assert port == ref
    meta = clients[("port", side)].get_server_metadata()
    assert meta["name"] == NAME[side]
    assert DEVICE_SHM[side] in meta["extensions"]
    assert clients[("port", side)].get_model_metadata(
        "enc")["platform"] == PLATFORM[side]
    assert clients[("port", side)].is_model_ready("add_sub")
    assert not clients[("port", side)].is_model_ready("nope")


@pytest.mark.parametrize("side", SIDES)
def test_statistics_and_metrics(clients, side):
    counts = []
    for c in SIDES:
        client = clients[(c, side)]
        before = client.get_inference_statistics("add_sub")[
            "model_stats"][0]["inference_count"]
        a = np.arange(16, dtype=np.int32)
        client.infer("add_sub", _add_sub_inputs(CLIENTS[c], a, a))
        after = client.get_inference_statistics("add_sub")[
            "model_stats"][0]
        counts.append(after["inference_count"] - before)
        assert after["name"] == "add_sub"
        text = client.get_server_metrics()
        assert "client_tpu_inference_count" in text or "# HELP" in text
    assert counts == [1, 1]


@pytest.mark.parametrize("side", SIDES)
def test_errors_read_the_same(clients, side):
    a = np.arange(16, dtype=np.int32)
    cases = [
        lambda c, m: c.get_model_metadata("no_such_model"),
        lambda c, m: c.get_model_config("no_such_model"),
        lambda c, m: c.infer("no_such_model", _add_sub_inputs(m, a, a)),
        lambda c, m: c.infer("add_sub", _add_sub_inputs(m, a[:8], a[:8])),
        lambda c, m: c.infer("add_sub", [_add_sub_inputs(m, a, a)[0]]),
        lambda c, m: c.infer("add_sub", _add_sub_inputs(m, a, a),
                             model_version="7"),
        # the all-models form reads as a model named "stats" on both
        # servers (its route comes after the model-metadata route)
        lambda c, m: c.get_inference_statistics(),
        lambda c, m: c.get_debug_traces(),
        lambda c, m: c.get_debug_incidents(),
        lambda c, m: c.unregister_system_shared_memory("never_registered"),
        lambda c, m: c.get_system_shared_memory_status("never_registered"),
        lambda c, m: c.load_model("add_sub", files={"x": b"1"}),
    ]
    for fn in cases:
        ref, port = _both(clients, side, fn)
        assert port == ref


def test_client_side_checks_raise_the_same_texts():
    for mod_a, mod_b in ((jhttp, thttp),):
        msgs = []
        for mod in (mod_a, mod_b):
            got = []
            x = mod.InferInput("IN", [4], "INT32")
            for bad in (np.zeros(4, np.float32), np.zeros(5, np.int32),
                        [1, 2, 3, 4]):
                with pytest.raises(Exception) as ei:
                    x.set_data_from_numpy(bad)
                got.append(str(ei.value))
            with pytest.raises(Exception) as ei:
                mod.InferenceServerClient.generate_request_body(
                    [mod.InferInput("IN", [4], "INT32")])
            got.append(str(ei.value))
            msgs.append(got)
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("side", SIDES)
def test_device_shared_memory_verbs(clients, side):
    """Each server answers the other package's device verbs with its
    400; both clients see the same status and text."""
    for fn in (lambda c, m: c.get_cuda_shared_memory_status(),
               lambda c, m: c.get_tpu_shared_memory_status(),
               lambda c, m: c.register_cuda_shared_memory(
                   "r", b"not a handle", 0, 8),
               lambda c, m: c.register_tpu_shared_memory(
                   "r", b"not a handle", 0, 8),
               lambda c, m: c.unregister_cuda_shared_memory(),
               lambda c, m: c.unregister_tpu_shared_memory()):
        ref, port = _both(clients, side, fn)
        assert port == ref
    wrong = "tpu" if side == "port" else "cuda"
    ref, port = _both(clients, side, lambda c, m: getattr(
        c, f"get_{wrong}_shared_memory_status")())
    assert port[0] == "error" and port[1] == "400"


@pytest.mark.parametrize("side", SIDES)
def test_repository_routes(clients, side):
    """The reference's server has the repository; the port's answers its
    routes with 404 until the repository is ported (ROADMAP queue A, item
    6)."""
    for fn in (lambda c, m: c.get_model_repository_index(),
               lambda c, m: c.load_model("add_sub"),
               lambda c, m: c.unload_model("no_such_model")):
        ref, port = _both(clients, side, fn)
        assert port == ref
        if side == "port":
            assert port[0] == "error" and port[1] == "404"


# ----------------------------------------------------------------- infer

@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("client,side", PAIRS)
def test_add_sub_and_identity(clients, client, side, binary):
    c, mod = clients[(client, side)], CLIENTS[client]
    rng = np.random.default_rng(3)
    for dtype, model, np_dtype in (("INT32", "add_sub", np.int32),
                                   ("FP32", "add_sub_fp32", np.float32)):
        a = rng.integers(-50, 50, 16).astype(np_dtype)
        b = rng.integers(-50, 50, 16).astype(np_dtype)
        outs = [mod.InferRequestedOutput(n, binary_data=binary)
                for n in ("OUTPUT0", "OUTPUT1")]
        r = c.infer(model, _add_sub_inputs(mod, a, b, binary, dtype),
                    outputs=outs, request_id="rq-1")
        np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), a + b)
        np.testing.assert_array_equal(r.as_numpy("OUTPUT1"), a - b)
        assert r.get_response()["id"] == "rq-1"
        assert r.get_output("OUTPUT0")["datatype"] == dtype
        assert r.get_output("nope") is None and r.as_numpy("nope") is None
    x = mod.InferInput("INPUT0", [16], "INT32")
    x.set_data_from_numpy(np.arange(16, dtype=np.int32), binary_data=binary)
    r = c.infer("identity", [x])
    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"),
                                  np.arange(16, dtype=np.int32))


@pytest.mark.parametrize("client,side", PAIRS)
def test_requested_outputs_and_classification(clients, client, side):
    c, mod = clients[(client, side)], CLIENTS[client]
    a = np.arange(16, dtype=np.int32)
    b = np.ones(16, np.int32)
    r = c.infer("add_sub", _add_sub_inputs(mod, a, b),
                outputs=[mod.InferRequestedOutput("OUTPUT1")])
    assert [o["name"] for o in r.get_response()["outputs"]] == ["OUTPUT1"]
    r = c.infer("add_sub", _add_sub_inputs(mod, a, b), outputs=[
        mod.InferRequestedOutput("OUTPUT0", binary_data=False,
                                 class_count=2)])
    got = r.as_numpy("OUTPUT0")
    ref = _both(clients, side, lambda cc, m: cc.infer(
        "add_sub", _add_sub_inputs(m, a, b), outputs=[
            m.InferRequestedOutput("OUTPUT0", binary_data=False,
                                   class_count=2)]).as_numpy("OUTPUT0"))[0]
    np.testing.assert_array_equal(got, ref)


def _tokens(seed, rows):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=(rows, SEQ)).astype(np.int32)


@pytest.mark.parametrize("client,side", PAIRS)
def test_encoder_embeddings(clients, client, side):
    """The tiny encoder's embeddings: every pair equal to the reference
    client against the reference server (the JAX forward), at 1e-5."""
    want = {}
    for binary in (True, False):
        for seed, rows in ((1, 1), (2, 3)):
            tok = _tokens(seed, rows)
            got = []
            for c, s in (("ref", "ref"), (client, side)):
                mod = CLIENTS[c]
                x = mod.InferInput("input_ids", list(tok.shape), "INT32")
                x.set_data_from_numpy(tok, binary_data=binary)
                o = mod.InferRequestedOutput("embedding", binary_data=binary)
                got.append(clients[(c, s)].infer("enc", [x], outputs=[o])
                           .as_numpy("embedding"))
            assert got[1].shape == (rows, D) and got[1].dtype == np.float32
            np.testing.assert_allclose(got[1], got[0], atol=ATOL, rtol=0)
            want[(binary, seed)] = got[1]


@pytest.mark.parametrize("algorithm", ["gzip", "deflate"])
@pytest.mark.parametrize("client,side", PAIRS)
def test_compression_both_ways(clients, client, side, algorithm):
    c, mod = clients[(client, side)], CLIENTS[client]
    a = np.arange(16, dtype=np.int32)
    for req, resp in ((algorithm, None), (None, algorithm),
                      (algorithm, algorithm)):
        r = c.infer("add_sub", _add_sub_inputs(mod, a, a),
                    request_compression_algorithm=req,
                    response_compression_algorithm=resp)
        np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), 2 * a)
        np.testing.assert_array_equal(r.as_numpy("OUTPUT1"), 0 * a)


@pytest.mark.parametrize("client,side", PAIRS)
def test_async_infer_callbacks(clients, client, side):
    c, mod = clients[(client, side)], CLIENTS[client]
    got, errors = {}, {}
    done = threading.Event()
    lock = threading.Lock()

    def cb(i):
        def call(result, error):
            with lock:
                if error is not None:
                    errors[i] = error
                else:
                    got[i] = result.as_numpy("OUTPUT0")
                if len(got) + len(errors) == 9:
                    done.set()
        return call

    reqs = []
    for i in range(8):
        a = np.full(16, i, np.int32)
        reqs.append(c.async_infer("add_sub", _add_sub_inputs(mod, a, a),
                                  callback=cb(i)))
    bad = c.async_infer("no_such_model", _add_sub_inputs(
        mod, np.zeros(16, np.int32), np.zeros(16, np.int32)),
        callback=cb(8))
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(
            r.get_result(timeout=60).as_numpy("OUTPUT0"),
            np.full(16, 2 * i, np.int32))
    with pytest.raises(Exception) as ei:
        bad.get_result(timeout=60)
    assert done.wait(60)
    assert sorted(got) == list(range(8)) and list(errors) == [8]
    for i in range(8):
        np.testing.assert_array_equal(got[i], np.full(16, 2 * i, np.int32))
    ref = _both(clients, side, lambda cc, m: cc.async_infer(
        "no_such_model", _add_sub_inputs(m, np.zeros(16, np.int32),
                                         np.zeros(16, np.int32)))
        .get_result(timeout=60))[0]
    assert (ref[1], ref[2]) == (ei.value.status(), str(ei.value))
    assert str(errors[8]) == str(ei.value)


@pytest.mark.parametrize("side", SIDES)
def test_a_sequence_id_is_answered_alike(clients, side):
    """Neither server has a sequence batcher for add_sub: both accept a
    request that carries sequence fields and answer it as a plain one
    (200)."""
    a = np.arange(16, dtype=np.int32)
    ref, port = _both(clients, side, lambda c, m: c.infer(
        "add_sub", _add_sub_inputs(m, a, a), sequence_id=5,
        sequence_start=True, sequence_end=False).as_numpy("OUTPUT0"))
    np.testing.assert_array_equal(port, 2 * a)
    np.testing.assert_array_equal(ref, port)


@pytest.mark.parametrize("client", SIDES)
def test_priority_timeout_and_parameters_reach_the_port_server(clients,
                                                               client):
    c, mod = clients[(client, "port")], CLIENTS[client]
    a = np.arange(16, dtype=np.int32)
    r = c.infer("add_sub", _add_sub_inputs(mod, a, a), priority=1,
                timeout=5_000_000, parameters={"tenant_id": "t1"},
                headers={"x-extra": "1"}, query_params={"q": "1"})
    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), 2 * a)


# -------------------------------------------------------- request bodies

def _body_cases(mod):
    """Each case: (inputs, outputs, kwargs) for generate_request_body."""
    rng = np.random.default_rng(0)
    cases = []
    a = rng.integers(-9, 9, (2, 3)).astype(np.int32)
    f = rng.standard_normal((4,)).astype(np.float32)
    h = rng.standard_normal((3,)).astype(np.float16)
    s = np.array([b"alpha", b"", "betä".encode()], dtype=np.object_)
    for binary in (True, False):
        x = mod.InferInput("A", [2, 3], "INT32")
        x.set_data_from_numpy(a, binary_data=binary)
        y = mod.InferInput("F", [4], "FP32")
        y.set_data_from_numpy(f, binary_data=binary)
        z = mod.InferInput("S", [3], "BYTES")
        z.set_data_from_numpy(s, binary_data=binary)
        w = mod.InferInput("H", [3], "FP16")
        w.set_data_from_numpy(h, binary_data=binary)
        cases.append(([x, y, z, w], None, {}))
        cases.append(([x], [mod.InferRequestedOutput("O", binary_data=binary),
                            mod.InferRequestedOutput("C", class_count=3)],
                      dict(request_id="id-7", priority=2, timeout=100)))
    shm_in = mod.InferInput("A", [2, 3], "INT32")
    shm_in.set_shared_memory("region", 24, offset=8)
    shm_out = mod.InferRequestedOutput("O")
    shm_out.set_shared_memory("out_region", 64, offset=0)
    cases.append(([shm_in], [shm_out], {}))
    cases.append(([shm_in], [mod.InferRequestedOutput("O")
                             .set_shared_memory("r2", 8).unset_shared_memory()],
                  dict(sequence_id=42, sequence_start=True,
                       sequence_end=True, parameters={"k": "v", "n": 3})))
    cases.append(([shm_in], None, dict(sequence_id="corr-1",
                                       sequence_end=True)))
    bf = mod.InferInput("B", [2], "BF16")
    try:
        import ml_dtypes

        bf.set_data_from_numpy(np.array([1.5, -2.25], ml_dtypes.bfloat16))
        cases.append(([bf], None, {}))
    except ImportError:
        pass
    return cases


def test_generate_request_body_is_byte_equal():
    for ref_case, port_case in zip(_body_cases(jhttp), _body_cases(thttp),
                                   strict=True):
        ref = jhttp.InferenceServerClient.generate_request_body(
            ref_case[0], ref_case[1], **ref_case[2])
        port = thttp.InferenceServerClient.generate_request_body(
            port_case[0], port_case[1], **port_case[2])
        assert port == ref   # (body bytes, JSON header size or None)


def test_set_data_from_torch_sends_the_numpy_bytes():
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    x = thttp.InferInput("A", [2, 3], "INT32").set_data_from_torch(t)
    y = thttp.InferInput("A", [2, 3], "INT32").set_data_from_numpy(t.numpy())
    assert thttp.InferenceServerClient.generate_request_body([x]) == \
        thttp.InferenceServerClient.generate_request_body([y])
    b = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    body, size = thttp.InferenceServerClient.generate_request_body(
        [thttp.InferInput("B", [2], "BF16").set_data_from_torch(b)])
    assert body[size:] == b.view(torch.int16).numpy().tobytes()
    with pytest.raises(Exception, match="datatype FP32"):
        thttp.InferInput("A", [2, 3], "INT32").set_data_from_torch(
            t.float())
    with pytest.raises(Exception, match="shape"):
        thttp.InferInput("A", [6], "INT32").set_data_from_torch(t)


def test_parse_response_body_equals_the_references():
    from client_tpu_torch.protocol.rest import build_infer_response_body
    import gzip
    import zlib

    out = np.arange(6, dtype=np.float32).reshape(2, 3)
    header = {"model_name": "m", "outputs": [
        {"name": "O", "datatype": "FP32", "shape": [2, 3],
         "parameters": {"binary_data_size": out.nbytes}},
        {"name": "J", "datatype": "INT32", "shape": [2], "data": [4, 5]}]}
    body, size = build_infer_response_body(header, [out.tobytes()])
    for enc, packed in ((None, body), ("gzip", gzip.compress(body)),
                        ("deflate", zlib.compress(body))):
        got = [mod.InferenceServerClient.parse_response_body(
            packed, header_length=size, content_encoding=enc)
            for mod in (jhttp, thttp)]
        assert got[1].get_response() == got[0].get_response()
        for name in ("O", "J"):
            np.testing.assert_array_equal(got[1].as_numpy(name),
                                          got[0].as_numpy(name))


# --------------------------------------------------------- shared memory

@pytest.mark.parametrize("client,side", PAIRS)
def test_system_shared_memory(clients, client, side):
    c, mod = clients[(client, side)], CLIENTS[client]
    tag = uuid.uuid4().hex[:8]
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 3, np.int32)
    ih = sysshm.create_shared_memory_region(f"in_{tag}", f"/in_{tag}", 128)
    oh = sysshm.create_shared_memory_region(f"out_{tag}", f"/out_{tag}", 128)
    try:
        sysshm.set_shared_memory_region(ih, [a, b])
        c.register_system_shared_memory(f"in_{tag}", f"/in_{tag}", 128)
        c.register_system_shared_memory(f"out_{tag}", f"/out_{tag}", 128)
        i0 = mod.InferInput("INPUT0", [16], "INT32")
        i0.set_shared_memory(f"in_{tag}", 64, 0)
        i1 = mod.InferInput("INPUT1", [16], "INT32")
        i1.set_shared_memory(f"in_{tag}", 64, 64)
        o0 = mod.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory(f"out_{tag}", 64, 0)
        o1 = mod.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory(f"out_{tag}", 64, 64)
        r = c.infer("add_sub", [i0, i1], outputs=[o0, o1])
        assert r.as_numpy("OUTPUT0") is None   # the data is in the region
        np.testing.assert_array_equal(sysshm.get_contents_as_numpy(
            oh, np.int32, [16], offset=0), a + b)
        np.testing.assert_array_equal(sysshm.get_contents_as_numpy(
            oh, np.int32, [16], offset=64), a - b)
        status = c.get_system_shared_memory_status(f"in_{tag}")
        assert [s["name"] for s in status] == [f"in_{tag}"]
        c.unregister_system_shared_memory(f"in_{tag}")
        c.unregister_system_shared_memory()
        assert c.get_system_shared_memory_status() == []
    finally:
        sysshm.destroy_shared_memory_region(ih)
        sysshm.destroy_shared_memory_region(oh)


@pytest.mark.parametrize("client", SIDES)
def test_cuda_shared_memory_on_the_port_server(clients, servers, client):
    """Regions on device="cpu" registered through either client: the
    port's server resolves them in process (zero-copy) and writes the
    outputs into the output region."""
    c, mod = clients[(client, "port")], CLIENTS[client]
    tag = uuid.uuid4().hex[:8]
    a = np.arange(16, dtype=np.int32)
    b = np.full(16, 9, np.int32)
    ih = cudashm.create_shared_memory_region(f"cin_{tag}", 128, 0,
                                             device="cpu")
    oh = cudashm.create_shared_memory_region(f"cout_{tag}", 128, 0,
                                             device="cpu")
    try:
        cudashm.set_shared_memory_region(ih, [a, b])
        c.register_cuda_shared_memory(f"cin_{tag}",
                                      cudashm.get_raw_handle(ih), 0, 128)
        c.register_cuda_shared_memory(f"cout_{tag}",
                                      cudashm.get_raw_handle(oh), 0, 128)
        att = servers["core"]["port"].cuda_shm.try_attachment(f"cin_{tag}")
        assert type(att).__name__ == "InProcessAttachment"
        i0 = mod.InferInput("INPUT0", [16], "INT32")
        i0.set_shared_memory(f"cin_{tag}", 64, 0)
        i1 = mod.InferInput("INPUT1", [16], "INT32")
        i1.set_shared_memory(f"cin_{tag}", 64, 64)
        o0 = mod.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory(f"cout_{tag}", 64, 0)
        o1 = mod.InferRequestedOutput("OUTPUT1")
        o1.set_shared_memory(f"cout_{tag}", 64, 64)
        c.infer("add_sub", [i0, i1], outputs=[o0, o1])
        np.testing.assert_array_equal(cudashm.get_contents_as_numpy(
            oh, np.int32, (16,)), a + b)
        np.testing.assert_array_equal(cudashm.get_contents_as_numpy(
            oh, np.int32, (16,), offset=64), a - b)
        names = sorted(r["name"] for r in c.get_cuda_shared_memory_status())
        assert names == sorted([f"cin_{tag}", f"cout_{tag}"])
        one = c.get_cuda_shared_memory_status(f"cout_{tag}")
        assert [r["byte_size"] for r in one] == [128]
        c.unregister_cuda_shared_memory(f"cin_{tag}")
        c.unregister_cuda_shared_memory()
        assert c.get_cuda_shared_memory_status() == []
    finally:
        cudashm.destroy_shared_memory_region(ih)
        cudashm.destroy_shared_memory_region(oh)


def test_port_client_registers_a_tpu_region_with_the_reference_server(
        clients):
    """The TPU verbs kept for API compatibility work against the server
    that has them: a JAX-package region through the port's client."""
    from client_tpu.utils import tpu_shared_memory as tpushm

    c = clients[("port", "ref")]
    tag = uuid.uuid4().hex[:8]
    a = np.arange(16, dtype=np.int32)
    ih = tpushm.create_shared_memory_region(f"tin_{tag}", 128, 0)
    oh = tpushm.create_shared_memory_region(f"tout_{tag}", 64, 0)
    try:
        tpushm.set_shared_memory_region(ih, [a, a])
        c.register_tpu_shared_memory(f"tin_{tag}", tpushm.get_raw_handle(ih),
                                     0, 128)
        c.register_tpu_shared_memory(f"tout_{tag}",
                                     tpushm.get_raw_handle(oh), 0, 64)
        i0 = thttp.InferInput("INPUT0", [16], "INT32")
        i0.set_shared_memory(f"tin_{tag}", 64, 0)
        i1 = thttp.InferInput("INPUT1", [16], "INT32")
        i1.set_shared_memory(f"tin_{tag}", 64, 64)
        o0 = thttp.InferRequestedOutput("OUTPUT0")
        o0.set_shared_memory(f"tout_{tag}", 64, 0)
        c.infer("add_sub", [i0, i1], outputs=[o0])
        np.testing.assert_array_equal(tpushm.get_contents_as_numpy(
            oh, np.int32, (16,)), 2 * a)
        assert {r["name"] for r in c.get_tpu_shared_memory_status()} == \
            {f"tin_{tag}", f"tout_{tag}"}
    finally:
        c.unregister_tpu_shared_memory()
        tpushm.destroy_shared_memory_region(ih)
        tpushm.destroy_shared_memory_region(oh)


# ------------------------------------------------------------------- TLS

@pytest.fixture(scope="module")
def tls_server(tmp_path_factory):
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
    core = TpuInferenceServer()
    core.register_model(jadd.make_add_sub("add_sub", 16, "INT32"))
    srv = RefHttp(core, port=0, ssl_certfile=str(crt),
                  ssl_keyfile=str(key)).start()
    yield srv, str(crt)
    srv.stop()
    core.stop()


def test_tls_roundtrip_against_the_reference_server(tls_server):
    srv, crt = tls_server
    for kw in (dict(ssl_options={"ca_certs": crt}),
               dict(insecure=True),
               dict(ssl_context_factory=lambda: __import__("ssl")
                    .create_default_context(cafile=crt))):
        client = thttp.InferenceServerClient(f"localhost:{srv.port}",
                                             ssl=True, **kw)
        assert client.is_server_live()
        a = np.arange(16, dtype=np.int32)
        r = client.infer("add_sub", _add_sub_inputs(thttp, a, a))
        np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), 2 * a)
        client.close()
    # an https:// URL turns TLS on by itself
    client = thttp.InferenceServerClient(f"https://localhost:{srv.port}",
                                         ssl_options={"ca_certs": crt})
    assert client.is_server_ready()
    client.close()


def test_tls_rejects_an_untrusted_certificate(tls_server):
    srv, _ = tls_server
    for mod in (jhttp, thttp):
        client = mod.InferenceServerClient(f"localhost:{srv.port}",
                                           ssl=True)  # default trust store
        with pytest.raises(Exception) as ei:
            client.is_server_live()
        assert "CERTIFICATE_VERIFY_FAILED" in str(ei.value)
        client.close()


# -------------------------------------------------------------- examples

@pytest.fixture(scope="module")
def example_server():
    core = TorchInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    http = HttpInferenceServer(core, port=0).start()
    grpc_srv = None
    try:
        import grpc  # noqa: F401

        from client_tpu_torch.server.grpc_server import GrpcInferenceServer

        grpc_srv = GrpcInferenceServer(core, port=0).start()
    except ImportError:
        pass
    kinds = {}
    register = core.cuda_shm.register

    def recording(name, raw_handle, device_id, byte_size):
        register(name, raw_handle, device_id, byte_size)
        kinds[name] = type(core.cuda_shm.try_attachment(name)).__name__

    core.cuda_shm.register = recording
    yield http, grpc_srv, kinds
    http.stop()
    if grpc_srv is not None:
        grpc_srv.stop()
    core.stop()


@pytest.mark.parametrize("example", ["simple_http_cudashm_client",
                                     "simple_grpc_cudashm_client"])
def test_cudashm_examples_run_across_processes(example_server, example):
    """Each example as its own process against the port's server, regions
    on the CPU: the server resolves them cross-process (the staging
    buffer), writes OUTPUT0 back into it, and the example checks it."""
    http, grpc_srv, kinds = example_server
    if "grpc" in example:
        if grpc_srv is None:
            pytest.skip("grpcio is not installed")
        url, regions = grpc_srv.address, ("g_cudashm", "g_cudashm_out")
    else:
        url, regions = http.url, ("example_cudashm", "example_cudashm_out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", f"client_tpu_torch.examples.{example}",
         "-u", url, "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "PASS" in out.stdout
    assert [kinds.get(r) for r in regions] == ["CrossProcessAttachment"] * 2


_RESET_EACH_CALL = r"""
import json, sys
import numpy as np
from client_tpu_torch.client import http as httpclient
from client_tpu_torch.utils import cuda_shared_memory as cudashm

url, tag = sys.argv[1], sys.argv[2]
client = httpclient.InferenceServerClient(url)
ih = cudashm.create_shared_memory_region("xin_" + tag, 128, 0, device="cpu")
oh = cudashm.create_shared_memory_region("xout_" + tag, 64, 0, device="cpu")
client.register_cuda_shared_memory("xin_" + tag, cudashm.get_raw_handle(ih),
                                   0, 128)
client.register_cuda_shared_memory("xout_" + tag, cudashm.get_raw_handle(oh),
                                   0, 64)
i0 = httpclient.InferInput("INPUT0", [16], "INT32")
i0.set_shared_memory("xin_" + tag, 64, 0)
i1 = httpclient.InferInput("INPUT1", [16], "INT32")
i1.set_shared_memory("xin_" + tag, 64, 64)
o0 = httpclient.InferRequestedOutput("OUTPUT0")
o0.set_shared_memory("xout_" + tag, 64, 0)
rows = []
for k in range(6):
    a = np.full(16, k, np.int32)
    b = np.arange(16, dtype=np.int32) * (k + 1)
    cudashm.set_shared_memory_region(ih, [a, b])
    before = oh.seqno()
    client.infer("add_sub", [i0, i1], outputs=[o0])
    after = oh.seqno()
    out = cudashm.get_contents_as_numpy(oh, np.int32, (16,))
    rows.append([before, after, bool(np.array_equal(out, a + b))])
client.unregister_cuda_shared_memory()
print(json.dumps(rows))
"""


def test_cross_process_regions_are_never_read_stale(example_server):
    """A client process sets its input region anew before each of six
    requests: the server's seqno-guarded device cache must read each new
    input, and each output lands in the output region (its seqno moves)
    before the client reads it."""
    http, _, kinds = example_server
    tag = uuid.uuid4().hex[:8]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RESET_EACH_CALL, http.url,
                          tag], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rows = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert [r[2] for r in rows] == [True] * 6
    assert all(after > before for before, after, _ in rows)
    assert kinds[f"xin_{tag}"] == "CrossProcessAttachment"
