"""The port's serving slice end to end on the CPU: a small encoder behind
client_tpu_torch's dynamic batcher and HTTP front end, driven over HTTP by
the JAX package's client, with every embedding held against the JAX
package's encoder apply on the same weights."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from client_tpu.client import http as httpclient
from client_tpu.models import transformer as jt
from client_tpu.utils import InferenceServerException
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.perf.bench_harness import make_encoder_model
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.server.types import InferRequest, InferTensor, ServerError

SEQ, MAX_BATCH, D = 16, 8, 32
# f32 on the CPU, the same weights in both packages
ATOL = 1e-5
KW = dict(vocab_size=61, d_model=D, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=SEQ, causal=False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_embed(cfg, params, tokens):
    """client_tpu/perf/bench_harness.py's encoder apply_fn, small."""
    x = params["embed"][tokens] + params["pos_embed"][:tokens.shape[1]][None]
    x = x.astype(cfg.dtype)
    x, _ = lax.scan(lambda x, lp: jt._layer(cfg, None, x, lp), x,
                    params["layers"])
    x = jt._rmsnorm(x, params["final_norm"])
    return np.asarray(jnp.mean(x, axis=1).astype(jnp.float32))


@pytest.fixture(scope="module")
def stack():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    jparams = jt.init_params(jax.random.key(7), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    core = TorchInferenceServer()
    # a long queue delay so that requests sent together share a batch
    core.register_model(make_encoder_model(
        tcfg, tparams, SEQ, MAX_BATCH, name="enc", max_queue_delay_us=50_000,
        device="cpu"), warmup=True)
    core.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    http_srv = HttpInferenceServer(core, port=0).start()
    client = httpclient.InferenceServerClient(http_srv.url, concurrency=8)
    yield {"core": core, "url": http_srv.url, "client": client,
           "ref": lambda tok: _jax_embed(jcfg, jparams, jnp.asarray(tok))}
    client.close()
    http_srv.stop()
    core.stop()


def _tokens(seed, rows=1):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=(rows, SEQ)).astype(np.int32)


def _enc_input(tok, binary):
    i = httpclient.InferInput("input_ids", tok.shape, "INT32")
    return i.set_data_from_numpy(tok, binary_data=binary)


def test_control_plane(stack):
    c = stack["client"]
    assert c.is_server_live() and c.is_server_ready()
    assert c.is_model_ready("enc") and not c.is_model_ready("nope")
    meta = c.get_server_metadata()
    assert meta["name"] == "client-tpu-torch-server"
    assert "binary_tensor_data" in meta["extensions"]
    mm = c.get_model_metadata("enc")
    assert mm["platform"] == "pytorch" and mm["versions"] == ["1"]
    assert mm["inputs"] == [{"name": "input_ids", "datatype": "INT32",
                             "shape": [-1, SEQ]}]
    assert mm["outputs"] == [{"name": "embedding", "datatype": "FP32",
                              "shape": [-1, D]}]
    cfg = c.get_model_config("enc")
    assert cfg["max_batch_size"] == MAX_BATCH and cfg["backend"] == "pytorch"
    assert cfg["dynamic_batching"]["preferred_batch_size"] == [MAX_BATCH]
    stats = c.get_inference_statistics("enc")["model_stats"]
    assert [s["name"] for s in stats] == ["enc"]


def test_concurrent_json_and_binary_requests_match_jax(stack):
    c, ref = stack["client"], stack["ref"]
    n = 24
    results, errors = [None] * n, []

    def one(i):
        tok = _tokens(100 + i)
        try:
            r = c.infer("enc", [_enc_input(tok, binary=i % 2 == 0)],
                        outputs=[httpclient.InferRequestedOutput(
                            "embedding", binary_data=i % 3 != 0)])
            results[i] = (tok, r.as_numpy("embedding"))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for tok, emb in results:
        assert emb.shape == (1, D) and emb.dtype == np.float32
        np.testing.assert_allclose(emb, ref(tok), rtol=0, atol=ATOL)


def test_requests_sent_together_share_a_batch(stack):
    """Callback-form infer through the core: eight requests submitted at
    once ride one padded batch of the dynamic batcher."""
    core, ref = stack["core"], stack["ref"]
    before = core.statistics("enc")["model_stats"][0]
    launches_before = fa.launches
    toks = [_tokens(200 + i) for i in range(MAX_BATCH)]
    got, done = {}, threading.Event()
    lock = threading.Lock()

    def cb(i):
        def f(resp, final):
            with lock:
                got[i] = resp
                if len(got) == len(toks):
                    done.set()
        return f

    for i, tok in enumerate(toks):
        req = InferRequest(model_name="enc", inputs=[InferTensor(
            "input_ids", "INT32", tok.shape, data=tok)])
        assert core.infer(req, response_callback=cb(i)) is None
    assert done.wait(30)
    for i, tok in enumerate(toks):
        assert got[i].error is None, got[i].error
        np.testing.assert_allclose(got[i].output("embedding").data, ref(tok),
                                   rtol=0, atol=ATOL)
    after = core.statistics("enc")["model_stats"][0]
    executions = after["execution_count"] - before["execution_count"]
    inferences = after["inference_count"] - before["inference_count"]
    assert inferences == MAX_BATCH and executions < inferences
    assert any(b["batch_size"] > 1 for b in after["batch_stats"])
    # the CPU takes the kernel's plain version
    assert fa.launches == launches_before


def test_sync_infer_of_a_multi_row_request(stack):
    core, ref = stack["core"], stack["ref"]
    tok = _tokens(300, rows=3)
    resp = core.infer(InferRequest(model_name="enc", inputs=[InferTensor(
        "input_ids", "INT32", tok.shape, data=tok)]))
    out = resp.output("embedding")
    assert out.shape == (3, D) and out.datatype == "FP32"
    np.testing.assert_allclose(out.data, ref(tok), rtol=0, atol=ATOL)


def test_statistics_count_the_requests(stack):
    c = stack["client"]
    before = c.get_inference_statistics("enc")["model_stats"][0]
    c.infer("enc", [_enc_input(_tokens(400), binary=True)])
    after = c.get_inference_statistics("enc")["model_stats"][0]
    assert after["inference_count"] == before["inference_count"] + 1
    assert after["execution_count"] == before["execution_count"] + 1
    assert after["inference_stats"]["success"]["count"] == \
        before["inference_stats"]["success"]["count"] + 1


@pytest.mark.parametrize("case,status,text", [
    ("unknown_model", "404", "unknown model"),
    ("wrong_shape", "400", "shape"),
    ("wrong_dtype", "400", "datatype"),
    ("batch_too_large", "400", "exceeds max_batch_size"),
    ("shm_input", "400", "is not registered"),
])
def test_errors_carry_the_reference_statuses(stack, case, status, text):
    c = stack["client"]
    tok = _tokens(500)
    model = "enc"
    if case == "unknown_model":
        model = "nope"
        inp = _enc_input(tok, True)
    elif case == "wrong_shape":
        inp = _enc_input(np.zeros((1, SEQ + 1), np.int32), True)
    elif case == "wrong_dtype":
        inp = httpclient.InferInput("input_ids", tok.shape, "FP32")
        inp.set_data_from_numpy(tok.astype(np.float32))
    elif case == "batch_too_large":
        inp = _enc_input(_tokens(501, rows=MAX_BATCH + 1), True)
    else:   # a region nobody registered
        inp = httpclient.InferInput("input_ids", tok.shape, "INT32")
        inp.set_shared_memory("region0", tok.nbytes)
    with pytest.raises(InferenceServerException) as ei:
        c.infer(model, [inp])
    assert ei.value.status() == status
    assert text in str(ei.value)


def test_lying_binary_header_is_a_client_error(stack):
    body = json.dumps({"inputs": [{"name": "input_ids", "shape": [1, SEQ],
                                   "datatype": "INT32",
                                   "parameters": {"binary_data_size": 64}}]})
    req = urllib.request.Request(
        f"http://{stack['url']}/v2/models/enc/infer",
        data=body.encode() + b"\0" * 8, method="POST",
        headers={"Inference-Header-Content-Length": str(len(body))})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_add_sub_over_http(stack):
    c = stack["client"]
    a = np.arange(16, dtype=np.int32)
    b = np.ones(16, dtype=np.int32)
    ins = []
    for name, x in (("INPUT0", a), ("INPUT1", b)):
        ins.append(httpclient.InferInput(name, x.shape, "INT32")
                   .set_data_from_numpy(x, binary_data=False))
    r = c.infer("add_sub", ins)
    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), a + b)
    np.testing.assert_array_equal(r.as_numpy("OUTPUT1"), a - b)


def test_core_raises_server_error_for_unknown_model(stack):
    with pytest.raises(ServerError) as ei:
        stack["core"].infer(InferRequest(model_name="nope"))
    assert ei.value.status == 404


def test_server_process_serves_add_sub(unused_tcp_port):
    """``python -m client_tpu_torch.server --demo-models`` on the CPU,
    driven like the verify recipe: a separate process, plain HTTP."""
    port = unused_tcp_port
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--device", "cpu",
         "--demo-models", "--http-port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 60
        while True:
            try:
                urllib.request.urlopen(f"{url}/v2/health/ready", timeout=2)
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.2)
        body = json.dumps({"inputs": [
            {"name": "INPUT0", "shape": [16], "datatype": "INT32",
             "data": list(range(16))},
            {"name": "INPUT1", "shape": [16], "datatype": "INT32",
             "data": [1] * 16}]}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/v2/models/add_sub/infer", data=body, method="POST"),
                timeout=10) as resp:
            out = json.loads(resp.read())
        by_name = {o["name"]: o["data"] for o in out["outputs"]}
        assert by_name["OUTPUT0"] == [i + 1 for i in range(16)]
        assert by_name["OUTPUT1"] == [i - 1 for i in range(16)]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("wire,arr", [
    ("INT32", np.arange(-6, 6, dtype=np.int32).reshape(3, 4)),
    ("FP32", np.linspace(-1, 1, 10, dtype=np.float32)),
    ("BOOL", np.array([True, False, True])),
    ("BYTES", np.array([b"a", b"", "été".encode()], dtype=np.object_)),
])
@pytest.mark.parametrize("binary", [False, True])
def test_protocol_codec_matches_the_reference(wire, arr, binary):
    """The port's copy of the v2 codec frames tensors byte for byte as
    the JAX package's does, and reads back what it wrote."""
    from client_tpu.protocol import rest as jrest
    from client_tpu_torch.protocol import rest as trest

    parts = {}
    for name, mod in (("ref", jrest), ("port", trest)):
        tj, blob = mod.tensor_json_and_blob("x", arr, wire, arr.shape, binary)
        body, json_size = mod.build_infer_request_body(
            {"inputs": [tj]}, [blob] if blob is not None else [])
        parts[name] = (body, json_size)
    assert parts["port"] == parts["ref"]
    body, json_size = parts["port"]
    header, tail = trest.parse_infer_request_body(
        body, json_size if binary else None)
    binmap = trest.slice_binary_tensors(header["inputs"], tail)
    back = trest.tensor_from_json(header["inputs"][0], binmap)
    assert back.shape == arr.shape
    assert back.tolist() == arr.tolist()


def test_config_from_dict_rejects_unknown_keys():
    from client_tpu_torch.server.config import (
        DynamicBatchingConfig,
        config_from_dict,
    )

    db = config_from_dict(DynamicBatchingConfig,
                          {"preferred_batch_size": (4,)},
                          defaults={"pipeline_depth": 2})
    assert db.preferred_batch_size == (4,) and db.pipeline_depth == 2
    with pytest.raises(ValueError, match="unknown DynamicBatchingConfig"):
        config_from_dict(DynamicBatchingConfig, {"pipline_depth": 2})


def test_device_batch_assembly_paths_equal_one_forward():
    """execute_parts_fused (single-row parts, padded by repeating the
    first) and execute_parts_ragged (multi-row parts, zero-padded) give
    the rows one forward of the concatenated batch gives."""
    model = make_add_sub("ab", 4, "FP32", max_batch_size=8,
                         dynamic_batching=True, device="cpu")
    model.load()
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((n, 4)).astype(np.float32)
            for n in (1, 1, 2, 3)]
    parts = [model.device_put_inputs({"INPUT0": r, "INPUT1": 2 * r})
             for r in rows]
    fused = model.execute_parts_fused(parts[:2], 8)
    ragged = model.execute_parts_ragged(parts, 8)
    assert fused["OUTPUT0"].shape == ragged["OUTPUT0"].shape == (8, 4)
    np.testing.assert_array_equal(fused["OUTPUT0"][:2].numpy(),
                                  3 * np.concatenate(rows[:2]))
    np.testing.assert_array_equal(ragged["OUTPUT1"][:7].numpy(),
                                  -np.concatenate(rows))
    np.testing.assert_array_equal(ragged["OUTPUT0"][7:].numpy(), 0)
