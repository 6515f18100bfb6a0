"""The port's shared-memory data plane on the CPU, held against the JAX
package: region contents (the port's cuda_shared_memory on device="cpu"
against tpu_shared_memory, system regions across the two packages), the
small encoder served over each package's device shm through its own
InProcessBackend, the port's shm routes driven by the JAX package's HTTP
client, and the rule that nothing falls back quietly to a host read."""

import base64
import json
import os
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

from client_tpu.client import http as httpclient
from client_tpu.models import transformer as jt
from client_tpu.perf import client_backend as jcb
from client_tpu.server import TpuInferenceServer
from client_tpu.server import config as jconfig
from client_tpu.server.model import JaxModel
from client_tpu.utils import InferenceServerException
from client_tpu.utils import shared_memory as jsys
from client_tpu.utils import tpu_shared_memory as tpushm
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf import client_backend as tcb
from client_tpu_torch.perf.bench_harness import make_encoder_model
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.server.types import (
    InferRequest,
    InferTensor,
    RequestedOutput,
    ServerError,
)
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as tsys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, MAX_BATCH, D = 16, 8, 32
# f32 on the CPU, the same weights in both packages
ATOL = 1e-5
KW = dict(vocab_size=128, d_model=D, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=SEQ, causal=False)


# ------------------------------------------------------- region contents

def _pair(name, size):
    """The same region in both packages: (JAX tpu handle, port cpu handle)."""
    return (tpushm.create_shared_memory_region(f"j{name}", size),
            cudashm.create_shared_memory_region(f"t{name}", size,
                                                device="cpu"))


def _read(mod, h, offset, dtype, shape):
    """What an in-process server reads: the attachment's device tensor."""
    dtype = np.dtype(dtype)
    att = mod.attach_from_raw_handle(mod.get_raw_handle(h))
    arr = att.read_array(offset, int(np.prod(shape)) * dtype.itemsize,
                         np_to_wire_dtype(dtype), shape)
    return arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def _floats_at_offsets(mod, h):
    mod.set_shared_memory_region(h, [np.arange(16, dtype=np.float32)])
    mod.set_shared_memory_region(h, [np.full(8, 7, np.int32)], offset=64)
    return [mod.get_contents_as_numpy(h, np.float32, (16,)),
            mod.get_contents_as_numpy(h, np.int32, (8,), offset=64)]


def _several_tensors_in_one_set(mod, h):
    mod.set_shared_memory_region(h, [
        np.arange(-4, 4, dtype=np.int8),
        np.linspace(-1, 1, 6, dtype=np.float16),
        np.array([True, False, True])])
    return [mod.get_contents_as_numpy(h, np.int8, (8,)),
            mod.get_contents_as_numpy(h, np.float16, (6,), offset=8),
            mod.get_contents_as_numpy(h, np.bool_, (3,), offset=20),
            _read(mod, h, 8, np.float16, (6,))]


def _bytes(mod, h):
    mod.set_shared_memory_region(h, [np.array(
        [b"a", b"", "été".encode(), b"xyz"], dtype=np.object_)])
    return [mod.get_contents_as_numpy(h, np.object_, (4,))]


def _overflow(mod, h):
    mod.set_shared_memory_region(h, [np.zeros(65, np.float32)])


def _not_a_list(mod, h):
    mod.set_shared_memory_region(h, np.zeros(4, np.float32))


def _seqno_invalidation(mod, h):
    out = []
    for value in (1, 2):
        mod.set_shared_memory_region(h, [np.full(8, value, np.float32)])
        out += [_read(mod, h, 0, np.float32, (8,)), h.seqno()]
    return out


def _read_at_a_sub_offset(mod, h):
    mod.set_shared_memory_region(h, [np.arange(16, dtype=np.int32)])
    return [_read(mod, h, 16, np.int32, (4,))]


_CASES = {f.__name__[1:]: f for f in (
    _floats_at_offsets, _several_tensors_in_one_set, _bytes, _overflow,
    _not_a_list, _seqno_invalidation, _read_at_a_sub_offset)}
_RAISES = ("overflow", "not_a_list")


@pytest.mark.parametrize("case", sorted(_CASES))
def test_region_contents_match_the_jax_package(case):
    """The same set/get calls give the same bytes, and the same errors, in
    the port's cuda_shared_memory (on the CPU) and the JAX package's
    tpu_shared_memory."""
    hj, ht = _pair(case, 256)
    try:
        if case in _RAISES:
            with pytest.raises(tpushm.TpuSharedMemoryException):
                _CASES[case](tpushm, hj)
            with pytest.raises(cudashm.CudaSharedMemoryException):
                _CASES[case](cudashm, ht)
            return
        want = _CASES[case](tpushm, hj)
        got = _CASES[case](cudashm, ht)
    finally:
        tpushm.destroy_shared_memory_region(hj)
        cudashm.destroy_shared_memory_region(ht)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        if isinstance(a, np.ndarray):
            assert (a.dtype, a.shape) == (b.dtype, b.shape)
            assert a.tolist() == b.tolist()
        else:
            assert a == b


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_system_regions_interoperate(creator):
    """A POSIX region either package creates, the other attaches."""
    make, attach = (jsys, tsys) if creator == "jax" else (tsys, jsys)
    key = f"/t_interop_{uuid.uuid4().hex[:8]}"
    h = make.create_shared_memory_region("r", key, 64)
    try:
        data = np.arange(16, dtype=np.float32)
        make.set_shared_memory_region(h, [data])
        other = attach.attach_shared_memory_region("r", key, 64)
        try:
            np.testing.assert_array_equal(
                attach.get_contents_as_numpy(other, np.float32, (16,)), data)
            attach.set_shared_memory_region(other, [2 * data])
            np.testing.assert_array_equal(
                make.get_contents_as_numpy(h, np.float32, (16,)), 2 * data)
        finally:
            attach.destroy_shared_memory_region(other)
    finally:
        make.destroy_shared_memory_region(h)


def test_attach_producer_in_a_subprocess():
    """A second process re-opens a region with attach_producer; its write
    bumps the seqno this process's consumer sees (as the JAX package's
    tests/test_shared_memory.py::test_attach_producer_cross_process)."""
    h = cudashm.create_shared_memory_region("xproc", 64, device="cpu")
    try:
        cudashm.set_shared_memory_region(h, [np.zeros(16, np.float32)])
        att = cudashm.CrossProcessAttachment(
            cudashm.parse_raw_handle(cudashm.get_raw_handle(h)))
        zeros = att.read_array(0, 64, "FP32", (16,))
        seq_before = h.seqno()
        raw = cudashm.get_raw_handle(h).decode()
        code = (
            "import sys, numpy as np\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from client_tpu_torch.utils import cuda_shared_memory as c\n"
            f"p = c.attach_producer({raw!r}.encode())\n"
            "c.set_shared_memory_region(p, [np.arange(16, "
            "dtype=np.float32)])\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       capture_output=True, timeout=120)
        assert h.seqno() > seq_before
        want = np.arange(16, dtype=np.float32)
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(h, np.float32, (16,)), want)
        # the consumer's device copy moved with the seqno
        moved = att.read_array(0, 64, "FP32", (16,))
        np.testing.assert_array_equal(moved.numpy(), want)
        np.testing.assert_array_equal(zeros.numpy(), 0)
        att.detach()
    finally:
        cudashm.destroy_shared_memory_region(h)


def test_in_process_read_is_zero_copy_and_outputs_fill_staging_lazily():
    h = cudashm.create_shared_memory_region("zc", 128, device="cpu")
    try:
        cudashm.set_shared_memory_region(h, [np.arange(8, dtype=np.int64)])
        att = cudashm.attach_from_raw_handle(cudashm.get_raw_handle(h))
        assert isinstance(att, cudashm.InProcessAttachment)
        got = att.read_array(0, 64, "INT64", (8,))
        assert got.data_ptr() == h.device_tensors[0][0].data_ptr()
        # an in-process server's output stays a tensor until a host read
        out = torch.arange(4, dtype=torch.float32) * 3
        att.write_array(64, out)
        assert h.device_tensors[64][0] is out and 64 in h.pending_device
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(h, np.float32, (4,), offset=64),
            [0, 3, 6, 9])
        assert not h.pending_device
    finally:
        cudashm.destroy_shared_memory_region(h)


@pytest.mark.parametrize("sync_staging", [True, False])
def test_torch_fast_path_matches_the_jax_fast_path(sync_staging):
    """set_shared_memory_region_from_torch registers a tensor already on
    the region's device, as set_shared_memory_region_from_jax does."""
    data = np.arange(8, dtype=np.float32)
    hj, ht = _pair("fast", 128)
    try:
        tpushm.set_shared_memory_region_from_jax(
            hj, [jnp.asarray(data)], sync_staging=sync_staging)
        src = torch.from_numpy(data.copy())
        cudashm.set_shared_memory_region_from_torch(
            ht, [src], sync_staging=sync_staging)
        att = cudashm.attach_from_raw_handle(cudashm.get_raw_handle(ht))
        assert att.read_array(0, 32, "FP32", (8,)) is src
        assert (0 in ht.pending_device) == (0 in hj.pending_device) \
            == (not sync_staging)
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(ht, np.float32, (8,)),
            tpushm.get_contents_as_numpy(hj, np.float32, (8,)))
        with pytest.raises(cudashm.CudaSharedMemoryException,
                           match="cannot be registered"):
            cudashm.set_shared_memory_region_from_torch(
                ht, [torch.zeros(2, device="meta")])
    finally:
        tpushm.destroy_shared_memory_region(hj)
        cudashm.destroy_shared_memory_region(ht)


def test_raw_handle_is_the_ports_own_schema():
    h = cudashm.create_shared_memory_region("schema", 32, device="cpu")
    try:
        doc = cudashm.parse_raw_handle(cudashm.get_raw_handle(h))
        assert doc["schema"] == "cuda_shm_handle_v1"
        assert doc["device"] == "cpu" and doc["byte_size"] == 32
        with pytest.raises(cudashm.CudaSharedMemoryException,
                           match="malformed"):
            cudashm.parse_raw_handle(tpushm.get_raw_handle(
                tpushm.create_shared_memory_region("j_schema", 8)))
        assert "schema" in cudashm.allocated_shared_memory_regions()
    finally:
        cudashm.destroy_shared_memory_region(h)
    assert "schema" not in cudashm.allocated_shared_memory_regions()


# ------------------------------------------------------- served encoder

def _jax_encoder(cfg, params):
    """client_tpu/perf/bench_harness.py's encoder as a JaxModel, small."""

    def apply_fn(params, inputs):
        tokens = inputs["input_ids"]
        x = params["embed"][tokens] \
            + params["pos_embed"][:tokens.shape[1]][None]
        x = x.astype(cfg.dtype)
        x, _ = lax.scan(lambda x, lp: jt._layer(cfg, None, x, lp), x,
                        params["layers"])
        x = jt._rmsnorm(x, params["final_norm"])
        return {"embedding": jnp.mean(x, axis=1).astype(jnp.float32)}

    mc = jconfig.ModelConfig(
        name="enc", max_batch_size=MAX_BATCH,
        inputs=(jconfig.TensorSpec("input_ids", "INT32", (SEQ,)),),
        outputs=(jconfig.TensorSpec("embedding", "FP32", (D,)),),
        dynamic_batching=jconfig.DynamicBatchingConfig(
            preferred_batch_size=(MAX_BATCH,),
            max_queue_delay_microseconds=50_000, pipeline_depth=8),
        batch_buckets_override=(MAX_BATCH,))
    return JaxModel(mc, apply_fn, params=params)


@pytest.fixture(scope="module")
def servers():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    jcore = TpuInferenceServer()
    jcore.register_model(_jax_encoder(jcfg, jparams), warmup=True)
    tmodel = make_encoder_model(tcfg, tparams, SEQ, MAX_BATCH, name="enc",
                                max_queue_delay_us=50_000, device="cpu")
    tcore = TorchInferenceServer()
    tcore.register_model(tmodel, warmup=True)
    tcore.register_model(make_add_sub("add_sub", 16, "FP32", device="cpu"))
    yield {"jax": jcore, "port": tcore, "model": tmodel}
    jcore.stop()
    tcore.stop()


def _serve_over_device_shm(pkg, core, toks):
    """Send every request at once, each with its own input and output
    region, through the package's InProcessBackend; return the output
    regions' embeddings."""
    if pkg == "jax":
        mod, cb_mod = tpushm, jcb

        def make(name, size):
            return mod.create_shared_memory_region(name, size)

        def register(be, h):
            be.register_tpu_shared_memory(h.name, mod.get_raw_handle(h), 0,
                                          h.byte_size)
    else:
        mod, cb_mod = cudashm, tcb

        def make(name, size):
            return mod.create_shared_memory_region(name, size, device="cpu")

        def register(be, h):
            be.register_cuda_shared_memory(h.name, mod.get_raw_handle(h), 0,
                                           h.byte_size)
    backend = cb_mod.InProcessBackend(server=core)
    handles, errors, done, lock = [], [], threading.Event(), threading.Lock()
    finished = [0]
    try:
        reqs = []
        for i, tok in enumerate(toks):
            h_in = make(f"{pkg}_in{i}", tok.nbytes)
            h_out = make(f"{pkg}_out{i}", 4 * D)
            handles += [h_in, h_out]
            mod.set_shared_memory_region(h_in, [tok])
            register(backend, h_in)
            register(backend, h_out)
            x = cb_mod.PerfInput("input_ids", [1, SEQ], "INT32")
            x.set_shared_memory(h_in.name, tok.nbytes)
            o = cb_mod.PerfRequestedOutput("embedding")
            o.set_shared_memory(h_out.name, 4 * D)
            reqs.append(([x], [o]))

        def cb(result, error):
            with lock:
                if error is not None:
                    errors.append(error)
                finished[0] += 1
                if finished[0] == len(toks):
                    done.set()

        for ins, outs in reqs:
            backend.async_infer(cb, "enc", ins, outs)
        assert done.wait(60) and not errors, errors
        return np.concatenate([
            mod.get_contents_as_numpy(h, np.float32, (1, D))
            for h in handles[1::2]])
    finally:
        backend.unregister_all_shared_memory()
        for h in handles:
            mod.destroy_shared_memory_region(h)


def test_served_embeddings_match_the_jax_servers_over_device_shm(servers):
    toks = [np.random.default_rng(50 + i).integers(
        0, KW["vocab_size"], size=(1, SEQ)).astype(np.int32)
        for i in range(MAX_BATCH)]
    model, tcore = servers["model"], servers["port"]
    before = tcore.statistics("enc")["model_stats"][0]["execution_count"]
    calls = model.fused_split_calls
    want = _serve_over_device_shm("jax", servers["jax"], toks)
    got = _serve_over_device_shm("port", tcore, toks)
    assert got.shape == want.shape == (MAX_BATCH, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # every batch took the pre-split path
    execs = tcore.statistics("enc")["model_stats"][0]["execution_count"] \
        - before
    assert execs >= 1 and model.fused_split_calls - calls == execs


def test_split_path_needs_every_output_in_a_region(servers):
    """A request whose output rides the response takes the slab path; its
    embedding is the same."""
    tcore, model = servers["port"], servers["model"]
    tok = np.random.default_rng(9).integers(
        0, KW["vocab_size"], size=(1, SEQ)).astype(np.int32)
    h = cudashm.create_shared_memory_region("slab_in", tok.nbytes,
                                            device="cpu")
    try:
        cudashm.set_shared_memory_region(h, [tok])
        tcore.cuda_shm.register("slab_in", cudashm.get_raw_handle(h), 0,
                                tok.nbytes)
        calls = model.fused_split_calls
        t = InferTensor("input_ids", "INT32", (1, SEQ))
        t.shm_region, t.shm_byte_size = "slab_in", tok.nbytes
        resp = tcore.infer(InferRequest(model_name="enc", inputs=[t]))
        assert model.fused_split_calls == calls
        direct = tcore.infer(InferRequest(model_name="enc", inputs=[
            InferTensor("input_ids", "INT32", (1, SEQ), data=tok)]))
        np.testing.assert_allclose(resp.output("embedding").data,
                                   direct.output("embedding").data,
                                   rtol=0, atol=ATOL)
    finally:
        tcore.cuda_shm.unregister("slab_in")
        cudashm.destroy_shared_memory_region(h)


# ------------------------------------------------------------- routes

@pytest.fixture(scope="module")
def http(servers):
    srv = HttpInferenceServer(servers["port"], port=0).start()
    client = httpclient.InferenceServerClient(srv.url)
    yield client
    client.close()
    srv.stop()


def _add_sub_io(region_in, region_out, nbytes):
    i0 = httpclient.InferInput("INPUT0", [16], "FP32")
    i0.set_shared_memory(region_in, nbytes, 0)
    i1 = httpclient.InferInput("INPUT1", [16], "FP32")
    i1.set_shared_memory(region_in, nbytes, nbytes)
    o0 = httpclient.InferRequestedOutput("OUTPUT0")
    o0.set_shared_memory(region_out, nbytes, 0)
    return [i0, i1], [o0]


def test_system_shm_region_made_by_the_jax_package_is_served(http):
    a = np.random.default_rng(1).random(16).astype(np.float32)
    b = np.random.default_rng(2).random(16).astype(np.float32)
    key_in, key_out = (f"/t_sys_{uuid.uuid4().hex[:8]}" for _ in range(2))
    h_in = jsys.create_shared_memory_region("sys_in", key_in, 2 * a.nbytes)
    h_out = jsys.create_shared_memory_region("sys_out", key_out, a.nbytes)
    try:
        jsys.set_shared_memory_region(h_in, [a, b])
        http.register_system_shared_memory("sys_in", key_in, 2 * a.nbytes)
        http.register_system_shared_memory("sys_out", key_out, a.nbytes)
        status = http.get_system_shared_memory_status()
        assert {s["name"] for s in status} == {"sys_in", "sys_out"}
        assert http.get_system_shared_memory_status("sys_in")[0]["key"] \
            == key_in
        ins, outs = _add_sub_io("sys_in", "sys_out", a.nbytes)
        result = http.infer("add_sub", ins, outputs=outs)
        assert result.get_output("OUTPUT0")["parameters"][
            "shared_memory_region"] == "sys_out"
        np.testing.assert_allclose(
            jsys.get_contents_as_numpy(h_out, np.float32, (16,)), a + b,
            rtol=1e-6)
        with pytest.raises(InferenceServerException, match="already"):
            http.register_system_shared_memory("sys_in", key_in, 8)
        http.unregister_system_shared_memory("sys_in")
        assert [s["name"] for s in http.get_system_shared_memory_status()] \
            == ["sys_out"]
        http.unregister_system_shared_memory()
        assert http.get_system_shared_memory_status() == []
    finally:
        jsys.destroy_shared_memory_region(h_in)
        jsys.destroy_shared_memory_region(h_out)


def test_cuda_shm_routes_register_infer_and_unregister(http):
    a = np.random.default_rng(3).random(16).astype(np.float32)
    b = np.random.default_rng(4).random(16).astype(np.float32)
    h_in = cudashm.create_shared_memory_region("cu_in", 2 * a.nbytes,
                                               device="cpu")
    h_out = cudashm.create_shared_memory_region("cu_out", a.nbytes,
                                                device="cpu")
    try:
        cudashm.set_shared_memory_region(h_in, [a, b])
        http.register_cuda_shared_memory(
            "cu_in", cudashm.get_raw_handle(h_in), 0, 2 * a.nbytes)
        http.register_cuda_shared_memory(
            "cu_out", cudashm.get_raw_handle(h_out), 0, a.nbytes)
        status = http.get_cuda_shared_memory_status()
        assert sorted(status, key=lambda s: s["name"]) == [
            {"name": "cu_in", "device_id": 0, "byte_size": 2 * a.nbytes},
            {"name": "cu_out", "device_id": 0, "byte_size": a.nbytes}]
        ins, outs = _add_sub_io("cu_in", "cu_out", a.nbytes)
        for _ in range(3):   # set once, infer many
            result = http.infer("add_sub", ins, outputs=outs)
        out = result.get_output("OUTPUT0")
        assert out["parameters"] == {"shared_memory_region": "cu_out",
                                     "shared_memory_offset": 0,
                                     "shared_memory_byte_size": a.nbytes}
        np.testing.assert_allclose(
            cudashm.get_contents_as_numpy(h_out, np.float32, (16,)), a + b,
            rtol=1e-6)
        http.unregister_cuda_shared_memory("cu_in")
        assert [s["name"] for s in http.get_cuda_shared_memory_status()] \
            == ["cu_out"]
        http.unregister_cuda_shared_memory()
        assert http.get_cuda_shared_memory_status() == []
    finally:
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


@pytest.mark.parametrize("case,text", [
    ("tpu_status", "/v2/cudasharedmemory"),
    ("tpu_register", "/v2/cudasharedmemory"),
    ("malformed_handle", "malformed CUDA shm raw handle"),
    ("jax_handle", "malformed CUDA shm raw handle"),
    ("unregistered_output", "is not registered"),
    ("output_too_small", "needs 64 bytes"),
])
def test_shm_route_errors_are_400s(http, servers, case, text):
    with pytest.raises(InferenceServerException) as ei:
        if case == "tpu_status":
            http.get_tpu_shared_memory_status()
        elif case == "tpu_register":
            http.register_tpu_shared_memory("t", b"abc", 0, 8)
        elif case == "malformed_handle":
            http.register_cuda_shared_memory("bad", b"not a handle", 0, 8)
        elif case == "jax_handle":
            h = tpushm.create_shared_memory_region("jh", 8)
            try:
                http.register_cuda_shared_memory(
                    "jh", tpushm.get_raw_handle(h), 0, 8)
            finally:
                tpushm.destroy_shared_memory_region(h)
        else:
            h = cudashm.create_shared_memory_region("small_out", 32,
                                                    device="cpu")
            try:
                http.register_cuda_shared_memory(
                    "small_out", cudashm.get_raw_handle(h), 0, 32)
                x = np.ones(16, np.float32)
                ins = [httpclient.InferInput(n, [16], "FP32")
                       .set_data_from_numpy(x) for n in ("INPUT0", "INPUT1")]
                o = httpclient.InferRequestedOutput("OUTPUT0")
                if case == "unregistered_output":
                    o.set_shared_memory("nowhere", 64)
                else:
                    o.set_shared_memory("small_out", 32)
                http.infer("add_sub", ins, outputs=[o])
            finally:
                http.unregister_cuda_shared_memory("small_out")
                cudashm.destroy_shared_memory_region(h)
    assert ei.value.status() == "400"
    assert text in str(ei.value)


def test_extensions_name_both_shm_planes(http):
    ext = http.get_server_metadata()["extensions"]
    assert "system_shared_memory" in ext and "cuda_shared_memory" in ext
    assert "tpu_shared_memory" not in ext


def test_server_process_reads_and_writes_cuda_regions(unused_tcp_port):
    """A server in another process attaches the regions through their
    staging buffers (the cross-process attachment): it reads the inputs
    this process set and writes the output this process reads back."""
    import time
    import urllib.error
    import urllib.request

    port = unused_tcp_port
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--device", "cpu",
         "--demo-models", "--http-port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    a = np.random.default_rng(5).random(16).astype(np.float32)
    b = np.random.default_rng(6).random(16).astype(np.float32)
    h_in = cudashm.create_shared_memory_region("xp_in", 2 * a.nbytes,
                                               device="cpu")
    h_out = cudashm.create_shared_memory_region("xp_out", a.nbytes,
                                                device="cpu")
    client = None
    try:
        deadline = time.time() + 60
        while True:
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v2/health/ready", timeout=2)
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.2)
        client = httpclient.InferenceServerClient(f"127.0.0.1:{port}")
        cudashm.set_shared_memory_region(h_in, [a, b])
        client.register_cuda_shared_memory(
            "xp_in", cudashm.get_raw_handle(h_in), 0, 2 * a.nbytes)
        client.register_cuda_shared_memory(
            "xp_out", cudashm.get_raw_handle(h_out), 0, a.nbytes)
        ins, outs = _add_sub_io("xp_in", "xp_out", a.nbytes)
        client.infer("add_sub_fp32", ins, outputs=outs)
        np.testing.assert_allclose(
            cudashm.get_contents_as_numpy(h_out, np.float32, (16,)), a + b,
            rtol=1e-6)
        # a new set moves the seqno: the server's device copy follows
        cudashm.set_shared_memory_region(h_in, [b, b])
        client.infer("add_sub_fp32", ins, outputs=outs)
        np.testing.assert_allclose(
            cudashm.get_contents_as_numpy(h_out, np.float32, (16,)), 2 * b,
            rtol=1e-6)
        client.unregister_cuda_shared_memory()
    finally:
        if client is not None:
            client.close()
        proc.terminate()
        proc.wait(timeout=30)
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


# ---------------------------------------------------------- no fallback

def _shm_request(region, nbytes, shape=(16,)):
    ins = []
    for name, off in (("INPUT0", 0), ("INPUT1", nbytes)):
        t = InferTensor(name, "FP32", shape)
        t.shm_region, t.shm_byte_size, t.shm_offset = region, nbytes, off
        ins.append(t)
    return InferRequest(model_name="add_sub", inputs=ins)


def test_a_failed_device_copy_raises_and_never_reads_the_host(servers):
    """A region whose tensors live on a device this process cannot copy to
    is never read as host bytes: the request fails."""
    core = servers["port"]
    x = np.ones(16, np.float32)
    h = cudashm.create_shared_memory_region("far", 2 * x.nbytes,
                                            device="cpu")
    try:
        cudashm.set_shared_memory_region(h, [x, x])
        doc = cudashm.parse_raw_handle(cudashm.get_raw_handle(h))
        # another producer process, on a device that does not exist here
        doc.update(pid=-1, device="cuda:99")
        raw = base64.b64encode(json.dumps(doc).encode())
        core.cuda_shm.register("far", raw, 99, 2 * x.nbytes)
        try:
            with pytest.raises(ServerError) as ei:
                core.infer(_shm_request("far", x.nbytes))
            assert ei.value.status == 500
            assert "device copy" in str(ei.value)
        finally:
            core.cuda_shm.unregister("far")
    finally:
        cudashm.destroy_shared_memory_region(h)


def test_a_failed_producer_copy_raises(monkeypatch):
    h = cudashm.create_shared_memory_region("prod", 64, device="cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("copy engine fault")

    try:
        monkeypatch.setattr(torch.Tensor, "to", broken)
        with pytest.raises(cudashm.CudaSharedMemoryException,
                           match="copy engine fault"):
            cudashm.set_shared_memory_region(h, [np.ones(4, np.float32)])
    finally:
        monkeypatch.undo()
        cudashm.destroy_shared_memory_region(h)


def test_an_input_region_on_another_device_is_a_400(servers):
    """An in-process region whose tensor lives on another device than the
    model's is refused, never moved quietly."""
    core = servers["port"]
    x = np.ones(16, np.float32)
    h = cudashm.create_shared_memory_region("other_in", 2 * x.nbytes,
                                            device="cpu")
    try:
        cudashm.set_shared_memory_region(h, [x, x])
        h.device_tensors[0] = (torch.empty(16, device="meta"), h.seqno(),
                               None)
        core.cuda_shm.register("other_in", cudashm.get_raw_handle(h), 0,
                               2 * x.nbytes)
        try:
            with pytest.raises(ServerError) as ei:
                core.infer(_shm_request("other_in", x.nbytes))
            assert ei.value.status == 400
            assert "tensor on meta" in str(ei.value)
        finally:
            core.cuda_shm.unregister("other_in")
    finally:
        cudashm.destroy_shared_memory_region(h)


def test_an_output_region_on_another_device_is_a_400(servers):
    """The pre-split path's device rows are never moved into a region on
    another device: the response is a 400."""
    core = servers["port"]
    h = cudashm.create_shared_memory_region("other_out", 4 * D,
                                            device="cpu")
    try:
        h.device = torch.device("meta")
        core.cuda_shm.register("other_out", cudashm.get_raw_handle(h), 0,
                               4 * D)
        try:
            tok = torch.zeros((1, SEQ), dtype=torch.int32)
            req = InferRequest(
                model_name="enc",
                inputs=[InferTensor("input_ids", "INT32", (1, SEQ),
                                    device_array=tok)],
                outputs=[RequestedOutput("embedding",
                                         shm_region="other_out")])
            with pytest.raises(ServerError) as ei:
                core.infer(req)
            assert ei.value.status == 400
            assert "cannot be stored" in str(ei.value)
        finally:
            core.cuda_shm.unregister("other_out")
    finally:
        cudashm.destroy_shared_memory_region(h)
