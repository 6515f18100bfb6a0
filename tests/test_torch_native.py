"""The port's native C++ stack (client_tpu_torch/native/) on the CPU.

The tree builds through ``client_tpu_torch._native.build`` into its own
hashed directory under ``client_tpu_torch/_build/`` (never the JAX
package's ``native/build``), and its self-checking binaries run against
the port's servers (``device="cpu"``, the models of tests/test_native.py):
``native_smoke``, the HPACK vectors, ``grpc_smoke``, the example matrix
(the cudashm pair included), ``cc_client_test`` (also against the JAX
package's servers), ``client_timeout_test``, ``memory_leak_test``,
``tls_client_test`` and ``perf_analyzer`` in its system and cuda shared-
memory modes. The C++ CUDA-shm producer's token is held against
``cuda_shared_memory.get_raw_handle``'s, and the CPU DIRECT library
against the port's ``make_add_sub``. The card's DIRECT library is held
against the CPU one in tests/test_torch_cuda.py.
"""

import ctypes
import fnmatch
import json
import os
import re
import shutil
import subprocess
import tomllib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
NATIVE = ROOT / "client_tpu_torch" / "native"

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is not installed")


def _native():
    from client_tpu_torch import _native
    return _native


def _source_files():
    return sorted(p for p in NATIVE.rglob("*") if p.is_file())


# ------------------------------------------------- isolation and packaging

def test_native_sources_name_nothing_of_the_jax_package():
    """No file of the port's tree includes a client_tpu/ header or names
    the JAX package's native/ tree."""
    bad = []
    for path in _source_files():
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"\bclient_tpu/|(?<![\w/])native/", line):
                bad.append(f"{path.relative_to(ROOT)}:{n}: {line.strip()}")
    assert not bad, "\n".join(bad)


def test_target_table_stays_in_the_port_tree():
    """Every source of the target table lies in client_tpu_torch/native/
    (or is protoc's output from the port's .proto files), and the include
    and link flags name only the port's tree and the build directory."""
    nat = _native()
    assert nat.NATIVE_DIR == NATIVE
    for proto in nat.PROTOS.values():
        assert proto.is_relative_to(ROOT / "client_tpu_torch"), proto
    for target in nat.TARGETS.values():
        for src in (*target.sources, *nat.PERF_PROTOBUF):
            if src.startswith("gen/"):
                assert src[4:-len(".pb.cc")] in nat.PROTOS, src
            else:
                assert (NATIVE / src).is_file(), src
        if target.ldscript:
            assert (NATIVE / target.ldscript).is_file()
        assert all(f.startswith("-l") for f in target.libs)
    src = Path(nat.__file__).read_text()
    assert "native/build" not in src and '"client_tpu"' not in src


def test_package_data_covers_every_native_source():
    """pyproject.toml's package data lists a glob for every file of the
    native tree, so an installed port can build it at first use."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)
    globs = project["tool"]["setuptools"]["package-data"]["client_tpu_torch"]
    for path in _source_files():
        rel = str(path.relative_to(NATIVE.parent))
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    scripts = project["project"]["scripts"]
    assert scripts["client-tpu-torch-perf-native"] == \
        "client_tpu_torch._native:run_perf_analyzer"


# ------------------------------------------------------------------ build

@pytest.fixture(scope="module")
def native_build():
    nat = _native()
    names = [n for n in nat.default_targets()
             if not nat.TARGETS[n].cuda]
    return nat.build(names)


def _binary(native_build, name):
    if name not in native_build:
        pytest.skip(f"{name} needs protobuf, which is not installed")
    return str(native_build[name])


@needs_gxx
def test_second_build_builds_nothing(native_build):
    nat = _native()
    before = {n: p.stat().st_mtime_ns for n, p in native_build.items()}
    timings: dict = {}
    again = nat.build(list(native_build), timings=timings)
    assert again == native_build and timings == {}
    assert {n: p.stat().st_mtime_ns for n, p in again.items()} == before
    assert next(iter(again.values())).parent == nat.build_dir()
    assert nat.build_dir().parent == ROOT / "client_tpu_torch" / "_build"


@needs_gxx
def test_headers_come_from_the_port_tree_only(native_build):
    """g++'s own dependency list of every library and perf source names
    no header of the JAX package's tree."""
    nat = _native()
    gen = nat.build_dir() / "gen"
    srcs = [str(p) for d in ("src", "perf") for p in (NATIVE / d).glob("*.cc")
            if (gen / "kserve.pb.h").exists()
            or p.name not in ("grpc_client.cc", "tfs_backend.cc")]
    if not (gen / "tfs.pb.h").exists():
        srcs = [s for s in srcs if not s.endswith("tfs_backend.cc")]
    out = subprocess.run(
        ["g++", "-std=c++17", "-MM", "-I", str(NATIVE / "include"),
         "-I", str(gen), "-DCLIENT_TPU_TORCH_PERF_GRPC", *srcs],
        capture_output=True, text=True, check=True, cwd=NATIVE)
    deps = out.stdout.replace("\\\n", " ").split()
    headers = [d for d in deps if d.endswith(".h")]
    assert headers
    for h in headers:
        path = (NATIVE / h).resolve() if not os.path.isabs(h) else Path(h)
        assert not path.is_relative_to(ROOT / "native"), h
        assert path.is_relative_to(NATIVE) or \
            path.is_relative_to(ROOT / "client_tpu_torch" / "_build"), h


def test_build_refuses_what_it_cannot_build(monkeypatch):
    """A target whose tools are missing raises and names them; nothing
    falls back to another tree."""
    nat = _native()
    tools = dict(nat.toolchain())
    tools.update(nvcc=None, protobuf_missing=["protoc", "libprotobuf"])
    monkeypatch.setattr(nat, "toolchain", lambda: dict(tools))
    with pytest.raises(RuntimeError, match="nvcc"):
        nat.build(["libdirect_models_cuda.so"])
    with pytest.raises(RuntimeError, match="protoc, libprotobuf"):
        nat.build(["grpc_smoke"])
    with pytest.raises(KeyError):
        nat.build(["libhttpclient_tpu.so"])
    assert "grpc_smoke" not in nat.default_targets()
    assert "perf_analyzer" in nat.default_targets() or tools["g++"] is None


# ---------------------------------------------------------------- servers

def _port_core():
    from client_tpu_torch.models import (
        make_accumulator,
        make_add_sub,
        make_add_sub_string,
        make_identity,
        make_repeat,
    )
    from client_tpu_torch.server import TorchInferenceServer

    core = TorchInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    core.register_model(make_add_sub_string("add_sub_string", 16))
    core.register_model(make_identity("identity", 16, "INT32", device="cpu"))
    core.register_model(make_identity("identity_slow", 16, "INT32",
                                      delay_s=1.5))
    core.register_model(make_identity("identity_dyn", -1, "INT32",
                                      device="cpu"))
    core.register_model(make_accumulator("accumulator", 1, "INT32",
                                         device="cpu"))
    core.register_model(make_repeat("repeat_int32"))
    return core


def _jax_core():
    from client_tpu.models import (
        make_accumulator,
        make_add_sub,
        make_add_sub_string,
        make_identity,
        make_repeat,
    )
    from client_tpu.server import TpuInferenceServer

    core = TpuInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32"))
    core.register_model(make_add_sub_string("add_sub_string", 16))
    core.register_model(make_identity("identity", 16, "INT32"))
    core.register_model(make_identity("identity_slow", 16, "INT32",
                                      delay_s=1.5))
    core.register_model(make_identity("identity_dyn", -1, "INT32"))
    core.register_model(make_accumulator("accumulator", 1, "INT32"))
    core.register_model(make_repeat("repeat_int32"))
    return core


@pytest.fixture(scope="module")
def port_server():
    """The port's core serving HTTP and gRPC with every model the
    examples and the C++ tests need; ``tokens`` records each CUDA-shm
    registration's decoded token and the attachment it resolved to."""
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.utils.cuda_shared_memory import parse_raw_handle

    core = _port_core()
    tokens: dict = {}
    register = core.cuda_shm.register

    def recording(name, raw_handle, device_id, byte_size):
        register(name, raw_handle, device_id, byte_size)
        tokens[name] = (parse_raw_handle(raw_handle),
                        type(core.cuda_shm.try_attachment(name)).__name__)

    core.cuda_shm.register = recording
    http_srv = HttpInferenceServer(core, port=0).start()
    grpc_srv = GrpcInferenceServer(core, port=0).start()
    yield {"core": core, "http": f"localhost:{http_srv.port}",
           "grpc": f"localhost:{grpc_srv.port}", "tokens": tokens}
    http_srv.stop()
    grpc_srv.stop()
    core.stop()


@pytest.fixture(scope="module")
def jax_server():
    from client_tpu.server.grpc_server import GrpcInferenceServer
    from client_tpu.server.http_server import HttpInferenceServer

    core = _jax_core()
    http_srv = HttpInferenceServer(core, port=0).start()
    grpc_srv = GrpcInferenceServer(core, port=0).start()
    yield {"http": f"localhost:{http_srv.port}",
           "grpc": f"localhost:{grpc_srv.port}"}
    http_srv.stop()
    grpc_srv.stop()
    core.stop()


def _run(path, *args, timeout=120, env=None):
    return subprocess.run([path, *args], capture_output=True, text=True,
                          timeout=timeout, env=env)


def _ok(proc, what=""):
    assert proc.returncode == 0, f"{what}\n{proc.stdout}{proc.stderr}"


# ------------------------------------------------------ self-checking bins

@needs_gxx
def test_native_smoke(native_build, port_server):
    proc = _run(_binary(native_build, "native_smoke"), port_server["http"])
    _ok(proc)
    assert "PASS" in proc.stdout


@needs_gxx
def test_hpack_vectors(native_build):
    proc = _run(_binary(native_build, "hpack_test"))
    _ok(proc)
    assert "ALL HPACK VECTORS PASS" in proc.stdout


@needs_gxx
def test_grpc_smoke(native_build, port_server):
    proc = _run(_binary(native_build, "grpc_smoke"), port_server["grpc"])
    _ok(proc)
    assert "ALL GRPC SMOKE TESTS PASS" in proc.stdout


HTTP_EXAMPLES = ("simple_http_infer_client", "simple_http_health_metadata",
                 "simple_http_string_infer_client", "simple_http_shm_client",
                 "simple_http_async_infer_client",
                 "simple_http_sequence_sync_client",
                 "simple_http_model_control")
GRPC_EXAMPLES = ("simple_grpc_infer_client", "simple_grpc_health_metadata",
                 "simple_grpc_stream_infer_client",
                 "simple_grpc_string_infer_client",
                 "simple_grpc_async_infer_client",
                 "simple_grpc_sequence_sync_client",
                 "simple_grpc_sequence_stream_client",
                 "simple_grpc_custom_repeat", "simple_grpc_keepalive_client",
                 "simple_grpc_shm_client", "simple_grpc_model_control")


@needs_gxx
@pytest.mark.parametrize("example", HTTP_EXAMPLES + GRPC_EXAMPLES)
def test_example(native_build, port_server, example):
    url = port_server["grpc" if "_grpc_" in example else "http"]
    _ok(_run(_binary(native_build, example), "-u", url), example)


@needs_gxx
def test_reuse_infer_objects_example(native_build, port_server):
    _ok(_run(_binary(native_build, "reuse_infer_objects_client"),
             "-u", port_server["http"], "-g", port_server["grpc"]))


@needs_gxx
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_cudashm_example_token_parity(native_build, port_server, proto):
    """The C++ producer's tokens: the keys and schema of
    cuda_shared_memory.get_raw_handle's, the device asked for, resolved by
    the port's server to a CrossProcessAttachment that reads the
    producer's bytes (the example checks the sums)."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    h = cudashm.create_shared_memory_region("parity", 64, device="cpu")
    try:
        want = cudashm.parse_raw_handle(cudashm.get_raw_handle(h))
    finally:
        cudashm.destroy_shared_memory_region(h)
    port_server["tokens"].clear()
    proc = _run(_binary(native_build, f"simple_{proto}_cudashm_client"),
                "-u", port_server[proto], "--device", "cpu")
    _ok(proc)
    assert "PASS" in proc.stdout
    prefix = "g_" if proto == "grpc" else ""
    names = {f"{prefix}cudashm_{s}" for s in ("in0", "in1", "out0", "out1")}
    assert set(port_server["tokens"]) == names
    for name, (doc, kind) in port_server["tokens"].items():
        assert set(doc) == set(want) and doc["schema"] == want["schema"]
        assert doc["name"] == name and doc["device"] == "cpu"
        assert doc["device_id"] == 0 and doc["byte_size"] == 64
        assert re.fullmatch(r"/cudashm_[0-9a-f]{16}", doc["staging_key"])
        assert doc["pid"] != os.getpid()
        assert kind == "CrossProcessAttachment"


@needs_gxx
def test_image_client_example(native_build, tmp_path):
    """image_client: PPM preprocess + classification against a
    resnet-shaped stub on the port's server."""
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.config import ModelConfig, TensorSpec
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.server.model import PyModel

    binary = _binary(native_build, "image_client")
    cfg = ModelConfig(
        name="resnet50", max_batch_size=4,
        inputs=(TensorSpec("image", "FP32", (224, 224, 3)),),
        outputs=(TensorSpec("logits", "FP32", (10,)),))

    def fn(inputs):
        b = inputs["image"].shape[0]
        return {"logits": np.tile(np.arange(10, dtype=np.float32), (b, 1))}

    core = TorchInferenceServer()
    core.register_model(PyModel(cfg, fn))
    srv = HttpInferenceServer(core, port=0).start()
    try:
        ppm = tmp_path / "img.ppm"
        ppm.write_bytes(b"P6\n8 8\n255\n" + bytes(range(192)))
        proc = _run(binary, "-u", f"localhost:{srv.port}", "-b", "2",
                    str(ppm))
        _ok(proc)
        assert "class 9" in proc.stdout
    finally:
        srv.stop()
        core.stop()


@needs_gxx
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_cc_client_test(native_build, port_server, proto):
    proc = _run(_binary(native_build, "cc_client_test"), "-i", proto,
                "-u", port_server[proto])
    _ok(proc)
    assert f"PASS : all {proto} client cases" in proc.stdout


@needs_gxx
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_cc_client_test_against_the_jax_server(native_build, jax_server,
                                               proto):
    """The standard verbs held against the reference's servers."""
    proc = _run(_binary(native_build, "cc_client_test"), "-i", proto,
                "-u", jax_server[proto])
    _ok(proc)
    assert f"PASS : all {proto} client cases" in proc.stdout


@needs_gxx
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_client_timeout_test(native_build, port_server, proto):
    _ok(_run(_binary(native_build, "client_timeout_test"), "-i", proto,
             "-u", port_server[proto]))


@needs_gxx
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_memory_leak_test(native_build, port_server, proto):
    _ok(_run(_binary(native_build, "memory_leak_test"), "-i", proto,
             "-u", port_server[proto], "-r", "300"))


@needs_gxx
def test_tls_client_test(native_build, tmp_path):
    """The native HTTP client over https:// and the native gRPC client
    over TLS against the port's TLS front ends."""
    from client_tpu_torch.models import make_add_sub
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    binary = _binary(native_build, "tls_client_test")
    key, crt = tmp_path / "server.key", tmp_path / "server.crt"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    core = TorchInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    http_srv = HttpInferenceServer(core, port=0, ssl_certfile=str(crt),
                                   ssl_keyfile=str(key)).start()
    grpc_srv = GrpcInferenceServer(core, port=0, ssl_certfile=str(crt),
                                   ssl_keyfile=str(key)).start()
    try:
        proc = _run(binary, "-u", f"localhost:{http_srv.port}",
                    "-g", f"localhost:{grpc_srv.port}", "-c", str(crt))
        _ok(proc)
        assert "PASS" in proc.stdout
    finally:
        http_srv.stop()
        grpc_srv.stop()
        core.stop()


@needs_gxx
def test_cshm_ctypes_shim(native_build):
    """The libcshm ctypes contract (parity: ref shared_memory.cc)."""
    lib = ctypes.CDLL(_binary(native_build, "libcshm_tpu_torch.so"))
    lib.SharedMemoryRegionCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p)]
    handle = ctypes.c_void_p()
    key = f"/cshm_torch_{os.getpid()}".encode()
    assert lib.SharedMemoryRegionCreate(b"t", key, 64,
                                        ctypes.byref(handle)) == 0
    try:
        data = np.arange(16, dtype=np.int32)
        assert lib.SharedMemoryRegionSet(
            handle, ctypes.c_size_t(0), ctypes.c_size_t(64),
            data.ctypes.data_as(ctypes.c_void_p)) == 0
        with open(f"/dev/shm{key.decode()}", "rb") as f:
            np.testing.assert_array_equal(
                np.frombuffer(f.read(64), np.int32), data)
    finally:
        assert lib.SharedMemoryRegionDestroy(handle) == 0


# --------------------------------------------------------------- perf

def _fail_count(core, model="add_sub"):
    stats = core.statistics(model)["model_stats"][0]
    return stats["inference_stats"]["fail"]["count"], \
        stats["inference_count"]


@needs_gxx
@pytest.mark.parametrize("mode", ["system", "cuda"])
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_perf_analyzer_shared_memory(native_build, port_server, proto,
                                     mode):
    """``--shared-memory system|cuda`` against the port's server: the
    report parses, no inference fails, every request reached the model,
    and the cuda regions resolve to CrossProcessAttachments."""
    perf = _binary(native_build, "perf_analyzer")
    if proto == "grpc":
        _binary(native_build, "grpc_smoke")   # skip without protobuf
    core = port_server["core"]
    fail0, count0 = _fail_count(core)
    port_server["tokens"].clear()
    proc = _run(perf, "-m", "add_sub", "-i", proto, "-u", port_server[proto],
                "--shared-memory", mode,
                *(["--device", "cpu"] if mode == "cuda" else []),
                "--concurrency-range", "2", "-p", "500", "-s", "95",
                "-r", "3")
    _ok(proc)
    m = re.search(r"Throughput: ([\d.]+) infer/sec", proc.stdout)
    assert m and float(m.group(1)) > 0, proc.stdout
    fail1, count1 = _fail_count(core)
    assert fail1 == fail0 and count1 > count0
    if mode == "cuda":
        assert set(port_server["tokens"]) == {
            "perf_in_INPUT0", "perf_in_INPUT1", "perf_out_OUTPUT0",
            "perf_out_OUTPUT1"}
        assert {k for _, k in port_server["tokens"].values()} == \
            {"CrossProcessAttachment"}
        assert {d["device"] for d, _ in port_server["tokens"].values()} == \
            {"cpu"}


@needs_gxx
def test_perf_analyzer_refuses_tpu_shared_memory(native_build):
    proc = _run(_binary(native_build, "perf_analyzer"), "-m", "add_sub",
                "--shared-memory", "tpu")
    assert proc.returncode == 2
    assert "none|system|cuda" in proc.stderr


@needs_gxx
def test_perf_analyzer_cuda_regions_name_the_card_by_default(native_build,
                                                             port_server):
    """Without --device the tokens name cuda:0: a CPU-only server cannot
    copy there, and the run fails (the card's path is chip_smoke.py's)."""
    port_server["tokens"].clear()
    proc = _run(_binary(native_build, "perf_analyzer"), "-m", "add_sub",
                "-u", port_server["http"], "--shared-memory", "cuda",
                "--concurrency-range", "1", "-p", "300", "-r", "2")
    docs = [d for d, _ in port_server["tokens"].values()]
    assert docs and {d["device"] for d in docs} == {"cuda:0"}
    import torch
    if not torch.cuda.is_available():
        assert proc.returncode != 0


@needs_gxx
@pytest.mark.parametrize("model,dtype,size", [
    ("add_sub", "INT32", 16), ("add_sub_fp32", "FP32", 16),
    ("identity", "INT32", 16), ("add_sub", "INT32", 1000)])
def test_direct_cpu_library_matches_make_add_sub(native_build, model, dtype,
                                                 size):
    """libdirect_models_cpu.so's outputs equal the JAX package's
    make_add_sub's (make_identity's) on the same seeded inputs, and the
    port's too."""
    from client_tpu import models as jax_models

    from client_tpu_torch import models as port_models
    from client_tpu_torch._native.direct import DirectLibrary

    lib = DirectLibrary(_binary(native_build, "libdirect_models_cpu.so"))
    assert lib.version() == 1 and not lib.has_launch_counts
    rng = np.random.default_rng(7)
    np_dtype = np.int32 if dtype == "INT32" else np.float32
    inputs = {f"INPUT{i}": (rng.integers(-2**20, 2**20, size)
                            if dtype == "INT32"
                            else rng.standard_normal(size)).astype(np_dtype)
              for i in range(1 if model == "identity" else 2)}
    name = model if size == 16 else f"{model}:{size}"
    with lib.model(name) as m:
        got = m.infer(inputs)
        meta = m.metadata()["metadata"]
        stats = m.stats()
    assert [o["shape"] for o in meta["outputs"]] == [[size]] * len(got)
    assert stats["inference_count"] == 1
    reference = (jax_models.make_identity("identity", size, dtype)
                 if model == "identity"
                 else jax_models.make_add_sub(model, size, dtype))
    port = (port_models.make_identity("identity", size, dtype, device="cpu")
            if model == "identity"
            else port_models.make_add_sub(model, size, dtype, device="cpu"))
    for served in (reference, port):
        served.load()
        want = served.execute(inputs)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
            assert got[k].dtype == np.asarray(want[k]).dtype


@needs_gxx
def test_perf_analyzer_direct_cpu_library(native_build):
    """-i direct profiles the CPU library when it is named with -u, with
    no server process."""
    lib = _binary(native_build, "libdirect_models_cpu.so")
    proc = _run(_binary(native_build, "perf_analyzer"), "-m", "add_sub",
                "-i", "direct", "-u", lib, "--concurrency-range", "2",
                "-p", "300", "-s", "90", "-r", "3")
    _ok(proc)
    assert "Throughput" in proc.stdout


@needs_gxx
def test_perf_analyzer_direct_default_is_the_card(native_build, tmp_path):
    """-i direct with no library loads libdirect_models_cuda.so; here
    (no nvcc, no card) it fails and says what is missing."""
    env = {k: v for k, v in os.environ.items()
           if k != "CLIENT_TPU_TORCH_DIRECT_LIBRARY"}
    proc = _run(_binary(native_build, "perf_analyzer"), "-m", "add_sub",
                "-i", "direct", "--concurrency-range", "1", "-p", "300",
                env=env)
    if _native().toolchain()["nvcc"] is None:
        assert proc.returncode != 0
        assert "nvcc" in proc.stdout + proc.stderr
        assert "libdirect_models_cuda.so" in proc.stdout + proc.stderr
    # the CPU library runs when the environment names it
    env["CLIENT_TPU_TORCH_DIRECT_LIBRARY"] = _binary(
        native_build, "libdirect_models_cpu.so")
    proc = _run(_binary(native_build, "perf_analyzer"), "-m", "identity",
                "-i", "direct", "--concurrency-range", "1", "-p", "300",
                "-s", "90", "-r", "2", env=env)
    _ok(proc)
    assert "Throughput" in proc.stdout


def test_run_perf_analyzer_reports_a_failed_build(monkeypatch, capsys):
    nat = _native()

    def refuse(names, timings=None):
        raise RuntimeError("cannot build perf_analyzer: g++ not found")

    monkeypatch.setattr(nat, "build", refuse)
    assert nat.run_perf_analyzer(["-m", "add_sub"]) == 1
    assert "g++ not found" in capsys.readouterr().err


def test_toolchain_reports_every_tool():
    tools = _native().toolchain()
    for key in ("g++", "nvcc", "protoc", "protobuf_missing", "cmake"):
        assert key in tools
    assert json.dumps(tools)
