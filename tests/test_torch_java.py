"""The port's Java client (``client_tpu_torch/java/``, package
``torch.client``) against the port's HTTP server.

Without a JDK (this image has none) the tests read the Java sources:
every file of ``java/`` has its counterpart in the port's tree, no TPU
shared-memory verb is left, and the paths and JSON bodies of
``registerCudaSharedMemory`` / ``unregisterCudaSharedMemory``, read out
of the source, are answered 200 by the port's server for a CUDA shm
region made on the CPU, while the reference client's TPU paths get the
port's 400. With a JDK the tree compiles (beside the reference's, on one
classpath) and both examples run against the port's server, as
``tests/test_java.py`` runs the reference's.
"""

import base64
import json
import re
import shutil
import subprocess
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from client_tpu_torch.models import make_add_sub
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.utils import cuda_shared_memory as cudashm

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "java"
PORT = ROOT / "client_tpu_torch" / "java"
REF_SRC = REF / "src" / "main" / "java"
PORT_SRC = PORT / "src" / "main" / "java"
PORT_CLIENT = PORT_SRC / "torch" / "client" / "InferenceServerClient.java"
REF_CLIENT = REF_SRC / "tpu" / "client" / "InferenceServerClient.java"

needs_jdk = pytest.mark.skipif(shutil.which("javac") is None,
                               reason="no JDK in this environment")


@pytest.fixture(scope="module")
def server():
    core = TorchInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    srv = HttpInferenceServer(core, port=0).start()
    try:
        yield f"localhost:{srv.port}"
    finally:
        srv.stop()
        core.stop()


@pytest.fixture
def region():
    """A 128-byte CUDA shm region on the CPU holding INPUT0 = 0..15 and
    INPUT1 = sixteen 1s, as SimpleCudaShmClient expects."""
    name = f"java_test_{np.random.default_rng().integers(1 << 30)}"
    h = cudashm.create_shared_memory_region(name, 128, 0, device="cpu")
    cudashm.set_shared_memory_region(
        h, [np.arange(16, dtype=np.int32), np.ones(16, np.int32)])
    try:
        yield h
    finally:
        cudashm.destroy_shared_memory_region(h)


def _post(url, path, body: bytes):
    req = urllib.request.Request(f"http://{url}{path}", data=body,
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _method(source: Path, name: str) -> str:
    text = source.read_text()
    start = text.index(f"public void {name}(")
    end = text.index("\n  }\n", start)
    return text[start:end]


def _path_of(expr: str, name: str) -> str:
    """A Java string expression of literals and ``name`` joined by +."""
    parts = [p.strip() for p in expr.split("+")]
    out = []
    for p in parts:
        if p == "name":
            out.append(name)
        else:
            m = re.fullmatch(r'"([^"]*)"', p)
            assert m, f"unexpected part {p!r} of {expr!r}"
            out.append(m.group(1))
    return "".join(out)


def _register_call(source: Path, method: str, region: str, raw_b64: str,
                   device_id: int, byte_size: int):
    """The (path, JSON body) that ``method`` posts, read out of its Java
    source: the post's path expression and the keys its Json puts."""
    body = _method(source, method)
    path_expr = re.search(r"post\((.+?),\s*\n?\s*req\.dump", body, re.S)
    assert path_expr, body
    path = _path_of(" ".join(path_expr.group(1).split()), region)
    keys = re.findall(r'\.put\("(\w+)"', body)
    assert keys == ["raw_handle", "b64", "device_id", "byte_size"], keys
    doc = {"raw_handle": {"b64": raw_b64}, "device_id": device_id,
           "byte_size": byte_size}
    return path, json.dumps(doc).encode()


def _unregister_paths(source: Path, method: str, region: str) -> list:
    """Both paths of the unregister verb: all regions, and one region."""
    body = _method(source, method)
    expr = re.search(r"\?\s*(\"[^\"]*\")\s*:\s*(.+?);", body, re.S)
    assert expr, body
    return [_path_of(expr.group(1), region),
            _path_of(" ".join(expr.group(2).split()), region)]


def _java_files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def test_every_reference_file_has_its_counterpart():
    ref = _java_files(REF)
    port = _java_files(PORT)
    assert len(ref) == 14         # 12 Java sources, README.md, pom.xml
    want = {r.replace("java/tpu/client", "java/torch/client") for r in ref}
    assert want <= port
    assert port - want == {
        "src/main/java/torch/client/examples/SimpleCudaShmClient.java"}
    for rel in port:
        if rel.endswith(".java"):
            text = (PORT / rel).read_text()
            pkg = re.search(r"^package ([\w.]+);", text, re.M).group(1)
            assert pkg.startswith("torch.client"), rel
            assert "import tpu." not in text, rel


def test_no_tpu_shared_memory_verb_is_left():
    for p in PORT.rglob("*"):
        if p.is_file():
            text = p.read_text()
            assert "tpusharedmemory" not in text, p
            assert "TpuSharedMemory" not in text, p
    text = PORT_CLIENT.read_text()
    assert "public void registerCudaSharedMemory(String name, " \
        "String rawHandleB64," in text
    assert "public void unregisterCudaSharedMemory(String name)" in text
    # nothing the reference's client lacks: its TPU verbs became the CUDA
    # ones, and the other public methods are the same
    pub = r"public (?:[\w<>\[\]]+ )+(\w+)\("
    ref_methods = re.findall(pub, REF_CLIENT.read_text())
    port_methods = re.findall(pub, text)
    assert port_methods == [m.replace("Tpu", "Cuda") for m in ref_methods]


def test_cuda_verbs_read_from_the_java_source_are_answered(server, region):
    raw = base64.b64encode(cudashm.get_raw_handle(region)).decode()
    path, body = _register_call(PORT_CLIENT, "registerCudaSharedMemory",
                                "java_region", raw, region.device_id, 128)
    assert path == "/v2/cudasharedmemory/region/java_region/register"
    status, text = _post(server, path, body)
    assert status == 200, text
    with urllib.request.urlopen(
            f"http://{server}/v2/cudasharedmemory/region/java_region/status",
            timeout=30) as r:
        status_doc = json.loads(r.read())
    assert [d["name"] for d in status_doc] == ["java_region"]
    assert status_doc[0]["byte_size"] == 128
    one, every = (_unregister_paths(PORT_CLIENT, "unregisterCudaSharedMemory",
                                    "java_region")[::-1])
    assert one == "/v2/cudasharedmemory/region/java_region/unregister"
    assert every == "/v2/cudasharedmemory/unregister"
    for path in (one, every):
        status, text = _post(server, path, b"")
        assert status == 200, text


def test_reference_tpu_verbs_get_the_ports_400(server, region):
    raw = base64.b64encode(cudashm.get_raw_handle(region)).decode()
    path, body = _register_call(REF_CLIENT, "registerTpuSharedMemory",
                                "java_region", raw, 0, 128)
    assert path.startswith("/v2/tpusharedmemory/")
    paths = [(path, body)] + [
        (p, b"") for p in _unregister_paths(
            REF_CLIENT, "unregisterTpuSharedMemory", "java_region")]
    for path, body in paths:
        status, text = _post(server, path, body)
        assert status == 400, (path, text)
        assert "/v2/cudasharedmemory" in json.loads(text)["error"]


# ------------------------------------------------------------ with a JDK

@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    out = tmp_path_factory.mktemp("javac_torch")
    # both trees on one classpath: their packages differ
    sources = [str(p) for src in (REF_SRC, PORT_SRC)
               for p in src.rglob("*.java")]
    subprocess.run(["javac", "-d", str(out), *sources], check=True,
                   capture_output=True)
    return str(out)


def _java(compiled, *args):
    if shutil.which("java") is None:
        pytest.skip("no java runtime")
    return subprocess.run(["java", "-cp", compiled, *args],
                          capture_output=True, text=True, timeout=60)


@needs_jdk
def test_java_example_against_the_port_server(compiled, server):
    proc = _java(compiled, "torch.client.examples.SimpleInferClient", server)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout


@needs_jdk
def test_java_cudashm_example_against_the_port_server(compiled, server,
                                                      region):
    raw = base64.b64encode(cudashm.get_raw_handle(region)).decode()
    proc = _java(compiled, "torch.client.examples.SimpleCudaShmClient",
                 server, raw, str(region.device_id))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout
