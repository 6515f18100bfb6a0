"""Installing the port's native tree and carrying it in the wheel
(``client_tpu_torch._native.install`` / ``bundle``, setup.py's port step).

- ``install(prefix)`` lays out ``include/``, ``lib/`` (shared and static
  client libraries, the CUDA-shm producer, the DIRECT library),
  ``bin/perf_analyzer`` and ``lib/cmake/ClientTpuTorch/`` with IMPORTED
  targets;
- a ``find_package(ClientTpuTorch)`` consumer builds the port's
  ``simple_http_infer_client.cc`` against the static library, and its
  stdout against the port's server equals its stdout against the JAX
  package's server;
- the installed ``perf_analyzer`` finds its default DIRECT library in
  ``lib/``;
- a wheel built with ``pip wheel --no-deps --no-build-isolation`` (from a
  copy of the port's tree) carries ``client_tpu_torch/_native/bundled/``
  and the three ``client-tpu-torch-*`` console scripts; installed with
  ``--target`` it resolves its bundled artifacts with ``g++`` off PATH,
  its bundled perf_analyzer profiles the bundled CPU DIRECT library, and
  a stamp that does not match makes the loader build, never use the
  bundled file.
"""

import os
import re
import shutil
import subprocess
import sys
import sysconfig
import zipfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "client_tpu_torch"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is not installed")
needs_cmake = pytest.mark.skipif(shutil.which("cmake") is None,
                                 reason="cmake is not installed")


def _native():
    from client_tpu_torch import _native
    return _native


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    nat = _native()
    names = [n for n in nat.INSTALL_TARGETS if not nat.TARGETS[n].cuda]
    root = tmp_path_factory.mktemp("prefix")
    return root, nat.install(root, names)


def test_install_lays_out_the_gnu_dirs_and_the_cmake_package(prefix):
    root, installed = prefix
    nat = _native()
    grpc = "libgrpcclient_tpu_torch.so" in nat.default_targets()
    libs = ["libhttpclient_tpu_torch.so", "libhttpclient_tpu_torch.a",
            "libcshm_tpu_torch.so", "libdirect_models_cpu.so"]
    if grpc:
        libs += ["libgrpcclient_tpu_torch.so", "libgrpcclient_tpu_torch.a"]
    assert sorted(installed) == sorted([*libs, "perf_analyzer"])
    for name in libs:
        assert (root / "lib" / name).is_file(), name
    assert os.access(root / "bin" / "perf_analyzer", os.X_OK)
    headers = sorted(p.name for p in
                     (root / "include" / "client_tpu_torch").glob("*.h"))
    assert headers == sorted(
        p.name for p in (nat.NATIVE_DIR / "include" / "client_tpu_torch")
        .glob("*.h"))
    assert (root / "include" / "kserve.pb.h").is_file() == grpc
    cmake = root / "lib" / "cmake" / "ClientTpuTorch"
    assert sorted(p.name for p in cmake.iterdir()) == [
        "ClientTpuTorchConfig.cmake", "ClientTpuTorchConfigVersion.cmake",
        "ClientTpuTorchTargets.cmake"]
    text = (cmake / "ClientTpuTorchTargets.cmake").read_text()
    want = ["httpclient_tpu_torch", "httpclient_tpu_torch_static",
            "cshm_tpu_torch"]
    if grpc:
        want += ["grpcclient_tpu_torch", "grpcclient_tpu_torch_static"]
    got = re.findall(r"add_library\(ClientTpuTorch::(\w+) (SHARED|STATIC) "
                     r"IMPORTED\)", text)
    assert sorted(t for t, _ in got) == sorted(want)
    assert all((kind == "STATIC") == t.endswith("_static") for t, kind in got)
    assert 'INTERFACE_LINK_LIBRARIES "pthread;rt;dl;z"' in text
    assert "/_build/" not in text and str(root) not in text
    assert 'set(PACKAGE_VERSION "0.1.0")' in \
        (cmake / "ClientTpuTorchConfigVersion.cmake").read_text()


def test_installed_perf_analyzer_finds_its_direct_library_in_lib(prefix):
    """With no -u, the installed analyzer looks for the card's library
    beside itself and then in ../lib; CLIENT_TPU_TORCH_DIRECT_LIBRARY
    names the CPU one."""
    root, _ = prefix
    perf = str(root / "bin" / "perf_analyzer")
    readelf = shutil.which("readelf")
    if readelf:
        dyn = subprocess.run([readelf, "-d", perf], capture_output=True,
                             text=True).stdout
        assert "$ORIGIN/../lib" in dyn
    proc = subprocess.run([perf, "-m", "add_sub", "-i", "direct"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert str(root / "bin" / "libdirect_models_cuda.so") in proc.stderr
    shutil.copy2(root / "lib" / "libdirect_models_cpu.so",
                 root / "lib" / "libdirect_models_cuda.so")
    try:
        proc = subprocess.run(
            [perf, "-m", "add_sub", "-i", "direct", "--concurrency-range",
             "1", "-p", "300", "-s", "90", "-r", "2"],
            capture_output=True, text=True, timeout=120)
    finally:
        (root / "lib" / "libdirect_models_cuda.so").unlink()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Throughput" in proc.stdout


@pytest.fixture(scope="module")
def servers():
    from client_tpu.models import make_add_sub as ref_add_sub
    from client_tpu.server import TpuInferenceServer
    from client_tpu.server.http_server import HttpInferenceServer as RefHttp

    from client_tpu_torch.models import make_add_sub
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    ref, port = TpuInferenceServer(), TorchInferenceServer()
    ref.register_model(ref_add_sub("add_sub", 16, "INT32"))
    port.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    fronts = {"ref": RefHttp(ref, port=0).start(),
              "port": HttpInferenceServer(port, port=0).start()}
    try:
        yield {side: f"localhost:{f.port}" for side, f in fronts.items()}
    finally:
        for f in fronts.values():
            f.stop()
        ref.stop()
        port.stop()


@needs_cmake
def test_find_package_consumer_infers_against_both_servers(
        prefix, servers, tmp_path):
    root, _ = prefix
    consumer = tmp_path / "consumer"
    consumer.mkdir()
    shutil.copy2(_native().NATIVE_DIR / "examples" /
                 "simple_http_infer_client.cc", consumer)
    (consumer / "CMakeLists.txt").write_text(
        "cmake_minimum_required(VERSION 3.18)\n"
        "project(consumer CXX)\n"
        "set(CMAKE_CXX_STANDARD 17)\n"
        "find_package(ClientTpuTorch 0.1 REQUIRED)\n"
        "add_executable(simple_http_infer_client "
        "simple_http_infer_client.cc)\n"
        "target_link_libraries(simple_http_infer_client "
        "ClientTpuTorch::httpclient_tpu_torch_static)\n")
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    for cmd in (["cmake", "-S", str(consumer), "-B", str(consumer / "build"),
                 f"-DCMAKE_PREFIX_PATH={root}", *gen],
                ["cmake", "--build", str(consumer / "build")]):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    exe = consumer / "build" / "simple_http_infer_client"
    ldd = shutil.which("ldd")
    if ldd:   # the static archive: no client library at run time
        deps = subprocess.run([ldd, str(exe)], capture_output=True,
                              text=True).stdout
        assert "httpclient_tpu_torch" not in deps
    outs = {}
    for side, url in servers.items():
        proc = subprocess.run([str(exe), "-u", url], capture_output=True,
                              text=True, timeout=60)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs[side] = proc.stdout
    assert "PASS" in outs["port"]
    assert outs["port"] == outs["ref"]


# ------------------------------------------------------------------ wheel

@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The wheel of a copy of the port's tree (setup.py, pyproject.toml,
    README.md, client_tpu_torch/): a build in the checkout itself would
    share ``build/`` with tests/test_wheel.py. Without ``native/`` in
    the copy the reference's step finds no tree and builds nothing."""
    tmp = tmp_path_factory.mktemp("torch_wheel")
    src = tmp / "src"
    src.mkdir()
    for name in ("setup.py", "pyproject.toml", "README.md"):
        shutil.copy2(ROOT / name, src / name)
    shutil.copytree(PKG, src / "client_tpu_torch", ignore=shutil.
                    ignore_patterns("_build", "bundled", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(src), "-w",
         str(tmp / "dist"), "--no-deps", "--no-build-isolation"],
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    wheels = list((tmp / "dist").glob("client_tpu-*.whl"))
    assert len(wheels) == 1, wheels
    assert not (src / "client_tpu_torch" / "_build").exists()
    assert not (src / "client_tpu_torch" / "_native" / "bundled").exists()
    site = tmp / "site"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps", "--target",
         str(site), str(wheels[0])],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    nopath = tmp / "empty_path"
    nopath.mkdir()
    return {"wheel": wheels[0], "site": site, "tmp": tmp, "path": nopath}


def _in_install(wheel, code):
    """Run ``code`` against the installed wheel with nothing on PATH (no
    g++, no ar: a build would fail)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(wheel["site"]) + os.pathsep + \
        sysconfig.get_paths()["purelib"]
    env["PATH"] = str(wheel["path"])
    env.pop("CUDA_HOME", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=wheel["tmp"])


def test_wheel_carries_the_bundle_and_the_console_scripts(wheel):
    with zipfile.ZipFile(wheel["wheel"]) as z:
        names = z.namelist()
        entry = z.read(next(n for n in names
                            if n.endswith("entry_points.txt"))).decode()
    bundled = {n.rsplit("/", 1)[1] for n in names
               if n.startswith("client_tpu_torch/_native/bundled/")}
    assert {"STAMP", "perf_analyzer", "libhttpclient_tpu_torch.so",
            "libhttpclient_tpu_torch.a", "libcshm_tpu_torch.so",
            "libdirect_models_cpu.so"} <= bundled
    for script, target in (
            ("client-tpu-torch-server", "client_tpu_torch.server.__main__:main"),
            ("client-tpu-torch-perf", "client_tpu_torch.perf.__main__:main"),
            ("client-tpu-torch-perf-native",
             "client_tpu_torch._native:run_perf_analyzer")):
        assert re.search(rf"^{script} = {re.escape(target)}$", entry, re.M), \
            entry
    # the reference's own scripts stay as they were
    assert "client-tpu-perf = client_tpu.perf.__main__:main" in entry


def test_installed_wheel_resolves_bundled_artifacts_without_a_compiler(
        wheel):
    proc = _in_install(wheel, (
        "import shutil, os\n"
        "assert shutil.which('g++') is None\n"
        "import client_tpu_torch._native as n\n"
        "lib = n.lib_path('libcshm_tpu_torch.so')\n"
        f"assert str(lib).startswith({str(wheel['site'])!r}), lib\n"
        "assert lib.parent == n.BUNDLED_DIR and lib.is_file(), lib\n"
        "assert n.perf_analyzer_path().parent == n.BUNDLED_DIR\n"
        "assert not (n.BUILD_ROOT).exists()\n"
        "print('ok')\n"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok" in proc.stdout


def test_bundled_perf_analyzer_profiles_the_bundled_direct_library(wheel):
    proc = _in_install(wheel, (
        "import subprocess\n"
        "import client_tpu_torch._native as n\n"
        "p = subprocess.run([str(n.perf_analyzer_path()), '-m', 'add_sub',\n"
        "    '-i', 'direct', '-u', str(n.lib_path('libdirect_models_cpu.so')),\n"
        "    '--concurrency-range', '1', '-p', '300', '-s', '90', '-r', '2'],\n"
        "    capture_output=True, text=True)\n"
        "assert p.returncode == 0, p.stdout + p.stderr\n"
        "assert 'Throughput' in p.stdout\n"
        "print('ok')\n"))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_stale_stamp_is_never_used(wheel):
    """In the installed wheel a stamp that does not match makes the
    loader build (which fails here, with no g++ on PATH)."""
    stamp = wheel["site"] / "client_tpu_torch" / "_native" / "bundled" / \
        "STAMP"
    good = stamp.read_text()
    stamp.write_text("0" * 64 + "\n")
    try:
        proc = _in_install(wheel, (
            "import client_tpu_torch._native as n\n"
            "assert n.bundled('libcshm_tpu_torch.so') is None\n"
            "try:\n"
            "    n.lib_path('libcshm_tpu_torch.so')\n"
            "except RuntimeError as e:\n"
            "    assert 'g++ not found' in str(e), e\n"
            "    print('built, not bundled')\n"))
    finally:
        stamp.write_text(good)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "built, not bundled" in proc.stdout


def test_loader_takes_the_bundle_only_at_the_sources_stamp(monkeypatch,
                                                           tmp_path):
    nat = _native()
    (tmp_path / "libcshm_tpu_torch.so").write_bytes(b"bundled")
    built = tmp_path / "built" / "libcshm_tpu_torch.so"
    calls = []

    def fake_build(names, timings=None, root=None):
        calls.append(list(names))
        return {n: built for n in names}

    monkeypatch.setattr(nat, "BUNDLED_DIR", tmp_path)
    monkeypatch.setattr(nat, "build", fake_build)
    (tmp_path / nat.STAMP_FILE).write_text(nat.stamp() + "\n")
    assert nat.lib_path("libcshm_tpu_torch.so") == \
        tmp_path / "libcshm_tpu_torch.so"
    assert calls == []
    (tmp_path / nat.STAMP_FILE).write_text("stale\n")
    assert nat.lib_path("libcshm_tpu_torch.so") == built
    assert calls == [["libcshm_tpu_torch.so"]]
    (tmp_path / nat.STAMP_FILE).unlink()
    assert nat.lib_path("libcshm_tpu_torch.so") == built
    # the stamp covers the sources and flags, not the compilers
    assert nat.stamp() == nat.stamp() and len(nat.stamp()) == 64
