"""The port's native C++ stack, built at first use.

The sources live in ``client_tpu_torch/native/`` (client libraries,
the CUDA-shm producer, the native perf analyzer, the DIRECT model
libraries, the examples and the C++ tests). :func:`build` compiles the
targets of :data:`TARGETS` with ``g++`` (and ``nvcc`` for the card's
DIRECT library) into ``client_tpu_torch/_build/native-<hash>/``, where
the hash covers every source and header, the two ``.proto`` files, the
flags and the compilers' versions: a changed source builds anew, an
unchanged tree is reused, and a second call builds nothing. Every object
compiles once, all of them in parallel, then the targets link in
parallel. No ``cmake`` is needed.

Targets that speak gRPC or TF-Serving (``protobuf=True``) need
``protoc``, protobuf's headers and ``libprotobuf``; their messages are
generated at build time from ``client_tpu_torch/protocol/kserve.proto``
and ``client_tpu_torch/perf/foreign/tfs.proto``. Asking for such a
target without them raises and names what is missing. ``perf_analyzer``
builds either way: without protobuf its ``grpc`` and ``tfserve`` kinds
are refused at run time. ``libdirect_models_cuda.so`` needs ``nvcc``
(``sm_90a``). A failed compile raises with the compiler's output;
nothing falls back to another build tree.

The client libraries also build as static archives (``ar`` over the
shared libraries' objects). :func:`install` lays the libraries, the
headers, ``perf_analyzer`` and a CMake package (``find_package(
ClientTpuTorch)``) out under a prefix; :func:`bundle` is what the wheel
build calls to carry the built artifacts in ``_native/bundled/`` beside
a stamp of the sources they came from. :func:`artifact_path` takes a
bundled artifact only while its stamp equals the installed sources'
stamp, and builds otherwise.

    from client_tpu_torch import _native
    paths = _native.build(["perf_analyzer", "libdirect_models_cpu.so"])
    _native.run_perf_analyzer(["-m", "add_sub", "-u", "localhost:8000"])
    _native.install("ctt")   # or: python -m client_tpu_torch._native
    # install --prefix ctt
"""

from __future__ import annotations

import ctypes.util
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from client_tpu_torch import __version__

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG / "native"
BUILD_ROOT = _PKG / "_build"
# the wheel's prebuilt artifacts and the stamp of the sources they came
# from (setup.py's build step writes both; a source checkout has none)
BUNDLED_DIR = Path(__file__).resolve().parent / "bundled"
STAMP_FILE = "STAMP"
PROTOS = {"kserve": _PKG / "protocol" / "kserve.proto",
          "tfs": _PKG / "perf" / "foreign" / "tfs.proto"}

CXXFLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SYS_LIBS = ("-lpthread", "-lrt", "-ldl", "-lz")
# defined for perf/*.cc when protobuf is there: the grpc and tfserve kinds
PERF_GRPC_DEFINE = "-DCLIENT_TPU_TORCH_PERF_GRPC"

# a source "gen/<name>.pb.cc" is protoc's output for PROTOS[name]
HTTP = ("src/http_client.cc", "src/shm_utils.cc", "src/tls_stream.cc")
GRPC = ("src/grpc_client.cc", "src/http2.cc", "src/hpack.cc",
        "gen/kserve.pb.cc", "src/shm_utils.cc", "src/tls_stream.cc")
PERF = ("perf/main.cc", "perf/perf_analyzer.cc", "perf/client_backend.cc",
        "perf/direct_backend.cc", "src/cuda_shm.cc", *HTTP)
PERF_PROTOBUF = ("perf/tfs_backend.cc", "gen/tfs.pb.cc", *GRPC)


@dataclass(frozen=True)
class Target:
    name: str                 # the file it makes in the build directory
    group: str                # reported build group
    sources: tuple            # relative to NATIVE_DIR (or gen/)
    shared: bool = False      # a shared library, else an executable
    protobuf: bool = False    # needs protoc + headers + libprotobuf
    cuda: bool = False        # one nvcc call over its one .cu source
    ldscript: Optional[str] = None
    libs: tuple = SYS_LIBS    # a static archive's: what its user links
    static: bool = False      # an archive (ar) of the objects
    ldflags: tuple = ()


HTTP_EXAMPLES = ("simple_http_infer_client", "simple_http_health_metadata",
                 "simple_http_string_infer_client",
                 "simple_http_model_control", "simple_http_shm_client",
                 "simple_http_async_infer_client",
                 "simple_http_sequence_sync_client", "ensemble_image_client")
GRPC_EXAMPLES = ("simple_grpc_infer_client", "simple_grpc_health_metadata",
                 "simple_grpc_stream_infer_client",
                 "simple_grpc_string_infer_client",
                 "simple_grpc_model_control", "simple_grpc_shm_client",
                 "simple_grpc_async_infer_client",
                 "simple_grpc_sequence_sync_client",
                 "simple_grpc_sequence_stream_client",
                 "simple_grpc_custom_repeat", "simple_grpc_keepalive_client")
CC_TESTS = ("cc_client_test", "client_timeout_test", "memory_leak_test",
            "tls_client_test")

TARGETS = {t.name: t for t in (
    Target("libhttpclient_tpu_torch.so", "http", HTTP, shared=True,
           ldscript="libhttpclient.ldscript"),
    Target("libhttpclient_tpu_torch.a", "http", HTTP, static=True),
    Target("libcshm_tpu_torch.so", "http",
           ("src/cshm.cc", "src/shm_utils.cc"), shared=True,
           libs=("-lrt",)),
    Target("native_smoke", "http", ("tests/native_smoke.cc", *HTTP)),
    Target("hpack_test", "http", ("tests/hpack_test.cc", "src/hpack.cc"),
           libs=()),
    *(Target(e, "http", (f"examples/{e}.cc", *HTTP)) for e in HTTP_EXAMPLES),
    Target("simple_http_cudashm_client", "http",
           ("examples/simple_http_cudashm_client.cc", "src/cuda_shm.cc",
            *HTTP)),
    Target("libgrpcclient_tpu_torch.so", "grpc", GRPC, shared=True,
           protobuf=True, ldscript="libgrpcclient.ldscript"),
    Target("libgrpcclient_tpu_torch.a", "grpc", GRPC, static=True,
           protobuf=True),
    Target("grpc_smoke", "grpc", ("tests/grpc_smoke.cc", *GRPC),
           protobuf=True),
    *(Target(e, "grpc", (f"examples/{e}.cc", *GRPC), protobuf=True)
      for e in GRPC_EXAMPLES),
    Target("simple_grpc_cudashm_client", "grpc",
           ("examples/simple_grpc_cudashm_client.cc", "src/cuda_shm.cc",
            *GRPC), protobuf=True),
    *(Target(e, "grpc", (f"examples/{e}.cc", *GRPC, *HTTP), protobuf=True)
      for e in ("reuse_infer_objects_client", "image_client")),
    *(Target(e, "grpc", (f"tests/{e}.cc", *GRPC, *HTTP), protobuf=True)
      for e in CC_TESTS),
    # the grpc/tfserve kinds join when protobuf is there (_sources)
    # installed in bin/ beside lib/ (install()), it finds its libraries
    # in the prefix
    Target("perf_analyzer", "perf", PERF,
           ldflags=("-Wl,-rpath,$ORIGIN/../lib:$ORIGIN",)),
    Target("libdirect_models_cpu.so", "direct", ("src/direct_models.cc",),
           shared=True, libs=()),
    Target("libdirect_models_cuda.so", "direct_cuda",
           ("src/direct_models_cuda.cu",), shared=True, cuda=True),
)}

# what install() lays out and the wheel carries, where this machine (or
# the bundle) has it
INSTALL_TARGETS = ("libhttpclient_tpu_torch.so", "libhttpclient_tpu_torch.a",
                   "libcshm_tpu_torch.so", "libgrpcclient_tpu_torch.so",
                   "libgrpcclient_tpu_torch.a", "perf_analyzer",
                   "libdirect_models_cpu.so", "libdirect_models_cuda.so")

_lock = threading.Lock()
_tools: Optional[dict] = None


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def _first_line(cmd, last: bool = False) -> str:
    try:
        out = _run(cmd)
    except OSError:
        return "none"
    lines = [ln for ln in (out.stdout + out.stderr).splitlines()
             if ln.strip()]
    if out.returncode != 0 or not lines:
        return "none"
    return lines[-1] if last else lines[0]


def _nvcc() -> Optional[str]:
    from client_tpu_torch.ops._build import nvcc_path
    try:
        return nvcc_path()
    except RuntimeError:
        return None


def _protobuf() -> dict:
    """protoc, the headers' and the library's flags, and what is
    missing of the three."""
    protoc = shutil.which("protoc")
    cflags: list = []
    libs: list = []
    found_pc = False
    if shutil.which("pkg-config"):
        out = _run(["pkg-config", "--cflags", "--libs", "protobuf"])
        if out.returncode == 0:
            found_pc = True
            flags = out.stdout.split()
            cflags = [f for f in flags if not f.startswith(("-l", "-L"))]
            libs = [f for f in flags if f.startswith(("-l", "-L"))]
    missing = []
    if protoc is None:
        missing.append("protoc")
    if not found_pc:
        incs = ("/usr/include", "/usr/local/include")
        if not any(os.path.exists(f"{d}/google/protobuf/message.h")
                   for d in incs):
            missing.append("the protobuf headers (google/protobuf/message.h)")
        if ctypes.util.find_library("protobuf") is None:
            missing.append("libprotobuf")
        libs = ["-lprotobuf"]
    return {"protoc": protoc, "cflags": cflags, "libs": libs,
            "missing": missing}


def toolchain() -> dict:
    """What the build can use here: the compilers' paths and versions,
    protobuf's parts (``protobuf_missing`` names what is absent) and
    whether ``cmake`` is on PATH (the build does not use it)."""
    global _tools
    with _lock:
        if _tools is None:
            cxx = shutil.which("g++")
            nvcc = _nvcc()
            pb = _protobuf()
            _tools = {
                "g++": cxx,
                "g++_version": _first_line([cxx, "--version"])
                if cxx else "none",
                "nvcc": nvcc,
                "nvcc_version": _first_line([nvcc, "--version"], last=True)
                if nvcc else "none",
                "protoc": pb["protoc"],
                "protoc_version": _first_line([pb["protoc"], "--version"])
                if pb["protoc"] else "none",
                "protobuf_cflags": pb["cflags"],
                "protobuf_libs": pb["libs"],
                "protobuf_missing": pb["missing"],
                "ar": shutil.which("ar"),
                "cmake": shutil.which("cmake"),
            }
        return dict(_tools)


def _has_protobuf(tools: dict) -> bool:
    return not tools["protobuf_missing"]


def _hash_sources(h) -> None:
    h.update(" ".join((*CXXFLAGS, *NVCC_FLAGS, *SYS_LIBS)).encode())
    for path in sorted(p for p in NATIVE_DIR.rglob("*") if p.is_file()
                       and p.suffix in (".cc", ".h", ".cu", ".ldscript")):
        h.update(str(path.relative_to(NATIVE_DIR)).encode())
        h.update(path.read_bytes())
    for name, path in sorted(PROTOS.items()):
        h.update(name.encode())
        h.update(path.read_bytes())


def stamp() -> str:
    """The hash of the native sources, the two protos and the flags (not
    of the compilers' versions): a bundled artifact is used only where
    its stamp equals this."""
    h = hashlib.sha256()
    _hash_sources(h)
    return h.hexdigest()


def build_dir(root: Optional[Path] = None) -> Path:
    """This tree's build directory: ``_build/native-<hash>`` (under
    ``root`` when given), the hash also covering the tools' versions."""
    tools = toolchain()
    h = hashlib.sha256()
    for key in ("g++_version", "nvcc_version", "protoc_version",
                "protobuf_cflags", "protobuf_libs", "protobuf_missing"):
        h.update(f"{key}={tools[key]}\n".encode())
    _hash_sources(h)
    return Path(root or BUILD_ROOT) / f"native-{h.hexdigest()[:16]}"


def _sources(target: Target, tools: dict) -> tuple:
    if target.name == "perf_analyzer" and _has_protobuf(tools):
        return tuple(dict.fromkeys((*target.sources, *PERF_PROTOBUF)))
    return tuple(dict.fromkeys(target.sources))


def _object(out: Path, src: str, perf_grpc: bool) -> Path:
    stem = src.replace("/", "_").rsplit(".", 1)[0]
    return out / "obj" / f"{stem}{'-grpc' if perf_grpc else ''}.o"


def _check_buildable(target: Target, tools: dict) -> None:
    if tools["g++"] is None:
        raise RuntimeError(f"cannot build {target.name}: g++ not found")
    if target.static and tools["ar"] is None:
        raise RuntimeError(f"cannot build {target.name}: ar not found")
    if target.cuda and tools["nvcc"] is None:
        raise RuntimeError(
            f"cannot build {target.name}: nvcc (the CUDA toolkit) not "
            "found; set CUDA_HOME or put nvcc on PATH")
    if target.protobuf and not _has_protobuf(tools):
        raise RuntimeError(
            f"cannot build {target.name}: it needs protobuf, and "
            + ", ".join(tools["protobuf_missing"]) + " not found")


def default_targets() -> list:
    """Every target this machine's tools can build."""
    tools = toolchain()
    return [t.name for t in TARGETS.values()
            if tools["g++"] and (not t.cuda or tools["nvcc"])
            and (not t.static or tools["ar"])
            and (not t.protobuf or _has_protobuf(tools))]


def _run_jobs(jobs: list, width: int) -> list:
    """jobs: [(label, cmd, on_success)], run ``width`` at a time in the
    order given, at a lower CPU priority (``nice``: a build beside a test
    run or a server must not starve them); returns [(label, end time)]
    and raises with every failure's output once all have ended."""
    nice = shutil.which("nice")

    def one(job):
        label, cmd, ok = job
        proc = subprocess.run([nice, "-n", "19", *cmd] if nice else cmd,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=NATIVE_DIR)
        if proc.returncode != 0:
            return label, None, (f"{label}: {' '.join(map(str, cmd))}\n"
                                 f"exited {proc.returncode}:\n"
                                 f"{proc.stdout.decode(errors='replace')}")
        ok()
        return label, time.time(), None

    if not jobs:
        return []
    with ThreadPoolExecutor(max(1, width)) as pool:
        results = list(pool.map(one, jobs))
    failures = [why for _, _, why in results if why]
    if failures:
        raise RuntimeError("native build failed:\n" + "\n".join(failures))
    return [(label, end) for label, end, _ in results]


def _replace(tmp: Path, path: Path):
    return lambda: os.replace(tmp, path)   # atomic: no half-written file


def build(targets=None, timings: Optional[dict] = None,
          root: Optional[Path] = None) -> dict:
    """Build ``targets`` (names of :data:`TARGETS`; None: every target the
    tools here can build) unless built already; returns {name: path}.
    ``timings``, when given, receives the seconds from the start of the
    build to the end of each group's last step. ``root`` puts the build
    directory elsewhere than ``_build/``."""
    names = default_targets() if targets is None else list(targets)
    unknown = [n for n in names if n not in TARGETS]
    if unknown:
        raise KeyError(f"unknown native targets {unknown}; "
                       f"known: {sorted(TARGETS)}")
    tools = toolchain()
    for n in names:
        _check_buildable(TARGETS[n], tools)
    out = build_dir(root)
    paths = {n: out / n for n in names}
    if all(p.exists() for p in paths.values()):
        return paths
    out.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one build of a tree at a time
        try:
            _build_locked([TARGETS[n] for n in names if not paths[n].exists()],
                          tools, out, timings)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return paths


def _build_locked(todo: list, tools: dict, out: Path,
                  timings: Optional[dict]) -> None:
    t0 = time.time()
    width = os.cpu_count() or 4
    (out / "obj").mkdir(exist_ok=True)
    (out / "gen").mkdir(exist_ok=True)
    pid = os.getpid()
    includes = ["-I", str(NATIVE_DIR / "include"), "-I", str(out / "gen")]
    perf_grpc = _has_protobuf(tools)
    group_of: dict = {}

    def note(label, group):
        group_of.setdefault(label, set()).add(group)

    # 1. protoc's sources, when a target needs them
    gen_jobs = []
    wanted = {s for t in todo if not t.cuda for s in _sources(t, tools)}
    for name, proto in sorted(PROTOS.items()):
        cc = out / "gen" / f"{name}.pb.cc"
        if f"gen/{name}.pb.cc" in wanted and not cc.exists():
            # protoc writes .pb.h then .pb.cc: the .cc's presence means both
            stage = out / "gen" / f".{name}.{pid}"
            stage.mkdir(exist_ok=True)
            gen_jobs.append((f"protoc {proto.name}", [
                tools["protoc"], f"--cpp_out={stage}",
                f"--proto_path={proto.parent}", str(proto)],
                _gen_done(stage, out / "gen", name)))
    _run_jobs(gen_jobs, width)
    # 2. every object once, and nvcc, all together; the longest first:
    # nvcc, protoc's sources, then the rest by source size
    jobs, seen = [], set()
    for t in todo:
        if t.cuda:
            dst = out / t.name
            tmp = dst.with_name(f"{dst.name}.{pid}.tmp")
            jobs.append((float("inf"), t.name, [
                tools["nvcc"], *NVCC_FLAGS, "-I", str(NATIVE_DIR / "include"),
                "-o", str(tmp), *t.sources], _replace(tmp, dst)))
            note(t.name, t.group)
            continue
        for src in _sources(t, tools):
            grpc_perf = perf_grpc and src.startswith("perf/")
            obj = _object(out, src, grpc_perf)
            note(str(obj), t.group)
            if obj in seen or obj.exists():
                continue
            seen.add(obj)
            gen = src.startswith("gen/")
            path = out / src if gen else NATIVE_DIR / src
            tmp = obj.with_name(f"{obj.name}.{pid}.tmp")
            cmd = [tools["g++"], *CXXFLAGS, *includes,
                   *tools["protobuf_cflags"],
                   *([PERF_GRPC_DEFINE] if grpc_perf else []),
                   "-c", str(path), "-o", str(tmp)]
            weight = 1e12 if gen else path.stat().st_size
            jobs.append((weight, str(obj), cmd, _replace(tmp, obj)))
    jobs.sort(key=lambda j: -j[0])
    done = _run_jobs([j[1:] for j in jobs], width)
    # 3. link
    links = []
    for t in todo:
        if t.cuda:
            continue
        dst = out / t.name
        tmp = dst.with_name(f"{dst.name}.{pid}.tmp")
        objs = [str(_object(out, s, perf_grpc and s.startswith("perf/")))
                for s in _sources(t, tools)]
        if t.static:
            # the shared library's objects (-fPIC), archived anew
            links.append((t.name, [tools["ar"], "rcs", str(tmp), *objs],
                          _replace(tmp, dst)))
            note(t.name, t.group)
            continue
        pb = (tools["protobuf_libs"]
              if any(s.startswith("gen/") for s in _sources(t, tools))
              else [])
        cmd = [tools["g++"], "-pthread", *(["-shared"] if t.shared else []),
               "-o", str(tmp), *objs, *pb, *t.libs, *t.ldflags]
        if t.shared:
            cmd.append(f"-Wl,-soname,{t.name}")
        if t.ldscript:
            cmd.append(f"-Wl,--version-script={NATIVE_DIR / t.ldscript}")
        links.append((t.name, cmd, _replace(tmp, dst)))
        note(t.name, t.group)
    done += _run_jobs(links, width)
    if timings is not None:
        for label, end in done:
            for group in group_of.get(label, ()):
                timings[group] = max(timings.get(group, 0.0), end - t0)


def _gen_done(stage: Path, gen: Path, name: str):
    def move():
        os.replace(stage / f"{name}.pb.h", gen / f"{name}.pb.h")
        os.replace(stage / f"{name}.pb.cc", gen / f"{name}.pb.cc")
        shutil.rmtree(stage, ignore_errors=True)
    return move


def bundled(name: str) -> Optional[Path]:
    """The wheel's prebuilt ``name`` where its stamp equals the installed
    sources' stamp; None otherwise (a stale bundle is never used)."""
    path = BUNDLED_DIR / name
    stamp_file = BUNDLED_DIR / STAMP_FILE
    if not (path.is_file() and stamp_file.is_file()):
        return None
    return path if stamp_file.read_text().strip() == stamp() else None


def artifact_path(name: str) -> Path:
    """The path of target ``name``: the wheel's bundled copy where it is
    current, else built at first use (raises when it cannot be built
    here)."""
    return bundled(name) or build([name])[name]


def lib_path(name: str) -> Path:
    """A shared library's path, e.g. lib_path('libcshm_tpu_torch.so')."""
    return artifact_path(name)


def perf_analyzer_path() -> Path:
    return artifact_path("perf_analyzer")


def run_perf_analyzer(argv=None) -> int:
    """Entry point of the ``client-tpu-torch-perf-native`` script: take
    the bundled analyzer (beside its bundled DIRECT libraries), or build
    it and the DIRECT libraries this machine can build, then exec the
    analyzer with ``argv``."""
    path = bundled("perf_analyzer")
    if path is None:
        names = ["perf_analyzer", "libdirect_models_cpu.so"]
        if toolchain()["nvcc"]:
            names.append("libdirect_models_cuda.so")
        try:
            path = build(names)["perf_analyzer"]
        except RuntimeError as e:
            print(f"client-tpu-torch: {e}", file=sys.stderr)
            return 1
    args = argv if argv is not None else sys.argv[1:]
    os.execv(path, [str(path), *args])
    return 0  # unreachable


# ---------------------------------------------------------------- install

def _available(names) -> list:
    """The names of ``names`` that are bundled or buildable here."""
    here = set(default_targets())
    return [n for n in names if bundled(n) is not None or n in here]


def _gen_header(name: str) -> Optional[Path]:
    """protoc's header ``<name>.pb.h`` that the gRPC client's header
    includes: the bundle's where its library is bundled, else the
    build's."""
    if bundled("libgrpcclient_tpu_torch.so") is not None:
        return bundled(f"{name}.pb.h")
    path = build_dir() / "gen" / f"{name}.pb.h"
    return path if path.is_file() else None


def bundle(dest, root: Optional[Path] = None) -> list:
    """Build :data:`INSTALL_TARGETS` that this machine can build (under
    ``root``, default ``_build/``) and copy them into ``dest`` with the
    stamp of their sources (and protoc's ``kserve.pb.h`` beside the gRPC
    libraries): what the wheel carries as ``_native/bundled/``. Returns
    the names copied."""
    here = set(default_targets())
    names = [n for n in INSTALL_TARGETS if n in here]
    paths = build(names, root=root)
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    for name, path in paths.items():
        shutil.copy2(path, dest / name)
    header = build_dir(root) / "gen" / "kserve.pb.h"
    if "libgrpcclient_tpu_torch.so" in paths and header.is_file():
        shutil.copy2(header, dest / header.name)
    (dest / STAMP_FILE).write_text(stamp() + "\n")
    return sorted(paths)


def _cmake_lib(name: str) -> str:
    return name[3:].split(".", 1)[0]           # libfoo.so -> foo


def _cmake_links(flags) -> str:
    return ";".join(f[2:] if f.startswith("-l") else f for f in flags)


def _targets_cmake(libs: list, protobuf_libs) -> str:
    lines = ["# IMPORTED targets of the port's native client libraries",
             "# (written by client_tpu_torch._native.install)",
             'get_filename_component(_CTT_PREFIX '
             '"${CMAKE_CURRENT_LIST_DIR}/../../.." ABSOLUTE)']
    for name in libs:
        t = TARGETS[name]
        target = f"ClientTpuTorch::{_cmake_lib(name)}" + \
            ("_static" if t.static else "")
        links = [*(protobuf_libs if t.protobuf else ()), *t.libs]
        kind = "STATIC" if t.static else "SHARED"
        lines += [
            f"if(NOT TARGET {target})",
            f"  add_library({target} {kind} IMPORTED)",
            f"  set_target_properties({target} PROPERTIES",
            f'    IMPORTED_LOCATION "${{_CTT_PREFIX}}/lib/{name}"',
            *([f'    IMPORTED_SONAME "{name}"'] if t.shared else
              ['    IMPORTED_LINK_INTERFACE_LANGUAGES "CXX"']),
            '    INTERFACE_INCLUDE_DIRECTORIES "${_CTT_PREFIX}/include"',
            f'    INTERFACE_LINK_LIBRARIES "{_cmake_links(links)}")',
            "endif()"]
    lines.append("unset(_CTT_PREFIX)")
    return "\n".join(lines) + "\n"


_CONFIG_VERSION = """\
# the package's version, compatible within its major version
set(PACKAGE_VERSION "{v}")
string(REGEX MATCH "^[0-9]+" _ctt_major "{v}")
if(PACKAGE_VERSION VERSION_LESS PACKAGE_FIND_VERSION)
  set(PACKAGE_VERSION_COMPATIBLE FALSE)
elseif(PACKAGE_FIND_VERSION_MAJOR STREQUAL _ctt_major)
  set(PACKAGE_VERSION_COMPATIBLE TRUE)
  if(PACKAGE_FIND_VERSION STREQUAL PACKAGE_VERSION)
    set(PACKAGE_VERSION_EXACT TRUE)
  endif()
elseif(NOT PACKAGE_FIND_VERSION)
  set(PACKAGE_VERSION_COMPATIBLE TRUE)
else()
  set(PACKAGE_VERSION_COMPATIBLE FALSE)
endif()
unset(_ctt_major)
if(NOT CMAKE_SIZEOF_VOID_P STREQUAL "8")
  set(PACKAGE_VERSION_UNSUITABLE TRUE)
endif()
"""


def install(prefix, targets=None) -> dict:
    """Build what is missing of ``targets`` (default: every one of
    :data:`INSTALL_TARGETS` that is bundled or buildable here) and lay
    them out under ``prefix`` as the GNU install dirs: the headers in
    ``include/client_tpu_torch/``, the libraries (shared, static, the
    CUDA-shm producer, the DIRECT libraries) in ``lib/``,
    ``bin/perf_analyzer`` (which finds its DIRECT library in ``lib/``),
    and ``lib/cmake/ClientTpuTorch/`` for ``find_package(ClientTpuTorch)``
    with IMPORTED targets ``ClientTpuTorch::httpclient_tpu_torch``,
    ``..._static``, ``cshm_tpu_torch`` and the gRPC pair where built.
    The CMake files are written as text: installing needs no cmake.
    Returns {name: installed path}."""
    wanted = list(INSTALL_TARGETS if targets is None else targets)
    unknown = [n for n in wanted if n not in INSTALL_TARGETS]
    if unknown:
        raise KeyError(f"not installable: {unknown}; "
                       f"known: {list(INSTALL_TARGETS)}")
    names = _available(wanted)
    missing = [n for n in wanted if n not in names]
    if targets is not None and missing:
        raise RuntimeError(f"cannot install {missing}: neither bundled nor "
                           "buildable here")
    prefix = Path(prefix)
    inc, lib, bin_ = prefix / "include", prefix / "lib", prefix / "bin"
    cmake_dir = lib / "cmake" / "ClientTpuTorch"
    for d in (inc / "client_tpu_torch", lib, bin_, cmake_dir):
        d.mkdir(parents=True, exist_ok=True)
    for header in sorted((NATIVE_DIR / "include" / "client_tpu_torch")
                         .glob("*.h")):
        shutil.copy2(header, inc / "client_tpu_torch" / header.name)
    out = {}
    for name in names:
        dst = (bin_ if name == "perf_analyzer" else lib) / name
        shutil.copy2(artifact_path(name), dst)
        out[name] = dst
    if "libgrpcclient_tpu_torch.so" in names \
            or "libgrpcclient_tpu_torch.a" in names:
        header = _gen_header("kserve")
        if header is None:
            raise RuntimeError("the gRPC client's kserve.pb.h is missing")
        shutil.copy2(header, inc / header.name)
    libs = [n for n in names
            if n.startswith(("libhttpclient", "libgrpcclient", "libcshm"))]
    (cmake_dir / "ClientTpuTorchTargets.cmake").write_text(
        _targets_cmake(libs, toolchain()["protobuf_libs"]))
    (cmake_dir / "ClientTpuTorchConfig.cmake").write_text(
        'include("${CMAKE_CURRENT_LIST_DIR}/ClientTpuTorchTargets.cmake")\n')
    (cmake_dir / "ClientTpuTorchConfigVersion.cmake").write_text(
        _CONFIG_VERSION.format(v=__version__))
    return out
