"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own into a shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The build goes into ``client_tpu_torch/_build/`` at first use, keyed by a
hash of the sources and flags, so a changed source builds anew and an
unchanged one is reused. Several libraries build in parallel, one
``nvcc`` process each. A missing ``nvcc`` or a failed build raises: there
is no fallback to the kernels' plain versions.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
at the CUDA toolkit's default prefix ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# every kernel library of the port, one per ops/csrc/<name>.cu
KERNELS = ("flash_attention", "paged_attention")
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_loaded: dict = {}
_lock = threading.Lock()
# every kernel module's LaunchCounter, in the order the modules loaded
COUNTERS: list = []


class LaunchCounter:
    """The launch count of the kernel module ``module``, kept in that
    module's global ``launches`` (which a run reads and resets).
    ``count()`` is called where the wrapper launches its kernel, and only
    there. A launch made while this thread's stream captures a CUDA graph
    launches nothing: it is recorded (``recorded()``), and each replay of
    the graph adds what its capture recorded (``add``,
    server/runtime_stats.py)."""

    def __init__(self, module: str):
        self.module = module
        self._lock = threading.Lock()
        self._recorded = threading.local()
        COUNTERS.append(self)

    def count(self) -> None:
        import torch

        if torch.cuda.is_current_stream_capturing():
            self._recorded.n = self.recorded() + 1
            return
        self.add(1)

    def recorded(self) -> int:
        """Launches this thread recorded into CUDA graph captures."""
        return getattr(self._recorded, "n", 0)

    def add(self, n: int) -> None:
        mod = sys.modules[self.module]
        with self._lock:
            mod.launches += n


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from client_tpu_torch/ops/csrc at first use")


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives once built: the name
    carries a hash of its source, every header in csrc/ and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Build every library of ``names`` not built yet, one ``nvcc`` each,
    all started together; returns {name: library path}. Raises with the
    compiler's output when any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = [(name, path) for name, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path in todo:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{out.decode(errors='replace')}")
        else:
            os.replace(tmp, path)   # atomic: readers never see half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use;
    ``bind(lib)`` declares its functions' argtypes and restype once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            bind(lib)
            _loaded[name] = lib
        return lib
