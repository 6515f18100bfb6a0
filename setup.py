"""Wheel assembly with bundled native artifacts.

Parity: ref:src/python/library/build_wheel.py:113-150 + setup.py:82-86 —
the reference wheel carries the generated protos, the ctypes shm
libraries, and the perf_analyzer binary. Here the native tree
(native/CMakeLists.txt) is built with CMake during the wheel build when
a toolchain is present, and the resulting shared libraries + the native
perf_analyzer are packaged under ``client_tpu/_native`` (loadable via
``client_tpu._native.lib_path`` and runnable via the
``client-tpu-perf-native`` console script). Without a toolchain the
wheel is pure-Python — every data-plane feature still works (the Python
shm module is mmap-based by design).

The PyTorch port (``client_tpu_torch``) has a second, separate step:
where ``g++`` is present it builds the port's native tree
(``client_tpu_torch._native.bundle``: the client libraries, shared and
static, the CUDA-shm producer, perf_analyzer and the DIRECT libraries,
the card's where ``nvcc`` is) in a temporary directory and carries the
artifacts in ``client_tpu_torch/_native/bundled/`` with a stamp of their
sources. It writes nothing into the source tree. An installed port uses
a bundled artifact only while the stamp matches its sources, and builds
at first use otherwise.
"""

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py

ROOT = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(ROOT, "native")
NATIVE_BUILD = os.path.join(NATIVE, "build")
ARTIFACTS = (
    "libcshm_tpu.so",
    "libhttpclient_tpu.so",
    "libgrpcclient_tpu.so",
    "libdirect_models_tpu.so",  # dlopen'd by perf_analyzer -i direct
    "perf_analyzer",
)
PORT_BUNDLE = os.path.join("client_tpu_torch", "_native", "bundled")


class BuildPyWithNative(build_py):
    """build_py that first builds + stages the native artifacts."""

    def _build_native(self):
        if shutil.which("cmake") is None or shutil.which("g++") is None:
            print("client-tpu: no native toolchain; building a "
                  "pure-Python wheel")
            return []
        try:
            gen = ["-G", "Ninja"] if shutil.which("ninja") else []
            subprocess.run(["cmake", "-S", NATIVE, "-B", NATIVE_BUILD,
                            *gen], check=True)
            subprocess.run(["cmake", "--build", NATIVE_BUILD], check=True)
        except subprocess.CalledProcessError as e:
            print(f"client-tpu: native build failed ({e}); building a "
                  "pure-Python wheel")
            return []
        staged = []
        dest = os.path.join(ROOT, "client_tpu", "_native")
        os.makedirs(dest, exist_ok=True)
        for name in ARTIFACTS:
            src = os.path.join(NATIVE_BUILD, name)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(dest, name))
                staged.append(name)
        return staged

    def _bundle_port(self):
        """The port's step: its native artifacts into
        <build_lib>/client_tpu_torch/_native/bundled/."""
        if shutil.which("g++") is None:
            print("client-tpu-torch: g++ not found; the wheel carries the "
                  "native sources only")
            return []
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        from client_tpu_torch import _native

        dest = os.path.join(self.build_lib, PORT_BUNDLE)
        shutil.rmtree(dest, ignore_errors=True)
        with tempfile.TemporaryDirectory() as root:
            try:
                return _native.bundle(dest, root=Path(root))
            except RuntimeError as e:
                print(f"client-tpu-torch: native build failed ({e}); the "
                      "wheel carries the native sources only")
                shutil.rmtree(dest, ignore_errors=True)
                return []

    def run(self):
        staged = self._build_native()
        if staged:
            print(f"client-tpu: bundling native artifacts: {staged}")
        super().run()
        bundled = self._bundle_port()
        if bundled:
            print(f"client-tpu-torch: bundling native artifacts: {bundled}")


setup(cmdclass={"build_py": BuildPyWithNative})
