"""ctypes access to a DIRECT model library (``direct_model_api.h``).

The port builds two: ``libdirect_models_cpu.so`` (the models computed on
the host, the plain version) and ``libdirect_models_cuda.so`` (the same
models through hand-written kernels on the card, which also exports its
kernels' launch counts). ``perf_analyzer -i direct`` drives either one;
this module calls them from Python, as the tests and ``chip_smoke.py``
do to hold one against the other.

    lib = DirectLibrary(_native.lib_path("libdirect_models_cpu.so"))
    with lib.model("add_sub") as m:
        out = m.infer({"INPUT0": a, "INPUT1": b})   # {"OUTPUT0": ..., ...}
"""

from __future__ import annotations

import ctypes
import json

import numpy as np

_DTYPES = {"INT32": np.int32, "FP32": np.float32}
_c = ctypes
_P = _c.POINTER


class DirectLibrary:
    def __init__(self, path):
        self.path = str(path)
        lib = self.lib = _c.CDLL(self.path)
        lib.DirectApiVersion.restype = _c.c_int
        lib.DirectModelCreate.argtypes = [_c.c_char_p, _P(_c.c_void_p),
                                          _P(_c.c_char_p)]
        lib.DirectModelDestroy.argtypes = [_c.c_void_p]
        for fn in (lib.DirectModelMetadataJson, lib.DirectModelStatsJson):
            fn.argtypes = [_c.c_void_p]
            fn.restype = _c.c_void_p     # malloc'd: freed by DirectStringFree
        lib.DirectStringFree.argtypes = [_c.c_void_p]
        lib.DirectModelInfer.argtypes = [
            _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_size_t,
            _P(_c.c_void_p), _P(_c.c_char_p)]
        lib.DirectResultOutputCount.argtypes = [_c.c_void_p]
        lib.DirectResultOutputCount.restype = _c.c_size_t
        for fn in (lib.DirectResultOutputName,
                   lib.DirectResultOutputDatatype):
            fn.argtypes = [_c.c_void_p, _c.c_size_t]
            fn.restype = _c.c_char_p
        lib.DirectResultOutputData.argtypes = [_c.c_void_p, _c.c_size_t,
                                               _P(_c.c_size_t)]
        lib.DirectResultOutputData.restype = _c.c_void_p
        lib.DirectResultDestroy.argtypes = [_c.c_void_p]
        self.has_launch_counts = hasattr(lib, "DirectCudaLaunches")
        if self.has_launch_counts:
            lib.DirectCudaLaunches.argtypes = [_c.c_char_p]
            lib.DirectCudaLaunches.restype = _c.c_uint64

    def version(self) -> int:
        return self.lib.DirectApiVersion()

    def launches(self, kernel: str = "") -> int:
        """The card library's launch count of ``kernel`` ("add_sub",
        "copy"; "" for both)."""
        return int(self.lib.DirectCudaLaunches(kernel.encode()))

    def model(self, name: str) -> "DirectModel":
        handle = _c.c_void_p()
        err = _c.c_char_p()
        if self.lib.DirectModelCreate(name.encode(), _c.byref(handle),
                                      _c.byref(err)) != 0:
            raise RuntimeError(f"{self.path}: {err.value.decode()}")
        return DirectModel(self, handle)


class DirectModel:
    def __init__(self, owner: DirectLibrary, handle):
        self.owner, self.handle = owner, handle

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self.handle:
            self.owner.lib.DirectModelDestroy(self.handle)
            self.handle = None

    def _json(self, fn) -> dict:
        p = fn(self.handle)
        try:
            return json.loads(_c.string_at(p).decode())
        finally:
            self.owner.lib.DirectStringFree(p)

    def metadata(self) -> dict:
        return self._json(self.owner.lib.DirectModelMetadataJson)

    def stats(self) -> dict:
        """The model's v2 statistics (``model_stats[0]``)."""
        return self._json(self.owner.lib.DirectModelStatsJson)[
            "model_stats"][0]

    def infer(self, inputs: dict) -> dict:
        """One DirectModelInfer; {output name: array (a copy)}."""
        lib = self.owner.lib
        arrays = {k: np.ascontiguousarray(v) for k, v in inputs.items()}
        n = len(arrays)
        names = (_c.c_char_p * n)(*[k.encode() for k in arrays])
        datas = (_c.c_void_p * n)(*[a.ctypes.data for a in arrays.values()])
        sizes = (_c.c_size_t * n)(*[a.nbytes for a in arrays.values()])
        result = _c.c_void_p()
        err = _c.c_char_p()
        if lib.DirectModelInfer(self.handle, names, datas, sizes, n,
                                _c.byref(result), _c.byref(err)) != 0:
            raise RuntimeError(err.value.decode())
        try:
            out = {}
            for i in range(lib.DirectResultOutputCount(result)):
                size = _c.c_size_t()
                p = lib.DirectResultOutputData(result, i, _c.byref(size))
                dtype = _DTYPES[lib.DirectResultOutputDatatype(
                    result, i).decode()]
                out[lib.DirectResultOutputName(result, i).decode()] = \
                    np.frombuffer(_c.string_at(p, size.value), dtype)
            return out
        finally:
            lib.DirectResultDestroy(result)
