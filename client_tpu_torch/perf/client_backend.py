"""Service-agnostic client backend seam for the perf analyzer: the port's
copy of ``client_tpu/perf/client_backend.py``.

Load managers and the profiler consume only this interface; each service
protocol plugs in underneath. The port has one backend so far:

- ``inprocess``: drives a ``TorchInferenceServer`` object directly — the
  no-RPC measurement path ``bench.py``'s headline point runs on.

The network (``http``, ``grpc``) and foreign (``tfserve``,
``torchserve``) kinds need the port's client library and raise
``NotImplementedError`` naming its ROADMAP item (A17).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np

from client_tpu_torch.server.types import (
    InferRequest,
    InferTensor,
    RequestedOutput,
)
from client_tpu_torch.utils import InferenceServerException

UNPORTED_KIND = ("the {kind} backend needs the port's client library, "
                 "which is not ported yet (ROADMAP A17)")


class BackendKind(enum.Enum):
    HTTP = "http"
    GRPC = "grpc"
    INPROCESS = "inprocess"
    TFSERVE = "tfserve"
    TORCHSERVE = "torchserve"


class PerfInput:
    """Backend-neutral input tensor descriptor."""

    def __init__(self, name: str, shape, datatype: str):
        self.name = name
        self.shape = list(shape)
        self.datatype = datatype
        self.data: Optional[np.ndarray] = None
        self.shm: Optional[tuple] = None  # (region, byte_size, offset)

    def set_data_from_numpy(self, arr: np.ndarray) -> None:
        self.data = arr
        self.shm = None

    def set_shared_memory(self, region: str, byte_size: int,
                          offset: int = 0) -> None:
        self.shm = (region, byte_size, offset)
        self.data = None


class PerfRequestedOutput:
    def __init__(self, name: str, class_count: int = 0):
        self.name = name
        self.class_count = class_count
        self.shm: Optional[tuple] = None

    def set_shared_memory(self, region: str, byte_size: int,
                          offset: int = 0) -> None:
        self.shm = (region, byte_size, offset)


class ClientInferStat:
    """Client-side aggregate of completed requests."""

    def __init__(self):
        self.completed_request_count = 0
        self.cumulative_total_request_time_ns = 0
        # admission-control sheds observed by this client (503s counted
        # and survived by the load workers, not worker-fatal)
        self.rejected_request_count = 0
        # retry-policy sleeps taken before an eventually-delivered answer
        # (kept separate from rejects)
        self.retried_request_count = 0


class ClientBackend:
    """Virtual interface (subset-by-default: unsupported verbs raise)."""

    kind: BackendKind

    def server_extensions(self) -> list:
        raise NotImplementedError

    def model_metadata(self, name: str, version: str = "") -> dict:
        raise NotImplementedError

    def model_config(self, name: str, version: str = "") -> dict:
        raise NotImplementedError

    def infer(self, model_name: str, inputs, outputs=None, **options):
        raise NotImplementedError

    def async_infer(self, callback: Callable, model_name: str, inputs,
                    outputs=None, **options) -> None:
        raise NotImplementedError

    def start_stream(self, callback: Callable) -> None:
        raise NotImplementedError("streaming not supported by this backend")

    def async_stream_infer(self, model_name: str, inputs, outputs=None,
                           **options) -> None:
        raise NotImplementedError("streaming not supported by this backend")

    def stop_stream(self) -> None:
        pass

    def model_inference_statistics(self, name: str = "",
                                   version: str = "") -> dict:
        raise NotImplementedError

    def server_metrics(self):
        """Parsed /metrics scrape (``metrics.parse_prometheus_text``) or
        None when the service exposes no Prometheus plane."""
        return None

    def server_traces(self):
        """Completed server-side request traces (``Trace.to_json`` dicts)
        or None when the service exposes no trace plane: the spans the
        profiler joins by trace id with its client-observed window for the
        slowest-request breakdown."""
        return None

    def server_incidents(self):
        """Watchdog incident bundles (the ``core.debug_incidents()``
        document) or None when the service exposes no incident plane: the
        evidence the profiler's ``fail_on_incident`` gate names."""
        return None

    # shared-memory verbs
    def register_system_shared_memory(self, name, key, byte_size) -> None:
        raise NotImplementedError("system shm not supported by this backend")

    def register_cuda_shared_memory(self, name, raw_handle, device_id,
                                    byte_size) -> None:
        raise NotImplementedError("cuda shm not supported by this backend")

    def unregister_all_shared_memory(self) -> None:
        pass

    def close(self) -> None:
        pass


class InProcessBackend(ClientBackend):
    """No-RPC path: drives a TorchInferenceServer instance in this
    process (no network in the measurement path)."""

    kind = BackendKind.INPROCESS

    def __init__(self, server):
        self._server = server
        # request-template cache: the load managers reuse their (cached)
        # input/output descriptor lists for every request, so the internal
        # InferRequest can be built once and reused — the per-request
        # construction cost matters at thousands of requests per second on
        # a small host. Values hold strong refs to the descriptor lists so
        # the id() keys can't be recycled.
        self._req_cache: dict = {}

    def server_extensions(self) -> list:
        return self._server.metadata().get("extensions", [])

    def model_metadata(self, name: str, version: str = "") -> dict:
        return self._server.model_metadata(name, version)

    def model_config(self, name: str, version: str = "") -> dict:
        return self._server.model_config(name, version)

    def model_inference_statistics(self, name: str = "",
                                   version: str = "") -> dict:
        return self._server.statistics(name, version)

    def server_metrics(self):
        from client_tpu_torch.server.metrics import parse_prometheus_text

        return parse_prometheus_text(self._server.metrics_text())

    def server_traces(self):
        return self._server.debug_traces().get("traces")

    def server_incidents(self):
        return self._server.debug_incidents()

    def _build_request(self, model_name, inputs, outputs, options):
        cache_key = fp = None
        if not options:
            cache_key = (model_name, id(inputs), id(outputs))
            # fingerprint guards against in-place descriptor mutation
            # (set_data_from_numpy / set_shared_memory rebind fields
            # without changing the list identity)
            fp = tuple((id(i.data), i.shm) for i in inputs)
            hit = self._req_cache.get(cache_key)
            if hit is not None and hit[0] is inputs and hit[1] is outputs \
                    and hit[3] == fp:
                return hit[2]
        ins = []
        for i in inputs:
            t = InferTensor(i.name, i.datatype, tuple(i.shape))
            if i.shm:
                t.shm_region, t.shm_byte_size, t.shm_offset = (
                    i.shm[0], i.shm[1], i.shm[2])
            else:
                t.data = i.data
            ins.append(t)
        outs = []
        for o in (outputs or []):
            r = RequestedOutput(o.name, classification_count=o.class_count)
            if o.shm:
                r.shm_region, r.shm_byte_size, r.shm_offset = (
                    o.shm[0], o.shm[1], o.shm[2])
            outs.append(r)
        unported = sorted(k for k in options
                          if k.startswith("sequence_") and options[k])
        if unported:
            raise NotImplementedError(
                f"sequence options {unported}: the port's server has no "
                "sequence batcher yet")
        req = InferRequest(
            model_name=model_name,
            model_version=options.get("model_version", ""),
            id=options.get("request_id", ""),
            inputs=ins, outputs=outs,
            priority=options.get("priority", 0),
            timeout_us=options.get("timeout", 0))
        if cache_key is not None:
            # without descriptor reuse (non-shm mode) every request brings
            # fresh ids — bound the cache so it cannot pin arrays forever
            if len(self._req_cache) >= 64:
                self._req_cache.clear()
            self._req_cache[cache_key] = (inputs, outputs, req, fp)
        return req

    def infer(self, model_name: str, inputs, outputs=None, **options):
        return self._server.infer(
            self._build_request(model_name, inputs, outputs, options))

    def async_infer(self, callback, model_name: str, inputs, outputs=None,
                    **options) -> None:
        req = self._build_request(model_name, inputs, outputs, options)

        def sink(resp, final):
            if final:
                err = None
                if resp.error is not None:
                    err = InferenceServerException(resp.error)
                    resp = None
                callback(resp, err)

        self._server.infer(req, response_callback=sink)

    def register_system_shared_memory(self, name, key, byte_size) -> None:
        self._server.system_shm.register(name, key, 0, byte_size)

    def register_cuda_shared_memory(self, name, raw_handle, device_id,
                                    byte_size) -> None:
        self._server.cuda_shm.register(name, raw_handle, device_id,
                                       byte_size)

    def unregister_all_shared_memory(self) -> None:
        self._server.system_shm.unregister_all()
        self._server.cuda_shm.unregister_all()


class ClientBackendFactory:
    """Creates one backend per load worker."""

    def __init__(self, kind: BackendKind, server=None):
        self.kind = kind
        self._server = server
        # no retry policy without the client library; the load manager
        # reads this attribute for the retried-request column
        self.retry_policy = None

    def create(self) -> ClientBackend:
        if self.kind == BackendKind.INPROCESS:
            if self._server is None:
                raise ValueError(
                    "the in-process backend needs a TorchInferenceServer "
                    "(server=); loading a model repository is not ported "
                    "yet")
            return InProcessBackend(self._server)
        if self.kind in (BackendKind.HTTP, BackendKind.GRPC,
                         BackendKind.TFSERVE, BackendKind.TORCHSERVE):
            raise NotImplementedError(UNPORTED_KIND.format(
                kind=self.kind.value))
        raise ValueError(f"unknown backend kind {self.kind}")
