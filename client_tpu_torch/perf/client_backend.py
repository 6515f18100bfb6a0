"""Service-agnostic client backend seam for the perf analyzer: the port's
copy of ``client_tpu/perf/client_backend.py``.

Load managers and the profiler consume only this interface; each service
protocol plugs in underneath:

- ``http`` / ``grpc``: the port's v2 protocol clients
  (``client_tpu_torch.client``) over the network; ``grpc`` needs grpcio.
- ``inprocess``: drives a ``TorchInferenceServer`` object directly — the
  no-RPC measurement path ``bench.py``'s headline point runs on.
- ``tfserve`` / ``torchserve``: foreign services (``perf/foreign/``),
  TF-Serving's ``Predict`` over gRPC (needs grpcio and protobuf) and
  TorchServe's multipart upload over HTTP (the standard library only).
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Optional

import numpy as np

from client_tpu_torch.server.types import (
    InferRequest,
    InferTensor,
    RequestedOutput,
)
from client_tpu_torch.utils import InferenceServerException

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

    def copy(self) -> "ClientInferStat":
        c = ClientInferStat()
        c.__dict__.update(self.__dict__)
        return c


class ClientBackend:
    """Virtual interface (subset-by-default: unsupported verbs raise)."""

    kind: BackendKind
    # the backend's own count of successful inferences, kept by the
    # foreign backends (``_init_stat``); the load manager counts for all
    _stat: Optional["ClientInferStat"] = None

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

    def client_infer_stat(self) -> "ClientInferStat":
        """A copy of the backend's own count (empty where it keeps
        none)."""
        if self._stat is None:
            return ClientInferStat()
        with self._stat_lock:
            return self._stat.copy()

    def _record(self, start_ns: int, end_ns: int) -> None:
        with self._stat_lock:
            self._stat.completed_request_count += 1
            self._stat.cumulative_total_request_time_ns += end_ns - start_ns

    def _init_stat(self) -> None:
        self._stat = ClientInferStat()
        self._stat_lock = threading.Lock()


def _infer_kwargs(options: dict) -> dict:
    out = {}
    for k in ("model_version", "request_id", "sequence_id", "sequence_start",
              "sequence_end", "priority", "timeout", "parameters"):
        if k in options:
            out[k] = options[k]
    return out


class _NetBackendBase(ClientBackend):
    """Common code for the HTTP/GRPC network backends."""

    def __init__(self, client, headers: Optional[dict] = None):
        self._client = client
        self._headers = headers or None

    def _kwargs(self, options: dict) -> dict:
        """Per-call kwargs: standard options + the client-scoped -H
        headers (subclasses extend, e.g. HTTP compression)."""
        kw = _infer_kwargs(options)
        if self._headers:
            kw["headers"] = self._headers
        return kw

    def _hdr(self) -> dict:
        return {"headers": self._headers} if self._headers else {}

    def _convert(self, inputs, outputs):
        ins = []
        for i in inputs:
            x = self._mod.InferInput(i.name, i.shape, i.datatype)
            if i.shm:
                x.set_shared_memory(*i.shm)
            elif i.data is not None:
                x.set_data_from_numpy(i.data)
            ins.append(x)
        outs = None
        if outputs:
            outs = []
            for o in outputs:
                y = self._mod.InferRequestedOutput(
                    o.name, class_count=o.class_count)
                if o.shm:
                    y.set_shared_memory(*o.shm)
                outs.append(y)
        return ins, outs

    def server_extensions(self) -> list:
        return self._client.get_server_metadata(
            **self._hdr()).get("extensions", [])

    def model_metadata(self, name: str, version: str = "") -> dict:
        return self._client.get_model_metadata(name, version,
                                               **self._hdr())

    def model_config(self, name: str, version: str = "") -> dict:
        return self._client.get_model_config(name, version, **self._hdr())

    def model_inference_statistics(self, name: str = "",
                                   version: str = "") -> dict:
        return self._client.get_inference_statistics(name, version,
                                                     **self._hdr())

    def register_system_shared_memory(self, name, key, byte_size) -> None:
        self._client.register_system_shared_memory(name, key, byte_size)

    def register_cuda_shared_memory(self, name, raw_handle, device_id,
                                    byte_size) -> None:
        self._client.register_cuda_shared_memory(name, raw_handle,
                                                 device_id, byte_size)

    def unregister_all_shared_memory(self) -> None:
        self._client.unregister_system_shared_memory()
        self._client.unregister_cuda_shared_memory()

    def infer(self, model_name: str, inputs, outputs=None, **options):
        ins, outs = self._convert(inputs, outputs)
        return self._client.infer(model_name, ins, outputs=outs,
                                  **self._kwargs(options))

    def async_infer(self, callback, model_name: str, inputs, outputs=None,
                    **options) -> None:
        ins, outs = self._convert(inputs, outputs)
        self._client.async_infer(model_name, ins, callback, outputs=outs,
                                 **self._kwargs(options))

    def close(self) -> None:
        self._client.close()


class HttpBackend(_NetBackendBase):
    kind = BackendKind.HTTP

    def __init__(self, url: str, verbose: bool = False, concurrency: int = 8,
                 compression: Optional[str] = None,
                 headers: Optional[dict] = None,
                 retry_policy=None):
        from client_tpu_torch.client import http as httpclient

        self._mod = httpclient
        self._compression = compression
        super().__init__(httpclient.InferenceServerClient(
            url, verbose=verbose, concurrency=concurrency,
            retry_policy=retry_policy),
            headers=headers)

    def _kwargs(self, options: dict) -> dict:
        kw = super()._kwargs(options)
        if self._compression:
            kw["request_compression_algorithm"] = self._compression
            kw["response_compression_algorithm"] = self._compression
        return kw

    def server_metrics(self):
        from client_tpu_torch.server.metrics import parse_prometheus_text

        return parse_prometheus_text(
            self._client.get_server_metrics(**self._hdr()))

    def server_traces(self):
        # debug surface: absent (404) unless the server runs with
        # --debug-endpoints — the plane is optional, never an error
        try:
            return self._client.get_debug_traces(
                **self._hdr()).get("traces")
        except Exception:  # noqa: BLE001
            return None

    def server_incidents(self):
        # same opt-in gating as the trace plane
        try:
            return self._client.get_debug_incidents(**self._hdr())
        except Exception:  # noqa: BLE001
            return None


class GrpcBackend(_NetBackendBase):
    kind = BackendKind.GRPC

    def __init__(self, url: str, verbose: bool = False,
                 headers: Optional[dict] = None,
                 retry_policy=None):
        from client_tpu_torch.client import grpc as grpcclient

        self._mod = grpcclient
        super().__init__(grpcclient.InferenceServerClient(
            url, verbose=verbose, retry_policy=retry_policy),
            headers=headers)

    # the profiler consumes dicts; the gRPC client returns typed protos
    # unless asked for JSON
    def model_metadata(self, name: str, version: str = "") -> dict:
        return self._client.get_model_metadata(name, version, as_json=True,
                                               **self._hdr())

    def model_config(self, name: str, version: str = "") -> dict:
        # unwrap ModelConfigResponse {"config": {...}} so the parser sees
        # the same shape the HTTP endpoint returns
        cfg = self._client.get_model_config(name, version, as_json=True,
                                            **self._hdr())
        return cfg.get("config", cfg)

    def model_inference_statistics(self, name: str = "",
                                   version: str = "") -> dict:
        # bounded: a stats snapshot must never stall the measurement loop
        # (a worker-starved server turns a hang into a missing snapshot)
        return self._client.get_inference_statistics(name, version,
                                                     as_json=True,
                                                     timeout=30,
                                                     **self._hdr())

    def server_extensions(self) -> list:
        meta = self._client.get_server_metadata(as_json=True,
                                                **self._hdr())
        return meta.get("extensions", [])

    def server_metrics(self):
        from client_tpu_torch.server.metrics import parse_prometheus_text

        text = self._client.get_server_metrics(**self._hdr())
        return parse_prometheus_text(text) if text else None

    def server_traces(self):
        # mirrored through ServerMetadata trailing metadata; None when
        # the server runs without --debug-endpoints
        try:
            doc = self._client.get_debug_traces(**self._hdr())
        except Exception:  # noqa: BLE001
            return None
        return doc.get("traces") if doc else None

    def server_incidents(self):
        # mirrored through ServerMetadata trailing metadata; None when
        # the server runs without --debug-endpoints
        try:
            return self._client.get_debug_incidents(**self._hdr())
        except Exception:  # noqa: BLE001
            return None

    def start_stream(self, callback) -> None:
        self._client.start_stream(callback, **self._hdr())

    def async_stream_infer(self, model_name: str, inputs, outputs=None,
                           **options) -> None:
        ins, outs = self._convert(inputs, outputs)
        self._client.async_stream_infer(model_name, ins, outputs=outs,
                                        **_infer_kwargs(options))

    def stop_stream(self) -> None:
        self._client.stop_stream()


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
        req = InferRequest(
            model_name=model_name,
            model_version=options.get("model_version", ""),
            id=options.get("request_id", ""),
            inputs=ins, outputs=outs,
            sequence_id=options.get("sequence_id", 0),
            sequence_start=options.get("sequence_start", False),
            sequence_end=options.get("sequence_end", False),
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


def repository_server(model_repository: str):
    """A TorchInferenceServer over ``model_repository`` with every entry
    of its index loaded: the in-process backend's server when the CLI is
    given ``--service-kind cuda_direct --model-repository``."""
    from client_tpu_torch.server.core import TorchInferenceServer

    server = TorchInferenceServer(model_repository=model_repository)
    for entry in server.repository_index():
        if entry.get("state") != "READY":
            server.load_model(entry["name"])
    return server


class ClientBackendFactory:
    """Creates one backend per load worker."""

    def __init__(self, kind: BackendKind, url: str = "",
                 verbose: bool = False, server=None,
                 compression: Optional[str] = None,
                 http_concurrency: int = 8,
                 signature_name: str = "serving_default",
                 headers: Optional[dict] = None,
                 retry_policy=None):
        self.kind = kind
        self._url = url
        self._verbose = verbose
        self._server = server
        self._compression = compression
        self._http_concurrency = http_concurrency
        self._signature_name = signature_name
        self._headers = headers
        # ONE shared policy instance across every worker backend: its
        # thread-safe counters aggregate harness-wide, so the load
        # manager reads one number for the retried-request column
        self.retry_policy = retry_policy

    def create(self) -> ClientBackend:
        if self.kind == BackendKind.HTTP:
            return HttpBackend(self._url, self._verbose,
                               self._http_concurrency, self._compression,
                               headers=self._headers,
                               retry_policy=self.retry_policy)
        if self.kind == BackendKind.GRPC:
            return GrpcBackend(self._url, self._verbose,
                               headers=self._headers,
                               retry_policy=self.retry_policy)
        if self.kind == BackendKind.INPROCESS:
            if self._server is None:
                raise ValueError(
                    "the in-process backend needs a TorchInferenceServer "
                    "(server=; repository_server builds one from a model "
                    "repository)")
            return InProcessBackend(self._server)
        if self.kind == BackendKind.TFSERVE:
            from client_tpu_torch.perf.foreign import TfServeBackend

            return TfServeBackend(self._url, self._verbose,
                                  signature_name=self._signature_name)
        if self.kind == BackendKind.TORCHSERVE:
            from client_tpu_torch.perf.foreign import TorchServeBackend

            return TorchServeBackend(self._url, self._verbose)
        raise ValueError(f"unknown backend kind {self.kind}")
