"""HTTP/REST InferenceServerClient: the port's copy of
``client_tpu/client/http.py``.

The ``tritonclient.http`` surface: InferenceServerClient with the full
control plane, infer/async_infer, static generate_request_body /
parse_response_body, InferInput.set_data_from_numpy (binary and JSON
paths), InferResult with lazy binary slicing, request/response gzip and
deflate. Device regions register through the CUDA shared-memory verbs
(``register_cuda_shared_memory`` with a handle of
``client_tpu_torch.utils.cuda_shared_memory``), and
InferInput.set_data_from_torch copies a tensor to the host and sends it
binary. The TPU verbs stay for API compatibility, as the reference keeps
the CUDA ones: the port's server answers them with 400.

Transport: stdlib http.client over a keep-alive connection pool sized by
``concurrency``. Threads come from a shared executor for async_infer.
The module imports neither torch nor grpc.
"""

from __future__ import annotations

import base64
import gzip
import http.client
import json
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import quote

import numpy as np

from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.protocol.rest import (
    INFERENCE_HEADER_CONTENT_LENGTH,
    build_infer_request_body,
    parse_infer_response_body,
    slice_binary_tensors,
    tensor_from_json,
    tensor_json_and_blob,
)
from client_tpu_torch.utils import InferenceServerException, raise_error


class InferInput:
    """Describes one request input tensor (set_data_from_numpy binary or
    JSON, set_data_from_torch, set_shared_memory)."""

    def __init__(self, name: str, shape, datatype: str):
        self._name = name
        self._shape = [int(d) for d in shape]
        self._datatype = datatype
        self._parameters: dict = {}
        self._tensor: np.ndarray | None = None
        self._binary = True
        self._raw: bytes | None = None

    def name(self) -> str:
        return self._name

    def datatype(self) -> str:
        return self._datatype

    def shape(self):
        return self._shape

    def set_shape(self, shape) -> None:
        self._shape = [int(d) for d in shape]

    def set_data_from_numpy(self, input_tensor: np.ndarray,
                            binary_data: bool = True) -> "InferInput":
        if not isinstance(input_tensor, np.ndarray):
            raise_error("input tensor must be a numpy array")
        dtype = np_to_wire_dtype(input_tensor.dtype)
        if dtype != self._datatype:
            raise_error(
                f"got unexpected datatype {dtype} from numpy array; "
                f"expected {self._datatype}")
        expected = tuple(self._shape)
        if tuple(input_tensor.shape) != expected:
            raise_error(
                f"got unexpected numpy array shape "
                f"{list(input_tensor.shape)}; expected {self._shape}")
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        self._tensor = input_tensor
        self._binary = binary_data
        self._raw = None
        return self

    def set_data_from_torch(self, tensor) -> "InferInput":
        """A torch tensor on any device: copied to the host and sent
        binary (bf16 as its raw bytes, so no numpy bf16 type is needed)."""
        from client_tpu_torch.device import tensor_bytes, wire_dtype_of

        dtype = wire_dtype_of(tensor)
        if dtype != self._datatype:
            raise_error(
                f"got unexpected datatype {dtype} from torch tensor; "
                f"expected {self._datatype}")
        if tuple(tensor.shape) != tuple(self._shape):
            raise_error(
                f"got unexpected torch tensor shape {list(tensor.shape)}; "
                f"expected {self._shape}")
        for k in ("shared_memory_region", "shared_memory_byte_size",
                  "shared_memory_offset"):
            self._parameters.pop(k, None)
        self._tensor = np.frombuffer(tensor_bytes(tensor), np.uint8)
        self._binary = True
        self._raw = None
        return self

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0) -> "InferInput":
        """Reference the tensor data inside a registered shm region
        (system or TPU). Parity: ref http/__init__.py:1739."""
        self._tensor = None
        self._raw = None
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = int(byte_size)
        self._parameters["shared_memory_offset"] = int(offset)
        return self

    def _to_json_and_blob(self):
        if "shared_memory_region" in self._parameters:
            tj = {"name": self._name, "shape": self._shape,
                  "datatype": self._datatype,
                  "parameters": dict(self._parameters)}
            return tj, None
        if self._tensor is None:
            raise_error(f"input {self._name!r} has no data; call "
                        "set_data_from_numpy or set_shared_memory")
        return tensor_json_and_blob(self._name, self._tensor, self._datatype,
                                    self._shape, self._binary,
                                    self._parameters or None)


class InferRequestedOutput:
    """Describes one requested output (binary_data, class_count, shared
    memory binding)."""

    def __init__(self, name: str, binary_data: bool = True,
                 class_count: int = 0):
        self._name = name
        self._parameters: dict = {}
        if binary_data:
            self._parameters["binary_data"] = True
        else:
            self._parameters["binary_data"] = False
        if class_count:
            self._parameters["classification"] = int(class_count)

    def name(self) -> str:
        return self._name

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0) -> "InferRequestedOutput":
        self._parameters.pop("binary_data", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = int(byte_size)
        self._parameters["shared_memory_offset"] = int(offset)
        return self

    def unset_shared_memory(self) -> "InferRequestedOutput":
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        self._parameters.setdefault("binary_data", True)
        return self

    def _to_json(self):
        j = {"name": self._name}
        if self._parameters:
            j["parameters"] = dict(self._parameters)
        return j


class InferResult:
    """Inference response: lazy access to outputs by name (as_numpy over
    the binary offset map, get_output, get_response,
    from_response_body)."""

    def __init__(self, header: dict, binary_map: dict):
        self._header = header
        self._binary_map = binary_map

    @classmethod
    def from_response_body(cls, response_body: bytes,
                           header_length: int | None = None,
                           content_encoding: str | None = None) -> "InferResult":
        body = response_body
        if content_encoding == "gzip":
            body = gzip.decompress(body)
        elif content_encoding == "deflate":
            body = zlib.decompress(body)
        header, tail = parse_infer_response_body(body, header_length)
        if "error" in header and header.get("error"):
            raise InferenceServerException(header["error"])
        binmap = slice_binary_tensors(header.get("outputs", []), tail)
        return cls(header, binmap)

    def get_response(self) -> dict:
        return self._header

    def get_output(self, name: str):
        for o in self._header.get("outputs", []):
            if o["name"] == name:
                return o
        return None

    def as_numpy(self, name: str):
        o = self.get_output(name)
        if o is None:
            return None
        if "shared_memory_region" in (o.get("parameters") or {}):
            return None  # data lives in shm; read it via the shm module
        arr = tensor_from_json(o, self._binary_map)
        if arr.dtype == np.object_:
            return arr
        return arr


class InferAsyncRequest:
    """Handle returned by async_infer; get_result() joins the worker."""

    def __init__(self, future, verbose: bool = False):
        self._future = future
        self._verbose = verbose

    def get_result(self, block: bool = True, timeout: float | None = None):
        if not block and not self._future.done():
            raise_error("timeout: the request is not completed yet")
        result = self._future.result(timeout=timeout)
        if isinstance(result, Exception):
            raise result
        return result


class _ConnectionPool:
    """Keep-alive HTTP(S)Connection pool, one connection checked out per
    call."""

    def __init__(self, host: str, port: int, size: int,
                 network_timeout: float, ssl_context=None):
        self._host, self._port = host, port
        self._timeout = network_timeout
        self._ssl_context = ssl_context
        self._q: queue.Queue = queue.Queue()
        self._size = size
        self._created = 0
        self._lock = threading.Lock()

    def _new_conn(self):
        if self._ssl_context is not None:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=self._timeout,
                context=self._ssl_context)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=self._timeout)

    def acquire(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            with self._lock:
                if self._created < self._size:
                    self._created += 1
                    return self._new_conn()
            return self._q.get()

    def release(self, conn, broken: bool = False):
        if broken:
            try:
                conn.close()
            finally:
                self._q.put(self._new_conn())
        else:
            self._q.put(conn)

    def close(self):
        while True:
            try:
                self._q.get_nowait().close()
            except queue.Empty:
                break


class InferenceServerClient:
    """HTTP client for the v2 protocol (ctor with concurrency, verbose,
    timeouts and TLS; every control-plane verb; infer/async_infer)."""

    def __init__(self, url: str, verbose: bool = False, concurrency: int = 1,
                 connection_timeout: float = 60.0,
                 network_timeout: float = 60.0, ssl: bool = False,
                 ssl_options: dict | None = None,
                 ssl_context_factory=None,
                 insecure: bool = False,
                 retry_policy=None,
                 **_ignored):
        """``retry_policy`` (a ``client_tpu_torch.client.retry.RetryPolicy``,
        default None = fail-fast): retry ``infer`` /
        ``async_infer`` on retryable statuses (502/503 by default)
        with exponential backoff + full jitter, honoring the server's
        ``Retry-After`` header as a floor. Non-streaming calls only —
        there is no HTTP streaming surface, and control-plane verbs
        stay fail-fast so health probes report what they saw."""
        context = None
        if url.startswith("https://"):
            ssl = True
        if ssl:
            # ssl_options (ca_certs, certfile, keyfile, password),
            # ssl_context_factory and insecure, as tritonclient.http
            if ssl_context_factory is not None:
                context = ssl_context_factory()
            else:
                import ssl as ssl_mod

                context = ssl_mod.create_default_context()
                opts = ssl_options or {}
                if opts.get("ca_certs"):
                    context.load_verify_locations(cafile=opts["ca_certs"])
                if opts.get("certfile"):
                    context.load_cert_chain(
                        certfile=opts["certfile"],
                        keyfile=opts.get("keyfile"),
                        password=opts.get("password"))
            if insecure:
                import ssl as ssl_mod

                context.check_hostname = False
                context.verify_mode = ssl_mod.CERT_NONE
        if "://" in url:
            url = url.split("://", 1)[1]
        host, _, port = url.partition(":")
        self._host = host
        self._port = int(port or (443 if ssl else 80))
        self._verbose = verbose
        self._pool = _ConnectionPool(self._host, self._port,
                                     max(1, concurrency), network_timeout,
                                     ssl_context=context)
        self._executor = ThreadPoolExecutor(max_workers=max(1, concurrency))
        self._retry_policy = retry_policy
        self._closed = False

    # ---- low-level ----

    def _request(self, method: str, path: str, body: bytes = b"",
                 headers: dict | None = None) -> tuple:
        """Returns (status, response_headers, body_bytes)."""
        hdrs = {"Connection": "keep-alive"}
        if headers:
            hdrs.update(headers)
        # A pooled keep-alive connection may have been closed by the
        # server while idle; the failure surfaces as RemoteDisconnected /
        # reset on the NEXT request. Retry once on a fresh connection (the
        # stale-socket policy urllib3 has too). A failure on a brand-new
        # connection is reported as-is.
        while True:
            conn = self._pool.acquire()
            fresh = getattr(conn, "_ever_used", False) is False
            conn._ever_used = True  # noqa: SLF001 — pool-private marker
            try:
                conn.request(method, path, body=body if body else None,
                             headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                self._pool.release(conn)
                if self._verbose:
                    print(f"{method} {path} -> {resp.status} "
                          f"({len(data)}B)")
                return resp.status, dict(resp.getheaders()), data
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError):
                self._pool.release(conn, broken=True)
                # every pooled connection may be stale after a server
                # idle sweep; only a failure on a NEVER-used connection
                # is a real transport error (pool replaces broken conns
                # with fresh ones, so this terminates)
                if fresh:
                    raise
            except Exception:
                self._pool.release(conn, broken=True)
                raise

    @staticmethod
    def _decode(headers: dict, data: bytes) -> bytes:
        enc = (headers.get("Content-Encoding") or "").lower()
        if enc == "gzip":
            return gzip.decompress(data)
        if enc == "deflate":
            return zlib.decompress(data)
        return data

    @staticmethod
    def _qs(path: str, query_params: dict | None) -> str:
        if not query_params:
            return path
        from urllib.parse import urlencode

        return path + "?" + urlencode(query_params, doseq=True)

    def _get_json(self, path: str, headers=None, query_params=None):
        status, rhdrs, data = self._request(
            "GET", self._qs(path, query_params), headers=headers)
        data = self._decode(rhdrs, data)
        if status != 200:
            raise InferenceServerException(_error_of(data), str(status))
        return json.loads(data) if data else {}

    def _post_json(self, path: str, obj=None, headers=None,
                   query_params=None):
        body = json.dumps(obj).encode() if obj is not None else b""
        status, rhdrs, data = self._request(
            "POST", self._qs(path, query_params), body, headers=headers)
        data = self._decode(rhdrs, data)
        if status != 200:
            raise InferenceServerException(_error_of(data), str(status))
        return json.loads(data) if data else {}

    # ---- health / metadata ----

    def is_server_live(self, headers=None, query_params=None) -> bool:
        status, _, _ = self._request(
            "GET", self._qs("/v2/health/live", query_params), headers=headers)
        return status == 200

    def is_server_ready(self, headers=None, query_params=None) -> bool:
        status, _, _ = self._request(
            "GET", self._qs("/v2/health/ready", query_params),
            headers=headers)
        return status == 200

    def is_model_ready(self, model_name: str, model_version: str = "",
                       headers=None, query_params=None) -> bool:
        path = _model_path(model_name, model_version) + "/ready"
        status, _, _ = self._request("GET", self._qs(path, query_params),
                                     headers=headers)
        return status == 200

    def get_server_metadata(self, headers=None, query_params=None) -> dict:
        return self._get_json("/v2", headers, query_params)

    def get_model_metadata(self, model_name: str, model_version: str = "",
                           headers=None, query_params=None) -> dict:
        return self._get_json(_model_path(model_name, model_version),
                              headers, query_params)

    def get_model_config(self, model_name: str, model_version: str = "",
                         headers=None, query_params=None) -> dict:
        return self._get_json(_model_path(model_name, model_version)
                              + "/config", headers, query_params)

    # ---- repository ----

    def get_model_repository_index(self, headers=None,
                                   query_params=None) -> list:
        return self._post_json("/v2/repository/index", {}, headers,
                               query_params)

    def load_model(self, model_name: str, headers=None, config: str = None,
                   files: dict = None, query_params=None) -> None:
        if files:
            raise_error("file-content overrides are not supported; models "
                        "load from the repository or registered factories")
        body: dict = {}
        if config is not None:
            body.setdefault("parameters", {})["config"] = config
        self._post_json(f"/v2/repository/models/{quote(model_name)}/load",
                        body, headers, query_params)

    def unload_model(self, model_name: str, headers=None,
                     unload_dependents: bool = False,
                     query_params=None) -> None:
        body = {"parameters": {"unload_dependents": unload_dependents}}
        self._post_json(f"/v2/repository/models/{quote(model_name)}/unload",
                        body, headers, query_params)

    # ---- statistics / trace ----

    def get_inference_statistics(self, model_name: str = "",
                                 model_version: str = "",
                                 headers=None, query_params=None) -> dict:
        if model_name:
            path = _model_path(model_name, model_version) + "/stats"
        else:
            path = "/v2/models/stats"
        return self._get_json(path, headers, query_params)

    def get_server_metrics(self, headers=None, query_params=None) -> str:
        """Scrape GET /metrics (Prometheus text exposition format)."""
        status, rhdrs, data = self._request(
            "GET", self._qs("/metrics", query_params), headers=headers)
        data = self._decode(rhdrs, data)
        if status != 200:
            raise InferenceServerException(_error_of(data), str(status))
        return data.decode("utf-8", errors="replace")

    def get_trace_settings(self, model_name: str = None, headers=None,
                           query_params=None) -> dict:
        if model_name:
            return self._get_json(
                f"/v2/models/{quote(model_name)}/trace/setting",
                headers, query_params)
        return self._get_json("/v2/trace/setting", headers, query_params)

    def update_trace_settings(self, model_name: str = None,
                              settings: dict = None, headers=None,
                              query_params=None) -> dict:
        path = (f"/v2/models/{quote(model_name)}/trace/setting"
                if model_name else "/v2/trace/setting")
        return self._post_json(path, settings or {}, headers, query_params)

    def get_debug_traces(self, model_name: str = None, headers=None,
                         query_params=None) -> dict:
        """Completed request traces from the server's opt-in debug
        surface (GET /v2/debug/traces — 404 unless the server runs
        with --debug-endpoints)."""
        qp = dict(query_params or {})
        if model_name:
            qp["model"] = model_name
        return self._get_json("/v2/debug/traces", headers, qp or None)

    def get_debug_incidents(self, headers=None, query_params=None) -> dict:
        """Watchdog incident bundles from the server's opt-in debug
        surface (GET /v2/debug/incidents — 404 unless the server runs
        with --debug-endpoints)."""
        return self._get_json("/v2/debug/incidents", headers, query_params)

    # ---- shared memory ----

    def get_system_shared_memory_status(self, region_name: str = "",
                                        headers=None, query_params=None):
        if region_name:
            return self._get_json(
                f"/v2/systemsharedmemory/region/{quote(region_name)}/status",
                headers, query_params)
        return self._get_json("/v2/systemsharedmemory/status", headers,
                              query_params)

    def register_system_shared_memory(self, name: str, key: str,
                                      byte_size: int, offset: int = 0,
                                      headers=None,
                                      query_params=None) -> None:
        self._post_json(
            f"/v2/systemsharedmemory/region/{quote(name)}/register",
            {"key": key, "offset": offset, "byte_size": byte_size},
            headers, query_params)

    def unregister_system_shared_memory(self, name: str = "", headers=None,
                                        query_params=None) -> None:
        if name:
            self._post_json(
                f"/v2/systemsharedmemory/region/{quote(name)}/unregister",
                {}, headers, query_params)
        else:
            self._post_json("/v2/systemsharedmemory/unregister", {},
                            headers, query_params)

    # TPU verbs exist for API compatibility; the port's server answers
    # them with 400 (it serves CUDA regions)
    def get_tpu_shared_memory_status(self, region_name: str = "",
                                     headers=None, query_params=None):
        if region_name:
            return self._get_json(
                f"/v2/tpusharedmemory/region/{quote(region_name)}/status",
                headers, query_params)
        return self._get_json("/v2/tpusharedmemory/status", headers,
                              query_params)

    def register_tpu_shared_memory(self, name: str, raw_handle: bytes,
                                   device_id: int, byte_size: int,
                                   headers=None, query_params=None) -> None:
        """Register a TPU shm region by its raw handle (the JAX package's
        device verb; the port's server refuses it)."""
        self._post_json(
            f"/v2/tpusharedmemory/region/{quote(name)}/register",
            {"raw_handle": {"b64": base64.b64encode(raw_handle).decode()},
             "device_id": device_id, "byte_size": byte_size},
            headers, query_params)

    def unregister_tpu_shared_memory(self, name: str = "", headers=None,
                                     query_params=None) -> None:
        if name:
            self._post_json(
                f"/v2/tpusharedmemory/region/{quote(name)}/unregister", {},
                headers, query_params)
        else:
            self._post_json("/v2/tpusharedmemory/unregister", {}, headers,
                            query_params)

    # the device regions of the port (client_tpu_torch.utils.
    # cuda_shared_memory): the raw handle is get_raw_handle's token
    def get_cuda_shared_memory_status(self, region_name: str = "",
                                      headers=None, query_params=None):
        if region_name:
            return self._get_json(
                f"/v2/cudasharedmemory/region/{quote(region_name)}/status",
                headers, query_params)
        return self._get_json("/v2/cudasharedmemory/status", headers,
                              query_params)

    def register_cuda_shared_memory(self, name, raw_handle, device_id,
                                    byte_size, headers=None,
                                    query_params=None):
        return self._post_json(
            f"/v2/cudasharedmemory/region/{quote(name)}/register",
            {"raw_handle": {"b64": base64.b64encode(raw_handle).decode()},
             "device_id": device_id, "byte_size": byte_size},
            headers, query_params)

    def unregister_cuda_shared_memory(self, name: str = "", headers=None,
                                      query_params=None):
        path = (f"/v2/cudasharedmemory/region/{quote(name)}/unregister"
                if name else "/v2/cudasharedmemory/unregister")
        return self._post_json(path, {}, headers, query_params)

    # ---- infer ----

    @staticmethod
    def generate_request_body(inputs, outputs=None, request_id: str = "",
                              sequence_id=0, sequence_start: bool = False,
                              sequence_end: bool = False, priority: int = 0,
                              timeout: int = 0, parameters: dict = None):
        """Build (body_bytes, json_size_or_None) without sending."""
        header: dict = {}
        if request_id:
            header["id"] = request_id
        params = dict(parameters or {})
        if sequence_id:
            params["sequence_id"] = sequence_id
            params["sequence_start"] = sequence_start
            params["sequence_end"] = sequence_end
        if priority:
            params["priority"] = priority
        if timeout:
            params["timeout"] = timeout
        tjs, blobs = [], []
        for i in inputs:
            tj, blob = i._to_json_and_blob()
            tjs.append(tj)
            if blob is not None:
                blobs.append(blob)
        header["inputs"] = tjs
        if outputs is not None:
            header["outputs"] = [o._to_json() for o in outputs]
        else:
            params["binary_data_output"] = True
        if params:
            header["parameters"] = params
        body, json_size = build_infer_request_body(header, blobs)
        return body, (json_size if blobs else None)

    @staticmethod
    def parse_response_body(response_body: bytes,
                            verbose: bool = False,
                            header_length: int | None = None,
                            content_encoding: str | None = None):
        """An InferResult from a response body (decompressed first when
        ``content_encoding`` names gzip or deflate)."""
        return InferResult.from_response_body(response_body, header_length,
                                              content_encoding)

    def infer(self, model_name: str, inputs, model_version: str = "",
              outputs=None, request_id: str = "", sequence_id=0,
              sequence_start: bool = False, sequence_end: bool = False,
              priority: int = 0, timeout: int = 0, headers: dict = None,
              query_params: dict = None,
              request_compression_algorithm: str = None,
              response_compression_algorithm: str = None,
              parameters: dict = None) -> InferResult:
        body, json_size = self.generate_request_body(
            inputs, outputs, request_id, sequence_id, sequence_start,
            sequence_end, priority, timeout, parameters)
        hdrs = dict(headers or {})
        if json_size is not None:
            hdrs[INFERENCE_HEADER_CONTENT_LENGTH] = str(json_size)
        hdrs["Content-Type"] = "application/octet-stream"
        if request_compression_algorithm == "gzip":
            body = gzip.compress(body, compresslevel=1)
            hdrs["Content-Encoding"] = "gzip"
        elif request_compression_algorithm == "deflate":
            body = zlib.compress(body, level=1)
            hdrs["Content-Encoding"] = "deflate"
        if response_compression_algorithm:
            hdrs["Accept-Encoding"] = response_compression_algorithm
        path = self._qs(_model_path(model_name, model_version) + "/infer",
                        query_params)

        def _once() -> InferResult:
            status, rhdrs, data = self._request("POST", path, body, hdrs)
            content_encoding = (rhdrs.get("Content-Encoding")
                                or "").lower() or None
            if status != 200:
                raw = self._decode(rhdrs, data) if content_encoding \
                    else data
                exc = InferenceServerException(_error_of(raw), str(status))
                ra = rhdrs.get("Retry-After")
                if ra is not None:
                    try:
                        # the retry policy's floor (server sheds and
                        # supervised-engine restarts advertise their
                        # backoff here)
                        exc.retry_after_s = float(ra)
                    except ValueError:
                        pass  # HTTP-date form: ignore, keep the backoff
                raise exc
            hdr_len = rhdrs.get(INFERENCE_HEADER_CONTENT_LENGTH)
            return InferResult.from_response_body(
                data, int(hdr_len) if hdr_len else None, content_encoding)

        from client_tpu_torch.client.retry import call_with_retry

        # sequence requests mutate per-correlation-id server state, so
        # a dropped connection (which may follow a completed execution)
        # must not be replayed — coded 503 sheds stay retryable
        return call_with_retry(
            self._retry_policy, _once,
            connection_errors=False if sequence_id else None)

    def async_infer(self, model_name: str, inputs, callback=None, **kwargs
                    ) -> InferAsyncRequest:
        """Submit on a worker thread (a ThreadPoolExecutor future); returns
        InferAsyncRequest. If ``callback`` is given it is invoked with
        (result, error) when done, as the gRPC client's is."""

        def work():
            try:
                result = self.infer(model_name, inputs, **kwargs)
                if callback:
                    callback(result, None)
                return result
            except Exception as e:  # noqa: BLE001 — delivered via get_result
                if callback:
                    callback(None, e)
                return e

        return InferAsyncRequest(self._executor.submit(work), self._verbose)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._executor.shutdown(wait=False)
            self._pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _model_path(name: str, version: str = "") -> str:
    path = f"/v2/models/{quote(name)}"
    if version:
        path += f"/versions/{quote(str(version))}"
    return path


def _error_of(data: bytes) -> str:
    try:
        return json.loads(data).get("error", data.decode(errors="replace"))
    except Exception:  # noqa: BLE001
        return data.decode(errors="replace") or "unknown error"
