"""gRPC InferenceServerClient: the port's copy of
``client_tpu/client/grpc.py``.

The ``tritonclient.grpc`` surface: the full control plane with the
``as_json`` option, infer / async_infer (a future, ``client_timeout``),
start_stream / async_stream_infer / stop_stream over a queue-fed
bidirectional stream with a dedicated reader thread, KeepAliveOptions,
and INT32_MAX message sizes. Device regions register through the CUDA
shared-memory verbs (the reference's TPU verbs), with a handle of
``client_tpu_torch.utils.cuda_shared_memory``.

Stubs are built with channel.unary_unary/stream_stream on the message
classes of the port's ``kserve_pb2``, from the one ``grpc_defs.METHODS``
table the server reads (what generated stubs do underneath). Needs
``grpcio`` and ``protobuf``.
"""

from __future__ import annotations

import json
import queue
import threading

import grpc as _grpc
import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype
from client_tpu_torch.protocol.grpc_defs import (
    CLIENT_CHANNEL_OPTIONS,
    METHODS,
    method_path,
)
from client_tpu_torch.protocol.grpc_tensors import (
    contents_to_numpy,
    fill_contents,
    numpy_to_raw,
    raw_to_numpy,
    set_param,
)
from client_tpu_torch.utils import InferenceServerException, raise_error


class KeepAliveOptions:
    """The channel's keep-alive arguments, as tritonclient.grpc's."""

    def __init__(self, keepalive_time_ms: int = 2**31 - 1,
                 keepalive_timeout_ms: int = 20000,
                 keepalive_permit_without_calls: bool = False,
                 http2_max_pings_without_data: int = 2):
        self.keepalive_time_ms = keepalive_time_ms
        self.keepalive_timeout_ms = keepalive_timeout_ms
        self.keepalive_permit_without_calls = keepalive_permit_without_calls
        self.http2_max_pings_without_data = http2_max_pings_without_data


class InferInput:
    """gRPC-flavor input tensor (raw or typed contents, or a shared-memory
    region)."""

    def __init__(self, name: str, shape, datatype: str):
        self._tensor = pb.ModelInferRequest.InferInputTensor()
        self._tensor.name = name
        self._tensor.shape.extend(int(d) for d in shape)
        self._tensor.datatype = datatype
        self._raw: bytes | None = None

    def name(self) -> str:
        return self._tensor.name

    def datatype(self) -> str:
        return self._tensor.datatype

    def shape(self):
        return list(self._tensor.shape)

    def set_shape(self, shape) -> None:
        del self._tensor.shape[:]
        self._tensor.shape.extend(int(d) for d in shape)

    def set_data_from_numpy(self, input_tensor: np.ndarray,
                            use_raw: bool = True) -> "InferInput":
        if not isinstance(input_tensor, np.ndarray):
            raise_error("input tensor must be a numpy array")
        dtype = np_to_wire_dtype(input_tensor.dtype)
        if dtype != self._tensor.datatype:
            raise_error(f"got unexpected datatype {dtype}; expected "
                        f"{self._tensor.datatype}")
        if tuple(input_tensor.shape) != tuple(self._tensor.shape):
            raise_error(f"got unexpected shape {list(input_tensor.shape)}; "
                        f"expected {list(self._tensor.shape)}")
        for k in ("shared_memory_region", "shared_memory_byte_size",
                  "shared_memory_offset"):
            self._tensor.parameters.pop(k, None)
        self._tensor.ClearField("contents")
        if use_raw:
            self._raw = numpy_to_raw(input_tensor, self._tensor.datatype)
        else:
            self._raw = None
            fill_contents(self._tensor.contents, input_tensor,
                          self._tensor.datatype)
        return self

    def set_data_from_torch(self, tensor) -> "InferInput":
        """A torch tensor on any device: copied to the host and sent as raw
        contents (bf16 as its raw bytes)."""
        from client_tpu_torch.device import tensor_bytes, wire_dtype_of

        dtype = wire_dtype_of(tensor)
        if dtype != self._tensor.datatype:
            raise_error(f"got unexpected datatype {dtype}; expected "
                        f"{self._tensor.datatype}")
        if tuple(tensor.shape) != tuple(self._tensor.shape):
            raise_error(f"got unexpected shape {list(tensor.shape)}; "
                        f"expected {list(self._tensor.shape)}")
        for k in ("shared_memory_region", "shared_memory_byte_size",
                  "shared_memory_offset"):
            self._tensor.parameters.pop(k, None)
        self._tensor.ClearField("contents")
        self._raw = tensor_bytes(tensor)
        return self

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0) -> "InferInput":
        self._raw = None
        self._tensor.ClearField("contents")
        set_param(self._tensor.parameters, "shared_memory_region", region_name)
        set_param(self._tensor.parameters, "shared_memory_byte_size",
                  int(byte_size))
        set_param(self._tensor.parameters, "shared_memory_offset", int(offset))
        return self


class InferRequestedOutput:
    """One requested output (class_count, shared memory binding)."""

    def __init__(self, name: str, class_count: int = 0):
        self._output = pb.ModelInferRequest.InferRequestedOutputTensor()
        self._output.name = name
        if class_count:
            set_param(self._output.parameters, "classification",
                      int(class_count))

    def name(self) -> str:
        return self._output.name

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0) -> "InferRequestedOutput":
        set_param(self._output.parameters, "shared_memory_region", region_name)
        set_param(self._output.parameters, "shared_memory_byte_size",
                  int(byte_size))
        set_param(self._output.parameters, "shared_memory_offset", int(offset))
        return self

    def unset_shared_memory(self) -> "InferRequestedOutput":
        for k in ("shared_memory_region", "shared_memory_byte_size",
                  "shared_memory_offset"):
            self._output.parameters.pop(k, None)
        return self


def _to_json(msg):
    import json as json_mod

    from google.protobuf import json_format

    return json_mod.loads(json_format.MessageToJson(
        msg, preserving_proto_field_name=True))


class InferResult:
    """A ModelInferResponse (as_numpy over raw_output_contents or typed
    contents)."""

    def __init__(self, result: pb.ModelInferResponse):
        self._result = result

    def get_response(self, as_json: bool = False):
        return _to_json(self._result) if as_json else self._result

    def get_output(self, name: str, as_json: bool = False):
        for o in self._result.outputs:
            if o.name == name:
                return _to_json(o) if as_json else o
        return None

    def as_numpy(self, name: str):
        for i, o in enumerate(self._result.outputs):
            if o.name != name:
                continue
            if "shared_memory_region" in o.parameters:
                return None
            if i < len(self._result.raw_output_contents):
                # presence, not truthiness: b"" is a valid zero-element blob
                return raw_to_numpy(self._result.raw_output_contents[i],
                                    o.datatype, tuple(o.shape))
            if o.HasField("contents"):
                return contents_to_numpy(o.contents, o.datatype,
                                         tuple(o.shape))
            return None
        return None


class CallContext:
    """Cancel handle returned by async_infer (wraps the gRPC future)."""

    def __init__(self, future):
        self._future = future

    def cancel(self):
        return self._future.cancel()

    def result(self, timeout=None):
        return self._future.result(timeout=timeout)


class _InferStream:
    """Bidirectional stream state: request queue + reader thread."""

    _SENTINEL = object()

    def __init__(self, callback, stub_stream, stream_timeout=None,
                 headers=None):
        self._callback = callback
        self._request_q: queue.Queue = queue.Queue()
        self._closed = False
        self._dead = False  # transport failed; sends must error loudly
        self._response_iter = stub_stream(
            iter(self._request_q.get, self._SENTINEL),
            timeout=stream_timeout,
            metadata=_metadata(headers))
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="grpc-stream-client-reader")
        self._reader.start()

    def _read_loop(self):
        try:
            for msg in self._response_iter:
                if msg.error_message:
                    self._callback(
                        None, InferenceServerException(msg.error_message))
                else:
                    self._callback(InferResult(msg.infer_response), None)
        except _grpc.RpcError as e:
            self._dead = True
            if not self._closed:
                self._callback(None, InferenceServerException(
                    _rpc_error_msg(e), _status_name(e)))
        except Exception as e:  # noqa: BLE001 — user callback raised: the
            # reader is gone, so mark the stream dead (sends error loudly)
            # instead of silently dropping every later response
            self._dead = True
            if not self._closed:
                try:
                    self._callback(None, InferenceServerException(
                        f"stream callback raised: {type(e).__name__}: {e}"))
                except Exception:  # noqa: BLE001
                    pass

    def send(self, request: pb.ModelInferRequest) -> None:
        if self._closed:
            raise_error("stream is closed")
        if self._dead:
            raise_error("stream transport has failed; call stop_stream and "
                        "start_stream to reconnect")
        self._request_q.put(request)

    def close(self, cancel_requests: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if cancel_requests:
            self._response_iter.cancel()
        self._request_q.put(self._SENTINEL)
        self._reader.join(timeout=10)


class InferenceServerClient:
    """gRPC client for the v2 protocol (ctor with keepalive and channel
    args; every control verb with as_json; infer/async_infer with
    client_timeout; the streaming trio)."""

    def __init__(self, url: str, verbose: bool = False, ssl: bool = False,
                 root_certificates=None, private_key=None,
                 certificate_chain=None, creds=None,
                 keepalive_options: KeepAliveOptions | None = None,
                 channel_args=None,
                 retry_policy=None):
        """``retry_policy`` (a ``client_tpu_torch.client.retry.RetryPolicy``,
        default None = fail-fast): retry the synchronous
        ``infer`` on retryable codes (UNAVAILABLE/RESOURCE_EXHAUSTED
        by default) with exponential backoff + full jitter, honoring
        the server's ``retry-after`` trailing-metadata hint as a
        floor. Non-streaming only: ``async_stream_infer`` responses
        and ``async_infer`` futures surface their errors — replaying
        a half-consumed token stream needs application-level dedup."""
        options = list(CLIENT_CHANNEL_OPTIONS)
        if keepalive_options is not None:
            options += [
                ("grpc.keepalive_time_ms",
                 keepalive_options.keepalive_time_ms),
                ("grpc.keepalive_timeout_ms",
                 keepalive_options.keepalive_timeout_ms),
                ("grpc.keepalive_permit_without_calls",
                 int(keepalive_options.keepalive_permit_without_calls)),
                ("grpc.http2.max_pings_without_data",
                 keepalive_options.http2_max_pings_without_data),
            ]
        if channel_args:
            options += list(channel_args)
        if ssl:
            # root_certificates / private_key / certificate_chain ->
            # grpc.ssl_channel_credentials, as tritonclient.grpc
            if creds is None:
                creds = _grpc.ssl_channel_credentials(
                    root_certificates=root_certificates,
                    private_key=private_key,
                    certificate_chain=certificate_chain)
            self._channel = _grpc.secure_channel(url, creds, options=options)
        else:
            self._channel = _grpc.insecure_channel(url, options=options)
        self._verbose = verbose
        self._retry_policy = retry_policy
        self._stubs = {}
        for name, (kind, req_cls, resp_cls) in METHODS.items():
            factory = (self._channel.unary_unary if kind == "unary"
                       else self._channel.stream_stream)
            self._stubs[name] = factory(
                method_path(name),
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)
        self._stream: _InferStream | None = None

    # ---- plumbing ----

    def _call(self, name: str, request, timeout=None, headers=None):
        try:
            return self._stubs[name](request, timeout=timeout,
                                     metadata=_metadata(headers))
        except _grpc.RpcError as e:
            raise _wrap_rpc_error(e) from None

    @staticmethod
    def _maybe_json(msg, as_json: bool):
        return _to_json(msg) if as_json else msg

    # ---- health / metadata ----

    def is_server_live(self, headers=None) -> bool:
        return self._call("ServerLive", pb.ServerLiveRequest(),
                          headers=headers).live

    def is_server_ready(self, headers=None) -> bool:
        return self._call("ServerReady", pb.ServerReadyRequest(),
                          headers=headers).ready

    def is_model_ready(self, model_name: str, model_version: str = "",
                       headers=None) -> bool:
        return self._call("ModelReady",
                          pb.ModelReadyRequest(name=model_name,
                                               version=model_version),
                          headers=headers).ready

    def get_server_metadata(self, headers=None, as_json: bool = False):
        return self._maybe_json(
            self._call("ServerMetadata", pb.ServerMetadataRequest(),
                       headers=headers), as_json)

    def get_model_metadata(self, model_name: str, model_version: str = "",
                           headers=None, as_json: bool = False):
        return self._maybe_json(
            self._call("ModelMetadata",
                       pb.ModelMetadataRequest(name=model_name,
                                               version=model_version),
                       headers=headers), as_json)

    def get_model_config(self, model_name: str, model_version: str = "",
                         headers=None, as_json: bool = False):
        return self._maybe_json(
            self._call("ModelConfig",
                       pb.ModelConfigRequest(name=model_name,
                                             version=model_version),
                       headers=headers), as_json)

    # ---- repository ----

    def get_model_repository_index(self, headers=None,
                                   as_json: bool = False):
        return self._maybe_json(
            self._call("RepositoryIndex", pb.RepositoryIndexRequest(),
                       headers=headers), as_json)

    def load_model(self, model_name: str, headers=None, config: str = None,
                   files: dict = None) -> None:
        if files:
            raise_error("file-content overrides are not supported; models "
                        "load from the repository or registered factories")
        req = pb.RepositoryModelLoadRequest(model_name=model_name)
        if config is not None:
            set_param(req.parameters, "config", config)
        self._call("RepositoryModelLoad", req, headers=headers)

    def unload_model(self, model_name: str, headers=None,
                     unload_dependents: bool = False) -> None:
        req = pb.RepositoryModelUnloadRequest(model_name=model_name)
        set_param(req.parameters, "unload_dependents", unload_dependents)
        self._call("RepositoryModelUnload", req, headers=headers)

    # ---- statistics / trace ----

    def get_inference_statistics(self, model_name: str = "",
                                 model_version: str = "", headers=None,
                                 as_json: bool = False, timeout=None):
        return self._maybe_json(
            self._call("ModelStatistics",
                       pb.ModelStatisticsRequest(name=model_name,
                                                 version=model_version),
                       timeout=timeout, headers=headers), as_json)

    def get_server_metrics(self, headers=None) -> str:
        """The gRPC twin of GET /metrics: ask ServerMetadata to mirror
        the Prometheus exposition text in trailing metadata."""
        md = dict(headers or {})
        md["client-tpu-metrics"] = "request"
        try:
            _, call = self._stubs["ServerMetadata"].with_call(
                pb.ServerMetadataRequest(), metadata=_metadata(md))
        except _grpc.RpcError as e:
            raise InferenceServerException(
                _rpc_error_msg(e), _status_name(e)) from None
        for k, v in call.trailing_metadata() or ():
            if k == "client-tpu-metrics-bin":
                return v.decode("utf-8", errors="replace") \
                    if isinstance(v, bytes) else str(v)
        return ""

    def get_debug_traces(self, model_name: str = "",
                         headers=None) -> dict | None:
        """The gRPC twin of GET /v2/debug/traces: ask ServerMetadata to
        mirror the completed-trace JSON in trailing metadata. Returns
        None when the server runs without --debug-endpoints (the
        trailer is absent, matching the HTTP 404)."""
        md = dict(headers or {})
        md["client-tpu-debug-traces"] = model_name or ""
        try:
            _, call = self._stubs["ServerMetadata"].with_call(
                pb.ServerMetadataRequest(), metadata=_metadata(md))
        except _grpc.RpcError as e:
            raise InferenceServerException(
                _rpc_error_msg(e), _status_name(e)) from None
        for k, v in call.trailing_metadata() or ():
            if k == "client-tpu-debug-traces-bin":
                return json.loads(v.decode("utf-8", errors="replace")
                                  if isinstance(v, bytes) else str(v))
        return None

    def get_debug_incidents(self, headers=None) -> dict | None:
        """The gRPC twin of GET /v2/debug/incidents: ask ServerMetadata
        to mirror the watchdog incident bundles in trailing metadata.
        Returns None when the server runs without --debug-endpoints."""
        md = dict(headers or {})
        md["client-tpu-debug-incidents"] = "request"
        try:
            _, call = self._stubs["ServerMetadata"].with_call(
                pb.ServerMetadataRequest(), metadata=_metadata(md))
        except _grpc.RpcError as e:
            raise InferenceServerException(
                _rpc_error_msg(e), _status_name(e)) from None
        for k, v in call.trailing_metadata() or ():
            if k == "client-tpu-debug-incidents-bin":
                return json.loads(v.decode("utf-8", errors="replace")
                                  if isinstance(v, bytes) else str(v))
        return None

    def get_trace_settings(self, model_name: str = "", headers=None,
                           as_json: bool = False):
        return self._maybe_json(
            self._call("TraceSetting",
                       pb.TraceSettingRequest(model_name=model_name or ""),
                       headers=headers), as_json)

    def update_trace_settings(self, model_name: str = "",
                              settings: dict = None, headers=None,
                              as_json: bool = False):
        req = pb.TraceSettingRequest(model_name=model_name or "")
        for k, v in (settings or {}).items():
            entry = req.settings[k]  # materialize key even when clearing
            if v is None:
                continue  # empty value list = clear the setting
            vals = v if isinstance(v, (list, tuple)) else [v]
            entry.value.extend(str(x) for x in vals)
        return self._maybe_json(
            self._call("TraceSetting", req, headers=headers), as_json)

    # ---- shared memory ----

    def get_system_shared_memory_status(self, region_name: str = "",
                                        headers=None, as_json: bool = False):
        return self._maybe_json(
            self._call("SystemSharedMemoryStatus",
                       pb.SystemSharedMemoryStatusRequest(name=region_name),
                       headers=headers), as_json)

    def register_system_shared_memory(self, name: str, key: str,
                                      byte_size: int, offset: int = 0,
                                      headers=None) -> None:
        self._call("SystemSharedMemoryRegister",
                   pb.SystemSharedMemoryRegisterRequest(
                       name=name, key=key, offset=offset,
                       byte_size=byte_size), headers=headers)

    def unregister_system_shared_memory(self, name: str = "",
                                        headers=None) -> None:
        self._call("SystemSharedMemoryUnregister",
                   pb.SystemSharedMemoryUnregisterRequest(name=name),
                   headers=headers)

    def get_cuda_shared_memory_status(self, region_name: str = "",
                                      headers=None, as_json: bool = False):
        return self._maybe_json(
            self._call("CudaSharedMemoryStatus",
                       pb.CudaSharedMemoryStatusRequest(name=region_name),
                       headers=headers), as_json)

    def register_cuda_shared_memory(self, name: str, raw_handle: bytes,
                                    device_id: int, byte_size: int,
                                    headers=None) -> None:
        """Register a CUDA shm region by its raw handle
        (``cuda_shared_memory.get_raw_handle``)."""
        self._call("CudaSharedMemoryRegister",
                   pb.CudaSharedMemoryRegisterRequest(
                       name=name, raw_handle=raw_handle,
                       device_id=device_id, byte_size=byte_size),
                   headers=headers)

    def unregister_cuda_shared_memory(self, name: str = "",
                                      headers=None) -> None:
        self._call("CudaSharedMemoryUnregister",
                   pb.CudaSharedMemoryUnregisterRequest(name=name),
                   headers=headers)

    # ---- infer ----

    @staticmethod
    def _build_request(model_name, inputs, model_version="", outputs=None,
                       request_id="", sequence_id=0, sequence_start=False,
                       sequence_end=False, priority=0, timeout=0,
                       parameters=None) -> pb.ModelInferRequest:
        """One ModelInferRequest from the call's arguments."""
        req = pb.ModelInferRequest(model_name=model_name,
                                   model_version=model_version,
                                   id=request_id)
        if sequence_id:
            set_param(req.parameters, "sequence_id", sequence_id)
            set_param(req.parameters, "sequence_start", sequence_start)
            set_param(req.parameters, "sequence_end", sequence_end)
        if priority:
            set_param(req.parameters, "priority", priority)
        if timeout:
            set_param(req.parameters, "timeout", timeout)
        for k, v in (parameters or {}).items():
            set_param(req.parameters, k, v)
        for i in inputs:
            req.inputs.append(i._tensor)
            if i._raw is not None:
                req.raw_input_contents.append(i._raw)
        if outputs is not None:
            for o in outputs:
                req.outputs.append(o._output)
        return req

    def infer(self, model_name: str, inputs, model_version: str = "",
              outputs=None, request_id: str = "", sequence_id=0,
              sequence_start: bool = False, sequence_end: bool = False,
              priority: int = 0, timeout: int = 0, client_timeout=None,
              headers=None, parameters: dict = None) -> InferResult:
        req = self._build_request(model_name, inputs, model_version, outputs,
                                  request_id, sequence_id, sequence_start,
                                  sequence_end, priority, timeout, parameters)
        from client_tpu_torch.client.retry import call_with_retry

        # sequence requests mutate per-correlation-id server state:
        # never replay them on a raw transport error (see retry.py)
        return call_with_retry(
            self._retry_policy,
            lambda: InferResult(self._call("ModelInfer", req,
                                           timeout=client_timeout,
                                           headers=headers)),
            connection_errors=False if sequence_id else None)

    def async_infer(self, model_name: str, inputs, callback,
                    model_version: str = "", outputs=None,
                    request_id: str = "", sequence_id=0,
                    sequence_start: bool = False, sequence_end: bool = False,
                    priority: int = 0, timeout: int = 0, client_timeout=None,
                    headers=None, parameters: dict = None) -> CallContext:
        """ModelInfer as a future; ``callback(result, error)`` runs when it
        is done."""
        req = self._build_request(model_name, inputs, model_version, outputs,
                                  request_id, sequence_id, sequence_start,
                                  sequence_end, priority, timeout, parameters)
        future = self._stubs["ModelInfer"].future(
            req, timeout=client_timeout, metadata=_metadata(headers))

        def done(fut):
            try:
                callback(InferResult(fut.result()), None)
            except _grpc.RpcError as e:
                callback(None, InferenceServerException(_rpc_error_msg(e),
                                                        _status_name(e)))
            except Exception as e:  # noqa: BLE001
                callback(None, InferenceServerException(str(e)))

        future.add_done_callback(done)
        return CallContext(future)

    # ---- streaming ----

    def start_stream(self, callback, stream_timeout=None, headers=None
                     ) -> None:
        """Open the bidirectional stream; ``callback(result, error)`` gets
        every response on the reader thread."""
        if self._stream is not None:
            raise_error("stream is already active; call stop_stream first")
        self._stream = _InferStream(callback, self._stubs["ModelStreamInfer"],
                                    stream_timeout, headers)

    def async_stream_infer(self, model_name: str, inputs,
                           model_version: str = "", outputs=None,
                           request_id: str = "", sequence_id=0,
                           sequence_start: bool = False,
                           sequence_end: bool = False, priority: int = 0,
                           timeout: int = 0, parameters: dict = None) -> None:
        if self._stream is None:
            raise_error("stream is not active; call start_stream first")
        req = self._build_request(model_name, inputs, model_version, outputs,
                                  request_id, sequence_id, sequence_start,
                                  sequence_end, priority, timeout, parameters)
        self._stream.send(req)

    def stop_stream(self, cancel_requests: bool = False) -> None:
        if self._stream is not None:
            self._stream.close(cancel_requests)
            self._stream = None

    def close(self) -> None:
        self.stop_stream()
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _metadata(headers: dict | None):
    if not headers:
        return None
    return tuple((k.lower(), str(v)) for k, v in headers.items())


def _wrap_rpc_error(e) -> InferenceServerException:
    """RpcError -> InferenceServerException, carrying the server's
    ``retry-after`` trailing-metadata hint (seconds) as the
    ``retry_after_s`` attribute the RetryPolicy floors its backoff on
    (a failed unary call IS a Call, so trailing metadata is there)."""
    exc = InferenceServerException(_rpc_error_msg(e), _status_name(e))
    try:
        trailing = e.trailing_metadata() or ()
    except Exception:  # noqa: BLE001 — hint only; the status suffices
        trailing = ()
    for k, v in trailing:
        if k == "retry-after":
            try:
                exc.retry_after_s = float(
                    v.decode() if isinstance(v, bytes) else v)
            except ValueError:
                pass
            break
    return exc


def _rpc_error_msg(e) -> str:
    try:
        return e.details() or str(e)
    except Exception:  # noqa: BLE001
        return str(e)


def _status_name(e) -> str:
    try:
        return e.code().name
    except Exception:  # noqa: BLE001
        return "UNKNOWN"
