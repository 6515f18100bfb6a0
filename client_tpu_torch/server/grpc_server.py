"""gRPC front end: inference.GRPCInferenceService over grpcio.

The port's counterpart of ``client_tpu/server/grpc_server.py``, serving a
``TorchInferenceServer``. The service handlers are registered through
grpc's generic-handler machinery from the method table of
``client_tpu_torch.protocol.grpc_defs`` (no protoc gRPC plugin). The unary
RPCs map one to one onto the core; ``ModelStreamInfer`` is the
bidirectional streaming data plane that carries decoupled (generation)
streams, each request with the RPC's cancel Event.

The port's differences from the reference:
- ``CudaSharedMemory*`` serve the core's CUDA shm registry; a
  ``TpuSharedMemory*`` call answers INVALID_ARGUMENT naming
  ``CudaSharedMemory``, as the HTTP front end answers
  ``/v2/tpusharedmemory`` with 400.
- TLS is left out as the port's HTTP front end leaves it out.

As in the reference: ``TraceSetting`` reads and updates the trace
settings; a request's ``triton_trace_id`` parameter propagates the
caller's trace id, and a traced request's id comes back as the
``triton-trace-id`` trailer of ``ModelInfer`` and as the
``triton_trace_id`` parameter of every ``ModelStreamInfer`` response; a
``ServerMetadata`` call with the ``client-tpu-metrics: request`` key gets
the Prometheus text back in the ``client-tpu-metrics-bin`` trailer, and,
on a server built with ``debug_endpoints=True``, one with the
``client-tpu-debug-traces`` key (its value a model name, "" for all) gets
the completed traces' JSON in the ``client-tpu-debug-traces-bin`` trailer
and one with the ``client-tpu-debug-incidents`` key the incident JSON in
the ``client-tpu-debug-incidents-bin`` trailer (each absent without the
flag, the twin of the HTTP 404). An armed ``transport_reset`` fault aborts
``ModelInfer`` with UNAVAILABLE before it is served.

Importing this module imports ``grpc`` and ``google.protobuf``; nothing on
the card's serving path imports it.
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent import futures

import grpc
import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb
from client_tpu_torch.protocol.grpc_defs import (
    DEFAULT_CHANNEL_OPTIONS,
    METHODS,
    SERVICE,
)
from client_tpu_torch.protocol.grpc_tensors import (
    contents_to_numpy,
    numpy_to_raw,
    params_to_dict,
    raw_to_numpy,
    set_param,
)
from client_tpu_torch.server import faultinject
from client_tpu_torch.server.core import TorchInferenceServer
from client_tpu_torch.server.types import (
    DEFAULT_SLO_CLASS,
    DEFAULT_TENANT,
    InferRequest,
    InferTensor,
    RequestedOutput,
    ServerError,
    parse_int_param,
    parse_label_param,
)

_STATUS_OF = {
    400: grpc.StatusCode.INVALID_ARGUMENT,
    404: grpc.StatusCode.NOT_FOUND,
    409: grpc.StatusCode.ALREADY_EXISTS,
    499: grpc.StatusCode.CANCELLED,  # client went away (nginx idiom)
    500: grpc.StatusCode.INTERNAL,
    503: grpc.StatusCode.UNAVAILABLE,
    504: grpc.StatusCode.DEADLINE_EXCEEDED,
}

# status codes whose aborts carry a ``retry-after`` trailing-metadata key
# (seconds): the gRPC twin of the HTTP Retry-After header
_RETRYABLE_CODES = (grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.RESOURCE_EXHAUSTED)

TPU_SHM_UNAVAILABLE = ("this server hosts CUDA devices; TPU shared memory is "
                       "not available — use CudaSharedMemory")

_TPU_SHM_RPCS = ("TpuSharedMemoryStatus", "TpuSharedMemoryRegister",
                 "TpuSharedMemoryUnregister")


def request_to_internal(req: pb.ModelInferRequest) -> InferRequest:
    """ModelInferRequest proto -> internal InferRequest."""
    params = params_to_dict(req.parameters)
    inputs = []
    # raw_input_contents is an ordered subsequence covering the inputs
    # that carry neither shm parameters nor typed contents
    raw_idx = 0
    for t in req.inputs:
        tp = params_to_dict(t.parameters)
        shape = tuple(int(d) for d in t.shape)
        tensor = InferTensor(name=t.name, datatype=t.datatype, shape=shape,
                             parameters=tp)
        region = tp.pop("shared_memory_region", None)
        if region is not None:
            tensor.shm_region = region
            tensor.shm_offset = int(tp.pop("shared_memory_offset", 0) or 0)
            tensor.shm_byte_size = int(
                tp.pop("shared_memory_byte_size", 0) or 0)
        elif t.HasField("contents"):
            if req.raw_input_contents:
                # mixing the typed and raw planes is a spec violation;
                # the reference's wording, so its example clients interop
                raise ServerError(
                    "contents field must not be specified when using "
                    f"raw_input_contents for '{t.name}' for model "
                    f"'{req.model_name}'", 400)
            try:
                tensor.data = contents_to_numpy(t.contents, t.datatype, shape)
            except ValueError as e:
                raise ServerError(
                    f"typed contents for input '{t.name}' do not match "
                    f"shape {list(shape)}/{t.datatype}: {e}", 400) from e
        elif raw_idx < len(req.raw_input_contents):
            raw = req.raw_input_contents[raw_idx]
            raw_idx += 1
            try:
                tensor.data = raw_to_numpy(raw, t.datatype, shape)
            except ValueError as e:
                raise ServerError(
                    f"raw content for input '{t.name}' does not match "
                    f"shape {list(shape)}/{t.datatype}: {e}", 400) from e
        else:
            tensor.data = None
        inputs.append(tensor)
    outputs = []
    for o in req.outputs:
        op = params_to_dict(o.parameters)
        outputs.append(RequestedOutput(
            name=o.name,
            binary_data=True,
            classification_count=int(op.pop("classification", 0) or 0),
            shm_region=op.pop("shared_memory_region", None),
            shm_offset=int(op.pop("shared_memory_offset", 0) or 0),
            shm_byte_size=int(op.pop("shared_memory_byte_size", 0) or 0),
            parameters=op))
    return InferRequest(
        model_name=req.model_name, model_version=req.model_version,
        id=req.id, inputs=inputs, outputs=outputs, parameters=params,
        priority=parse_int_param(params, "priority"),
        timeout_us=parse_int_param(params, "timeout"),
        tenant_id=parse_label_param(params, "tenant_id", DEFAULT_TENANT),
        slo_class=parse_label_param(params, "slo_class",
                                    DEFAULT_SLO_CLASS),
        sequence_id=params.pop("sequence_id", 0),
        sequence_start=bool(params.pop("sequence_start", False)),
        sequence_end=bool(params.pop("sequence_end", False)),
        trace_id=str(params.pop("triton_trace_id", "") or ""))


def response_to_proto(resp) -> pb.ModelInferResponse:
    out = pb.ModelInferResponse(model_name=resp.model_name,
                                model_version=resp.model_version,
                                id=resp.id)
    for k, v in (resp.parameters or {}).items():
        set_param(out.parameters, k, v)
    for t in resp.outputs:
        ot = out.outputs.add()
        ot.name = t.name
        ot.datatype = t.datatype
        ot.shape.extend(int(d) for d in t.shape)
        if t.shm_region is not None:
            set_param(ot.parameters, "shared_memory_region", t.shm_region)
            set_param(ot.parameters, "shared_memory_offset", t.shm_offset)
            set_param(ot.parameters, "shared_memory_byte_size",
                      t.shm_byte_size)
            out.raw_output_contents.append(b"")
        else:
            out.raw_output_contents.append(
                numpy_to_raw(np.asarray(t.data), t.datatype))
    return out


class _Handlers:
    def __init__(self, core: TorchInferenceServer,
                 debug_endpoints: bool = False):
        self.core = core
        self.debug_endpoints = debug_endpoints

    def _abort(self, context, e: ServerError):
        code = _STATUS_OF.get(e.status, grpc.StatusCode.INTERNAL)
        hint = getattr(e, "retry_after", None)
        if code in _RETRYABLE_CODES and hint is not None:
            context.set_trailing_metadata((("retry-after", f"{hint:g}"),))
        context.abort(code, str(e))

    # ---- unary handlers ----

    def ServerLive(self, req, context):
        return pb.ServerLiveResponse(live=self.core.live())

    def ServerReady(self, req, context):
        return pb.ServerReadyResponse(ready=self.core.ready())

    def ModelReady(self, req, context):
        return pb.ModelReadyResponse(
            ready=self.core.model_ready(req.name, req.version))

    def ServerMetadata(self, req, context):
        md = self.core.metadata()
        # the metrics mirror: a caller that sends the client-tpu-metrics
        # key gets the Prometheus text in trailing metadata (the gRPC twin
        # of GET /metrics)
        inv = dict(context.invocation_metadata() or ())
        trailers = []
        if inv.get("client-tpu-metrics") == "request":
            try:
                trailers.append(("client-tpu-metrics-bin",
                                 self.core.metrics_text().encode()))
            except Exception:  # noqa: BLE001 — metrics are best-effort
                pass
        # the traces and incidents mirrors (GET /v2/debug/traces and
        # /v2/debug/incidents), only on a server that opted into the debug
        # surface; otherwise the trailer is absent
        if "client-tpu-debug-traces" in inv and self.debug_endpoints:
            try:
                trailers.append((
                    "client-tpu-debug-traces-bin",
                    json.dumps(self.core.debug_traces(
                        inv["client-tpu-debug-traces"])).encode()))
            except Exception:  # noqa: BLE001 — debug is best-effort
                pass
        if "client-tpu-debug-incidents" in inv and self.debug_endpoints:
            try:
                trailers.append((
                    "client-tpu-debug-incidents-bin",
                    json.dumps(self.core.debug_incidents()).encode()))
            except Exception:  # noqa: BLE001 — debug is best-effort
                pass
        if trailers:
            context.set_trailing_metadata(tuple(trailers))
        return pb.ServerMetadataResponse(name=md["name"],
                                         version=md["version"],
                                         extensions=md["extensions"])

    def ModelMetadata(self, req, context):
        try:
            md = self.core.model_metadata(req.name, req.version)
        except ServerError as e:
            self._abort(context, e)
        out = pb.ModelMetadataResponse(
            name=md["name"], versions=md["versions"], platform=md["platform"])
        for io, dst in ((md["inputs"], out.inputs),
                        (md["outputs"], out.outputs)):
            for t in io:
                tm = dst.add()
                tm.name = t["name"]
                tm.datatype = t["datatype"]
                tm.shape.extend(t["shape"])
        return out

    def ModelConfig(self, req, context):
        try:
            cfg = self.core._entry(req.name, req.version).model.config
        except ServerError as e:
            self._abort(context, e)
        out = pb.ModelConfigResponse()
        c = out.config
        c.name = cfg.name
        c.platform = "ensemble" if cfg.is_ensemble() else cfg.platform
        c.backend = cfg.backend
        c.max_batch_size = cfg.max_batch_size
        for spec, dst in ((cfg.inputs, c.input), (cfg.outputs, c.output)):
            for s in spec:
                ts = dst.add()
                ts.name = s.name
                ts.datatype = s.datatype
                ts.dims.extend(int(d) for d in s.dims)
                ts.is_shape_tensor = s.is_shape_tensor
                ts.optional = s.optional
        if cfg.dynamic_batching is not None:
            c.dynamic_batching.preferred_batch_size.extend(
                cfg.dynamic_batching.preferred_batch_size)
            c.dynamic_batching.max_queue_delay_microseconds = \
                cfg.dynamic_batching.max_queue_delay_microseconds
            c.dynamic_batching.preserve_ordering = \
                cfg.dynamic_batching.preserve_ordering
        if cfg.sequence_batching is not None:
            c.sequence_batching.max_sequence_idle_microseconds = \
                cfg.sequence_batching.max_sequence_idle_microseconds
            c.sequence_batching.max_candidate_sequences = \
                cfg.sequence_batching.max_candidate_sequences
        for step in cfg.ensemble_steps:
            s = c.ensemble_scheduling.step.add()
            s.model_name = step.model_name
            s.model_version = step.model_version
            for k, v in step.input_map.items():
                s.input_map[k] = v
            for k, v in step.output_map.items():
                s.output_map[k] = v
        c.model_transaction_policy.decoupled = cfg.decoupled
        c.response_cache.enable = cfg.response_cache
        ig = c.instance_group.add()
        ig.kind = "KIND_GPU"
        ig.count = cfg.instance_count
        ig.device_ids.extend(cfg.device_ids)
        if cfg.sharding is not None:
            c.sharding.mesh_axes.extend(cfg.sharding.mesh_axes)
            c.sharding.mesh_shape.extend(cfg.sharding.mesh_shape)
            c.sharding.batch_axis = cfg.sharding.batch_axis
        for k, v in cfg.parameters.items():
            c.parameters[k] = str(v)
        return out

    def ModelStatistics(self, req, context):
        try:
            stats = self.core.statistics(req.name, req.version)
        except ServerError as e:
            self._abort(context, e)
        out = pb.ModelStatisticsResponse()
        for ms in stats["model_stats"]:
            m = out.model_stats.add()
            m.name = ms["name"]
            m.version = ms["version"]
            m.last_inference = ms["last_inference"]
            m.inference_count = ms["inference_count"]
            m.execution_count = ms["execution_count"]
            ist = ms["inference_stats"]
            for field in ("success", "fail", "queue", "compute_input",
                          "compute_infer", "compute_output", "cache_hit",
                          "cache_miss"):
                d = getattr(m.inference_stats, field)
                d.count = ist[field]["count"]
                d.ns = ist[field]["ns"]
            for bs in ms["batch_stats"]:
                b = m.batch_stats.add()
                b.batch_size = bs["batch_size"]
                for field in ("compute_input", "compute_infer",
                              "compute_output"):
                    d = getattr(b, field)
                    d.count = bs[field]["count"]
                    d.ns = bs[field]["ns"]
        return out

    def RepositoryIndex(self, req, context):
        out = pb.RepositoryIndexResponse()
        for m in self.core.repository_index(req.ready):
            mi = out.models.add()
            mi.name = m["name"]
            mi.version = m["version"]
            mi.state = m["state"]
            mi.reason = m["reason"]
        return out

    def RepositoryModelLoad(self, req, context):
        override = None
        params = params_to_dict(req.parameters)
        if "config" in params:
            override = json.loads(params["config"])
        try:
            self.core.load_model(req.model_name, override)
        except ServerError as e:
            self._abort(context, e)
        return pb.RepositoryModelLoadResponse()

    def RepositoryModelUnload(self, req, context):
        params = params_to_dict(req.parameters)
        try:
            self.core.unload_model(req.model_name,
                                   bool(params.get("unload_dependents",
                                                   False)))
        except ServerError as e:
            self._abort(context, e)
        return pb.RepositoryModelUnloadResponse()

    def SystemSharedMemoryStatus(self, req, context):
        out = pb.SystemSharedMemoryStatusResponse()
        for r in self.core.system_shm.status(req.name or None):
            rs = out.regions[r["name"]]
            rs.name = r["name"]
            rs.key = r["key"]
            rs.offset = r["offset"]
            rs.byte_size = r["byte_size"]
        return out

    def SystemSharedMemoryRegister(self, req, context):
        try:
            self.core.system_shm.register(req.name, req.key, req.offset,
                                          req.byte_size)
        except ServerError as e:
            self._abort(context, e)
        return pb.SystemSharedMemoryRegisterResponse()

    def SystemSharedMemoryUnregister(self, req, context):
        if req.name:
            self.core.system_shm.unregister(req.name)
        else:
            self.core.system_shm.unregister_all()
        return pb.SystemSharedMemoryUnregisterResponse()

    def CudaSharedMemoryStatus(self, req, context):
        out = pb.CudaSharedMemoryStatusResponse()
        for r in self.core.cuda_shm.status(req.name or None):
            rs = out.regions[r["name"]]
            rs.name = r["name"]
            rs.device_id = r["device_id"]
            rs.byte_size = r["byte_size"]
        return out

    def CudaSharedMemoryRegister(self, req, context):
        try:
            self.core.cuda_shm.register(req.name, req.raw_handle,
                                        req.device_id, req.byte_size)
        except ServerError as e:
            self._abort(context, e)
        return pb.CudaSharedMemoryRegisterResponse()

    def CudaSharedMemoryUnregister(self, req, context):
        if req.name:
            self.core.cuda_shm.unregister(req.name)
        else:
            self.core.cuda_shm.unregister_all()
        return pb.CudaSharedMemoryUnregisterResponse()

    def TraceSetting(self, req, context):
        if req.settings:
            # an empty value list clears the key (a client's None)
            settings = {k: (list(v.value) or None)
                        for k, v in req.settings.items()}
            merged = self.core.update_trace_settings(req.model_name, settings)
        else:
            merged = self.core.get_trace_settings(req.model_name)
        out = pb.TraceSettingResponse()
        for k, v in merged.items():
            out.settings[k].value.extend(v)
        return out

    def ModelInfer(self, req, context):
        if faultinject.fire("transport_reset",
                            transport="grpc") is not None:
            # fault point: abort before serving, the RPC-level fault a
            # client's retry policy handles as UNAVAILABLE
            context.set_trailing_metadata((("retry-after", "1"),))
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "injected transport reset")
        try:
            internal = request_to_internal(req)
            resp = self.core.infer(internal)
        except ServerError as e:
            self._abort(context, e)
        except ValueError as e:
            self._abort(context, ServerError(str(e), 400))
        if internal.trace is not None:
            # the sampled or propagated id, so the caller can join its
            # spans with the server's trace export
            context.set_trailing_metadata(
                (("triton-trace-id", internal.trace.id),))
        return response_to_proto(resp)

    # ---- streaming ----

    def ModelStreamInfer(self, request_iterator, context):
        """Bidirectional stream: requests in, responses out as they
        complete. A decoupled model sends N responses per request."""
        out_q: queue.Queue = queue.Queue()  # (msg | None, is_final) items
        state = {"submitted": 0, "reader_done": False}
        state_lock = threading.Lock()
        # RPC-scoped cancellation: when the caller cancels (or the
        # connection dies) grpc fires the context callback; every request
        # submitted on this stream carries the Event, so the generation
        # engine frees its slots and prefix pins at the next dispatch
        # boundary instead of decoding for nobody
        cancel_ev = threading.Event()
        context.add_callback(cancel_ev.set)

        def make_on_response(internal):
            def on_response(resp, final):
                msg = pb.ModelStreamInferResponse()
                if resp.error is not None:
                    msg.error_message = resp.error
                    msg.infer_response.id = resp.id
                    if resp.retry_after_s is not None:
                        # a streamed error cannot carry per-RPC trailing
                        # metadata: the retry hint rides the parameters
                        set_param(msg.infer_response.parameters,
                                  "retry_after", f"{resp.retry_after_s:g}")
                else:
                    msg.infer_response.CopyFrom(response_to_proto(resp))
                if internal.trace is not None:
                    # trailing metadata is per RPC: on a stream the trace
                    # id rides every response as a parameter
                    set_param(msg.infer_response.parameters,
                              "triton_trace_id", internal.trace.id)
                out_q.put((msg, final))
            return on_response

        def reader():
            try:
                for req in request_iterator:
                    with state_lock:
                        state["submitted"] += 1
                    try:
                        internal = request_to_internal(req)
                        internal.cancel_event = cancel_ev
                        self.core.infer(
                            internal,
                            response_callback=make_on_response(internal))
                    except Exception as e:  # noqa: BLE001 — every
                        # submitted request must be answered, or the
                        # writer never ends
                        text = (str(e) if isinstance(e, ServerError)
                                else f"{type(e).__name__}: {e}")
                        msg = pb.ModelStreamInferResponse(error_message=text)
                        msg.infer_response.id = req.id
                        out_q.put((msg, True))
            except grpc.RpcError:
                # the caller cancelled the RPC (or the connection died)
                # mid-stream: the context callback already set cancel_ev,
                # so the in-flight streams are being reclaimed
                pass
            finally:
                with state_lock:
                    state["reader_done"] = True
                out_q.put((None, False))  # wake the writer

        threading.Thread(target=reader, daemon=True,
                         name="grpc-stream-reader").start()

        completed = 0
        while True:
            msg, final = out_q.get()
            if msg is not None:
                yield msg
                if final:
                    completed += 1
            with state_lock:
                if state["reader_done"] and completed >= state["submitted"]:
                    return


def _tpu_shm(req, context):
    context.abort(grpc.StatusCode.INVALID_ARGUMENT, TPU_SHM_UNAVAILABLE)


class GrpcInferenceServer:
    # max_workers sizes the RPC thread pool; every live bidi stream holds
    # one worker for its whole lifetime, so the pool must exceed the
    # expected stream count or the unary RPCs (health, statistics) starve
    def __init__(self, core: TorchInferenceServer, host: str = "127.0.0.1",
                 port: int = 8001, max_workers: int = 48,
                 ssl_certfile: str | None = None,
                 ssl_keyfile: str | None = None,
                 ssl_root_certfile: str | None = None,
                 debug_endpoints: bool = False):
        """``ssl_certfile`` serves over TLS with that certificate and
        ``ssl_keyfile`` (omitted: the key is read from the certificate's
        combined PEM, as the HTTP front end's ``load_cert_chain`` reads
        it); ``ssl_root_certfile`` also turns on mutual TLS: a client must
        present a certificate that root signed."""
        self.core = core
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=list(DEFAULT_CHANNEL_OPTIONS) + [
                # a serving front end tolerates aggressive client keepalive;
                # the defaults would GOAWAY with too_many_pings
                ("grpc.keepalive_permit_without_calls", 1),
                ("grpc.http2.min_ping_interval_without_data_ms", 100),
                ("grpc.http2.max_ping_strikes", 0),
            ])
        handlers = _Handlers(core, debug_endpoints=debug_endpoints)
        method_handlers = {}
        for name, (kind, req_cls, resp_cls) in METHODS.items():
            fn = getattr(handlers, name)
            make = (grpc.unary_unary_rpc_method_handler if kind == "unary"
                    else grpc.stream_stream_rpc_method_handler)
            method_handlers[name] = make(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
        for name in _TPU_SHM_RPCS:
            # the port defines no Tpu messages: the request stays raw bytes
            method_handlers[name] = grpc.unary_unary_rpc_method_handler(
                _tpu_shm, request_deserializer=None,
                response_serializer=None)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, method_handlers),))
        if ssl_certfile:
            with open(ssl_keyfile or ssl_certfile, "rb") as f:
                key = f.read()
            with open(ssl_certfile, "rb") as f:
                cert = f.read()
            root = None
            if ssl_root_certfile:
                with open(ssl_root_certfile, "rb") as f:
                    root = f.read()
            creds = grpc.ssl_server_credentials(
                [(key, cert)], root_certificates=root,
                require_client_auth=bool(root))
            self.port = self._server.add_secure_port(f"{host}:{port}", creds)
        else:
            self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "GrpcInferenceServer":
        self._server.start()
        return self

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace)
