"""HTTP/REST front end: the v2 protocol over HTTP/1.1.

The port's counterpart of ``client_tpu/server/http_server.py``: a
threaded stdlib server (one OS thread per connection, keep-alive on)
whose wire format (JSON + the binary tensor extension) is parsed and
produced by ``client_tpu_torch.protocol.rest``.

Routes: health live/ready, model ready, server metadata (``/v2``), model
metadata, model config, statistics, infer, the Prometheus scrape
(``/metrics``), the trace settings (``/v2[/models/{name}]/trace/setting``,
GET and POST), and the shared-memory extensions: ``/v2/systemsharedmemory``
and ``/v2/cudasharedmemory`` (status, register, unregister).
``/v2/tpusharedmemory`` answers a clear 400 naming
``/v2/cudasharedmemory``, as the reference answers the CUDA verbs. An
infer request's ``triton-trace-id`` header propagates the caller's trace
id, and a traced request's id comes back in the same header.
The repository extension: ``POST /v2/repository/index``,
``/v2/repository/models/{name}/load`` (a ``config`` override in its
parameters) and ``.../unload`` (``unload_dependents``); an infer
request's ``sequence_id``, ``sequence_start`` and ``sequence_end``
parameters drive a stateful model's sequence.
``access_log=True`` logs one structured INFO record per request.
``debug_endpoints=True`` opts into the debug surface: GET
``/v2/debug/runtime``, ``/v2/debug/models/{name}[/versions/{v}]/engine``,
``/v2/debug/slo``, ``/v2/debug/scheduler``, ``/v2/debug/fleet`` (every
replica fleet's routing rows), ``/v2/debug/incidents``,
``/v2/debug/timeline`` (the Chrome-trace document) and
``/v2/debug/traces`` (the completed traces; both take ``?model=``), GET
and POST ``/v2/debug/faults`` and POST ``/v2/debug/profile``; with the
flag off they answer 404 like any unknown path. An armed
``transport_reset`` fault drops the connection before any response byte.
"""

from __future__ import annotations

import base64
import gzip
import json
import logging
import math
import re
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from client_tpu_torch.protocol.rest import (
    INFERENCE_HEADER_CONTENT_LENGTH,
    build_infer_response_body,
    parse_infer_request_body,
    slice_binary_tensors,
    tensor_from_json,
    tensor_json_and_blob,
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

_ROUTES = []

# the opt-in structured access log (HttpInferenceServer(access_log=True)):
# one INFO record per request with its method, path, status and latency,
# in place of BaseHTTPRequestHandler's stderr line, which stays off
_ACCESS_LOG = logging.getLogger("client_tpu_torch.server.http.access")

TRACE_ID_HEADER = "triton-trace-id"

TPU_SHM_UNAVAILABLE = ("this server hosts CUDA devices; TPU shared memory is "
                       "not available — use /v2/cudasharedmemory")


def route(method: str, pattern: str):
    rx = re.compile("^" + pattern + "$")

    def deco(fn):
        _ROUTES.append((method, rx, fn))
        return fn

    return deco


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "client-tpu-torch-http"

    # BaseHTTPRequestHandler logs every request to stderr; keep quiet.
    def log_message(self, fmt, *args):  # noqa: D102
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    @property
    def core(self) -> TorchInferenceServer:
        return self.server.core  # type: ignore[attr-defined]

    # ---- plumbing ----

    def _consume_body(self) -> None:
        """Drain the request body exactly once (keep-alive correctness: an
        unread body would desync the next request on the connection)."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        enc = (self.headers.get("Content-Encoding") or "").lower()
        if enc == "gzip":
            body = gzip.decompress(body)
        elif enc == "deflate":
            body = zlib.decompress(body)
        self._body = body

    def _send(self, status: int, body: bytes = b"",
              content_type: str = "application/json",
              extra_headers: dict | None = None) -> None:
        accept = (self.headers.get("Accept-Encoding") or "").lower()
        headers = dict(extra_headers or {})
        if body and len(body) > 1024:
            if "gzip" in accept:
                body = gzip.compress(body, compresslevel=1)
                headers["Content-Encoding"] = "gzip"
            elif "deflate" in accept:
                body = zlib.compress(body, level=1)
                headers["Content-Encoding"] = "deflate"
        self._status = status
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, str(v))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json(self, status: int, obj) -> None:
        self._send(status, json.dumps(obj, separators=(",", ":")).encode())

    def _send_error_json(self, status: int, msg: str,
                         retry_after: float | None = None) -> None:
        # Retry-After is emitted exactly when the server set a hint (the
        # admission-control sheds); RFC 7231 delta-seconds is an integer,
        # so sub-second backoffs round UP
        extra = None
        if retry_after is not None:
            extra = {"Retry-After": str(max(1, math.ceil(retry_after)))}
        self._send(status,
                   json.dumps({"error": msg},
                              separators=(",", ":")).encode(),
                   extra_headers=extra)

    def _dispatch(self, method: str) -> None:
        path = unquote(self.path.split("?", 1)[0]).rstrip("/") or "/"
        access_log = self.server.access_log  # type: ignore[attr-defined]
        t0 = time.monotonic_ns() if access_log else 0
        self._status = 0
        try:
            self._consume_body()
            # fault point: an armed transport_reset drops the connection
            # before any response byte (the client sees a reset)
            if faultinject.fire("transport_reset",
                                transport="http") is not None:
                self.close_connection = True
                return
            for m, rx, fn in _ROUTES:
                if m != method:
                    continue
                match = rx.match(path)
                if match:
                    fn(self, **match.groupdict())
                    return
            self._send_error_json(404, f"no handler for {method} {path}")
        except ServerError as e:
            self._send_error_json(e.status, str(e),
                                  retry_after=e.retry_after)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            # malformed request (bad JSON, lying framing headers, missing
            # fields) — client error, not server fault
            self._send_error_json(400, f"{type(e).__name__}: {e}")
        except BrokenPipeError:  # client went away
            self.close_connection = True
        except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
            self._send_error_json(500, f"{type(e).__name__}: {e}")
        finally:
            if access_log:
                _ACCESS_LOG.info(
                    "method=%s path=%s status=%d latency_us=%d",
                    method, path, self._status,
                    (time.monotonic_ns() - t0) // 1000)

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    # ---- health / metadata ----

    @route("GET", r"/v2/health/live")
    def health_live(self):
        self._send(200 if self.core.live() else 400)

    @route("GET", r"/v2/health/ready")
    def health_ready(self):
        self._send(200 if self.core.ready() else 400)

    @route("GET", r"/v2/models/(?P<name>[^/]+)(/versions/(?P<version>[^/]+))?/ready")
    def model_ready(self, name, version=None):
        self._send(200 if self.core.model_ready(name, version or "") else 400)

    @route("GET", r"/v2")
    def server_metadata(self):
        self._send_json(200, self.core.metadata())

    @route("GET", r"/v2/models/(?P<name>[^/]+)(/versions/(?P<version>[^/]+))?")
    def model_metadata(self, name, version=None):
        self._send_json(200, self.core.model_metadata(name, version or ""))

    @route("GET", r"/v2/models/(?P<name>[^/]+)(/versions/(?P<version>[^/]+))?/config")
    def model_config(self, name, version=None):
        self._send_json(200, self.core.model_config(name, version or ""))

    @route("GET", r"/v2/models(/(?P<name>[^/]+)(/versions/(?P<version>[^/]+))?)?/stats")
    def model_stats(self, name=None, version=None):
        self._send_json(200, self.core.statistics(name or "", version or ""))

    # ---- metrics (the Prometheus scrape) ----

    @route("GET", r"/metrics")
    def metrics(self):
        self._send(200, self.core.metrics_text().encode(),
                   content_type="text/plain; version=0.0.4; charset=utf-8")

    # ---- debug introspection (opt-in: HttpInferenceServer(
    #      debug_endpoints=True) / --debug-endpoints) ----

    def _require_debug(self) -> None:
        if not self.server.debug_endpoints:  # type: ignore[attr-defined]
            # 404, not 403: with the flag off this surface does not exist
            raise ServerError(
                f"no handler for {self.command} {self.path}", 404)

    @route("GET", r"/v2/debug/runtime")
    def debug_runtime(self):
        self._require_debug()
        self._send_json(200, self.core.debug_runtime())

    @route("GET", r"/v2/debug/models/(?P<name>[^/]+)(/versions/(?P<version>[^/]+))?/engine")
    def debug_engine(self, name, version=None):
        self._require_debug()
        self._send_json(200, self.core.debug_engine(name, version or ""))

    @route("GET", r"/v2/debug/slo")
    def debug_slo(self):
        self._require_debug()
        self._send_json(200, self.core.debug_slo())

    @route("GET", r"/v2/debug/scheduler")
    def debug_scheduler(self):
        self._require_debug()
        self._send_json(200, self.core.debug_scheduler())

    @route("GET", r"/v2/debug/fleet")
    def debug_fleet(self):
        self._require_debug()
        self._send_json(200, self.core.debug_fleet())

    @route("GET", r"/v2/debug/incidents")
    def debug_incidents(self):
        self._require_debug()
        self._send_json(200, self.core.debug_incidents())

    @route("GET", r"/v2/debug/timeline")
    def debug_timeline(self):
        self._require_debug()
        name = parse_qs(urlparse(self.path).query).get("model", [""])[0]
        self._send_json(200, self.core.debug_timeline(name))

    @route("GET", r"/v2/debug/traces")
    def debug_traces(self):
        self._require_debug()
        name = parse_qs(urlparse(self.path).query).get("model", [""])[0]
        self._send_json(200, self.core.debug_traces(name))

    @route("GET", r"/v2/debug/faults")
    def debug_faults_get(self):
        self._require_debug()
        self._send_json(200, self.core.debug_faults())

    @route("POST", r"/v2/debug/faults")
    def debug_faults_post(self):
        # gated like the rest of /v2/debug/*: a production server exposes
        # no crash button
        self._require_debug()
        body = json.loads(self._body or b"{}")
        self._send_json(200, self.core.debug_faults_update(body))

    @route("POST", r"/v2/debug/profile")
    def debug_profile(self):
        self._require_debug()
        body = json.loads(self._body or b"{}")
        self._send_json(200, self.core.debug_profile(
            body.get("log_dir", ""), float(body.get("duration_s", 1.0))))

    # ---- trace ----

    @route("GET", r"/v2(/models/(?P<name>[^/]+))?/trace/setting")
    def trace_get(self, name=None):
        self._send_json(200, self.core.get_trace_settings(name or ""))

    @route("POST", r"/v2(/models/(?P<name>[^/]+))?/trace/setting")
    def trace_post(self, name=None):
        body = json.loads(self._body or b"{}")
        self._send_json(200, self.core.update_trace_settings(name or "", body))

    # ---- repository ----

    @route("POST", r"/v2/repository/index")
    def repo_index(self):
        body = self._body
        ready = False
        if body:
            ready = bool(json.loads(body or b"{}").get("ready", False))
        self._send_json(200, self.core.repository_index(ready))

    @route("POST", r"/v2/repository/models/(?P<name>[^/]+)/load")
    def repo_load(self, name):
        body = self._body
        override = None
        if body:
            params = json.loads(body).get("parameters", {})
            cfg = params.get("config")
            if cfg:
                override = json.loads(cfg) if isinstance(cfg, str) else cfg
        self.core.load_model(name, override)
        self._send_json(200, {})

    @route("POST", r"/v2/repository/models/(?P<name>[^/]+)/unload")
    def repo_unload(self, name):
        body = self._body
        unload_dependents = False
        if body:
            params = json.loads(body).get("parameters", {})
            unload_dependents = bool(params.get("unload_dependents", False))
        self.core.unload_model(name, unload_dependents)
        self._send_json(200, {})

    # ---- shared memory ----

    @route("GET", r"/v2/systemsharedmemory(/region/(?P<name>[^/]+))?/status")
    def sys_shm_status(self, name=None):
        self._send_json(200, self.core.system_shm.status(name))

    @route("POST", r"/v2/systemsharedmemory/region/(?P<name>[^/]+)/register")
    def sys_shm_register(self, name):
        body = json.loads(self._body or b"{}")
        self.core.system_shm.register(
            name, body["key"], int(body.get("offset", 0)),
            int(body["byte_size"]))
        self._send_json(200, {})

    @route("POST", r"/v2/systemsharedmemory(/region/(?P<name>[^/]+))?/unregister")
    def sys_shm_unregister(self, name=None):
        if name is None:
            self.core.system_shm.unregister_all()
        else:
            self.core.system_shm.unregister(name)
        self._send_json(200, {})

    @route("GET", r"/v2/cudasharedmemory(/region/(?P<name>[^/]+))?/status")
    def cuda_shm_status(self, name=None):
        self._send_json(200, self.core.cuda_shm.status(name))

    @route("POST", r"/v2/cudasharedmemory/region/(?P<name>[^/]+)/register")
    def cuda_shm_register(self, name):
        body = json.loads(self._body or b"{}")
        raw = body.get("raw_handle", {})
        handle_b64 = raw.get("b64") if isinstance(raw, dict) else raw
        if not handle_b64:
            raise ServerError("raw_handle.b64 is required", 400)
        # the raw handle is itself base64 JSON; the REST field wraps it in
        # one more base64 layer (as the CUDA raw_handle {b64: ...} does)
        self.core.cuda_shm.register(name, base64.b64decode(handle_b64),
                                    int(body.get("device_id", 0)),
                                    int(body.get("byte_size", 0)))
        self._send_json(200, {})

    @route("POST", r"/v2/cudasharedmemory(/region/(?P<name>[^/]+))?/unregister")
    def cuda_shm_unregister(self, name=None):
        if name is None:
            self.core.cuda_shm.unregister_all()
        else:
            self.core.cuda_shm.unregister(name)
        self._send_json(200, {})

    @route("GET", r"/v2/tpusharedmemory(/.*)?")
    def tpu_shm_get(self):
        self._send_error_json(400, TPU_SHM_UNAVAILABLE)

    @route("POST", r"/v2/tpusharedmemory(/.*)?")
    def tpu_shm_post(self):
        self._send_error_json(400, TPU_SHM_UNAVAILABLE)

    # ---- infer ----

    @route("POST", r"/v2/models/(?P<name>[^/]+)(/versions/(?P<version>[^/]+))?/infer")
    def infer(self, name, version=None):
        hdr_len = self.headers.get(INFERENCE_HEADER_CONTENT_LENGTH)
        header, tail = parse_infer_request_body(
            self._body, int(hdr_len) if hdr_len else None)
        binmap = slice_binary_tensors(header.get("inputs", []), tail)
        request = _wire_to_request(name, version or "", header, binmap)
        request.trace_id = self.headers.get(TRACE_ID_HEADER, "") or ""
        response = self.core.infer(request)
        body_out, json_size = _response_to_wire(header, response)
        extra = {INFERENCE_HEADER_CONTENT_LENGTH: json_size}
        if request.trace is not None:
            extra[TRACE_ID_HEADER] = request.trace.id
        self._send(200, body_out,
                   content_type="application/octet-stream",
                   extra_headers=extra)


def _wire_to_request(name: str, version: str, header: dict,
                     binmap: dict) -> InferRequest:
    req_params = dict(header.get("parameters") or {})
    inputs = []
    for tj in header.get("inputs", []):
        params = dict(tj.get("parameters") or {})
        shm_region = params.pop("shared_memory_region", None)
        shm_offset = int(params.pop("shared_memory_offset", 0) or 0)
        shm_size = int(params.pop("shared_memory_byte_size", 0) or 0)
        params.pop("binary_data_size", None)
        t = InferTensor(name=tj["name"], datatype=tj.get("datatype", ""),
                        shape=tuple(int(d) for d in tj.get("shape", [])),
                        parameters=params)
        if shm_region is not None:
            t.shm_region = shm_region
            t.shm_offset = shm_offset
            t.shm_byte_size = shm_size
        else:
            t.data = tensor_from_json(tj, binmap)
        inputs.append(t)
    outputs = []
    default_binary = bool(req_params.pop("binary_data_output", False))
    for oj in header.get("outputs", []):
        params = dict(oj.get("parameters") or {})
        outputs.append(RequestedOutput(
            name=oj["name"],
            binary_data=bool(params.pop("binary_data", default_binary)),
            classification_count=int(params.pop("classification", 0) or 0),
            shm_region=params.pop("shared_memory_region", None),
            shm_offset=int(params.pop("shared_memory_offset", 0) or 0),
            shm_byte_size=int(params.pop("shared_memory_byte_size", 0) or 0),
            parameters=params))
    return InferRequest(
        model_name=name, model_version=version,
        id=str(header.get("id", "")),
        inputs=inputs, outputs=outputs, parameters=req_params,
        priority=parse_int_param(req_params, "priority"),
        timeout_us=parse_int_param(req_params, "timeout"),
        tenant_id=parse_label_param(req_params, "tenant_id",
                                    DEFAULT_TENANT),
        slo_class=parse_label_param(req_params, "slo_class",
                                    DEFAULT_SLO_CLASS),
        sequence_id=req_params.pop("sequence_id", 0),
        sequence_start=bool(req_params.pop("sequence_start", False)),
        sequence_end=bool(req_params.pop("sequence_end", False)))


def _response_to_wire(request_header: dict, response) -> tuple:
    default_binary = bool((request_header.get("parameters") or {})
                          .get("binary_data_output", False))
    requested = {o["name"]: dict(o.get("parameters") or {})
                 for o in request_header.get("outputs", [])}
    out_json = []
    blobs = []
    for t in response.outputs:
        if t.shm_region is not None:
            out_json.append({
                "name": t.name, "datatype": t.datatype,
                "shape": list(t.shape),
                "parameters": {"shared_memory_region": t.shm_region,
                               "shared_memory_offset": t.shm_offset,
                               "shared_memory_byte_size": t.shm_byte_size}})
            continue
        params = requested.get(t.name)
        binary = bool(params.get("binary_data", default_binary)) \
            if params is not None else default_binary
        tj, blob = tensor_json_and_blob(t.name, t.data, t.datatype, t.shape,
                                        binary)
        out_json.append(tj)
        if blob is not None:
            blobs.append(blob)
    resp_json = {
        "model_name": response.model_name,
        "model_version": response.model_version,
        "outputs": out_json,
    }
    if response.id:
        resp_json["id"] = response.id
    if response.parameters:
        resp_json["parameters"] = response.parameters
    return build_infer_response_body(resp_json, blobs)


class HttpInferenceServer:
    """Bind + serve a TorchInferenceServer core over HTTP(S)."""

    def __init__(self, core: TorchInferenceServer, host: str = "127.0.0.1",
                 port: int = 8000, verbose: bool = False,
                 access_log: bool = False, debug_endpoints: bool = False,
                 ssl_certfile: str | None = None,
                 ssl_keyfile: str | None = None):
        """``debug_endpoints`` opts into the ``/v2/debug/*`` routes; with
        the flag off they answer 404 like any unknown path.
        ``ssl_certfile`` serves HTTPS: the listening socket is wrapped in
        a TLS server context loaded with that certificate chain and
        ``ssl_keyfile`` (None: the key is in the certificate's PEM)."""
        self.core = core

        # a burst of concurrent clients opens its connections at once;
        # the stdlib default backlog of 5 resets the overflow
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self._httpd = _Server((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.core = core  # type: ignore[attr-defined]
        self._httpd.verbose = verbose  # type: ignore[attr-defined]
        self._httpd.access_log = access_log  # type: ignore[attr-defined]
        self._httpd.debug_endpoints = debug_endpoints  # type: ignore[attr-defined]
        if ssl_certfile:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=ssl_certfile, keyfile=ssl_keyfile)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                 server_side=True)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = None

    def start(self) -> "HttpInferenceServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="http-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"
