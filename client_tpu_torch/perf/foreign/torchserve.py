"""TorchServe HTTP perf backend: the port's copy of
``client_tpu/perf/foreign/torchserve.py``.

A multipart file upload named ``data`` to ``POST /predictions/{model}``;
Infer, AsyncInfer and client stats only. The model's single input
``TORCHSERVE_INPUT`` (BYTES, shape [1]) carries the *path* of the file to
upload, given through ``--input-data`` JSON. The standard library only:
no grpcio, no protobuf.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

import numpy as np

from client_tpu_torch.perf.client_backend import ClientBackend


class TorchServeResult:
    def __init__(self, body: bytes, status: int):
        self.body = body
        self.status = status

    def get_response(self):
        return {"status": self.status, "body": self.body}

    def as_numpy(self, name: str) -> Optional[np.ndarray]:  # noqa: ARG002
        # TorchServe responses are free-form JSON; expose raw bytes
        return np.frombuffer(self.body, dtype=np.uint8)


class TorchServeBackend(ClientBackend):
    kind = "torchserve"

    def __init__(self, url: str, verbose: bool = False,
                 async_workers: int = 8):
        from concurrent.futures import ThreadPoolExecutor

        if "://" not in url:
            url = "http://" + url
        self._url = url
        self._verbose = verbose
        self._local = threading.local()
        self._pool = ThreadPoolExecutor(
            max_workers=async_workers, thread_name_prefix="torchserve-async")
        self._init_stat()

    def _conn(self):
        import http.client
        from urllib.parse import urlparse

        conn = getattr(self._local, "conn", None)
        if conn is None:
            p = urlparse(self._url)
            conn = http.client.HTTPConnection(p.hostname, p.port or 8080)
            self._local.conn = conn
        return conn

    # -- control plane (TorchServe exposes no model metadata) --

    def server_extensions(self) -> list:
        return []

    def model_metadata(self, name: str, version: str = "") -> dict:
        return {"name": name}

    def model_config(self, name: str, version: str = "") -> dict:
        return {}

    # -- data plane --

    @staticmethod
    def _file_bytes(inputs) -> bytes:
        """The single BYTES input holds the file path to upload."""
        if not inputs or inputs[0].data is None:
            raise ValueError(
                "torchserve backend requires one BYTES input holding a "
                "file path (--input-data JSON)")
        item = np.asarray(inputs[0].data).reshape(-1)[0]
        path = item.decode() if isinstance(item, bytes) else str(item)
        with open(path, "rb") as f:
            return f.read()

    def infer(self, model_name: str, inputs, outputs=None, **options):
        payload = self._file_bytes(inputs)
        boundary = uuid.uuid4().hex
        body = (f"--{boundary}\r\n"
                f"Content-Disposition: form-data; name=\"data\"; "
                f"filename=\"input\"\r\n"
                f"Content-Type: application/octet-stream\r\n\r\n"
                ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
        conn = self._conn()
        t0 = time.monotonic_ns()
        try:
            conn.request(
                "POST", f"/predictions/{model_name}", body=body,
                headers={"Content-Type":
                         f"multipart/form-data; boundary={boundary}",
                         "Content-Length": str(len(body))})
            resp = conn.getresponse()
            data = resp.read()
        except Exception:
            self._local.conn = None  # drop the broken keep-alive conn
            raise
        if resp.status >= 400:
            raise RuntimeError(
                f"torchserve inference failed ({resp.status}): "
                f"{data[:200]!r}")
        # only successful inferences count (same contract as the v2
        # backends: _record on success)
        self._record(t0, time.monotonic_ns())
        return TorchServeResult(data, resp.status)

    def async_infer(self, callback, model_name: str, inputs, outputs=None,
                    **options) -> None:
        def run():
            try:
                res = self.infer(model_name, inputs, outputs, **options)
                callback(res, None)
            except Exception as e:  # noqa: BLE001
                callback(None, e)

        self._pool.submit(run)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
