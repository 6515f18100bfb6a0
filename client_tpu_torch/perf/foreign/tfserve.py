"""TF-Serving gRPC perf backend: the port's copy of
``client_tpu/perf/foreign/tfserve.py``.

Speaks ``/tensorflow.serving.PredictionService/Predict`` and
``GetModelMetadata`` with the port's own TFS-subset messages
(``tfs_pb2.py``; ``tfs.proto`` keeps the public field numbers, so this
drives a real TF-Serving endpoint). Infer, AsyncInfer and client stats
only: no streaming, no shared memory, no server statistics. It needs
grpcio and protobuf; the package imports it only when asked for it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from client_tpu_torch.perf.client_backend import ClientBackend
from client_tpu_torch.perf.foreign import tfs_pb2 as pb

_SERVICE = "/tensorflow.serving.PredictionService/"

# v2 wire dtype <-> TFS DataType
_TO_TFS = {
    "FP32": pb.DT_FLOAT, "FP64": pb.DT_DOUBLE, "INT32": pb.DT_INT32,
    "INT64": pb.DT_INT64, "INT16": pb.DT_INT16, "INT8": pb.DT_INT8,
    "UINT8": pb.DT_UINT8, "UINT32": pb.DT_UINT32, "UINT64": pb.DT_UINT64,
    "BOOL": pb.DT_BOOL, "BYTES": pb.DT_STRING, "FP16": pb.DT_HALF,
    "BF16": pb.DT_BFLOAT16,
}
_FROM_TFS = {v: k for k, v in _TO_TFS.items()}


class TfsResult:
    """Predict response wrapper with the as_numpy surface perf expects."""

    def __init__(self, response: pb.PredictResponse):
        self._response = response

    def get_response(self):
        return self._response

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        from client_tpu_torch.protocol.dtypes import wire_to_np_dtype

        if name not in self._response.outputs:
            return None
        t = self._response.outputs[name]
        shape = tuple(d.size for d in t.tensor_shape.dim)
        wire = _FROM_TFS.get(t.dtype)
        if wire == "BYTES":
            return np.array(list(t.string_val), dtype=object).reshape(shape)
        np_dtype = wire_to_np_dtype(wire)
        if t.tensor_content:
            return np.frombuffer(
                t.tensor_content, dtype=np_dtype).reshape(shape)
        for field, field_dtype in (
                (t.float_val, np.float32), (t.double_val, np.float64),
                (t.int_val, np.int32), (t.int64_val, np.int64),
                (t.bool_val, np.bool_), (t.uint32_val, np.uint32),
                (t.uint64_val, np.uint64)):
            if field:
                return np.asarray(field, field_dtype).reshape(shape) \
                    .astype(np_dtype, copy=False)
        if t.half_val:  # fp16/bf16 ride int32 bit patterns (tensor.proto)
            bits = np.asarray(t.half_val, np.int32).astype(np.uint16)
            return bits.view(np_dtype).reshape(shape)
        n = int(np.prod(shape)) if shape else 1
        if n == 0:
            return np.zeros(shape, np_dtype)
        raise ValueError(
            f"TF-Serving output '{name}' ({pb.DataType.Name(t.dtype)}) has "
            "no tensor_content and no recognized value field")


class TfServeBackend(ClientBackend):
    kind = "tfserve"

    def __init__(self, url: str, verbose: bool = False,
                 signature_name: str = "serving_default"):
        import grpc

        self._verbose = verbose
        self.signature_name = signature_name
        self._channel = grpc.insecure_channel(url)
        self._predict = self._channel.unary_unary(
            _SERVICE + "Predict",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.PredictResponse.FromString)
        self._get_metadata = self._channel.unary_unary(
            _SERVICE + "GetModelMetadata",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.GetModelMetadataResponse.FromString)
        self._init_stat()

    # -- control plane --

    def server_extensions(self) -> list:
        return []  # TF-Serving has no v2 extension discovery

    def model_metadata(self, name: str, version: str = "") -> dict:
        """GetModelMetadata -> the JSON shape of a proto->JSON conversion,
        which ModelParser.init_tfserve consumes."""
        req = pb.GetModelMetadataRequest()
        req.model_spec.name = name
        if version:
            req.model_spec.version.value = int(version)
        req.metadata_field.append("signature_def")
        resp = self._get_metadata(req)
        sig_map = pb.SignatureDefMap()
        any_proto = resp.metadata["signature_def"]
        sig_map.ParseFromString(any_proto.value)

        def tensor_info_json(info: pb.TensorInfo) -> dict:
            shape = {"dim": [{"size": str(d.size)}
                             for d in info.tensor_shape.dim],
                     "unknown_rank": bool(info.tensor_shape.unknown_rank)}
            return {"name": info.name,
                    "dtype": pb.DataType.Name(info.dtype),
                    "tensor_shape": shape}

        sigs = {}
        for sig_name, sig in sig_map.signature_def.items():
            sigs[sig_name] = {
                "inputs": {k: tensor_info_json(v)
                           for k, v in sig.inputs.items()},
                "outputs": {k: tensor_info_json(v)
                            for k, v in sig.outputs.items()},
                "method_name": sig.method_name,
            }
        return {"metadata": {"signature_def": {"signature_def": sigs}}}

    def model_config(self, name: str, version: str = "") -> dict:
        return {}  # TF-Serving exposes no Triton-style config

    # -- data plane --

    def _build_request(self, model_name, inputs, options):
        req = pb.PredictRequest()
        req.model_spec.name = model_name
        version = options.get("model_version", "")
        if version:
            req.model_spec.version.value = int(version)
        req.model_spec.signature_name = self.signature_name
        for i in inputs:
            if i.shm:
                raise NotImplementedError(
                    "shared memory not supported by TF-Serving backend "
                    "(ref parity)")
            t = req.inputs[i.name]
            t.dtype = _TO_TFS[i.datatype]
            for d in i.shape:
                dim = t.tensor_shape.dim.add()
                dim.size = int(d)
            arr = i.data
            if arr.dtype == np.object_:
                for item in arr.reshape(-1):
                    t.string_val.append(
                        item if isinstance(item, bytes) else
                        str(item).encode())
            else:
                t.tensor_content = np.ascontiguousarray(arr).tobytes()
        return req

    def infer(self, model_name: str, inputs, outputs=None, **options):
        req = self._build_request(model_name, inputs, options)
        timeout = options.get("timeout")
        t0 = time.monotonic_ns()
        resp = self._predict(
            req, timeout=(timeout / 1e6 if timeout else None))
        self._record(t0, time.monotonic_ns())
        return TfsResult(resp)

    def async_infer(self, callback, model_name: str, inputs, outputs=None,
                    **options) -> None:
        req = self._build_request(model_name, inputs, options)
        timeout = options.get("timeout")
        t0 = time.monotonic_ns()
        future = self._predict.future(
            req, timeout=(timeout / 1e6 if timeout else None))

        def done(f):
            self._record(t0, time.monotonic_ns())
            err = f.exception()
            callback(None if err else TfsResult(f.result()), err)

        future.add_done_callback(done)

    def close(self) -> None:
        self._channel.close()
