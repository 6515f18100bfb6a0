"""numpy <-> gRPC tensor message conversion (shared by client and server).

The port's counterpart of ``client_tpu/protocol/grpc_tensors.py``, on its
own ``kserve_pb2``, ``binary`` and ``dtypes``.

Two data paths, as in the v2 spec:
- ``raw_*_contents``: little-endian packed bytes, one blob per tensor in
  order (the fast path; FP16/BF16 must use it).
- ``InferTensorContents``: typed repeated fields (the JSON-ish slow path).
"""

from __future__ import annotations

import numpy as np

from client_tpu_torch.protocol import kserve_pb2 as pb
from client_tpu_torch.protocol.binary import bytes_to_tensor, tensor_to_bytes
from client_tpu_torch.protocol.dtypes import DataType, wire_to_np_dtype

# wire dtype -> InferTensorContents field name (None => raw-only)
_CONTENTS_FIELD = {
    DataType.BOOL: "bool_contents",
    DataType.INT8: "int_contents",
    DataType.INT16: "int_contents",
    DataType.INT32: "int_contents",
    DataType.INT64: "int64_contents",
    DataType.UINT8: "uint_contents",
    DataType.UINT16: "uint_contents",
    DataType.UINT32: "uint_contents",
    DataType.UINT64: "uint64_contents",
    DataType.FP32: "fp32_contents",
    DataType.FP64: "fp64_contents",
    DataType.BYTES: "bytes_contents",
    DataType.FP16: None,
    DataType.BF16: None,
}


def contents_field(wire_dtype: str):
    try:
        return _CONTENTS_FIELD[wire_dtype]
    except KeyError:
        raise ValueError(f"unknown wire datatype {wire_dtype!r}") from None


def fill_contents(contents: pb.InferTensorContents, tensor: np.ndarray,
                  wire_dtype: str) -> None:
    """Write a tensor into the typed-contents message (slow path)."""
    field = contents_field(wire_dtype)
    if field is None:
        raise ValueError(
            f"{wire_dtype} has no typed-contents field; use raw contents"
        )
    flat = tensor.reshape(-1)
    if wire_dtype == DataType.BYTES:
        vals = [
            bytes(x) if isinstance(x, (bytes, bytearray, np.bytes_))
            else str(x).encode("utf-8")
            for x in flat
        ]
    elif wire_dtype == DataType.BOOL:
        vals = [bool(x) for x in flat]
    else:
        vals = flat.tolist()
    getattr(contents, field).extend(vals)


def contents_to_numpy(contents: pb.InferTensorContents, wire_dtype: str,
                      shape) -> np.ndarray:
    """Read a tensor out of the typed-contents message."""
    field = contents_field(wire_dtype)
    if field is None:
        raise ValueError(f"{wire_dtype} tensors only travel in raw contents")
    vals = getattr(contents, field)
    shape = tuple(int(d) for d in shape)
    if wire_dtype == DataType.BYTES:
        return np.array([bytes(v) for v in vals], dtype=np.object_).reshape(shape)
    return np.array(vals, dtype=wire_to_np_dtype(wire_dtype)).reshape(shape)


def raw_to_numpy(raw: bytes, wire_dtype: str, shape) -> np.ndarray:
    return bytes_to_tensor(raw, wire_dtype, shape)


def numpy_to_raw(tensor: np.ndarray, wire_dtype: str) -> bytes:
    return tensor_to_bytes(tensor, wire_dtype)


def set_param(params_map, key: str, value) -> None:
    """Set an InferParameter map entry from a python value."""
    p = params_map[key]
    if isinstance(value, bool):
        p.bool_param = value
    elif isinstance(value, int):
        p.int64_param = value
    elif isinstance(value, float):
        p.double_param = value
    elif isinstance(value, str):
        p.string_param = value
    else:
        raise ValueError(f"unsupported parameter type {type(value)} for {key}")


def param_value(p: pb.InferParameter):
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else None


def params_to_dict(params_map) -> dict:
    return {k: param_value(v) for k, v in params_map.items()}
