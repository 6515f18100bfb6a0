"""Device selection for the port's entry points, and the wire datatypes
of tensors.

The port runs on the card. An entry point given no device takes CUDA,
and one that finds no CUDA raises: it never moves quietly to the CPU.
The CPU is used only when the caller names it (the tests do).
"""

from __future__ import annotations

import numpy as np
import torch

from client_tpu_torch.protocol.dtypes import np_to_wire_dtype


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for (or
    implied) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def canonical_device(device) -> torch.device:
    """The device a tensor made on ``device`` reports: ``cuda`` takes the
    current CUDA device's index, so ``tensor.device == canonical`` is one
    comparison."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_WIRE_TO_TORCH = {
    "BOOL": torch.bool, "UINT8": torch.uint8, "INT8": torch.int8,
    "INT16": torch.int16, "INT32": torch.int32, "INT64": torch.int64,
    "FP16": torch.float16, "FP32": torch.float32, "FP64": torch.float64,
    "BF16": torch.bfloat16,
}
_TORCH_TO_WIRE = {v: k for k, v in _WIRE_TO_TORCH.items()}


def torch_dtype_of_wire(wire: str):
    """The torch dtype of a wire datatype (None for BYTES and the
    unsigned types torch does not compute in)."""
    return _WIRE_TO_TORCH.get(wire)


def wire_dtype_of(arr) -> str:
    """Wire datatype of a torch tensor or a numpy array."""
    if isinstance(arr, torch.Tensor):
        return _TORCH_TO_WIRE[arr.dtype]
    return np_to_wire_dtype(np.asarray(arr).dtype)


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes in row-major order, copied to the host (any dtype,
    bf16 included: the bytes are reinterpreted, not converted)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu() \
        .numpy().tobytes()
