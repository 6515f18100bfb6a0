"""Decoupled and stateful demo models: the port's counterparts of
``client_tpu/models/streaming.py``.

``make_repeat`` (``repeat_int32``) streams IN[i] once per element, WAIT
microseconds apart, as a decoupled host model. ``make_accumulator`` is a
stateful sequence model: the running sum of INPUT over a correlation id,
its state a tensor on the model's device (the card unless
``device="cpu"`` is asked for).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from client_tpu_torch.device import resolve_device, torch_dtype_of_wire
from client_tpu_torch.server.config import (
    ModelConfig,
    SequenceBatchingConfig,
    TensorSpec,
)
from client_tpu_torch.server.model import PyModel, SequenceModel


def make_repeat(name: str = "repeat_int32") -> PyModel:
    """Decoupled: emits IN[i] once per element, WAIT microseconds apart."""

    def stream_fn(inputs):
        data = np.asarray(inputs["IN"]).reshape(-1)
        waits = np.asarray(inputs.get("WAIT", np.zeros_like(data))).reshape(-1)
        for i, v in enumerate(data):
            if i < len(waits) and waits[i] > 0:
                time.sleep(float(waits[i]) / 1e6)
            yield {"OUT": np.array([v], dtype=data.dtype)}

    config = ModelConfig(
        name=name,
        backend="python",
        platform="python",
        decoupled=True,
        inputs=(TensorSpec("IN", "INT32", (-1,)),
                TensorSpec("WAIT", "INT32", (-1,), optional=True)),
        outputs=(TensorSpec("OUT", "INT32", (1,)),),
    )
    return PyModel(config, fn=None, stream_fn=stream_fn)


def make_accumulator(name: str = "accumulator", size: int = 1,
                     datatype: str = "INT32", device=None) -> SequenceModel:
    """Stateful sequence model: the running sum over a correlation id.
    The state is a ``[size]`` tensor on the model's device; each step
    adds INPUT to it and answers the new sum."""
    dev = resolve_device(device)
    torch_dtype = torch_dtype_of_wire(datatype)

    def step_fn(params, inputs, state):
        new_state = state + inputs["INPUT"]
        return {"OUTPUT": new_state}, new_state

    def init_state_fn():
        return torch.zeros((size,), dtype=torch_dtype, device=dev)

    config = ModelConfig(
        name=name,
        inputs=(TensorSpec("INPUT", datatype, (size,)),),
        outputs=(TensorSpec("OUTPUT", datatype, (size,)),),
        sequence_batching=SequenceBatchingConfig(),
    )
    return SequenceModel(config, step_fn, init_state_fn, device=dev)
