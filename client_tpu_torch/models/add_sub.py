"""add_sub and identity models — the protocol-test workhorses, the port's
counterparts of ``client_tpu/models/add_sub.py``.

``make_add_sub`` serves INPUT0+INPUT1 / INPUT0-INPUT1 and
``make_identity`` passes INPUT0 through, both as TorchModels on the
card unless ``device="cpu"`` is asked for; ``make_add_sub_string`` is
their BYTES variant (numeric strings in and out), a host model.
``make_identity(delay_s=)`` sleeps in a host model before it answers, for
client-timeout tests; ``make_add_sub(response_cache=True)`` lets the
server's response cache serve repeated requests.
"""

from __future__ import annotations

import time

from client_tpu_torch.server.config import (
    DynamicBatchingConfig,
    ModelConfig,
    TensorSpec,
)
import numpy as np

from client_tpu_torch.server.model import PyModel, TorchModel


def make_add_sub(name: str = "add_sub", size: int = 16,
                 datatype: str = "INT32", max_batch_size: int = 0,
                 dynamic_batching: bool = False,
                 response_cache: bool = False,
                 device=None) -> TorchModel:
    """INPUT0/INPUT1 -> OUTPUT0=sum, OUTPUT1=difference."""

    def apply_fn(params, inputs):
        a, b = inputs["INPUT0"], inputs["INPUT1"]
        return {"OUTPUT0": a + b, "OUTPUT1": a - b}

    config = ModelConfig(
        name=name,
        max_batch_size=max_batch_size,
        inputs=(TensorSpec("INPUT0", datatype, (size,)),
                TensorSpec("INPUT1", datatype, (size,))),
        outputs=(TensorSpec("OUTPUT0", datatype, (size,)),
                 TensorSpec("OUTPUT1", datatype, (size,))),
        dynamic_batching=(DynamicBatchingConfig(
            max_queue_delay_microseconds=500)
            if dynamic_batching else None),
        response_cache=response_cache,
    )
    return TorchModel(config, apply_fn, device=device)


def make_add_sub_string(name: str = "add_sub_string",
                        size: int = 16) -> PyModel:
    """BYTES variant: numeric strings in, sum/difference strings out."""

    def fn(inputs):
        a = np.array([int(x) for x in inputs["INPUT0"].reshape(-1)],
                     dtype=np.int64)
        b = np.array([int(x) for x in inputs["INPUT1"].reshape(-1)],
                     dtype=np.int64)
        shape = inputs["INPUT0"].shape
        out0 = np.array([str(v).encode() for v in a + b],
                        dtype=np.object_).reshape(shape)
        out1 = np.array([str(v).encode() for v in a - b],
                        dtype=np.object_).reshape(shape)
        return {"OUTPUT0": out0, "OUTPUT1": out1}

    config = ModelConfig(
        name=name,
        inputs=(TensorSpec("INPUT0", "BYTES", (size,)),
                TensorSpec("INPUT1", "BYTES", (size,))),
        outputs=(TensorSpec("OUTPUT0", "BYTES", (size,)),
                 TensorSpec("OUTPUT1", "BYTES", (size,))),
    )
    return PyModel(config, fn)


def make_identity(name: str = "identity", size: int = 16,
                  datatype: str = "INT32", max_batch_size: int = 0,
                  delay_s: float = 0.0, device=None):
    """Pass-through model. With ``delay_s`` it is a host ``PyModel`` that
    sleeps that long before it answers (a sleep has no place among a
    TorchModel's device ops); without one a TorchModel."""
    config = ModelConfig(
        name=name,
        max_batch_size=max_batch_size,
        inputs=(TensorSpec("INPUT0", datatype, (size,)),),
        outputs=(TensorSpec("OUTPUT0", datatype, (size,)),),
    )
    if delay_s:
        def fn(inputs):
            time.sleep(delay_s)
            return {"OUTPUT0": inputs["INPUT0"]}

        return PyModel(config, fn)
    return TorchModel(config, lambda params, inputs: {
        "OUTPUT0": inputs["INPUT0"]}, device=device)
