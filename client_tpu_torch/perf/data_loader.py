"""DataLoader — provides the input tensors the load managers send: the
port's copy of ``client_tpu/perf/data_loader.py``.

Synthetic random/zero data, string data, per-tensor files from a
directory, and the multi-stream multi-step JSON format (``{"data":
[...]}`` with ``b64``/explicit values, per-step shapes, and validation
outputs) used for sequence models; plus the shared-prefix synthetic
workload (``generate_shared_prefix_data``) — N streams whose token
prompts share one common prefix and diverge into per-stream random
suffixes, the traffic shape a generation engine's prefix cache sees.

Random integers lie in [0, 127): inside any model's vocabulary the
repo serves, so a token gather never reads out of range.
"""

from __future__ import annotations

import base64
import json
import os
import random
import string as _string
from typing import Optional

import numpy as np

from client_tpu_torch.protocol.binary import deserialize_bytes_tensor
from client_tpu_torch.protocol.dtypes import wire_to_np_dtype


def _np_dtype(wire: str):
    return wire_to_np_dtype(wire)


class DataLoader:
    def __init__(self, batch_size: int = 1):
        self.batch_size = batch_size
        # data_[stream][step][tensor_name] -> np.ndarray
        self._data: list[list[dict]] = []
        self._shapes: list[list[dict]] = []
        self._outputs: list[list[dict]] = []

    # ---- population ----

    def generate_data(self, inputs: dict, zero_data: bool = False,
                      string_data: Optional[str] = None,
                      string_length: int = 128, seed: int = 0) -> None:
        """One stream, one step of synthetic data."""
        rng = np.random.default_rng(seed)
        step = {}
        for name, info in inputs.items():
            dims = [abs(d) for d in info.dims]
            if info.datatype == "BYTES":
                if string_data is not None:
                    val = string_data
                    arr = np.full(dims, val.encode(), dtype=np.object_)
                elif zero_data:
                    arr = np.full(dims, b"", dtype=np.object_)
                else:
                    pyr = random.Random(seed)
                    flat = [
                        "".join(pyr.choices(_string.ascii_letters,
                                            k=string_length)).encode()
                        for _ in range(int(np.prod(dims)) if dims else 1)]
                    arr = np.array(flat, dtype=np.object_).reshape(dims)
            else:
                np_dtype = _np_dtype(info.datatype)
                if zero_data:
                    arr = np.zeros(dims, dtype=np_dtype)
                elif np_dtype == np.bool_:
                    arr = rng.integers(0, 2, dims).astype(np.bool_)
                elif np.issubdtype(np_dtype, np.integer):
                    arr = rng.integers(0, 127, dims).astype(np_dtype)
                else:
                    arr = rng.random(dims).astype(np_dtype)
            step[name] = arr
        self._data = [[step]]
        self._shapes = [[{}]]
        self._outputs = [[{}]]

    def generate_shared_prefix_data(self, inputs: dict,
                                    prefix_len: int = 256,
                                    suffix_len: int = 32,
                                    n_streams: int = 16,
                                    vocab: int = 1024,
                                    max_tokens: int = 32,
                                    seed: int = 0) -> None:
        """Shared-prefix token workload: ``n_streams`` streams, each one
        step whose integer token input is ``prefix_len`` common tokens
        followed by ``suffix_len`` per-stream random tokens — the
        shared-system-prompt traffic shape. The prompt lands on every
        integer input with a dynamic (-1) dim (the generator models'
        PROMPT); a ``MAX_TOKENS`` input gets the ``max_tokens`` budget;
        every other input is ZERO-filled so the decode stays greedy and
        deterministic (random TEMPERATURE/SEED values would turn the
        measurement into sampled decoding). Load managers rotate
        requests across the streams, so a server-side prefix cache sees
        the same prefix under diverging suffixes."""
        if prefix_len < 1 or suffix_len < 1 or n_streams < 1:
            raise ValueError("prefix_len, suffix_len and n_streams must "
                             "be >= 1")
        rng = np.random.default_rng(seed)
        prefix = rng.integers(0, vocab, size=prefix_len)
        prompt_names = [
            name for name, info in inputs.items()
            if any(d < 0 for d in info.dims)
            and np.issubdtype(_np_dtype(info.datatype), np.integer)]
        if not prompt_names:
            raise ValueError(
                "shared-prefix data needs at least one integer input "
                "with a dynamic (-1) dim to carry the token prompt")
        base = {}
        for name, info in inputs.items():
            if name in prompt_names:
                continue
            dims = [abs(d) for d in info.dims]
            if info.datatype == "BYTES":
                base[name] = np.full(dims, b"", dtype=np.object_)
            elif name == "MAX_TOKENS":
                base[name] = np.full(dims, max_tokens,
                                     _np_dtype(info.datatype))
            else:
                base[name] = np.zeros(dims, _np_dtype(info.datatype))
        self._data, self._shapes, self._outputs = [], [], []
        for _ in range(n_streams):
            suffix = rng.integers(0, vocab, size=suffix_len)
            prompt = np.concatenate([prefix, suffix]).astype(np.int64)
            step, shapes = dict(base), {}
            for name in prompt_names:
                arr = prompt.astype(_np_dtype(inputs[name].datatype))
                step[name] = arr
                shapes[name] = list(arr.shape)
            self._data.append([step])
            self._shapes.append([shapes])
            self._outputs.append([{}])

    def read_data_from_dir(self, data_dir: str, inputs: dict) -> None:
        """Per-tensor file named after the input. Text files hold one
        value per line; .bin/raw files hold raw bytes."""
        step = {}
        for name, info in inputs.items():
            path = os.path.join(data_dir, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no data file for input '{name}' in {data_dir}")
            dims = [abs(d) for d in info.dims]
            if info.datatype == "BYTES":
                with open(path, "rb") as f:
                    lines = f.read().splitlines()
                arr = np.array(lines, dtype=np.object_).reshape(dims)
            else:
                np_dtype = _np_dtype(info.datatype)
                with open(path, "rb") as f:
                    raw = f.read()
                try:
                    text = raw.decode()
                    vals = [float(x) for x in text.split()]
                    arr = np.array(vals).astype(np_dtype).reshape(dims)
                except (UnicodeDecodeError, ValueError):
                    arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
            step[name] = arr
        self._data = [[step]]
        self._shapes = [[{}]]
        self._outputs = [[{}]]

    def read_data_from_json(self, path: str, inputs: dict,
                            outputs: Optional[dict] = None) -> None:
        """{"data": [stream...]} where a stream is either a step-dict or
        a list of step-dicts; values are explicit lists, {"b64": ...}, or
        {"content": ..., "shape": ...}."""
        with open(path) as f:
            doc = json.load(f)
        data = doc.get("data")
        if data is None:
            raise ValueError(f"{path}: missing 'data' array")
        validation = doc.get("validation_data", [])

        self._data, self._shapes, self._outputs = [], [], []
        for si, stream in enumerate(data):
            steps = stream if isinstance(stream, list) else [stream]
            dsteps, sshapes, osteps = [], [], []
            for step in steps:
                tensors, shapes = {}, {}
                for name, val in step.items():
                    info = inputs.get(name)
                    if info is None:
                        continue
                    arr, shape = self._parse_value(val, info)
                    tensors[name] = arr
                    if shape is not None:
                        shapes[name] = shape
                dsteps.append(tensors)
                sshapes.append(shapes)
            self._data.append(dsteps)
            self._shapes.append(sshapes)
            ovals = []
            if si < len(validation) and outputs:
                vstream = validation[si]
                vsteps = vstream if isinstance(vstream, list) else [vstream]
                for vstep in vsteps:
                    out = {}
                    for name, val in vstep.items():
                        info = outputs.get(name)
                        if info is None:
                            continue
                        arr, _ = self._parse_value(val, info)
                        out[name] = arr
                    ovals.append(out)
            self._outputs.append(ovals or [{}] * len(dsteps))

    def _parse_value(self, val, info):
        shape = None
        if isinstance(val, dict) and "b64" in val:
            raw = base64.b64decode(val["b64"])
            if info.datatype == "BYTES":
                arr = deserialize_bytes_tensor(raw)
            else:
                arr = np.frombuffer(raw, dtype=_np_dtype(info.datatype))
            return arr, shape
        if isinstance(val, dict):
            shape = val.get("shape")
            val = val.get("content", [])
        flat = np.asarray(val).reshape(-1)
        if info.datatype == "BYTES":
            arr = np.array([x.encode() if isinstance(x, str) else x
                            for x in flat], dtype=np.object_)
        else:
            arr = flat.astype(_np_dtype(info.datatype))
        dims = shape if shape is not None else [abs(d) for d in info.dims]
        if dims and int(np.prod(dims)) == arr.size:
            arr = arr.reshape(dims)
        return arr, shape

    # ---- access ----

    @property
    def num_streams(self) -> int:
        return len(self._data)

    def num_steps(self, stream: int) -> int:
        return len(self._data[stream % len(self._data)])

    def get_input_data(self, name: str, stream: int = 0,
                       step: int = 0) -> np.ndarray:
        streams = self._data
        s = streams[stream % len(streams)]
        return s[step % len(s)][name]

    def get_input_shape(self, name: str, stream: int = 0,
                        step: int = 0):
        s = self._shapes[stream % len(self._shapes)]
        return s[step % len(s)].get(name)

    def get_output_data(self, name: str, stream: int = 0,
                        step: int = 0) -> Optional[np.ndarray]:
        s = self._outputs[stream % len(self._outputs)]
        if not s:
            return None
        return s[step % len(s)].get(name)

    def batched(self, name: str, stream: int = 0, step: int = 0,
                batch_size: Optional[int] = None) -> np.ndarray:
        """Stack the step tensor batch_size times along a new batch dim."""
        b = batch_size if batch_size is not None else self.batch_size
        arr = self.get_input_data(name, stream, step)
        if b <= 0:
            return arr
        return np.stack([arr] * b, axis=0)
