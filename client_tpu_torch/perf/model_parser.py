"""ModelParser — turns server metadata/config into what the load generator
needs: the port's copy of ``client_tpu/perf/model_parser.py``.

Scheduler-type detection (with the recursive ensemble walk),
max_batch_size, the decoupled policy, the response cache, read through
any backend (in process, HTTP, or gRPC, whose backend unwraps the
config response). The TF-Serving and TorchServe initialisers wait for
the port's foreign backends (ROADMAP A5, the foreign backends).
"""

from __future__ import annotations

import enum


class SchedulerType(enum.Enum):
    NONE = "none"
    DYNAMIC = "dynamic"
    SEQUENCE = "sequence"
    ENSEMBLE = "ensemble"
    ENSEMBLE_SEQUENCE = "ensemble_sequence"


class TensorInfo:
    def __init__(self, name: str, datatype: str, dims, optional=False):
        self.name = name
        self.datatype = datatype
        # protobuf JSON renders int64 dims as strings — normalize
        self.dims = [int(d) for d in dims]
        self.optional = optional

    def is_dynamic(self) -> bool:
        return any(d < 0 for d in self.dims)


class ModelParser:
    def __init__(self):
        self.model_name = ""
        self.model_version = ""
        self.max_batch_size = 0
        self.inputs: dict[str, TensorInfo] = {}
        self.outputs: dict[str, TensorInfo] = {}
        self.scheduler_type = SchedulerType.NONE
        self.decoupled = False
        self.response_cache_enabled = False
        self.composing_models: list[tuple[str, str]] = []

    def init(self, backend, model_name: str, model_version: str = "",
             batch_size: int = 1) -> None:
        """Fetch metadata+config via the backend and derive load settings."""
        metadata = backend.model_metadata(model_name, model_version)
        config = backend.model_config(model_name, model_version)
        self.init_from(metadata, config, backend=backend)
        if batch_size > 1 and self.max_batch_size == 0:
            raise ValueError(
                f"model {model_name} does not support batching; requested "
                f"batch size {batch_size}")
        if batch_size > self.max_batch_size > 0:
            raise ValueError(
                f"requested batch size {batch_size} exceeds max_batch_size "
                f"{self.max_batch_size}")

    def init_from(self, metadata: dict, config: dict, backend=None) -> None:
        self.model_name = metadata.get("name", config.get("name", ""))
        versions = metadata.get("versions") or []
        self.model_version = versions[-1] if versions else ""
        self.max_batch_size = int(
            config.get("max_batch_size", config.get("maxBatchSize", 0)))

        for t in metadata.get("inputs", []):
            # proto JSON renders int64 dims as strings — normalize first
            dims = [int(d) for d in t.get("shape", t.get("dims", []))]
            if self.max_batch_size > 0 and dims and dims[0] == -1:
                dims = dims[1:]  # metadata includes the batch dim
            self.inputs[t["name"]] = TensorInfo(
                t["name"], t["datatype"], dims, t.get("optional", False))
        for t in metadata.get("outputs", []):
            dims = [int(d) for d in t.get("shape", t.get("dims", []))]
            if self.max_batch_size > 0 and dims and dims[0] == -1:
                dims = dims[1:]
            self.outputs[t["name"]] = TensorInfo(t["name"], t["datatype"],
                                                 dims)

        tx = config.get("model_transaction_policy", {})
        self.decoupled = bool(tx.get("decoupled", False)
                              or config.get("decoupled", False))
        cache = config.get("response_cache", {})
        self.response_cache_enabled = bool(
            cache.get("enable", False) if isinstance(cache, dict) else cache)

        if config.get("ensemble_scheduling") or config.get("ensemble_steps"):
            seq = self._ensemble_walk(config, backend)
            self.scheduler_type = (SchedulerType.ENSEMBLE_SEQUENCE if seq
                                   else SchedulerType.ENSEMBLE)
        elif config.get("sequence_batching"):
            self.scheduler_type = SchedulerType.SEQUENCE
        elif config.get("dynamic_batching"):
            self.scheduler_type = SchedulerType.DYNAMIC
        else:
            self.scheduler_type = SchedulerType.NONE

    def _ensemble_walk(self, config: dict, backend) -> bool:
        """Recursively collect composing models; returns True if any
        composing model is sequence-batched."""
        steps = (config.get("ensemble_scheduling", {}).get("step")
                 or config.get("ensemble_steps") or [])
        has_sequence = False
        for step in steps:
            name = step.get("model_name")
            version = str(step.get("model_version", ""))
            if version == "-1":
                version = ""
            if not name:
                continue
            self.composing_models.append((name, version))
            if backend is not None:
                sub = backend.model_config(name, version)
                if sub.get("sequence_batching"):
                    has_sequence = True
                if sub.get("ensemble_scheduling") or sub.get("ensemble_steps"):
                    has_sequence |= self._ensemble_walk(sub, backend)
        return has_sequence

    def is_sequence(self) -> bool:
        return self.scheduler_type in (SchedulerType.SEQUENCE,
                                       SchedulerType.ENSEMBLE_SEQUENCE)
