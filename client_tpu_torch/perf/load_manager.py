"""Load manager base: worker threads, input preparation, shared-memory
setup, sequence bookkeeping, timestamp collection — the port's copy of
``client_tpu/perf/load_manager.py``.

Timestamps are (start_ns, end_ns, sequence_end, delayed) tuples.
``shared_memory`` is "none", "system" (POSIX regions) or "cuda" (regions
whose tensors live on ``shm_device``, ``cuda:0`` unless the CPU is
asked for); every request of a run reads the same input regions and
writes the same output regions (the last write wins), set once before
the first request.
"""

from __future__ import annotations

import random
import threading
import uuid
from typing import Optional

import numpy as np

from client_tpu_torch.perf.client_backend import (
    ClientBackendFactory,
    ClientInferStat,
    PerfInput,
    PerfRequestedOutput,
)
from client_tpu_torch.perf.data_loader import DataLoader
from client_tpu_torch.perf.model_parser import ModelParser
from client_tpu_torch.protocol.binary import serialize_byte_tensor
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as sysshm

SHARED_MEMORY_KINDS = ("none", "system", "cuda")


class ThreadStat:
    """Per-thread request timestamps + health."""

    def __init__(self):
        self.lock = threading.Lock()
        self.timestamps: list[tuple] = []  # (start, end, seq_end, delayed)
        self.error: Optional[str] = None
        self.stat = ClientInferStat()
        # token-generation series (streaming mode against decoupled
        # models): client-observed time-to-first-token per request and
        # per-token inter-token gaps, both in ns
        self.ttft_ns: list[int] = []
        self.itl_ns: list[int] = []
        self.token_count = 0


class SequenceStat:
    """Live sequence slot."""

    def __init__(self, seq_id):
        self.lock = threading.Lock()
        self.seq_id = seq_id
        self.data_stream = 0
        self.remaining = 0


class SharedMemoryRegions:
    """Created regions for shared_memory="system"|"cuda" (input +
    output)."""

    def __init__(self):
        self.system: dict[str, object] = {}   # region name -> handle
        self.cuda: dict[str, object] = {}

    def cleanup(self) -> None:
        for h in self.system.values():
            sysshm.destroy_shared_memory_region(h)
        for h in self.cuda.values():
            cudashm.destroy_shared_memory_region(h)
        self.system.clear()
        self.cuda.clear()


class LoadManager:
    def __init__(self, factory: ClientBackendFactory, parser: ModelParser,
                 data_loader: DataLoader, batch_size: int = 1,
                 async_mode: bool = True, streaming: bool = False,
                 shared_memory: str = "none",
                 output_shm_size: int = 100 * 1024,
                 sequence_length: int = 20,
                 num_of_sequences: int = 4,
                 sequence_id_range: Optional[tuple] = None,
                 string_length: int = 128,
                 shm_device=None):
        if shared_memory == "tpu":
            raise ValueError(
                "shared_memory='tpu' is the JAX package's device data "
                "plane; this port's is 'cuda'")
        if shared_memory not in SHARED_MEMORY_KINDS:
            raise ValueError(
                f"unsupported shared memory type '{shared_memory}' "
                f"(one of {SHARED_MEMORY_KINDS})")
        self.factory = factory
        self.parser = parser
        self.data = data_loader
        self.batch_size = batch_size
        self.async_mode = async_mode
        self.streaming = streaming
        self.shared_memory = shared_memory
        self.output_shm_size = output_shm_size
        self.sequence_length = sequence_length
        self.num_of_sequences = num_of_sequences
        self.sequence_id_range = sequence_id_range
        self.string_length = string_length
        self.shm_device = shm_device

        self.thread_stats: list[ThreadStat] = []
        self.threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self.shm_regions = SharedMemoryRegions()
        self._shm_backend = None
        # shm-mode request descriptors are step-invariant (regions hold
        # fixed data written at init) —
        # cache them instead of rebuilding per request on the hot path
        self._input_cache: dict[tuple, list] = {}
        self._output_cache: Optional[list] = None

        self.sequence_stats: list[SequenceStat] = []
        self._next_seq_id = (sequence_id_range[0] if sequence_id_range
                             else 1)
        self._seq_lock = threading.Lock()
        if parser.is_sequence():
            for _ in range(num_of_sequences):
                self.sequence_stats.append(SequenceStat(0))

        if shared_memory != "none":
            self._init_shared_memory()

    # ---- input preparation ----

    def prepare_inputs(self, stream: int = 0, step: int = 0) -> list:
        """Build the PerfInput list for one request."""
        if self.shared_memory != "none":
            cached = self._input_cache.get((stream, step))
            if cached is not None:
                return cached
        inputs = []
        for name, info in self.parser.inputs.items():
            shape = self.data.get_input_shape(name, stream, step) or \
                [abs(d) for d in info.dims]
            if self.shared_memory != "none":
                region = self._region_name(name)
                byte_size = self._input_byte_size(name)
                full_shape = ([self.batch_size] + list(shape)
                              if self.parser.max_batch_size > 0 else shape)
                x = PerfInput(name, full_shape, info.datatype)
                x.set_shared_memory(region, byte_size)
            else:
                arr = self.data.get_input_data(name, stream, step)
                if self.parser.max_batch_size > 0:
                    arr = np.stack([arr] * self.batch_size, axis=0)
                x = PerfInput(name, list(arr.shape), info.datatype)
                x.set_data_from_numpy(arr)
            inputs.append(x)
        if self.shared_memory != "none":
            self._input_cache[(stream, step)] = inputs
        return inputs

    def prepare_outputs(self) -> list:
        if self._output_cache is not None:
            return self._output_cache
        outs = []
        for name in self.parser.outputs:
            o = PerfRequestedOutput(name)
            if self.shared_memory != "none":
                o.set_shared_memory(self._region_name(name, output=True),
                                    self.output_shm_size)
            outs.append(o)
        if self.shared_memory != "none":
            self._output_cache = outs
        return outs

    # ---- shared memory setup ----

    def _region_name(self, tensor: str, output: bool = False) -> str:
        return f"perf_{'out' if output else 'in'}_{tensor}"

    def _input_byte_size(self, name: str) -> int:
        arr = self.data.get_input_data(name, 0, 0)
        if self.parser.max_batch_size > 0:
            arr = np.stack([arr] * self.batch_size, axis=0)
        if arr.dtype == np.object_:
            return len(serialize_byte_tensor(arr))
        return arr.nbytes

    def _init_shared_memory(self) -> None:
        backend = self.factory.create()
        self._shm_backend = backend
        if self.shared_memory == "system":
            self._init_system_shm(backend)
        else:
            self._init_cuda_shm(backend)

    def _init_system_shm(self, backend) -> None:
        for name in self.parser.inputs:
            arr = self.data.get_input_data(name, 0, 0)
            if self.parser.max_batch_size > 0:
                arr = np.stack([arr] * self.batch_size, axis=0)
            region = self._region_name(name)
            key = f"/{region}_{uuid.uuid4().hex[:8]}"
            byte_size = self._input_byte_size(name)
            handle = sysshm.create_shared_memory_region(region, key, byte_size)
            sysshm.set_shared_memory_region(handle, [arr])
            backend.register_system_shared_memory(region, key, byte_size)
            self.shm_regions.system[region] = handle
        for name in self.parser.outputs:
            region = self._region_name(name, output=True)
            key = f"/{region}_{uuid.uuid4().hex[:8]}"
            handle = sysshm.create_shared_memory_region(
                region, key, self.output_shm_size)
            backend.register_system_shared_memory(region, key,
                                                  self.output_shm_size)
            self.shm_regions.system[region] = handle

    def _init_cuda_shm(self, backend) -> None:
        for name in self.parser.inputs:
            arr = self.data.get_input_data(name, 0, 0)
            if self.parser.max_batch_size > 0:
                arr = np.stack([arr] * self.batch_size, axis=0)
            region = self._region_name(name)
            byte_size = self._input_byte_size(name)
            handle = cudashm.create_shared_memory_region(
                region, byte_size, 0, device=self.shm_device)
            self.shm_regions.cuda[region] = handle
            cudashm.set_shared_memory_region(handle, [arr])
            backend.register_cuda_shared_memory(
                region, cudashm.get_raw_handle(handle), handle.device_id,
                byte_size)
        for name in self.parser.outputs:
            region = self._region_name(name, output=True)
            handle = cudashm.create_shared_memory_region(
                region, self.output_shm_size, 0, device=self.shm_device)
            self.shm_regions.cuda[region] = handle
            backend.register_cuda_shared_memory(
                region, cudashm.get_raw_handle(handle), handle.device_id,
                self.output_shm_size)

    # ---- sequence bookkeeping ----

    def _new_sequence_id(self):
        with self._seq_lock:
            sid = self._next_seq_id
            self._next_seq_id += 1
            if self.sequence_id_range \
                    and self._next_seq_id >= self.sequence_id_range[1]:
                self._next_seq_id = self.sequence_id_range[0]
            return sid

    def _random_length(self) -> int:
        """Sequence length jitter ±20%."""
        jitter = int(self.sequence_length * 0.2)
        if jitter == 0:
            return max(1, self.sequence_length)
        return max(1, self.sequence_length +
                   random.randint(-jitter, jitter))

    def sequence_options(self, slot: int) -> dict:
        """Pick start/end flags for the next request of sequence ``slot``.
        Must be called with the slot lock held."""
        seq = self.sequence_stats[slot]
        opts = {}
        if seq.remaining == 0:
            seq.seq_id = self._new_sequence_id()
            seq.remaining = self._random_length()
            seq.data_stream = (seq.seq_id - 1) % max(1, self.data.num_streams)
            opts["sequence_start"] = True
        opts["sequence_id"] = seq.seq_id
        seq.remaining -= 1
        if seq.remaining == 0:
            opts["sequence_end"] = True
        return opts

    def drain_sequences(self, backend, thread_stat: ThreadStat) -> None:
        """Send sequence_end for any live sequences (graceful early
        exit)."""
        for slot, seq in enumerate(self.sequence_stats):
            with seq.lock:
                if seq.remaining > 0:
                    opts = {"sequence_id": seq.seq_id, "sequence_end": True}
                    seq.remaining = 0
                    try:
                        backend.infer(self.parser.model_name,
                                      self.prepare_inputs(seq.data_stream),
                                      self.prepare_outputs(), **opts)
                    except Exception:  # noqa: BLE001
                        pass

    # ---- stats collection ----

    def swap_timestamps(self) -> list:
        """Harvest and clear all per-thread timestamps."""
        out = []
        for ts in self.thread_stats:
            with ts.lock:
                out.extend(ts.timestamps)
                ts.timestamps = []
        return out

    def swap_generation_samples(self) -> tuple:
        """Harvest and clear the streaming-mode token series:
        (ttft_ns list, itl_ns list, token count)."""
        ttft, itl, tokens = [], [], 0
        for ts in self.thread_stats:
            with ts.lock:
                ttft.extend(ts.ttft_ns)
                itl.extend(ts.itl_ns)
                tokens += ts.token_count
                ts.ttft_ns = []
                ts.itl_ns = []
                ts.token_count = 0
        return ttft, itl, tokens

    def count_collected_requests(self) -> int:
        n = 0
        for ts in self.thread_stats:
            with ts.lock:
                n += len(ts.timestamps)
        return n

    def accumulated_client_stat(self) -> ClientInferStat:
        total = ClientInferStat()
        for ts in self.thread_stats:
            with ts.lock:
                total.completed_request_count += \
                    ts.stat.completed_request_count
                total.cumulative_total_request_time_ns += \
                    ts.stat.cumulative_total_request_time_ns
                total.rejected_request_count += \
                    ts.stat.rejected_request_count
        # retries live on the factory's SHARED policy (the client layer
        # sleeps/retries below the worker threads), not per-thread
        policy = getattr(self.factory, "retry_policy", None)
        if policy is not None:
            total.retried_request_count = policy.stats()["retries"]
        return total

    def check_health(self) -> None:
        for ts in self.thread_stats:
            with ts.lock:
                if ts.error:
                    raise RuntimeError(f"worker thread failed: {ts.error}")

    def stop_worker_threads(self) -> None:
        self._stop.set()
        for t in self.threads:
            t.join(timeout=30)
        self.threads = []
        self.thread_stats = []

    def cleanup(self) -> None:
        self.stop_worker_threads()
        if self._shm_backend is not None:
            try:
                self._shm_backend.unregister_all_shared_memory()
            except Exception:  # noqa: BLE001
                pass
            try:
                self._shm_backend.close()
            except Exception:  # noqa: BLE001
                pass
            self._shm_backend = None
        self.shm_regions.cleanup()
