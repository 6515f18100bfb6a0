"""Server-side shared-memory registries (system + CUDA).

The port's counterpart of ``client_tpu/server/shm.py``. The v2
shared-memory extensions: clients create regions out of band, then
``register`` them by name; per-request tensor parameters
(shared_memory_region/offset/byte_size) reference registered regions, so
tensor bytes never ride the request.

System shm: regions are POSIX shm objects; the server attaches them via
/dev/shm mmap.

CUDA shm: regions hold torch tensors on a device; registration resolves
the raw handle through ``client_tpu_torch.utils.cuda_shared_memory``
(in-process: zero-copy pickup from the process-local registry;
cross-process: attach the system-shm staging buffer and copy to the
device on a changed seqno). It takes the place of the reference's
``TpuShmRegistry``.
"""

from __future__ import annotations

import threading

from client_tpu_torch.server.types import ServerError
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as shm_mod


class SystemShmRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._regions: dict[str, shm_mod.SharedMemoryRegion] = {}
        self._meta: dict[str, dict] = {}

    def register(self, name: str, key: str, offset: int, byte_size: int):
        with self._lock:
            if name in self._regions:
                raise ServerError(
                    f"shared memory region '{name}' already registered", 400)
            try:
                region = shm_mod.attach_shared_memory_region(
                    name, key, byte_size, offset)
            except shm_mod.SharedMemoryException as e:
                raise ServerError(str(e), 400) from e
            self._regions[name] = region
            self._meta[name] = {"name": name, "key": key, "offset": offset,
                                "byte_size": byte_size}

    def unregister(self, name: str):
        with self._lock:
            region = self._regions.pop(name, None)
            self._meta.pop(name, None)
        if region is not None:
            shm_mod.destroy_shared_memory_region(region)

    def unregister_all(self):
        with self._lock:
            regions = list(self._regions.values())
            self._regions.clear()
            self._meta.clear()
        for r in regions:
            shm_mod.destroy_shared_memory_region(r)

    def status(self, name: str = None):
        with self._lock:
            if name is not None:
                return [self._meta[name]] if name in self._meta else []
            return list(self._meta.values())

    def metrics(self) -> tuple:
        """(region_count, total_bytes) for the /metrics gauges."""
        with self._lock:
            return len(self._meta), sum(m["byte_size"]
                                        for m in self._meta.values())

    def read(self, name: str, offset: int, byte_size: int) -> memoryview:
        with self._lock:
            region = self._regions.get(name)
        if region is None:
            raise ServerError(
                f"shared memory region '{name}' is not registered", 400)
        start = region.offset + offset
        if start + byte_size > region.offset + region.byte_size:
            raise ServerError(
                f"read [{offset}, {offset + byte_size}) exceeds region "
                f"'{name}' size {region.byte_size}", 400)
        return region.buffer()[start:start + byte_size]

    def write(self, name: str, offset: int, data: bytes) -> None:
        with self._lock:
            region = self._regions.get(name)
        if region is None:
            raise ServerError(
                f"shared memory region '{name}' is not registered", 400)
        start = region.offset + offset
        if start + len(data) > region.offset + region.byte_size:
            raise ServerError(
                f"write of {len(data)} bytes at offset {offset} exceeds "
                f"region '{name}' size {region.byte_size}", 400)
        region.buffer()[start:start + len(data)] = data


class CudaShmRegistry:
    """Registered CUDA regions; resolution happens via cuda_shared_memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self._regions: dict[str, dict] = {}  # name -> {device_id, byte_size, attachment}
        # read-mostly mirror for the per-request fast path: dict reads are
        # GIL-atomic, so lookups skip the mutex (mutations rebuild it
        # under the lock)
        self._attachments: dict[str, cudashm.Attachment] = {}

    def register(self, name: str, raw_handle: bytes, device_id: int,
                 byte_size: int):
        with self._lock:
            if name in self._regions:
                raise ServerError(
                    f"CUDA shared memory region '{name}' already registered",
                    400)
            try:
                attachment = cudashm.attach_from_raw_handle(raw_handle)
            except cudashm.CudaSharedMemoryException as e:
                raise ServerError(str(e), 400) from e
            self._regions[name] = {
                "name": name, "device_id": device_id,
                "byte_size": byte_size, "attachment": attachment,
            }
            self._attachments = {n: e["attachment"]
                                 for n, e in self._regions.items()}

    def unregister(self, name: str):
        with self._lock:
            entry = self._regions.pop(name, None)
            self._attachments = {n: e["attachment"]
                                 for n, e in self._regions.items()}
        if entry is not None:
            entry["attachment"].detach()

    def unregister_all(self):
        with self._lock:
            entries = list(self._regions.values())
            self._regions.clear()
            self._attachments = {}
        for e in entries:
            e["attachment"].detach()

    def metrics(self) -> tuple:
        """(region_count, total_bytes) for the /metrics gauges."""
        with self._lock:
            return len(self._regions), sum(e["byte_size"]
                                           for e in self._regions.values())

    def status(self, name: str = None):
        with self._lock:
            items = ([self._regions[name]] if name in self._regions else []) \
                if name is not None else list(self._regions.values())
            return [{"name": e["name"], "device_id": e["device_id"],
                     "byte_size": e["byte_size"]} for e in items]

    def try_attachment(self, name: str):
        """Hot-path lookup: attachment or None. Lock-free — reads the
        read-mostly mirror (one GIL-atomic dict get per request)."""
        return self._attachments.get(name)
