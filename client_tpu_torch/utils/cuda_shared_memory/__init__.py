"""CUDA shared memory: device-resident tensor regions shared between a
producer and the serving process.

The port's counterpart of ``client_tpu/utils/tpu_shared_memory``, with
the same design and semantics, and torch tensors on an explicit device in
place of ``jax.Array``s. The six-call API (create_shared_memory_region /
set_shared_memory_region / get_raw_handle / get_contents_as_numpy /
destroy_shared_memory_region / allocated_shared_memory_regions), plus
``attach_producer`` and a fast path that registers tensors already on
the device (``set_shared_memory_region_from_torch``).

Design
------
- Every region owns a POSIX-shm **staging buffer** (16-byte header with
  a magic + monotonically increasing seqno, then the payload) shared
  between the producer and the serving process.
- The **raw handle** is a serializable token: base64 JSON carrying
  (region uuid, producer pid, staging key, byte size, device), schema
  ``cuda_shm_handle_v1``. It travels inside the register verb as the
  base64 cudaIpcMemHandle does in the CUDA shared-memory extension; no
  CUDA IPC memory handle is exchanged.
- **In-process** (client and server share a process — the perf
  analyzer's in-process backend): set_shared_memory_region also records
  the tensors it copied to the device in a process-local registry, and
  the server picks them up **zero-copy**.
- **Cross-process**: the server attaches the staging buffer and keeps a
  per-(offset, dtype, shape) device cache guarded by the seqno: set once,
  infer many costs one host->device copy; a set() bumps the seqno and
  invalidates exactly once.
- **Outputs** an in-process server writes stay on the device; the staging
  buffer is filled lazily, when a host reader asks.

Regions live on ``cuda:{device_id}`` unless a ``device`` is named (the
CPU only when asked; without CUDA the default raises). A device copy that
fails raises: nothing falls back quietly to a host read.

Streams: a producer's host->device copy runs on its thread's current
stream, and the forward that reads it on the serving thread's. Each copy
records a CUDA event beside its tensor, and the first read of the tensor
waits for that event on the host, so a reader on any stream sees the
copied bytes.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import threading
import uuid as uuid_mod

import numpy as np
import torch

from client_tpu_torch.device import (
    canonical_device,
    resolve_device,
    tensor_bytes,
    torch_dtype_of_wire,
)
from client_tpu_torch.protocol.binary import (
    deserialize_bytes_tensor,
    serialize_byte_tensor,
)
from client_tpu_torch.protocol.dtypes import wire_to_np_dtype
from client_tpu_torch.utils import shared_memory as sysshm

_MAGIC = b"CUDS"
_HEADER = 16  # magic(4) + seqno(8) + reserved(4)
SCHEMA = "cuda_shm_handle_v1"


class CudaSharedMemoryException(Exception):
    pass


# process-local registry: uuid -> CudaShmHandle (the zero-copy
# in-process attach path)
_lock = threading.Lock()
_local_regions: dict[str, "CudaShmHandle"] = {}


def _read_seqno(buf: memoryview) -> int:
    if bytes(buf[0:4]) != _MAGIC:
        raise CudaSharedMemoryException("staging buffer has bad magic")
    return struct.unpack_from("<Q", buf, 4)[0]


def _bump_seqno(buf: memoryview) -> int:
    seq = _read_seqno(buf) + 1
    struct.pack_into("<Q", buf, 4, seq)
    return seq


def _nbytes(t: torch.Tensor) -> int:
    return t.element_size() * t.numel()


def _device_put(arr: np.ndarray, device: torch.device) -> tuple:
    """Host -> device copy of ``arr``: ``(tensor, event)``, the event
    recorded behind the copy on the current stream (None on the CPU).
    Raises when the copy fails."""
    try:
        t = torch.from_numpy(np.array(arr, order="C")).to(device)
        event = None
        if t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
    except (RuntimeError, TypeError, AssertionError) as e:
        # torch built without CUDA asserts; a CUDA failure is a
        # RuntimeError
        raise CudaSharedMemoryException(
            f"device copy of a {arr.dtype} {list(arr.shape)} tensor to "
            f"{device} failed: {e}") from e
    return t, event


def _ready(entries: dict, offset: int, entry: tuple) -> torch.Tensor:
    """The tensor of a (tensor, seqno, event) entry once its copy has
    landed: the first reader waits for the event, later ones do not."""
    t, seq, event = entry
    if event is not None:
        event.synchronize()
        entries[offset] = (t, seq, None)
    return t


class CudaShmHandle:
    """Producer-side handle for a CUDA shared-memory region."""

    def __init__(self, name: str, byte_size: int, device: torch.device,
                 staging: sysshm.SharedMemoryRegion, region_uuid: str):
        self.name = name
        self.byte_size = byte_size          # logical payload size
        self.device = device
        self.staging = staging
        self.uuid = region_uuid
        self.closed = False
        # offset -> (tensor, seqno, copy event or None): tensors on the
        # device set by the producer (or written by an in-process
        # server), consumed zero-copy in-process
        self.device_tensors: dict[int, tuple] = {}
        # offsets whose latest content is on the device only (an
        # in-process server wrote outputs without a host round trip);
        # staging is filled lazily on the first host read. Every access
        # is one GIL-atomic dict operation, so the per-request completion
        # path takes no lock; materialize_staging pops one key at a time.
        self.pending_device: dict[int, torch.Tensor] = {}

    @property
    def device_id(self) -> int:
        return self.device.index or 0

    def _payload(self) -> memoryview:
        return self.staging.buffer()[_HEADER:_HEADER + self.byte_size]

    def seqno(self) -> int:
        return _read_seqno(self.staging.buffer())

    def materialize_staging(self) -> None:
        """Copy pending device-resident writes into the staging buffer
        (the lazy half of the zero-copy output path: the device->host
        copy happens only when a host reader asks)."""
        if not self.pending_device:
            return
        payload = self._payload()
        for off in sorted(list(self.pending_device)):
            dev = self.pending_device.pop(off, None)
            if dev is None:
                continue  # a concurrent host write cleared it
            raw = tensor_bytes(dev)
            payload[off:off + len(raw)] = raw

    def __repr__(self):
        return (f"CudaShmHandle(name={self.name!r}, uuid={self.uuid}, "
                f"byte_size={self.byte_size}, device={self.device})")


def create_shared_memory_region(name: str, byte_size: int,
                                device_id: int = 0,
                                device=None) -> CudaShmHandle:
    """Allocate a region (staging buffer + registry entry) whose tensors
    live on ``cuda:{device_id}``, or on ``device`` when one is named."""
    dev = resolve_device(f"cuda:{device_id}" if device is None else device)
    region_uuid = uuid_mod.uuid4().hex
    key = f"/cudashm_{region_uuid[:16]}"
    staging = sysshm.create_shared_memory_region(
        name, key, byte_size + _HEADER, create_only=True)
    buf = staging.buffer()
    buf[0:4] = _MAGIC
    struct.pack_into("<Q", buf, 4, 0)
    handle = CudaShmHandle(name, byte_size, dev, staging, region_uuid)
    with _lock:
        _local_regions[region_uuid] = handle
    return handle


def attach_producer(raw_handle: bytes) -> CudaShmHandle:
    """Re-open an existing region as a PRODUCER in another process. Writes
    through the returned handle bump the shared seqno, so consumers'
    seqno-guarded device caches see the change."""
    doc = parse_raw_handle(raw_handle)
    staging = sysshm.attach_shared_memory_region(
        doc["uuid"], doc["staging_key"], int(doc["byte_size"]) + _HEADER)
    if bytes(staging.buffer()[0:4]) != _MAGIC:
        raise CudaSharedMemoryException("staging buffer has bad magic")
    return CudaShmHandle(doc.get("name", doc["uuid"]), int(doc["byte_size"]),
                         resolve_device(doc["device"]), staging, doc["uuid"])


def set_shared_memory_region(handle: CudaShmHandle, input_values,
                             offset: int = 0) -> None:
    """Copy numpy tensors into the region: the staging buffer, and a
    host->device copy of each (BYTES tensors have no device form)."""
    if not isinstance(input_values, (list, tuple)):
        raise CudaSharedMemoryException(
            "input_values must be a list/tuple of numpy arrays")
    payload = handle._payload()
    pos = offset
    seq = _bump_seqno(handle.staging.buffer())
    for arr in input_values:
        arr = np.asarray(arr)
        is_bytes = arr.dtype == np.object_ or arr.dtype.kind in ("S", "U")
        raw = (serialize_byte_tensor(arr.astype(np.object_, copy=False))
               if is_bytes else np.ascontiguousarray(arr).tobytes())
        end = pos + len(raw)
        if end > handle.byte_size:
            raise CudaSharedMemoryException(
                f"tensors exceed region size {handle.byte_size}")
        payload[pos:end] = raw
        handle.pending_device.pop(pos, None)
        if is_bytes:  # BYTES tensors have no device form
            handle.device_tensors.pop(pos, None)
        else:
            t, event = _device_put(arr, handle.device)
            handle.device_tensors[pos] = (t, seq, event)
        pos = end


def set_shared_memory_region_from_torch(handle: CudaShmHandle, tensors,
                                        offset: int = 0,
                                        sync_staging: bool = True) -> None:
    """Register tensors already on the region's device, without a copy.

    An in-process consumer reads them zero-copy; the staging buffer is
    written only with ``sync_staging=True`` (needed by cross-process
    readers), else it is filled lazily on the first host read. A tensor
    on another device raises: it is never moved quietly."""
    payload = handle._payload()
    pos = offset
    seq = _bump_seqno(handle.staging.buffer())
    want = canonical_device(handle.device)
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise CudaSharedMemoryException("expected torch.Tensor inputs")
        if t.device != want:
            raise CudaSharedMemoryException(
                f"tensor on {t.device} cannot be registered in a region on "
                f"{want}")
        nbytes = _nbytes(t)
        if pos + nbytes > handle.byte_size:
            raise CudaSharedMemoryException(
                f"tensors exceed region size {handle.byte_size}")
        event = None
        if t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        handle.device_tensors[pos] = (t, seq, event)
        if sync_staging:
            payload[pos:pos + nbytes] = tensor_bytes(t)
            handle.pending_device.pop(pos, None)
        else:
            handle.pending_device[pos] = t
        pos += nbytes


def get_raw_handle(handle: CudaShmHandle) -> bytes:
    """Serialized registration token (base64 JSON)."""
    doc = {
        "schema": SCHEMA,
        "uuid": handle.uuid,
        "pid": os.getpid(),
        "name": handle.name,
        "staging_key": handle.staging.key,
        "byte_size": handle.byte_size,
        "device_id": handle.device_id,
        "device": str(handle.device),
    }
    return base64.b64encode(json.dumps(doc).encode("utf-8"))


def get_contents_as_numpy(handle: CudaShmHandle, dtype, shape,
                          offset: int = 0) -> np.ndarray:
    """Read region contents (the staging view) as a numpy array."""
    handle.materialize_staging()
    dtype = np.dtype(dtype)
    payload = handle._payload()
    if dtype == np.object_ or dtype.kind in ("S", "U"):
        raw = bytes(payload[offset:])
        n = int(np.prod(shape)) if len(shape) else 1
        flat = deserialize_bytes_tensor(raw, count=n)
        return flat.reshape(shape)
    count = int(np.prod(shape)) if len(shape) else 1
    nbytes = count * dtype.itemsize
    arr = np.frombuffer(payload[offset:offset + nbytes], dtype=dtype)
    return arr.reshape(shape)


def allocated_shared_memory_regions():
    """Names of regions created by this process."""
    with _lock:
        return [h.name for h in _local_regions.values()]


def destroy_shared_memory_region(handle: CudaShmHandle) -> None:
    if handle.closed:
        return
    handle.closed = True
    with _lock:
        _local_regions.pop(handle.uuid, None)
    handle.device_tensors.clear()
    handle.pending_device.clear()
    sysshm.destroy_shared_memory_region(handle.staging)


# ---------------------------------------------------------------------------
# consumer (server) side
# ---------------------------------------------------------------------------


def parse_raw_handle(raw_handle: bytes) -> dict:
    try:
        doc = json.loads(base64.b64decode(raw_handle).decode("utf-8"))
        if doc.get("schema") != SCHEMA:
            raise ValueError("bad schema")
        return doc
    except (ValueError, TypeError, AttributeError) as e:
        raise CudaSharedMemoryException(
            f"malformed CUDA shm raw handle: {e}") from e


def _check_write_size(nbytes: int, offset: int, byte_size: int) -> None:
    if offset + nbytes > byte_size:
        raise CudaSharedMemoryException(
            f"output write of {nbytes} bytes at {offset} exceeds region "
            f"size {byte_size}")


def _host_bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        return tensor_bytes(arr)
    arr = np.asarray(arr)
    return (serialize_byte_tensor(arr) if arr.dtype == np.object_
            else np.ascontiguousarray(arr).tobytes())


class Attachment:
    """Server-side view of a registered CUDA shm region."""

    def detach(self) -> None:
        raise NotImplementedError

    def read_array(self, offset: int, byte_size: int, datatype: str, shape):
        """The tensor at [offset, offset+byte_size): a torch tensor on the
        region's device (zero host copies when possible), numpy for
        BYTES."""
        raise NotImplementedError

    def write_array(self, offset: int, arr) -> None:
        raise NotImplementedError


class InProcessAttachment(Attachment):
    """Producer lives in our process: zero-copy device references."""

    def __init__(self, handle: CudaShmHandle):
        self._handle = handle
        self._device = canonical_device(handle.device)

    def detach(self) -> None:
        self._handle = None

    def read_array(self, offset: int, byte_size: int, datatype: str, shape):
        h = self._handle
        entry = h.device_tensors.get(offset)
        if entry is not None:
            dev = entry[0]
            if (entry[1] == h.seqno()
                    and dev.dtype == torch_dtype_of_wire(datatype)
                    and tuple(dev.shape) == tuple(int(d) for d in shape)):
                return _ready(h.device_tensors, offset, entry)  # ZERO-COPY
        np_dtype = wire_to_np_dtype(datatype)
        if np_dtype == np.object_:
            raw = bytes(h._payload()[offset:offset + byte_size])
            return deserialize_bytes_tensor(raw).reshape(
                tuple(int(d) for d in shape))
        return get_contents_as_numpy(h, np_dtype, shape, offset)

    def write_array(self, offset: int, arr) -> None:
        h = self._handle
        if isinstance(arr, torch.Tensor):
            # zero-copy output: the tensor is recorded in the region (the
            # producer reads it in-process, or through the lazy staging
            # fill) — no device->host copy on the serving path. The caller
            # hands over a tensor whose producing work has completed.
            if arr.device != self._device:
                raise CudaSharedMemoryException(
                    f"output on {arr.device} cannot be stored in region "
                    f"'{h.name}' on {self._device}")
            _check_write_size(_nbytes(arr), offset, h.byte_size)
            seq = _bump_seqno(h.staging.buffer())
            h.device_tensors[offset] = (arr, seq, None)
            h.pending_device[offset] = arr
            return
        raw = _host_bytes(arr)
        _check_write_size(len(raw), offset, h.byte_size)
        h._payload()[offset:offset + len(raw)] = raw
        h.pending_device.pop(offset, None)
        h.device_tensors.pop(offset, None)
        _bump_seqno(h.staging.buffer())


class CrossProcessAttachment(Attachment):
    """Producer is another process: staging shm + a seqno-guarded device
    cache."""

    def __init__(self, doc: dict):
        self._doc = doc
        self._byte_size = int(doc["byte_size"])
        # the producer's device: a read that cannot copy there raises
        self._device = torch.device(doc["device"])
        try:
            self._staging = sysshm.attach_shared_memory_region(
                doc["uuid"], doc["staging_key"], self._byte_size + _HEADER)
        except sysshm.SharedMemoryException as e:
            raise CudaSharedMemoryException(
                f"cannot attach staging buffer for CUDA shm region: {e}"
            ) from e
        self._cache: dict[tuple, tuple] = {}  # (off, dt, shape) -> (seq, t)
        self._cache_lock = threading.Lock()

    def detach(self) -> None:
        if self._staging is not None:
            sysshm.destroy_shared_memory_region(self._staging)
            self._staging = None
        self._cache.clear()

    def _payload(self) -> memoryview:
        return self._staging.buffer()[_HEADER:_HEADER + self._byte_size]

    def read_array(self, offset: int, byte_size: int, datatype: str, shape):
        seq = _read_seqno(self._staging.buffer())
        np_dtype = wire_to_np_dtype(datatype)
        shape_t = tuple(int(d) for d in shape)
        if np_dtype == np.object_:
            raw = bytes(self._payload()[offset:offset + byte_size])
            return deserialize_bytes_tensor(raw).reshape(shape_t)
        key = (offset, str(np_dtype), shape_t)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is not None and hit[0] == seq:
                return hit[1]  # steady state: zero host->device copies
        arr = np.frombuffer(self._payload()[offset:offset + byte_size],
                            dtype=np_dtype).reshape(shape_t)
        dev, event = _device_put(arr, self._device)
        if event is not None:
            event.synchronize()
        with self._cache_lock:
            self._cache[key] = (seq, dev)
        return dev

    def write_array(self, offset: int, arr) -> None:
        # cross-process: the staging buffer is the only bridge
        raw = _host_bytes(arr)
        _check_write_size(len(raw), offset, self._byte_size)
        self._payload()[offset:offset + len(raw)] = raw
        _bump_seqno(self._staging.buffer())


def attach_from_raw_handle(raw_handle: bytes) -> Attachment:
    """Server-side resolution of a registration token."""
    doc = parse_raw_handle(raw_handle)
    if int(doc.get("pid", -1)) == os.getpid():
        with _lock:
            handle = _local_regions.get(doc["uuid"])
        if handle is not None:
            return InProcessAttachment(handle)
    return CrossProcessAttachment(doc)
