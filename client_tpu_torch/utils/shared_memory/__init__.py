"""System (POSIX) shared-memory regions for tensor passing.

The port's own copy of ``client_tpu/utils/shared_memory``: create / set /
get_contents_as_numpy / get_shared_memory_handle_info / destroy, plus the
module-level mapped-regions registry.

On Linux, POSIX shm objects are files under /dev/shm, so regions are
opened with os.open + mmap directly. A key "/foo" maps to /dev/shm/foo
and is interoperable with any shm_open("/foo") peer: a region either
package creates, the other can attach.
"""

from __future__ import annotations

import mmap
import os
import threading

import numpy as np

from client_tpu_torch.protocol.binary import (
    deserialize_bytes_tensor,
    serialize_byte_tensor,
)
from client_tpu_torch.protocol.dtypes import np_to_wire_dtype

_SHM_DIR = "/dev/shm"


class SharedMemoryException(Exception):
    """Raised on shared-memory failures."""


class SharedMemoryRegion:
    """Handle for a mapped region."""

    def __init__(self, shm_name: str, key: str, fd: int, byte_size: int,
                 offset: int, mm: mmap.mmap, owner: bool):
        self.name = shm_name          # registration name
        self.key = key                # POSIX key, e.g. "/my_region"
        self.fd = fd
        self.byte_size = byte_size
        self.offset = offset
        self.mmap = mm
        self.owner = owner            # owner unlinks the backing object
        self.closed = False

    def buffer(self) -> memoryview:
        return memoryview(self.mmap)

    def __repr__(self):
        return (f"SharedMemoryRegion(name={self.name!r}, key={self.key!r}, "
                f"byte_size={self.byte_size})")


_lock = threading.Lock()
_mapped: dict[str, SharedMemoryRegion] = {}  # key -> region


def _path_for_key(key: str) -> str:
    if not key.startswith("/"):
        raise SharedMemoryException(f"shared memory key must start with '/': {key!r}")
    return os.path.join(_SHM_DIR, key[1:])


def create_shared_memory_region(shm_name: str, key: str, byte_size: int,
                                create_only: bool = False) -> SharedMemoryRegion:
    """Create (or open+resize) a POSIX shm region and map it."""
    path = _path_for_key(key)
    flags = os.O_RDWR | os.O_CREAT | (os.O_EXCL if create_only else 0)
    try:
        fd = os.open(path, flags, 0o600)
    except OSError as e:
        raise SharedMemoryException(
            f"unable to create shared memory object {key!r}: {e}") from e
    try:
        os.ftruncate(fd, byte_size)
        mm = mmap.mmap(fd, byte_size)
    except OSError as e:
        os.close(fd)
        raise SharedMemoryException(
            f"unable to map shared memory object {key!r}: {e}") from e
    region = SharedMemoryRegion(shm_name, key, fd, byte_size, 0, mm, owner=True)
    with _lock:
        _mapped[key] = region
    return region


def attach_shared_memory_region(shm_name: str, key: str, byte_size: int,
                                offset: int = 0) -> SharedMemoryRegion:
    """Map an existing region created by another process (server-side verb).

    Maps from byte 0 (mmap offsets must be page-aligned) and tracks the
    logical offset on the handle.
    """
    path = _path_for_key(key)
    try:
        fd = os.open(path, os.O_RDWR)
    except OSError as e:
        raise SharedMemoryException(
            f"unable to attach shared memory object {key!r}: {e}") from e
    actual = os.fstat(fd).st_size
    if offset + byte_size > actual:
        os.close(fd)
        raise SharedMemoryException(
            f"region {key!r} is {actual} bytes; cannot map "
            f"[{offset}, {offset + byte_size})")
    try:
        mm = mmap.mmap(fd, offset + byte_size)
    except OSError as e:
        os.close(fd)
        raise SharedMemoryException(
            f"unable to map shared memory object {key!r}: {e}") from e
    return SharedMemoryRegion(shm_name, key, fd, byte_size, offset, mm,
                              owner=False)


def set_shared_memory_region(shm_handle: SharedMemoryRegion,
                             input_values, offset: int = 0) -> None:
    """Copy a list of numpy tensors into the region sequentially (BYTES
    tensors in their serialized form)."""
    if not isinstance(input_values, (list, tuple)):
        raise SharedMemoryException(
            "input_values must be a list/tuple of numpy arrays")
    buf = shm_handle.buffer()
    pos = shm_handle.offset + offset
    for arr in input_values:
        arr = np.asarray(arr)
        if arr.dtype == np.object_ or arr.dtype.kind in ("S", "U"):
            raw = serialize_byte_tensor(arr.astype(np.object_, copy=False))
        else:
            raw = arr.tobytes()
        end = pos + len(raw)
        if end > shm_handle.offset + shm_handle.byte_size:
            raise SharedMemoryException(
                f"tensors exceed region size {shm_handle.byte_size}")
        buf[pos:end] = raw
        pos = end


def get_contents_as_numpy(shm_handle: SharedMemoryRegion, dtype, shape,
                          offset: int = 0) -> np.ndarray:
    """View region contents as a numpy array (copy for BYTES)."""
    dtype = np.dtype(dtype)
    start = shm_handle.offset + offset
    buf = shm_handle.buffer()
    if dtype == np.object_ or dtype.kind in ("S", "U"):
        raw = bytes(buf[start:shm_handle.offset + shm_handle.byte_size])
        n = int(np.prod(shape)) if len(shape) else 1
        flat = deserialize_bytes_tensor(raw, count=n)
        return flat.reshape(shape)
    count = int(np.prod(shape)) if len(shape) else 1
    nbytes = count * dtype.itemsize
    arr = np.frombuffer(buf[start:start + nbytes], dtype=dtype)
    return arr.reshape(shape)


def get_shared_memory_handle_info(shm_handle: SharedMemoryRegion):
    """Return (key, byte_size, offset)."""
    return shm_handle.key, shm_handle.byte_size, shm_handle.offset


def mapped_shared_memory_regions():
    """Names of regions created by this process."""
    with _lock:
        return [r.name for r in _mapped.values()]


def destroy_shared_memory_region(shm_handle: SharedMemoryRegion) -> None:
    """Unmap and (if owner) unlink the region."""
    if shm_handle.closed:
        return
    shm_handle.closed = True
    with _lock:
        _mapped.pop(shm_handle.key, None)
    try:
        shm_handle.mmap.close()
    except BufferError:
        # live numpy views exported from the mapping keep it alive; the
        # mapping is reclaimed when they die — still unlink the object now
        pass
    finally:
        os.close(shm_handle.fd)
        if shm_handle.owner:
            try:
                os.unlink(_path_for_key(shm_handle.key))
            except FileNotFoundError:
                pass


def wire_dtype_of(arr: np.ndarray) -> str:
    return np_to_wire_dtype(arr.dtype)
