// C ABI shared-memory shim loaded by the Python package via ctypes.
// Parity: ref:src/python/library/tritonclient/utils/shared_memory/
// shared_memory.cc (SharedMemoryRegionCreate/Set/GetInfo/Destroy) — same
// four-verb contract, built on the native shm_utils.
#include <cstring>
#include <string>

#include "client_tpu_torch/shm_utils.h"

namespace {

struct ShmHandle {
  void* base;
  std::string name;
  std::string key;
  int fd;
  size_t offset;
  size_t byte_size;
};

}  // namespace

extern "C" {

int SharedMemoryRegionCreate(const char* name, const char* shm_key,
                             size_t byte_size, void** handle) {
  int fd = -1;
  auto err =
      client_tpu_torch::CreateSharedMemoryRegion(shm_key, byte_size, &fd);
  if (!err.IsOk()) return -2;
  void* base = nullptr;
  err = client_tpu_torch::MapSharedMemory(fd, 0, byte_size, &base);
  if (!err.IsOk()) {
    client_tpu_torch::CloseSharedMemory(fd);
    client_tpu_torch::UnlinkSharedMemoryRegion(shm_key);
    return -3;
  }
  auto* h = new ShmHandle{base, name, shm_key, fd, 0, byte_size};
  *handle = h;
  return 0;
}

int SharedMemoryRegionSet(void* handle, size_t offset, size_t byte_size,
                          const void* data) {
  auto* h = static_cast<ShmHandle*>(handle);
  if (offset + byte_size > h->byte_size) return -1;
  std::memcpy(static_cast<char*>(h->base) + offset, data, byte_size);
  return 0;
}

int GetSharedMemoryHandleInfo(void* handle, char** base, const char** key,
                              int* fd, size_t* offset, size_t* byte_size) {
  auto* h = static_cast<ShmHandle*>(handle);
  *base = static_cast<char*>(h->base);
  *key = h->key.c_str();
  *fd = h->fd;
  *offset = h->offset;
  *byte_size = h->byte_size;
  return 0;
}

int SharedMemoryRegionDestroy(void* handle) {
  auto* h = static_cast<ShmHandle*>(handle);
  client_tpu_torch::UnmapSharedMemory(h->base, h->byte_size);
  client_tpu_torch::CloseSharedMemory(h->fd);
  client_tpu_torch::UnlinkSharedMemoryRegion(h->key);
  delete h;
  return 0;
}

}  // extern "C"
