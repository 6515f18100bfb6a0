// POSIX system shared-memory helpers.
// Parity: ref:src/c++/library/shm_utils.{h,cc} (Create/Map/Close/Unlink/
// Unmap) — same five-verb surface.
#pragma once

#include <cstddef>
#include <string>

#include "client_tpu_torch/common.h"

namespace client_tpu_torch {

// Shared base64 codec (one implementation for the cuda-shm handle token,
// the REST raw_handle wrapping, and --input-data {"b64": ...} values).
std::string Base64Encode(const void* data, size_t len);
Error Base64Decode(const std::string& in, std::string* out);

Error CreateSharedMemoryRegion(const std::string& shm_key, size_t byte_size,
                               int* shm_fd);
Error MapSharedMemory(int shm_fd, size_t offset, size_t byte_size,
                      void** shm_addr);
Error CloseSharedMemory(int shm_fd);
Error UnlinkSharedMemoryRegion(const std::string& shm_key);
Error UnmapSharedMemory(void* shm_addr, size_t byte_size);

}  // namespace client_tpu_torch
