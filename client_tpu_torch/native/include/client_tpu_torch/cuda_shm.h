// CUDA shared-memory producer: the C++ half of the port's CUDA-shm data
// plane.
//
// Parity role: ref:src/python/library/tritonclient/utils/cuda_shared_memory/
// cuda_shared_memory.cc:65-130 (create/set/get_raw_handle/destroy). A
// region is a POSIX-shm STAGING buffer with a 16-byte header (magic
// "CUDS" + little-endian seqno + 4 reserved bytes) and the raw handle is
// a base64 JSON token {schema:"cuda_shm_handle_v1", uuid, pid, name,
// staging_key, byte_size, device_id, device} — the format defined by
// client_tpu_torch.utils.cuda_shared_memory (get_raw_handle). The
// producer stays on the host: the serving process attaches the staging
// buffer (CrossProcessAttachment) and keeps a seqno-guarded cache on the
// token's device, so steady-state inference makes one host->device copy
// per seqno and none after. The token names cuda:<device_id> unless the
// caller names another device ("cpu" for a CPU-only server).

#pragma once

#include <cstdint>
#include <memory>
#include <string>

#include "client_tpu_torch/common.h"

namespace client_tpu_torch {

class CudaShmHandle {
 public:
  ~CudaShmHandle();

  const std::string& Name() const { return name_; }
  const std::string& StagingKey() const { return key_; }
  size_t ByteSize() const { return byte_size_; }
  int64_t DeviceId() const { return device_id_; }
  // the torch device string the token names ("cuda:0", "cpu", ...)
  const std::string& Device() const { return device_; }
  uint64_t Seqno() const;

 private:
  friend Error CudaShmCreate(std::unique_ptr<CudaShmHandle>*,
                             const std::string&, size_t, int64_t,
                             const std::string&);
  friend Error CudaShmSet(CudaShmHandle&, size_t, const void*, size_t);
  friend Error CudaShmRead(CudaShmHandle&, size_t, void*, size_t);
  friend Error CudaShmGetRawHandle(const CudaShmHandle&, std::string*);

  std::string name_;
  std::string key_;
  std::string uuid_;
  std::string device_;
  size_t byte_size_ = 0;  // logical payload size (excludes header)
  int64_t device_id_ = 0;
  int fd_ = -1;
  uint8_t* base_ = nullptr;  // maps header + payload
};

// Allocate a region (parity: CudaSharedMemoryRegionCreate). An empty
// `device` names cuda:<device_id>; "cpu" asks for a CPU-resident region.
Error CudaShmCreate(std::unique_ptr<CudaShmHandle>* handle,
                    const std::string& name, size_t byte_size,
                    int64_t device_id = 0, const std::string& device = "");

// Copy data into the region at offset and bump the seqno
// (parity: CudaSharedMemoryRegionSet).
Error CudaShmSet(CudaShmHandle& handle, size_t offset, const void* data,
                 size_t byte_size);

// Read payload back (outputs written by the server land in staging).
Error CudaShmRead(CudaShmHandle& handle, size_t offset, void* data,
                  size_t byte_size);

// Serialized registration token (parity: GetRawHandle). Pass verbatim to
// RegisterCudaSharedMemory.
Error CudaShmGetRawHandle(const CudaShmHandle& handle, std::string* raw);

}  // namespace client_tpu_torch
