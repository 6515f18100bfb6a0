// CUDA shared-memory producer — see cuda_shm.h.

#include "client_tpu_torch/cuda_shm.h"

#include <string.h>
#include <sys/mman.h>
#include <unistd.h>

#include <random>

#include "client_tpu_torch/json.h"
#include "client_tpu_torch/shm_utils.h"

namespace client_tpu_torch {

namespace {

constexpr char kMagic[4] = {'C', 'U', 'D', 'S'};
constexpr size_t kHeader = 16;  // magic(4) + seqno(8) + reserved(4)

std::string RandomHex(size_t n) {
  static const char digits[] = "0123456789abcdef";
  std::random_device rd;
  std::mt19937_64 rng(rd());
  std::uniform_int_distribution<int> pick(0, 15);
  std::string out;
  for (size_t i = 0; i < n; ++i) out += digits[pick(rng)];
  return out;
}

uint64_t ReadSeqno(const uint8_t* base) {
  uint64_t v;
  memcpy(&v, base + 4, 8);  // little-endian (x86/arm64 hosts)
  return v;
}

void WriteSeqno(uint8_t* base, uint64_t v) { memcpy(base + 4, &v, 8); }

}  // namespace

CudaShmHandle::~CudaShmHandle() {
  if (base_ != nullptr) {
    UnmapSharedMemory(base_, byte_size_ + kHeader);
  }
  if (fd_ >= 0) {
    CloseSharedMemory(fd_);
    UnlinkSharedMemoryRegion(key_);
  }
}

uint64_t CudaShmHandle::Seqno() const { return ReadSeqno(base_); }

Error CudaShmCreate(std::unique_ptr<CudaShmHandle>* handle,
                    const std::string& name, size_t byte_size,
                    int64_t device_id, const std::string& device) {
  auto h = std::unique_ptr<CudaShmHandle>(new CudaShmHandle());
  h->name_ = name;
  h->uuid_ = RandomHex(32);
  h->key_ = "/cudashm_" + h->uuid_.substr(0, 16);
  h->byte_size_ = byte_size;
  if (device.empty()) {
    h->device_id_ = device_id;
    h->device_ = "cuda:" + std::to_string(device_id);
  } else {
    // as torch.device(...).index or 0: "cuda:N" carries N, "cpu" 0
    h->device_ = device;
    const size_t colon = device.find(':');
    h->device_id_ =
        colon == std::string::npos ? 0 : std::stoll(device.substr(colon + 1));
  }
  Error err = CreateSharedMemoryRegion(h->key_, byte_size + kHeader,
                                       &h->fd_);
  if (!err.IsOk()) return err;
  void* addr = nullptr;
  err = MapSharedMemory(h->fd_, 0, byte_size + kHeader, &addr);
  if (!err.IsOk()) return err;
  h->base_ = static_cast<uint8_t*>(addr);
  memcpy(h->base_, kMagic, 4);
  WriteSeqno(h->base_, 0);
  memset(h->base_ + 12, 0, 4);
  *handle = std::move(h);
  return Error::Success();
}

Error CudaShmSet(CudaShmHandle& handle, size_t offset, const void* data,
                 size_t byte_size) {
  if (offset + byte_size > handle.byte_size_) {
    return Error("write of " + std::to_string(byte_size) + " bytes at " +
                 std::to_string(offset) + " exceeds region size " +
                 std::to_string(handle.byte_size_));
  }
  WriteSeqno(handle.base_, ReadSeqno(handle.base_) + 1);
  memcpy(handle.base_ + kHeader + offset, data, byte_size);
  return Error::Success();
}

Error CudaShmRead(CudaShmHandle& handle, size_t offset, void* data,
                  size_t byte_size) {
  if (offset + byte_size > handle.byte_size_) {
    return Error("read exceeds region size");
  }
  memcpy(data, handle.base_ + kHeader + offset, byte_size);
  return Error::Success();
}

Error CudaShmGetRawHandle(const CudaShmHandle& handle, std::string* raw) {
  // JSON doc per the cuda_shm_handle_v1 spec
  // (client_tpu_torch/utils/cuda_shared_memory/__init__.py get_raw_handle)
  json::Value doc;
  doc["schema"] = json::Value(std::string("cuda_shm_handle_v1"));
  doc["uuid"] = json::Value(handle.uuid_);
  doc["pid"] = json::Value(static_cast<int64_t>(getpid()));
  doc["name"] = json::Value(handle.name_);
  doc["staging_key"] = json::Value(handle.key_);
  doc["byte_size"] = json::Value(static_cast<int64_t>(handle.byte_size_));
  doc["device_id"] = json::Value(handle.device_id_);
  doc["device"] = json::Value(handle.device_);
  const std::string text = doc.Dump();
  *raw = Base64Encode(text.data(), text.size());
  return Error::Success();
}

}  // namespace client_tpu_torch
