#include "client_tpu_torch/shm_utils.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <cstring>

namespace client_tpu_torch {

namespace {
Error Errno(const std::string& what) {
  return Error(what + ": " + std::strerror(errno));
}
}  // namespace

Error CreateSharedMemoryRegion(const std::string& shm_key, size_t byte_size,
                               int* shm_fd) {
  *shm_fd = shm_open(shm_key.c_str(), O_RDWR | O_CREAT,
                     S_IRUSR | S_IWUSR);
  if (*shm_fd < 0)
    return Errno("failed to create shared memory region '" + shm_key + "'");
  if (ftruncate(*shm_fd, static_cast<off_t>(byte_size)) != 0) {
    Error err =
        Errno("failed to size shared memory region '" + shm_key + "'");
    close(*shm_fd);
    *shm_fd = -1;
    shm_unlink(shm_key.c_str());
    return err;
  }
  return Error::Success();
}

Error MapSharedMemory(int shm_fd, size_t offset, size_t byte_size,
                      void** shm_addr) {
  *shm_addr = mmap(nullptr, byte_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   shm_fd, static_cast<off_t>(offset));
  if (*shm_addr == MAP_FAILED)
    return Errno("failed to map shared memory");
  return Error::Success();
}

Error CloseSharedMemory(int shm_fd) {
  if (close(shm_fd) != 0) return Errno("failed to close shared memory fd");
  return Error::Success();
}

Error UnlinkSharedMemoryRegion(const std::string& shm_key) {
  if (shm_unlink(shm_key.c_str()) != 0)
    return Errno("failed to unlink shared memory region '" + shm_key + "'");
  return Error::Success();
}

Error UnmapSharedMemory(void* shm_addr, size_t byte_size) {
  if (munmap(shm_addr, byte_size) != 0)
    return Errno("failed to unmap shared memory");
  return Error::Success();
}

}  // namespace client_tpu_torch

namespace client_tpu_torch {

std::string Base64Encode(const void* data, size_t len) {
  static const char tbl[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
  const uint8_t* p = static_cast<const uint8_t*>(data);
  std::string out;
  out.reserve((len + 2) / 3 * 4);
  for (size_t i = 0; i < len; i += 3) {
    uint32_t v = uint32_t(p[i]) << 16;
    if (i + 1 < len) v |= uint32_t(p[i + 1]) << 8;
    if (i + 2 < len) v |= uint32_t(p[i + 2]);
    out.push_back(tbl[(v >> 18) & 63]);
    out.push_back(tbl[(v >> 12) & 63]);
    out.push_back(i + 1 < len ? tbl[(v >> 6) & 63] : '=');
    out.push_back(i + 2 < len ? tbl[v & 63] : '=');
  }
  return out;
}

Error Base64Decode(const std::string& in, std::string* out) {
  auto val = [](char c) -> int {
    if (c >= 'A' && c <= 'Z') return c - 'A';
    if (c >= 'a' && c <= 'z') return c - 'a' + 26;
    if (c >= '0' && c <= '9') return c - '0' + 52;
    if (c == '+') return 62;
    if (c == '/') return 63;
    return -1;
  };
  out->clear();
  int buf = 0, bits = 0;
  for (char c : in) {
    if (c == '=' || c == '\n' || c == '\r') continue;
    int v = val(c);
    if (v < 0) return Error("invalid base64");
    buf = (buf << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out->push_back(static_cast<char>((buf >> bits) & 0xff));
    }
  }
  return Error::Success();
}

}  // namespace client_tpu_torch
