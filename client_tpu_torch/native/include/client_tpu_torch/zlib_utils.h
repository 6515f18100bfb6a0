// Shared zlib helpers for the native transports.
//
// One definition of compress/decompress used by the HTTP/1.1 client
// (Content-Encoding / Accept-Encoding bodies, parity:
// ref:src/c++/library/http_client.cc compression support) and the gRPC
// client (per-message compression behind grpc-encoding, parity: the
// reference's --grpc-compression-algorithm channel option).
//
// "deflate" is the zlib format (RFC 1950), "gzip" the gzip wrapper
// (RFC 1952) — the same mapping HTTP (RFC 9110) and grpc-core use.
#pragma once

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <vector>

#include "client_tpu_torch/common.h"

namespace client_tpu_torch {
namespace zlib_utils {

inline Error ZCompress(const uint8_t* data, size_t size, bool gzip,
                       std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, Z_DEFAULT_COMPRESSION, Z_DEFLATED,
                   gzip ? 15 + 16 : 15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return Error("deflateInit2 failed");
  out->resize(deflateBound(&zs, size));
  zs.next_in = const_cast<uint8_t*>(data);
  zs.avail_in = static_cast<uInt>(size);
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return Error("deflate failed");
  out->resize(out->size() - zs.avail_out);
  return Error::Success();
}

// Decompression-bomb guard: a tiny compressed payload can legally
// inflate ~1000x, so an unbounded ZDecompress would let one message
// allocate the host dry. Reachable from both the HTTP response path
// and gRPC per-message decompression, so the bound is enforced here,
// once. The limit is max(64x input, 64 MiB floor), capped at 2 GiB:
// legitimate sparse/constant tensors compress far beyond 64x (a
// zero-filled 4 MiB tensor gzips to ~4 KiB), so the ratio alone would
// reject legal traffic — the floor admits any payload a serving
// request plausibly carries while still bounding a 1 KiB bomb to
// 64 MiB instead of the whole host.
inline constexpr size_t kZDecompressMaxRatio = 64;
inline constexpr size_t kZDecompressFloorBytes = size_t{64} << 20;
inline constexpr size_t kZDecompressMaxBytes = size_t{1} << 31;  // 2 GiB

inline Error ZDecompress(const uint8_t* data, size_t size,
                         std::vector<uint8_t>* out,
                         size_t max_ratio = kZDecompressMaxRatio,
                         size_t max_bytes = kZDecompressMaxBytes) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 15+32: auto-detect zlib vs gzip framing
  if (inflateInit2(&zs, 15 + 32) != Z_OK)
    return Error("inflateInit2 failed");
  zs.next_in = const_cast<uint8_t*>(data);
  zs.avail_in = static_cast<uInt>(size);
  out->clear();
  size_t limit = max_bytes;
  if (max_ratio != 0 && size <= max_bytes / max_ratio) {
    size_t ratio_cap = size * max_ratio;
    if (ratio_cap < kZDecompressFloorBytes)
      ratio_cap = kZDecompressFloorBytes;
    if (ratio_cap < limit) limit = ratio_cap;
  }
  uint8_t buf[64 * 1024];
  int rc = Z_OK;
  do {
    zs.next_out = buf;
    zs.avail_out = sizeof(buf);
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return Error("inflate failed (corrupt compressed data)");
    }
    out->insert(out->end(), buf, buf + (sizeof(buf) - zs.avail_out));
    if (out->size() > limit) {
      inflateEnd(&zs);
      return Error("decompressed payload exceeds the output bound (" +
                   std::to_string(limit) +
                   " bytes); rejecting instead of allocating further");
    }
  } while (rc != Z_STREAM_END && (zs.avail_in > 0 || zs.avail_out == 0));
  inflateEnd(&zs);
  if (rc != Z_STREAM_END)
    return Error("inflate failed (truncated compressed data)");
  return Error::Success();
}

}  // namespace zlib_utils
}  // namespace client_tpu_torch
