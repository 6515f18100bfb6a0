// gRPC wire helpers shared by every gRPC-protocol client in the native
// tree (the kserve client and the perf analyzer's TF-Serving backend):
// length-prefixed message framing (1-byte compressed flag + 4-byte BE
// length) and trailer status parsing per the gRPC HTTP/2 spec.
#pragma once

#include <cstdint>
#include <string>

#include "client_tpu_torch/common.h"
#include "client_tpu_torch/hpack.h"

namespace client_tpu_torch {
namespace grpc_framing {

// compressed=true sets the flag byte: the payload is encoded with the
// algorithm the stream's grpc-encoding header names.
inline std::string FramePayload(const std::string& payload,
                                bool compressed = false) {
  std::string out;
  out.reserve(payload.size() + 5);
  out.push_back(compressed ? 1 : 0);
  uint32_t len = static_cast<uint32_t>(payload.size());
  out.push_back(static_cast<char>((len >> 24) & 0xff));
  out.push_back(static_cast<char>((len >> 16) & 0xff));
  out.push_back(static_cast<char>((len >> 8) & 0xff));
  out.push_back(static_cast<char>(len & 0xff));
  out.append(payload);
  return out;
}

// Pop one complete message from a reassembly buffer; false if incomplete.
// *compressed (optional) reports the message's flag byte — the receiver
// must then decompress per the stream's grpc-encoding header.
inline bool PopMessage(std::string* buf, std::string* msg,
                       bool* compressed = nullptr) {
  if (buf->size() < 5) return false;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf->data());
  uint32_t len = (uint32_t(p[1]) << 24) | (uint32_t(p[2]) << 16) |
                 (uint32_t(p[3]) << 8) | p[4];
  if (buf->size() < 5u + len) return false;
  if (compressed != nullptr) *compressed = p[0] != 0;
  msg->assign(*buf, 5, len);
  buf->erase(0, 5 + len);
  return true;
}

inline std::string PercentDecode(const std::string& in) {
  std::string out;
  for (size_t i = 0; i < in.size(); ++i) {
    if (in[i] == '%' && i + 2 < in.size()) {
      auto hex = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return -1;
      };
      int hi = hex(in[i + 1]), lo = hex(in[i + 2]);
      if (hi >= 0 && lo >= 0) {
        out.push_back(static_cast<char>(hi * 16 + lo));
        i += 2;
        continue;
      }
    }
    out.push_back(in[i]);
  }
  return out;
}

inline Error StatusFromTrailers(
    const std::vector<hpack::Header>& trailers) {
  std::string status, message;
  for (const auto& h : trailers) {
    if (h.first == "grpc-status") status = h.second;
    if (h.first == "grpc-message") message = h.second;
  }
  if (status.empty()) return Error("missing grpc-status in trailers");
  if (status == "0") return Error::Success();
  return Error("[grpc " + status + "] " + PercentDecode(message),
               atoi(status.c_str()));
}

}  // namespace grpc_framing
}  // namespace client_tpu_torch
