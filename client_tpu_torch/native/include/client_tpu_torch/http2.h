// Minimal HTTP/2 (RFC 7540) client transport for the native gRPC client.
//
// Scope: exactly what gRPC needs — h2c prior knowledge over a TCP (or
// TLS-less loopback) socket, HEADERS/DATA/WINDOW_UPDATE/SETTINGS/PING/
// RST_STREAM/GOAWAY frames, client-initiated streams, both-direction flow
// control, HPACK via client_tpu_torch/hpack.h. One reader thread per
// connection delivers stream events via callbacks.
//
// Role parity: the reference's grpc++ channel (grpc_client.cc:81-140);
// this repo's native stack is dependency-free by design (cf. the POSIX
// HTTP/1.1 client in src/http_client.cc).

#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "client_tpu_torch/hpack.h"
#include "client_tpu_torch/tls_stream.h"

namespace client_tpu_torch {
namespace http2 {

using Headers = std::vector<hpack::Header>;

struct StreamEvents {
  // response HEADERS (initial). trailers arrive via on_trailers.
  std::function<void(const Headers&)> on_headers;
  // DATA payload chunk
  std::function<void(const uint8_t*, size_t)> on_data;
  // stream closed: trailers (may be empty), error text (empty = clean)
  std::function<void(const Headers&, const std::string&)> on_closed;
};

class Connection {
 public:
  // host:port, h2c prior knowledge. Returns nullptr + error on failure.
  static std::unique_ptr<Connection> Connect(const std::string& url,
                                             std::string* error);
  // TLS variant: handshake with ALPN "h2" before the HTTP/2 preface
  // (parity role: ref grpc_client.h:42 SslOptions secure channels).
  static std::unique_ptr<Connection> Connect(const std::string& url,
                                             const TlsOptions& tls,
                                             std::string* error);
  ~Connection();

  // Open a stream: send HEADERS (+ optionally END_STREAM). Returns the
  // stream id, or 0 on failure.
  int32_t StartStream(const Headers& headers, bool end_stream,
                      StreamEvents events, std::string* error);

  // Send DATA on a stream, honoring flow control (blocks while the
  // send window is exhausted). end_stream half-closes our side.
  bool SendData(int32_t stream_id, const uint8_t* data, size_t len,
                bool end_stream, std::string* error);

  bool SendRstStream(int32_t stream_id, uint32_t code);
  bool Ping();

  bool healthy() const { return healthy_; }
  const std::string& authority() const { return authority_; }

 private:
  Connection() = default;
  bool WriteAll(const uint8_t* data, size_t len);
  ssize_t RawRecv(void* buf, size_t len);
  bool WriteFrame(uint8_t type, uint8_t flags, int32_t stream_id,
                  const uint8_t* payload, size_t len);
  bool WriteFrameLocked(uint8_t type, uint8_t flags, int32_t stream_id,
                        const uint8_t* payload, size_t len);
  void ReaderLoop();
  void HandleFrame(uint8_t type, uint8_t flags, int32_t stream_id,
                   std::vector<uint8_t>& payload);
  void CloseAllStreams(const std::string& reason);

  struct Stream {
    StreamEvents events;
    bool saw_headers = false;
    bool cancelled = false;  // client-side cancel: keep for HPACK state,
                             // suppress callbacks, drop on server close
    int64_t send_window = 0;
    int64_t recv_since_update = 0;
  };

  int fd_ = -1;
  std::string authority_;
  std::atomic<bool> healthy_{true};
  std::string close_reason_;

  std::unique_ptr<TlsStream> tls_;  // set when TLS-wrapped
  std::mutex write_mu_;
  std::mutex mu_;  // streams_, windows
  std::condition_variable window_cv_;
  std::map<int32_t, std::shared_ptr<Stream>> streams_;
  int32_t next_stream_id_ = 1;
  int64_t conn_send_window_ = 65535;
  int64_t initial_send_window_ = 65535;
  uint32_t max_frame_size_ = 16384;
  int64_t recv_since_update_ = 0;

  // one in-progress header block per connection (RFC 7540 S4.3: header
  // blocks are contiguous — HEADERS/CONTINUATION of different streams
  // cannot interleave), decoded unconditionally to keep HPACK state in
  // sync even for cancelled/unknown streams
  int32_t hdr_block_sid_ = 0;
  std::vector<uint8_t> hdr_block_;
  bool hdr_block_end_stream_ = false;
  bool hdr_block_active_ = false;

  hpack::Decoder hpack_decoder_{4096};
  std::thread reader_;
};

}  // namespace http2
}  // namespace client_tpu_torch
