// Minimal HTTP/2 client transport — see http2.h.

#include "client_tpu_torch/http2.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdio>

namespace client_tpu_torch {
namespace http2 {

namespace {
constexpr uint8_t kFrameData = 0x0;
constexpr uint8_t kFrameHeaders = 0x1;
constexpr uint8_t kFrameRstStream = 0x3;
constexpr uint8_t kFrameSettings = 0x4;
constexpr uint8_t kFramePing = 0x6;
constexpr uint8_t kFrameGoaway = 0x7;
constexpr uint8_t kFrameWindowUpdate = 0x8;
constexpr uint8_t kFrameContinuation = 0x9;

constexpr uint8_t kFlagEndStream = 0x1;
constexpr uint8_t kFlagEndHeaders = 0x4;
constexpr uint8_t kFlagAck = 0x1;
constexpr uint8_t kFlagPadded = 0x8;
constexpr uint8_t kFlagPriority = 0x20;

constexpr char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";

void Put24(uint8_t* p, uint32_t v) {
  p[0] = (v >> 16) & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = v & 0xff;
}
void Put32(uint8_t* p, uint32_t v) {
  p[0] = (v >> 24) & 0xff;
  p[1] = (v >> 16) & 0xff;
  p[2] = (v >> 8) & 0xff;
  p[3] = v & 0xff;
}
uint32_t Get32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}
}  // namespace

std::unique_ptr<Connection> Connection::Connect(const std::string& url,
                                                std::string* error) {
  return Connect(url, TlsOptions(), error);
}

std::unique_ptr<Connection> Connection::Connect(const std::string& url,
                                                const TlsOptions& tls,
                                                std::string* error) {
  std::string target = url;
  auto pos = target.find("://");
  if (pos != std::string::npos) target = target.substr(pos + 3);
  std::string host = target, port = "80";
  pos = target.rfind(':');
  if (pos != std::string::npos) {
    host = target.substr(0, pos);
    port = target.substr(pos + 1);
  }

  struct addrinfo hints;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  int rc = getaddrinfo(host.c_str(), port.c_str(), &hints, &res);
  if (rc != 0) {
    if (error) *error = std::string("resolve failed: ") + gai_strerror(rc);
    return nullptr;
  }
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) {
    if (error) *error = "connect failed to " + target;
    return nullptr;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));

  std::unique_ptr<Connection> conn(new Connection());
  conn->fd_ = fd;
  conn->authority_ = target;

  if (tls.enabled) {
    TlsOptions h2_tls = tls;
    if (h2_tls.alpn.empty()) h2_tls.alpn = "h2";
    conn->tls_.reset(new TlsStream());
    Error terr = conn->tls_->Connect(fd, host, h2_tls);
    if (!terr.IsOk()) {
      if (error) *error = terr.Message();
      close(fd);
      conn->fd_ = -1;
      return nullptr;
    }
    if (!conn->tls_->AlpnSelected().empty() &&
        conn->tls_->AlpnSelected() != "h2") {
      if (error)
        *error = "server negotiated ALPN '" + conn->tls_->AlpnSelected() +
                 "', not h2";
      close(fd);
      conn->fd_ = -1;
      return nullptr;
    }
  }

  // client preface + SETTINGS: disable server->us dynamic table growth
  // beyond our decoder default and raise the stream recv window
  if (!conn->WriteAll(reinterpret_cast<const uint8_t*>(kPreface),
                      sizeof(kPreface) - 1)) {
    if (error) *error = "preface write failed";
    return nullptr;
  }
  uint8_t settings[12];
  // SETTINGS_INITIAL_WINDOW_SIZE (0x4) = 256MB
  settings[0] = 0x00;
  settings[1] = 0x04;
  Put32(settings + 2, 256u * 1024 * 1024);
  // SETTINGS_MAX_FRAME_SIZE (0x5) = 1MB (reduce frame count on downloads)
  settings[6] = 0x00;
  settings[7] = 0x05;
  Put32(settings + 8, 1024 * 1024);
  if (!conn->WriteFrame(kFrameSettings, 0, 0, settings, sizeof(settings))) {
    if (error) *error = "settings write failed";
    return nullptr;
  }
  // grow the connection-level receive window
  uint8_t wu[4];
  Put32(wu, 256u * 1024 * 1024 - 65535);
  conn->WriteFrame(kFrameWindowUpdate, 0, 0, wu, sizeof(wu));

  conn->reader_ = std::thread(&Connection::ReaderLoop, conn.get());
  return conn;
}

Connection::~Connection() {
  healthy_ = false;
  if (fd_ >= 0) {
    shutdown(fd_, SHUT_RDWR);
  }
  if (reader_.joinable()) reader_.join();
  // TLS teardown must precede close(fd_): SSL_shutdown writes a
  // close_notify, and the fd number could be reused by another thread
  // the moment it is closed
  if (tls_) tls_->Close();
  if (fd_ >= 0) close(fd_);
}

bool Connection::WriteAll(const uint8_t* data, size_t len) {
  size_t off = 0;
  while (off < len) {
    ssize_t n = tls_ ? tls_->Write(data + off, len - off)
                     : ::send(fd_, data + off, len - off, MSG_NOSIGNAL);
    if (n <= 0) {
      healthy_ = false;
      return false;
    }
    off += static_cast<size_t>(n);
  }
  return true;
}

ssize_t Connection::RawRecv(void* buf, size_t len) {
  if (tls_) return tls_->Read(buf, len);
  return ::recv(fd_, buf, len, 0);
}

bool Connection::WriteFrame(uint8_t type, uint8_t flags, int32_t stream_id,
                            const uint8_t* payload, size_t len) {
  std::lock_guard<std::mutex> lock(write_mu_);
  return WriteFrameLocked(type, flags, stream_id, payload, len);
}

bool Connection::WriteFrameLocked(uint8_t type, uint8_t flags,
                                  int32_t stream_id, const uint8_t* payload,
                                  size_t len) {
  uint8_t hdr[9];
  Put24(hdr, static_cast<uint32_t>(len));
  hdr[3] = type;
  hdr[4] = flags;
  Put32(hdr + 5, static_cast<uint32_t>(stream_id));
  if (!WriteAll(hdr, sizeof(hdr))) return false;
  if (len && !WriteAll(payload, len)) return false;
  return true;
}

int32_t Connection::StartStream(const Headers& headers, bool end_stream,
                                StreamEvents events, std::string* error) {
  if (!healthy_) {
    if (error) *error = "connection is closed: " + close_reason_;
    return 0;
  }
  std::string block;
  for (const auto& h : headers) {
    hpack::EncodeHeader(h.first, h.second, &block);
  }
  // RFC 7540 S5.1.1: client stream ids must hit the wire strictly
  // increasing. Hold write_mu_ (the wire lock) across id allocation AND
  // the HEADERS write so two threads can't emit out of order. Lock order
  // is write_mu_ -> mu_ everywhere (HandleFrame defers its WINDOW_UPDATE
  // writes until after mu_ is released to respect this).
  int32_t sid;
  uint8_t flags = kFlagEndHeaders | (end_stream ? kFlagEndStream : 0);
  {
    std::lock_guard<std::mutex> wlock(write_mu_);
    {
      std::lock_guard<std::mutex> lock(mu_);
      sid = next_stream_id_;
      next_stream_id_ += 2;
      auto stream = std::make_shared<Stream>();
      stream->events = std::move(events);
      stream->send_window = initial_send_window_;
      streams_[sid] = std::move(stream);
    }
    if (!WriteFrameLocked(kFrameHeaders, flags, sid,
                          reinterpret_cast<const uint8_t*>(block.data()),
                          block.size())) {
      if (error) *error = "HEADERS write failed";
      std::lock_guard<std::mutex> lock(mu_);
      streams_.erase(sid);
      return 0;
    }
  }
  return sid;
}

bool Connection::SendData(int32_t stream_id, const uint8_t* data, size_t len,
                          bool end_stream, std::string* error) {
  size_t off = 0;
  while (off < len || (end_stream && len == 0)) {
    size_t chunk;
    {
      std::unique_lock<std::mutex> lock(mu_);
      window_cv_.wait(lock, [&] {
        if (!healthy_) return true;
        auto it = streams_.find(stream_id);
        if (it == streams_.end() || it->second->cancelled) return true;
        return len == 0 ||
               (conn_send_window_ > 0 && it->second->send_window > 0);
      });
      if (!healthy_) {
        if (error) *error = "connection closed during send";
        return false;
      }
      auto it = streams_.find(stream_id);
      if (it == streams_.end() || it->second->cancelled) {
        if (error) *error = "stream closed during send";
        return false;
      }
      int64_t window = std::min(conn_send_window_,
                                it->second->send_window);
      chunk = std::min<size_t>(
          {len - off, static_cast<size_t>(std::max<int64_t>(window, 0)),
           max_frame_size_});
      if (len == 0) chunk = 0;
      conn_send_window_ -= chunk;
      it->second->send_window -= chunk;
    }
    bool last = (off + chunk == len);
    uint8_t flags = (last && end_stream) ? kFlagEndStream : 0;
    if (!WriteFrame(kFrameData, flags, stream_id, data + off, chunk)) {
      if (error) *error = "DATA write failed";
      return false;
    }
    off += chunk;
    if (len == 0) break;
  }
  return true;
}

bool Connection::SendRstStream(int32_t stream_id, uint32_t code) {
  uint8_t p[4];
  Put32(p, code);
  {
    // erase immediately: no further flow-controlled writes are legal
    // after RST, and late trailers are harmless because HandleFrame
    // decodes every header block through the shared HPACK decoder BEFORE
    // looking the stream up, so connection header state stays in sync.
    // Keeping the entry would leak one per cancelled/timed-out call (a
    // compliant server sends nothing after RST).
    std::lock_guard<std::mutex> lock(mu_);
    auto it = streams_.find(stream_id);
    if (it != streams_.end()) {
      it->second->cancelled = true;  // in case another thread holds the ptr
      streams_.erase(it);
    }
  }
  window_cv_.notify_all();
  return WriteFrame(kFrameRstStream, 0, stream_id, p, sizeof(p));
}

bool Connection::Ping() {
  uint8_t p[8] = {0};
  return WriteFrame(kFramePing, 0, 0, p, sizeof(p));
}

void Connection::CloseAllStreams(const std::string& reason) {
  std::map<int32_t, std::shared_ptr<Stream>> doomed;
  {
    std::lock_guard<std::mutex> lock(mu_);
    doomed.swap(streams_);
  }
  window_cv_.notify_all();
  for (auto& kv : doomed) {
    if (kv.second->events.on_closed) {
      kv.second->events.on_closed({}, reason);
    }
  }
}

void Connection::ReaderLoop() {
  std::vector<uint8_t> buf;
  uint8_t hdr[9];
  while (healthy_) {
    size_t got = 0;
    while (got < sizeof(hdr)) {
      ssize_t n = RawRecv(hdr + got, sizeof(hdr) - got);
      if (n <= 0) {
        healthy_ = false;
        CloseAllStreams(close_reason_.empty() ? "connection closed by peer"
                                              : close_reason_);
        return;
      }
      got += static_cast<size_t>(n);
    }
    uint32_t len = (uint32_t(hdr[0]) << 16) | (uint32_t(hdr[1]) << 8) |
                   hdr[2];
    uint8_t type = hdr[3];
    uint8_t flags = hdr[4];
    int32_t sid = static_cast<int32_t>(Get32(hdr + 5) & 0x7fffffff);
    buf.resize(len);
    size_t off = 0;
    while (off < len) {
      ssize_t n = RawRecv(buf.data() + off, len - off);
      if (n <= 0) {
        healthy_ = false;
        CloseAllStreams("connection closed mid-frame");
        return;
      }
      off += static_cast<size_t>(n);
    }
    HandleFrame(type, flags, sid, buf);
  }
  CloseAllStreams(close_reason_.empty() ? "connection shut down"
                                        : close_reason_);
}

void Connection::HandleFrame(uint8_t type, uint8_t flags, int32_t sid,
                             std::vector<uint8_t>& payload) {
  switch (type) {
    case kFrameSettings: {
      if (flags & kFlagAck) return;
      for (size_t i = 0; i + 6 <= payload.size(); i += 6) {
        uint16_t id = (uint16_t(payload[i]) << 8) | payload[i + 1];
        uint32_t value = Get32(payload.data() + i + 2);
        std::lock_guard<std::mutex> lock(mu_);
        if (id == 0x4) {  // INITIAL_WINDOW_SIZE: adjust open streams
          int64_t delta = int64_t(value) - initial_send_window_;
          initial_send_window_ = value;
          for (auto& kv : streams_) kv.second->send_window += delta;
          window_cv_.notify_all();
        } else if (id == 0x5) {
          max_frame_size_ = value;
        }
      }
      WriteFrame(kFrameSettings, kFlagAck, 0, nullptr, 0);
      return;
    }
    case kFramePing: {
      if (!(flags & kFlagAck)) {
        WriteFrame(kFramePing, kFlagAck, 0, payload.data(), payload.size());
      }
      return;
    }
    case kFrameWindowUpdate: {
      if (payload.size() < 4) return;
      uint32_t inc = Get32(payload.data()) & 0x7fffffff;
      std::lock_guard<std::mutex> lock(mu_);
      if (sid == 0) {
        conn_send_window_ += inc;
      } else {
        auto it = streams_.find(sid);
        if (it != streams_.end()) it->second->send_window += inc;
      }
      window_cv_.notify_all();
      return;
    }
    case kFrameGoaway: {
      uint32_t code = payload.size() >= 8 ? Get32(payload.data() + 4) : 0;
      close_reason_ = "GOAWAY (code " + std::to_string(code) + ")";
      if (payload.size() > 8) {
        close_reason_ += ": " + std::string(payload.begin() + 8,
                                            payload.end());
      }
      healthy_ = false;
      shutdown(fd_, SHUT_RDWR);
      return;
    }
    case kFrameHeaders:
    case kFrameContinuation: {
      // accumulate the connection's single in-progress header block
      // (RFC 7540 S4.3: blocks are contiguous across streams)
      const uint8_t* p = payload.data();
      size_t len = payload.size();
      if (type == kFrameHeaders) {
        if (flags & kFlagPadded) {
          if (len < 1) return;
          uint8_t pad = p[0];
          p += 1;
          len = (len > pad + 1u) ? len - pad - 1 : 0;
        }
        if (flags & kFlagPriority) {
          if (len < 5) return;
          p += 5;
          len -= 5;
        }
        hdr_block_sid_ = sid;
        hdr_block_.assign(p, p + len);
        hdr_block_end_stream_ = (flags & kFlagEndStream) != 0;
        hdr_block_active_ = true;
      } else {
        if (!hdr_block_active_ || sid != hdr_block_sid_) return;
        hdr_block_.insert(hdr_block_.end(), p, p + len);
      }
      if (!(flags & kFlagEndHeaders)) return;
      hdr_block_active_ = false;
      // ALWAYS decode: the HPACK dynamic table is connection state, even
      // if the stream is cancelled or unknown
      Headers decoded;
      bool decode_ok = hpack_decoder_.Decode(hdr_block_.data(),
                                             hdr_block_.size(), &decoded);
      hdr_block_.clear();
      bool ends = hdr_block_end_stream_;

      std::shared_ptr<Stream> stream;
      bool is_trailers = false;
      {
        std::lock_guard<std::mutex> lock(mu_);
        auto it = streams_.find(sid);
        if (it == streams_.end()) return;
        stream = it->second;
        is_trailers = stream->saw_headers;
        if (!decode_ok || is_trailers || ends) {
          streams_.erase(it);
        } else {
          stream->saw_headers = true;
        }
      }
      // wake any sender blocked on flow control for the erased stream
      if (!decode_ok || is_trailers || ends) window_cv_.notify_all();
      if (stream->cancelled) return;  // caller already gave up
      // callbacks run WITHOUT mu_ held (a callback may re-enter the
      // connection, e.g. issue the next stream write)
      if (!decode_ok) {
        if (stream->events.on_closed) {
          stream->events.on_closed({}, "HPACK decode error");
        }
      } else if (is_trailers || ends) {
        if (stream->events.on_closed) {
          stream->events.on_closed(decoded, "");
        }
      } else {
        if (stream->events.on_headers) stream->events.on_headers(decoded);
      }
      return;
    }
    case kFrameData: {
      const uint8_t* p = payload.data();
      size_t len = payload.size();
      if (flags & kFlagPadded) {
        if (len < 1) return;
        uint8_t pad = p[0];
        p += 1;
        len = (len > pad + 1u) ? len - pad - 1 : 0;
      }
      std::shared_ptr<Stream> stream;
      bool finished = false;
      uint64_t stream_wu = 0, conn_wu = 0;
      {
        std::lock_guard<std::mutex> lock(mu_);
        auto it = streams_.find(sid);
        if (it != streams_.end()) {
          stream = it->second;
          if (flags & kFlagEndStream) {
            finished = true;
            streams_.erase(it);
          } else {
            // replenish the per-stream receive window (long-lived bidi
            // streams would otherwise stall at the initial window)
            stream->recv_since_update += payload.size();
            if (stream->recv_since_update >= 32 * 1024 * 1024) {
              stream_wu = stream->recv_since_update;
              stream->recv_since_update = 0;
            }
          }
        }
        // replenish the connection receive window
        recv_since_update_ += payload.size();
        if (recv_since_update_ >= 8 * 1024 * 1024) {
          conn_wu = recv_since_update_;
          recv_since_update_ = 0;
        }
      }
      // WINDOW_UPDATE writes happen after mu_ is released: the wire lock
      // (write_mu_) is the outer lock in this file (see StartStream)
      if (stream_wu) {
        uint8_t wu[4];
        Put32(wu, static_cast<uint32_t>(stream_wu));
        WriteFrame(kFrameWindowUpdate, 0, sid, wu, sizeof(wu));
      }
      if (conn_wu) {
        uint8_t wu[4];
        Put32(wu, static_cast<uint32_t>(conn_wu));
        WriteFrame(kFrameWindowUpdate, 0, 0, wu, sizeof(wu));
      }
      if (finished) window_cv_.notify_all();
      if (!stream || stream->cancelled) return;
      if (len && stream->events.on_data) stream->events.on_data(p, len);
      if (finished && stream->events.on_closed) {
        // END_STREAM on DATA without trailers (rare for gRPC)
        stream->events.on_closed({}, "");
      }
      return;
    }
    case kFrameRstStream: {
      uint32_t code = payload.size() >= 4 ? Get32(payload.data()) : 0;
      std::shared_ptr<Stream> stream;
      {
        std::lock_guard<std::mutex> lock(mu_);
        auto it = streams_.find(sid);
        if (it != streams_.end()) {
          stream = it->second;
          streams_.erase(it);
        }
      }
      window_cv_.notify_all();
      if (stream && !stream->cancelled && stream->events.on_closed) {
        stream->events.on_closed(
            {}, "stream reset by server (code " + std::to_string(code) +
                    ")");
      }
      return;
    }
    default:
      return;  // PRIORITY, PUSH_PROMISE (never for us), unknown: ignore
  }
}

}  // namespace http2
}  // namespace client_tpu_torch
