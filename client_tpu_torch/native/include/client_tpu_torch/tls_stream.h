// TLS client stream over the system libssl, loaded at runtime.
//
// Parity role: the reference's HttpSslOptions / SslOptions knobs
// (ref:src/c++/library/http_client.h:46-104, grpc_client.h:42-59) are
// satisfied by libcurl/grpc++ linking OpenSSL at build time; this build
// has no OpenSSL headers, so the needed OpenSSL 3 ABI surface is declared
// locally and resolved with dlopen("libssl.so.3") — the client library
// stays dependency-free and TLS lights up wherever the system provides
// libssl (everywhere that matters). All functions return Error rather
// than aborting when libssl is absent.

#pragma once

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <string>

#include "client_tpu_torch/common.h"

namespace client_tpu_torch {

struct TlsOptions {
  bool enabled = false;
  // Verify the server certificate chain (CURLOPT_SSL_VERIFYPEER analog;
  // ref HttpSslOptions::verify_peer http_client.h:60).
  bool verify_peer = true;
  // Verify the certificate matches the host (CURLOPT_SSL_VERIFYHOST
  // analog; ref HttpSslOptions::verify_host :69).
  bool verify_host = true;
  // PEM CA bundle (CURLOPT_CAINFO analog; ref :74). Empty = system paths.
  std::string ca_cert_path;
  // PEM client certificate + key (ref :80-104 cert/key, PEM only).
  std::string cert_path;
  std::string key_path;
  // ALPN protocol to offer (e.g. "h2" for gRPC); empty = none.
  std::string alpn;
};

class TlsStream {
 public:
  TlsStream() = default;
  ~TlsStream();
  TlsStream(const TlsStream&) = delete;
  TlsStream& operator=(const TlsStream&) = delete;

  // True when libssl.so.3 (or .so/.1.1) resolves.
  static bool Available();

  // Handshake over an already-connected socket. On success the stream
  // owns the TLS session (not the fd).
  Error Connect(int fd, const std::string& host, const TlsOptions& opts);

  // Negotiated ALPN protocol ("" when none).
  const std::string& AlpnSelected() const { return alpn_selected_; }

  // Read/Write are safe to call concurrently from ONE reader thread and
  // ONE writer thread: the socket runs non-blocking after the handshake
  // and every SSL_* call happens under an internal mutex (OpenSSL
  // forbids concurrent use of one SSL* even split by direction); the
  // poll() waits happen OUTSIDE the lock so a blocked reader never
  // starves a writer.
  ssize_t Read(void* buf, size_t len);
  ssize_t Write(const void* buf, size_t len);

  // poll deadline for Read/Write (0 = wait forever). On expiry the call
  // returns -1 with errno=EAGAIN — same contract as SO_RCVTIMEO on a
  // plain socket.
  void SetTimeoutUs(uint64_t timeout_us) { timeout_us_ = timeout_us; }

  void Close();

 private:
  ssize_t DoIo(bool is_read, void* buf, size_t len);

  void* ssl_ = nullptr;      // SSL*
  void* ctx_ = nullptr;      // SSL_CTX*
  int fd_ = -1;
  uint64_t timeout_us_ = 0;
  std::mutex ssl_mu_;
  std::string alpn_selected_;
};

}  // namespace client_tpu_torch
