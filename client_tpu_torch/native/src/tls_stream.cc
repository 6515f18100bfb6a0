// TLS client stream over dlopen'd libssl (see tls_stream.h).

#include "client_tpu_torch/tls_stream.h"

#include <dlfcn.h>
#include <fcntl.h>
#include <poll.h>
#include <signal.h>

#include <cerrno>
#include <chrono>
#include <mutex>

namespace client_tpu_torch {

namespace {

// OpenSSL 3 ABI subset, resolved at runtime.
struct Libssl {
  void* handle = nullptr;

  int (*OPENSSL_init_ssl)(uint64_t, const void*) = nullptr;
  const void* (*TLS_client_method)() = nullptr;
  void* (*SSL_CTX_new)(const void*) = nullptr;
  void (*SSL_CTX_free)(void*) = nullptr;
  void (*SSL_CTX_set_verify)(void*, int, void*) = nullptr;
  int (*SSL_CTX_set_default_verify_paths)(void*) = nullptr;
  int (*SSL_CTX_load_verify_locations)(void*, const char*, const char*) =
      nullptr;
  int (*SSL_CTX_use_certificate_chain_file)(void*, const char*) = nullptr;
  int (*SSL_CTX_use_PrivateKey_file)(void*, const char*, int) = nullptr;
  void* (*SSL_new)(void*) = nullptr;
  void (*SSL_free)(void*) = nullptr;
  int (*SSL_set_fd)(void*, int) = nullptr;
  int (*SSL_connect)(void*) = nullptr;
  int (*SSL_read)(void*, void*, int) = nullptr;
  int (*SSL_write)(void*, const void*, int) = nullptr;
  int (*SSL_shutdown)(void*) = nullptr;
  int (*SSL_get_error)(const void*, int) = nullptr;
  int (*SSL_set1_host)(void*, const char*) = nullptr;
  long (*SSL_ctrl)(void*, int, long, void*) = nullptr;  // NOLINT
  int (*SSL_set_alpn_protos)(void*, const unsigned char*, unsigned) =
      nullptr;
  void (*SSL_get0_alpn_selected)(const void*, const unsigned char**,
                                 unsigned*) = nullptr;
  unsigned long (*ERR_get_error)() = nullptr;           // NOLINT
  void (*ERR_error_string_n)(unsigned long, char*, size_t) = nullptr;

  bool ok() const { return handle != nullptr; }
};

Libssl* LoadLibssl() {
  static Libssl lib;
  static std::once_flag once;
  std::call_once(once, [] {
    void* h = nullptr;
    for (const char* name :
         {"libssl.so.3", "libssl.so", "libssl.so.1.1"}) {
      h = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
      if (h) break;
    }
    if (!h) return;
    // ERR_* live in libcrypto, which libssl pulls in via RTLD_GLOBAL
    auto sym = [&](const char* n) { return dlsym(h, n); };
#define RESOLVE(field)                                                     \
  lib.field = reinterpret_cast<decltype(lib.field)>(sym(#field));          \
  if (lib.field == nullptr) return;
    RESOLVE(OPENSSL_init_ssl)
    RESOLVE(TLS_client_method)
    RESOLVE(SSL_CTX_new)
    RESOLVE(SSL_CTX_free)
    RESOLVE(SSL_CTX_set_verify)
    RESOLVE(SSL_CTX_set_default_verify_paths)
    RESOLVE(SSL_CTX_load_verify_locations)
    RESOLVE(SSL_CTX_use_certificate_chain_file)
    RESOLVE(SSL_CTX_use_PrivateKey_file)
    RESOLVE(SSL_new)
    RESOLVE(SSL_free)
    RESOLVE(SSL_set_fd)
    RESOLVE(SSL_connect)
    RESOLVE(SSL_read)
    RESOLVE(SSL_write)
    RESOLVE(SSL_shutdown)
    RESOLVE(SSL_get_error)
    RESOLVE(SSL_set1_host)
    RESOLVE(SSL_ctrl)
    RESOLVE(SSL_set_alpn_protos)
    RESOLVE(SSL_get0_alpn_selected)
#undef RESOLVE
    lib.ERR_get_error =
        reinterpret_cast<decltype(lib.ERR_get_error)>(sym("ERR_get_error"));
    lib.ERR_error_string_n = reinterpret_cast<decltype(
        lib.ERR_error_string_n)>(sym("ERR_error_string_n"));
    lib.OPENSSL_init_ssl(0, nullptr);
    lib.handle = h;
  });
  return &lib;
}

std::string LastSslError(Libssl* lib, const std::string& fallback) {
  if (lib->ERR_get_error && lib->ERR_error_string_n) {
    unsigned long code = lib->ERR_get_error();  // NOLINT
    if (code != 0) {
      char buf[256];
      lib->ERR_error_string_n(code, buf, sizeof(buf));
      return std::string(buf);
    }
  }
  return fallback;
}

constexpr int kSslVerifyNone = 0x00;
constexpr int kSslVerifyPeer = 0x01;
constexpr int kSslFiletypePem = 1;
constexpr int kSslCtrlSetTlsextHostname = 55;
constexpr long kTlsextNametypeHostName = 0;  // NOLINT

}  // namespace

bool TlsStream::Available() { return LoadLibssl()->ok(); }

TlsStream::~TlsStream() { Close(); }

Error TlsStream::Connect(int fd, const std::string& host,
                         const TlsOptions& opts) {
  // SSL_write has no MSG_NOSIGNAL equivalent: a peer-closed socket would
  // deliver SIGPIPE and kill the process (observed at connection
  // teardown). Ignore it process-wide once TLS is in use — the write
  // error still surfaces through the normal return path. (libcurl and
  // grpc-core do the same.)
  static std::once_flag sigpipe_once;
  std::call_once(sigpipe_once, [] { ::signal(SIGPIPE, SIG_IGN); });
  Libssl* lib = LoadLibssl();
  if (!lib->ok()) {
    return Error(
        "TLS requested but no usable libssl was found (tried libssl.so.3, "
        "libssl.so, libssl.so.1.1)");
  }
  ctx_ = lib->SSL_CTX_new(lib->TLS_client_method());
  if (!ctx_) return Error("SSL_CTX_new failed");
  if (opts.verify_peer) {
    lib->SSL_CTX_set_verify(ctx_, kSslVerifyPeer, nullptr);
    if (!opts.ca_cert_path.empty()) {
      if (lib->SSL_CTX_load_verify_locations(
              ctx_, opts.ca_cert_path.c_str(), nullptr) != 1) {
        return Error("failed to load CA bundle " + opts.ca_cert_path +
                     ": " + LastSslError(lib, "load_verify_locations"));
      }
    } else {
      lib->SSL_CTX_set_default_verify_paths(ctx_);
    }
  } else {
    lib->SSL_CTX_set_verify(ctx_, kSslVerifyNone, nullptr);
  }
  if (!opts.cert_path.empty()) {
    if (lib->SSL_CTX_use_certificate_chain_file(
            ctx_, opts.cert_path.c_str()) != 1) {
      return Error("failed to load client certificate " + opts.cert_path +
                   ": " + LastSslError(lib, "use_certificate_chain_file"));
    }
    const std::string& key =
        opts.key_path.empty() ? opts.cert_path : opts.key_path;
    if (lib->SSL_CTX_use_PrivateKey_file(ctx_, key.c_str(),
                                         kSslFiletypePem) != 1) {
      return Error("failed to load client key " + key + ": " +
                   LastSslError(lib, "use_PrivateKey_file"));
    }
  }

  ssl_ = lib->SSL_new(ctx_);
  if (!ssl_) return Error("SSL_new failed");
  lib->SSL_set_fd(ssl_, fd);
  // SNI (literal IPs excluded per RFC 6066 is the server's concern; the
  // common case is a hostname)
  lib->SSL_ctrl(ssl_, kSslCtrlSetTlsextHostname, kTlsextNametypeHostName,
                const_cast<char*>(host.c_str()));
  if (opts.verify_peer && opts.verify_host) {
    lib->SSL_set1_host(ssl_, host.c_str());
  }
  if (!opts.alpn.empty()) {
    std::string wire;
    wire.push_back(static_cast<char>(opts.alpn.size()));
    wire += opts.alpn;
    lib->SSL_set_alpn_protos(
        ssl_, reinterpret_cast<const unsigned char*>(wire.data()),
        static_cast<unsigned>(wire.size()));
  }
  int rc = lib->SSL_connect(ssl_);
  if (rc != 1) {
    int code = lib->SSL_get_error(ssl_, rc);
    Error err("TLS handshake with " + host + " failed (ssl error " +
              std::to_string(code) + "): " +
              LastSslError(lib, "SSL_connect"));
    Close();
    return err;
  }
  const unsigned char* proto = nullptr;
  unsigned len = 0;
  lib->SSL_get0_alpn_selected(ssl_, &proto, &len);
  if (proto != nullptr && len > 0) {
    alpn_selected_.assign(reinterpret_cast<const char*>(proto), len);
  } else {
    alpn_selected_.clear();
  }
  // switch to non-blocking: Read/Write serialize all SSL_* calls on
  // ssl_mu_ and must never sleep inside the lock (see header)
  fd_ = fd;
  int flags = fcntl(fd, F_GETFL, 0);
  if (flags >= 0) fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  return Error::Success();
}

constexpr int kSslErrorWantRead = 2;
constexpr int kSslErrorWantWrite = 3;

ssize_t TlsStream::DoIo(bool is_read, void* buf, size_t len) {
  Libssl* lib = LoadLibssl();
  if (!ssl_) return -1;
  const uint64_t deadline_us = timeout_us_;
  const auto start = std::chrono::steady_clock::now();
  while (true) {
    int n;
    int code;
    {
      std::lock_guard<std::mutex> lock(ssl_mu_);
      if (!ssl_) return -1;
      n = is_read
              ? lib->SSL_read(ssl_, buf, static_cast<int>(len))
              : lib->SSL_write(ssl_, const_cast<void*>(buf),
                               static_cast<int>(len));
      if (n > 0) return n;
      code = lib->SSL_get_error(ssl_, n);
    }
    short events;
    if (code == kSslErrorWantRead) {
      events = POLLIN;
    } else if (code == kSslErrorWantWrite) {
      events = POLLOUT;
    } else {
      return n <= 0 ? (n == 0 ? 0 : -1) : n;  // clean close or error
    }
    struct pollfd pfd;
    pfd.fd = fd_;
    pfd.events = events;
    int rc = poll(&pfd, 1, 100);
    if (rc < 0 && errno != EINTR) return -1;
    if (deadline_us > 0) {
      auto elapsed = std::chrono::duration_cast<std::chrono::microseconds>(
                         std::chrono::steady_clock::now() - start)
                         .count();
      if (static_cast<uint64_t>(elapsed) >= deadline_us) {
        errno = EAGAIN;
        return -1;
      }
    }
  }
}

ssize_t TlsStream::Read(void* buf, size_t len) {
  return DoIo(true, buf, len);
}

ssize_t TlsStream::Write(const void* buf, size_t len) {
  return DoIo(false, const_cast<void*>(buf), len);
}

void TlsStream::Close() {
  Libssl* lib = LoadLibssl();
  std::lock_guard<std::mutex> lock(ssl_mu_);
  if (ssl_ && lib->ok()) {
    lib->SSL_shutdown(ssl_);
    lib->SSL_free(ssl_);
  }
  ssl_ = nullptr;
  if (ctx_ && lib->ok()) lib->SSL_CTX_free(ctx_);
  ctx_ = nullptr;
}

}  // namespace client_tpu_torch
