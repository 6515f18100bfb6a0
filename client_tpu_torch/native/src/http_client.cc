#include "client_tpu_torch/http_client.h"

#include "client_tpu_torch/shm_utils.h"

#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <zlib.h>

#include "client_tpu_torch/zlib_utils.h"

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cstdlib>
#include <cstring>
#include <map>
#include <sstream>

namespace client_tpu_torch {

namespace {

constexpr const char* kInferHeaderLen = "Inference-Header-Content-Length";

// HTTP "deflate" is the zlib format, "gzip" the gzip wrapper (RFC 9110);
// one shared zlib implementation with the gRPC client (zlib_utils.h).
using zlib_utils::ZCompress;
using zlib_utils::ZDecompress;

const char* CompressionName(CompressionType t) {
  switch (t) {
    case CompressionType::DEFLATE: return "deflate";
    case CompressionType::GZIP: return "gzip";
    default: return "";
  }
}

}  // namespace

// ---------------------------------------------------------------------
// HttpConnection: blocking POSIX-socket HTTP/1.1 with keep-alive.
// ---------------------------------------------------------------------

class HttpConnection {
 public:
  HttpConnection(std::string host, int port,
                 TlsOptions tls = TlsOptions())
      : host_(std::move(host)), port_(port), tls_opts_(std::move(tls)) {}
  ~HttpConnection() { Close(); }

  Error Request(const std::string& method, const std::string& path,
                const std::vector<std::pair<std::string, std::string>>&
                    extra_headers,
                const std::vector<std::pair<const uint8_t*, size_t>>& body,
                int* status, std::map<std::string, std::string>* rheaders,
                std::vector<uint8_t>* rbody,
                RequestTimers* timers = nullptr,
                uint64_t timeout_us = 0) {
    timeout_us_ = timeout_us;
    const bool reused = fd_ >= 0;
    bool wrote_bytes = false;
    Error err = DoRequest(method, path, extra_headers, body, status,
                          rheaders, rbody, timers, &wrote_bytes);
    if (!err.IsOk()) {
      Close();
      // Retry only a stale keep-alive socket that rejected the very first
      // write — a request that may have reached the server must NOT be
      // re-sent (inference POSTs are not idempotent).
      if (reused && !wrote_bytes) {
        err = DoRequest(method, path, extra_headers, body, status, rheaders,
                        rbody, timers, &wrote_bytes);
        if (!err.IsOk()) Close();
      }
    }
    return err;
  }

 private:
  Error Connect() {
    if (fd_ >= 0) return Error::Success();
    struct addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    const std::string port = std::to_string(port_);
    int rc = getaddrinfo(host_.c_str(), port.c_str(), &hints, &res);
    if (rc != 0)
      return Error("failed to resolve " + host_ + ": " + gai_strerror(rc));
    Error err("failed to connect to " + host_ + ":" + port);
    for (struct addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
      fd_ = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd_ < 0) continue;
      if (connect(fd_, ai->ai_addr, ai->ai_addrlen) == 0) {
        int one = 1;
        setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        err = Error::Success();
        break;
      }
      close(fd_);
      fd_ = -1;
    }
    freeaddrinfo(res);
    if (!err.IsOk()) return err;
    if (tls_opts_.enabled) {
      tls_.reset(new TlsStream());
      err = tls_->Connect(fd_, host_, tls_opts_);
      if (!err.IsOk()) Close();
    }
    return err;
  }

  void Close() {
    if (tls_) {
      tls_->Close();
      tls_.reset();
    }
    if (fd_ >= 0) {
      close(fd_);
      fd_ = -1;
    }
  }

  ssize_t RawRecv(void* buf, size_t len) {
    if (tls_) return tls_->Read(buf, len);
    return recv(fd_, buf, len, 0);
  }

  Error WriteAll(const uint8_t* data, size_t size) {
    while (size > 0) {
      ssize_t n = tls_ ? tls_->Write(data, size)
                       : send(fd_, data, size, MSG_NOSIGNAL);
      if (n <= 0) return Error("socket write failed");
      data += n;
      size -= static_cast<size_t>(n);
    }
    return Error::Success();
  }

  Error DoRequest(const std::string& method, const std::string& path,
                  const std::vector<std::pair<std::string, std::string>>&
                      extra_headers,
                  const std::vector<std::pair<const uint8_t*, size_t>>& body,
                  int* status, std::map<std::string, std::string>* rheaders,
                  std::vector<uint8_t>* rbody, RequestTimers* timers,
                  bool* wrote_bytes) {
    *wrote_bytes = false;
    Error err = Connect();
    if (!err.IsOk()) return err;
    // per-request client timeout via socket deadlines (parity role:
    // CURLOPT_TIMEOUT_MS; a timed-out request maps to a 499-style error)
    struct timeval tv;
    tv.tv_sec = static_cast<time_t>(timeout_us_ / 1000000);
    tv.tv_usec = static_cast<suseconds_t>(timeout_us_ % 1000000);
    setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd_, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    if (tls_) tls_->SetTimeoutUs(timeout_us_);  // poll-based on TLS

    size_t content_length = 0;
    for (const auto& piece : body) content_length += piece.second;

    std::ostringstream req;
    req << method << ' ' << path << " HTTP/1.1\r\n"
        << "Host: " << host_ << ':' << port_ << "\r\n"
        << "Connection: keep-alive\r\n"
        << "Content-Length: " << content_length << "\r\n";
    for (const auto& kv : extra_headers)
      req << kv.first << ": " << kv.second << "\r\n";
    req << "\r\n";
    const std::string head = req.str();
    if (timers) timers->Capture(RequestTimers::Kind::SEND_START);
    err = WriteAll(reinterpret_cast<const uint8_t*>(head.data()),
                   head.size());
    if (!err.IsOk()) return err;
    *wrote_bytes = true;
    for (const auto& piece : body) {  // scatter-gather upload, no copy
      err = WriteAll(piece.first, piece.second);
      if (!err.IsOk()) return err;
    }
    if (timers) timers->Capture(RequestTimers::Kind::SEND_END);
    if (timers) timers->Capture(RequestTimers::Kind::RECV_START);
    err = ReadResponse(status, rheaders, rbody);
    if (timers && err.IsOk())
      timers->Capture(RequestTimers::Kind::RECV_END);
    return err;
  }

  Error ReadResponse(int* status, std::map<std::string, std::string>* rheaders,
                     std::vector<uint8_t>* rbody) {
    // read until header terminator
    std::string head;
    while (head.find("\r\n\r\n") == std::string::npos) {
      char buf[4096];
      ssize_t n = RawRecv(buf, sizeof(buf));
      if (n == 0) return Error("connection closed by server");
      if (n < 0)
        return (timeout_us_ > 0 && (errno == EAGAIN ||
                                    errno == EWOULDBLOCK))
                   ? Error("Deadline Exceeded", 499)
                   : Error("socket read failed");
      head.append(buf, static_cast<size_t>(n));
      if (head.size() > (16u << 20)) return Error("response header too big");
    }
    const size_t header_end = head.find("\r\n\r\n");
    std::string overflow = head.substr(header_end + 4);
    head.resize(header_end);

    std::istringstream hs(head);
    std::string line;
    std::getline(hs, line);
    if (line.size() < 12 || line.compare(0, 5, "HTTP/") != 0)
      return Error("malformed HTTP status line: " + line);
    *status = std::atoi(line.substr(9, 3).c_str());

    rheaders->clear();
    while (std::getline(hs, line)) {
      if (!line.empty() && line.back() == '\r') line.pop_back();
      const size_t colon = line.find(':');
      if (colon == std::string::npos) continue;
      // HTTP header names are case-insensitive (RFC 9110): store lowercase
      std::string key = line.substr(0, colon);
      std::transform(key.begin(), key.end(), key.begin(),
                     [](unsigned char c) { return std::tolower(c); });
      size_t vstart = line.find_first_not_of(' ', colon + 1);
      std::string val =
          vstart == std::string::npos ? "" : line.substr(vstart);
      (*rheaders)[key] = val;
    }

    size_t content_length = 0;
    auto it = rheaders->find("content-length");
    if (it != rheaders->end()) {
      errno = 0;
      char* endp = nullptr;
      unsigned long long v = strtoull(it->second.c_str(), &endp, 10);
      if (errno != 0 || endp == it->second.c_str() || *endp != '\0')
        return Error("malformed Content-Length: " + it->second);
      content_length = static_cast<size_t>(v);
    }

    rbody->assign(overflow.begin(), overflow.end());
    while (rbody->size() < content_length) {
      uint8_t buf[65536];
      size_t want = std::min(sizeof(buf), content_length - rbody->size());
      ssize_t n = RawRecv(buf, want);
      if (n == 0)
        return Error("connection closed by server (body)");
      if (n < 0)
        return (timeout_us_ > 0 && (errno == EAGAIN ||
                                    errno == EWOULDBLOCK))
                   ? Error("Deadline Exceeded", 499)
                   : Error("socket read failed (body)");
      rbody->insert(rbody->end(), buf, buf + n);
    }
    return Error::Success();
  }

  std::string host_;
  int port_;
  int fd_ = -1;
  uint64_t timeout_us_ = 0;
  TlsOptions tls_opts_;
  std::unique_ptr<TlsStream> tls_;
};

// ---------------------------------------------------------------------
// InferResultHttp
// ---------------------------------------------------------------------

namespace {

// Fill a raw little-endian buffer from a JSON data array for a dtype.
Error JsonDataToRaw(const json::Array& data, const std::string& dt,
                    std::vector<uint8_t>* out) {
  auto push = [&out](const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    out->insert(out->end(), b, b + n);
  };
  for (const auto& v : data) {
    if (dt == "BOOL") {
      uint8_t x = v.IsBool() ? (v.AsBool() ? 1 : 0)
                             : (v.AsInt() ? 1 : 0);
      push(&x, 1);
    } else if (dt == "INT8") {
      int8_t x = static_cast<int8_t>(v.AsInt()); push(&x, 1);
    } else if (dt == "UINT8") {
      uint8_t x = static_cast<uint8_t>(v.AsInt()); push(&x, 1);
    } else if (dt == "INT16") {
      int16_t x = static_cast<int16_t>(v.AsInt()); push(&x, 2);
    } else if (dt == "UINT16") {
      uint16_t x = static_cast<uint16_t>(v.AsInt()); push(&x, 2);
    } else if (dt == "INT32") {
      int32_t x = static_cast<int32_t>(v.AsInt()); push(&x, 4);
    } else if (dt == "UINT32") {
      uint32_t x = static_cast<uint32_t>(v.AsInt()); push(&x, 4);
    } else if (dt == "INT64") {
      int64_t x = v.AsInt(); push(&x, 8);
    } else if (dt == "UINT64") {
      uint64_t x = static_cast<uint64_t>(v.AsInt()); push(&x, 8);
    } else if (dt == "FP32") {
      float x = static_cast<float>(v.AsDouble()); push(&x, 4);
    } else if (dt == "FP64") {
      double x = v.AsDouble(); push(&x, 8);
    } else if (dt == "BYTES") {
      const std::string& s = v.AsString();
      uint32_t len = static_cast<uint32_t>(s.size());
      push(&len, 4);
      push(s.data(), s.size());
    } else {
      return Error("cannot convert JSON data for datatype " + dt);
    }
  }
  return Error::Success();
}

}  // namespace

class InferResultHttp : public InferResult {
 public:
  // body ownership moves in; header_length==npos => all-JSON response
  static Error Create(InferResult** result, std::vector<uint8_t> body,
                      size_t header_length) {
    auto* res = new InferResultHttp();
    res->body_ = std::move(body);
    size_t jlen = header_length == std::string::npos ? res->body_.size()
                                                     : header_length;
    if (jlen > res->body_.size()) {
      delete res;
      return Error("inference header length exceeds response size");
    }
    try {
      res->header_ = json::Parser(
          reinterpret_cast<const char*>(res->body_.data()), jlen).Parse();
    } catch (const std::exception& e) {
      delete res;
      return Error(std::string("failed to parse response JSON: ") +
                   e.what());
    }
    if (res->header_.Has("error")) {
      res->status_ = Error(res->header_.At("error").AsString(), 400);
    } else {
      // map binary sections: concatenated after the JSON in output order
      size_t offset = jlen;
      for (const auto& out : res->header_.At("outputs").AsArray()) {
        const std::string& name = out.At("name").AsString();
        const auto& params = out.At("parameters");
        if (params.Has("binary_data_size")) {
          size_t sz =
              static_cast<size_t>(params.At("binary_data_size").AsInt());
          if (offset + sz > res->body_.size()) {
            delete res;
            return Error("binary section for '" + name +
                         "' exceeds response size");
          }
          res->binary_[name] = {offset, sz};
          offset += sz;
        }
      }
    }
    *result = res;
    return Error::Success();
  }

  Error RequestStatus() const override { return status_; }
  Error Id(std::string* id) const override {
    *id = header_.At("id").AsString();
    return Error::Success();
  }
  Error ModelName(std::string* name) const override {
    *name = header_.At("model_name").AsString();
    return Error::Success();
  }
  Error ModelVersion(std::string* version) const override {
    *version = header_.At("model_version").AsString();
    return Error::Success();
  }

  Error Shape(const std::string& name,
              std::vector<int64_t>* shape) const override {
    const json::Value* out = FindOutput(name);
    if (!out) return Error("output '" + name + "' not found");
    shape->clear();
    for (const auto& d : out->At("shape").AsArray())
      shape->push_back(d.AsInt());
    return Error::Success();
  }

  Error Datatype(const std::string& name,
                 std::string* datatype) const override {
    const json::Value* out = FindOutput(name);
    if (!out) return Error("output '" + name + "' not found");
    *datatype = out->At("datatype").AsString();
    return Error::Success();
  }

  Error RawData(const std::string& name, const uint8_t** buf,
                size_t* byte_size) const override {
    auto bit = binary_.find(name);
    if (bit != binary_.end()) {
      *buf = body_.data() + bit->second.first;
      *byte_size = bit->second.second;
      return Error::Success();
    }
    const json::Value* out = FindOutput(name);
    if (!out) return Error("output '" + name + "' not found");
    // JSON data path: convert (and cache) to a raw LE buffer
    auto cit = converted_.find(name);
    if (cit == converted_.end()) {
      std::vector<uint8_t> raw;
      Error err = JsonDataToRaw(out->At("data").AsArray(),
                                out->At("datatype").AsString(), &raw);
      if (!err.IsOk()) return err;
      cit = converted_.emplace(name, std::move(raw)).first;
    }
    *buf = cit->second.data();
    *byte_size = cit->second.size();
    return Error::Success();
  }

  Error StringData(const std::string& name,
                   std::vector<std::string>* out) const override {
    std::string dt;
    Error err = Datatype(name, &dt);
    if (!err.IsOk()) return err;
    if (dt != "BYTES") return Error("output '" + name + "' is not BYTES");
    const uint8_t* buf;
    size_t size;
    err = RawData(name, &buf, &size);
    if (!err.IsOk()) return err;
    out->clear();
    size_t off = 0;
    while (off + 4 <= size) {
      uint32_t len;
      std::memcpy(&len, buf + off, 4);
      off += 4;
      if (off + len > size) return Error("malformed BYTES payload");
      out->emplace_back(reinterpret_cast<const char*>(buf + off), len);
      off += len;
    }
    return Error::Success();
  }

  std::string DebugString() const override { return header_.Dump(); }

 private:
  const json::Value* FindOutput(const std::string& name) const {
    if (!header_.Has("outputs")) return nullptr;
    for (const auto& out : header_.At("outputs").AsArray()) {
      if (out.At("name").AsString() == name) return &out;
    }
    return nullptr;
  }

  json::Value header_;
  std::vector<uint8_t> body_;
  std::map<std::string, std::pair<size_t, size_t>> binary_;
  mutable std::map<std::string, std::vector<uint8_t>> converted_;
  Error status_;
};

// ---------------------------------------------------------------------
// InferenceServerHttpClient
// ---------------------------------------------------------------------

Error InferenceServerHttpClient::Create(
    std::unique_ptr<InferenceServerHttpClient>* client,
    const std::string& server_url, bool verbose, size_t async_workers,
    const HttpSslOptions& ssl_options) {
  client->reset(new InferenceServerHttpClient(server_url, verbose,
                                              async_workers, ssl_options));
  return Error::Success();
}

InferenceServerHttpClient::InferenceServerHttpClient(
    const std::string& url, bool verbose, size_t async_workers,
    const HttpSslOptions& ssl_options) {
  std::string hostport = url;
  const size_t scheme = hostport.find("://");
  if (scheme != std::string::npos) {
    if (hostport.compare(0, scheme, "https") == 0) {
      tls_.enabled = true;
      tls_.verify_peer = ssl_options.verify_peer;
      tls_.verify_host = ssl_options.verify_host;
      tls_.ca_cert_path = ssl_options.ca_info;
      tls_.cert_path = ssl_options.cert;
      tls_.key_path = ssl_options.key;
    }
    hostport = hostport.substr(scheme + 3);
  }
  const size_t slash = hostport.find('/');
  if (slash != std::string::npos) hostport = hostport.substr(0, slash);
  port_ = tls_.enabled ? 443 : 8000;
  if (!hostport.empty() && hostport[0] == '[') {
    // IPv6 literal: [addr] or [addr]:port
    const size_t close = hostport.find(']');
    host_ = hostport.substr(1, close == std::string::npos
                                   ? std::string::npos
                                   : close - 1);
    if (close != std::string::npos && close + 1 < hostport.size() &&
        hostport[close + 1] == ':')
      port_ = std::atoi(hostport.substr(close + 2).c_str());
  } else {
    const size_t colon = hostport.rfind(':');
    if (colon == std::string::npos || hostport.find(':') != colon) {
      host_ = hostport;  // no port, or bare IPv6 without brackets
    } else {
      host_ = hostport.substr(0, colon);
      port_ = std::atoi(hostport.substr(colon + 1).c_str());
    }
  }
  verbose_ = verbose;
  sync_conn_ = NewConnection();
  for (size_t i = 0; i < async_workers; ++i)
    workers_.emplace_back(&InferenceServerHttpClient::AsyncWorker, this);
}

InferenceServerHttpClient::~InferenceServerHttpClient() {
  {
    // must hold the mutex so a worker can't check the predicate and then
    // miss this notify (lost wakeup => join() hangs forever)
    std::lock_guard<std::mutex> lk(queue_mutex_);
    exiting_ = true;
  }
  queue_cv_.notify_all();
  for (auto& w : workers_)
    if (w.joinable()) w.join();
}

std::unique_ptr<HttpConnection> InferenceServerHttpClient::NewConnection()
    const {
  return std::unique_ptr<HttpConnection>(
      new HttpConnection(host_, port_, tls_));
}

Error InferenceServerHttpClient::Get(const std::string& path,
                                     json::Value* response, int* status) {
  std::lock_guard<std::mutex> lk(sync_mutex_);
  std::map<std::string, std::string> rheaders;
  std::vector<uint8_t> rbody;
  Error err = sync_conn_->Request("GET", path, default_headers_, {},
                                  status, &rheaders, &rbody);
  if (!err.IsOk()) return err;
  if (response != nullptr && !rbody.empty()) {
    try {
      *response = json::Parser(reinterpret_cast<const char*>(rbody.data()),
                               rbody.size())
                      .Parse();
    } catch (const std::exception& e) {
      return Error(std::string("bad JSON response: ") + e.what());
    }
  }
  return Error::Success();
}

Error InferenceServerHttpClient::Post(const std::string& path,
                                      const std::string& body,
                                      json::Value* response, int* status) {
  std::lock_guard<std::mutex> lk(sync_mutex_);
  std::map<std::string, std::string> rheaders;
  std::vector<uint8_t> rbody;
  std::vector<std::pair<const uint8_t*, size_t>> pieces;
  if (!body.empty())
    pieces.emplace_back(reinterpret_cast<const uint8_t*>(body.data()),
                        body.size());
  std::vector<std::pair<std::string, std::string>> post_headers = {
      {"Content-Type", "application/json"}};
  for (const auto& kv : default_headers_) post_headers.push_back(kv);
  Error err = sync_conn_->Request("POST", path, post_headers, pieces,
                                  status, &rheaders, &rbody);
  if (!err.IsOk()) return err;
  if (response != nullptr && !rbody.empty()) {
    try {
      *response = json::Parser(reinterpret_cast<const char*>(rbody.data()),
                               rbody.size())
                      .Parse();
    } catch (const std::exception& e) {
      return Error(std::string("bad JSON response: ") + e.what());
    }
  }
  return Error::Success();
}

namespace {
Error CheckStatus(int status, const json::Value& resp) {
  if (status == 200) return Error::Success();
  std::string msg = resp.Has("error") ? resp.At("error").AsString()
                                      : "HTTP status " + std::to_string(status);
  return Error(msg, status);
}
}  // namespace

Error InferenceServerHttpClient::IsServerLive(bool* live) {
  int status = 0;
  Error err = Get("/v2/health/live", nullptr, &status);
  *live = err.IsOk() && status == 200;
  return err;
}

Error InferenceServerHttpClient::IsServerReady(bool* ready) {
  int status = 0;
  Error err = Get("/v2/health/ready", nullptr, &status);
  *ready = err.IsOk() && status == 200;
  return err;
}

Error InferenceServerHttpClient::IsModelReady(
    bool* ready, const std::string& model_name,
    const std::string& model_version) {
  std::string path = "/v2/models/" + model_name;
  if (!model_version.empty()) path += "/versions/" + model_version;
  path += "/ready";
  int status = 0;
  Error err = Get(path, nullptr, &status);
  *ready = err.IsOk() && status == 200;
  return err;
}

Error InferenceServerHttpClient::ServerMetadata(json::Value* metadata) {
  int status = 0;
  Error err = Get("/v2", metadata, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, *metadata);
}

Error InferenceServerHttpClient::ModelMetadata(
    json::Value* metadata, const std::string& model_name,
    const std::string& model_version) {
  std::string path = "/v2/models/" + model_name;
  if (!model_version.empty()) path += "/versions/" + model_version;
  int status = 0;
  Error err = Get(path, metadata, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, *metadata);
}

Error InferenceServerHttpClient::ModelConfig(
    json::Value* config, const std::string& model_name,
    const std::string& model_version) {
  std::string path = "/v2/models/" + model_name;
  if (!model_version.empty()) path += "/versions/" + model_version;
  path += "/config";
  int status = 0;
  Error err = Get(path, config, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, *config);
}

Error InferenceServerHttpClient::ModelRepositoryIndex(json::Value* index) {
  int status = 0;
  Error err = Post("/v2/repository/index", "", index, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, *index);
}

Error InferenceServerHttpClient::LoadModel(const std::string& model_name,
                                           const std::string& config) {
  std::string body;
  if (!config.empty()) {
    json::Value req;
    json::Value params;
    params["config"] = json::Value(config);
    req["parameters"] = params;
    body = req.Dump();
  }
  json::Value resp;
  int status = 0;
  Error err =
      Post("/v2/repository/models/" + model_name + "/load", body, &resp,
           &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, resp);
}

Error InferenceServerHttpClient::UnloadModel(const std::string& model_name) {
  json::Value resp;
  int status = 0;
  Error err = Post("/v2/repository/models/" + model_name + "/unload", "",
                   &resp, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, resp);
}

Error InferenceServerHttpClient::ModelInferenceStatistics(
    json::Value* stats, const std::string& model_name,
    const std::string& model_version) {
  std::string path = "/v2/models";
  if (!model_name.empty()) {
    path += "/" + model_name;
    if (!model_version.empty()) path += "/versions/" + model_version;
  }
  path += "/stats";
  int status = 0;
  Error err = Get(path, stats, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, *stats);
}

Error InferenceServerHttpClient::SystemSharedMemoryStatus(
    json::Value* status_out) {
  int status = 0;
  Error err = Get("/v2/systemsharedmemory/status", status_out, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, *status_out);
}

Error InferenceServerHttpClient::RegisterSystemSharedMemory(
    const std::string& name, const std::string& key, size_t byte_size,
    size_t offset) {
  json::Value req;
  req["key"] = json::Value(key);
  req["offset"] = json::Value(static_cast<int64_t>(offset));
  req["byte_size"] = json::Value(static_cast<int64_t>(byte_size));
  json::Value resp;
  int status = 0;
  Error err = Post("/v2/systemsharedmemory/region/" + name + "/register",
                   req.Dump(), &resp, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, resp);
}

Error InferenceServerHttpClient::UnregisterSystemSharedMemory(
    const std::string& name) {
  const std::string path =
      name.empty() ? "/v2/systemsharedmemory/unregister"
                   : "/v2/systemsharedmemory/region/" + name + "/unregister";
  json::Value resp;
  int status = 0;
  Error err = Post(path, "", &resp, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, resp);
}

Error InferenceServerHttpClient::CudaSharedMemoryStatus(
    json::Value* status_out) {
  int status = 0;
  Error err = Get("/v2/cudasharedmemory/status", status_out, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, *status_out);
}

Error InferenceServerHttpClient::RegisterCudaSharedMemory(
    const std::string& name, const std::string& raw_handle,
    int device_id, size_t byte_size) {
  // the REST field wraps the raw handle in one more base64 layer (parity
  // with the cuda raw_handle {b64: ...} and the Python client's
  // b64encode(raw_handle) — the caller passes the handle token verbatim)
  json::Value handle;
  handle["b64"] = json::Value(
      Base64Encode(raw_handle.data(), raw_handle.size()));
  json::Value req;
  req["raw_handle"] = handle;
  req["device_id"] = json::Value(device_id);
  req["byte_size"] = json::Value(static_cast<int64_t>(byte_size));
  json::Value resp;
  int status = 0;
  Error err = Post("/v2/cudasharedmemory/region/" + name + "/register",
                   req.Dump(), &resp, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, resp);
}

Error InferenceServerHttpClient::UnregisterCudaSharedMemory(
    const std::string& name) {
  const std::string path =
      name.empty() ? "/v2/cudasharedmemory/unregister"
                   : "/v2/cudasharedmemory/region/" + name + "/unregister";
  json::Value resp;
  int status = 0;
  Error err = Post(path, "", &resp, &status);
  if (!err.IsOk()) return err;
  return CheckStatus(status, resp);
}

// ---- inference ----

Error InferenceServerHttpClient::GenerateRequestBody(
    std::vector<uint8_t>* request_body, size_t* header_length,
    const InferOptions& options, const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs) {
  json::Value req;
  if (!options.request_id.empty())
    req["id"] = json::Value(options.request_id);

  json::Value params;
  bool has_params = false;
  if (!options.sequence_id_str.empty()) {
    params["sequence_id"] = json::Value(options.sequence_id_str);
    has_params = true;
  } else if (options.sequence_id != 0) {
    params["sequence_id"] =
        json::Value(static_cast<int64_t>(options.sequence_id));
    has_params = true;
  }
  if (options.sequence_start) {
    params["sequence_start"] = json::Value(true);
    has_params = true;
  }
  if (options.sequence_end) {
    params["sequence_end"] = json::Value(true);
    has_params = true;
  }
  if (options.priority != 0) {
    params["priority"] = json::Value(static_cast<int64_t>(options.priority));
    has_params = true;
  }
  if (options.server_timeout_us != 0) {
    params["timeout"] =
        json::Value(static_cast<int64_t>(options.server_timeout_us));
    has_params = true;
  }
  if (has_params) req["parameters"] = params;

  json::Value jinputs;
  for (InferInput* input : inputs) {
    json::Value ji;
    ji["name"] = json::Value(input->Name());
    ji["datatype"] = json::Value(input->Datatype());
    json::Value shape;
    for (int64_t d : input->Shape())
      shape.Append(json::Value(d));
    ji["shape"] = shape;
    json::Value iparams;
    if (input->IsSharedMemory()) {
      iparams["shared_memory_region"] =
          json::Value(input->SharedMemoryName());
      iparams["shared_memory_byte_size"] =
          json::Value(static_cast<int64_t>(input->SharedMemoryByteSize()));
      if (input->SharedMemoryOffset() != 0)
        iparams["shared_memory_offset"] =
            json::Value(static_cast<int64_t>(input->SharedMemoryOffset()));
    } else {
      iparams["binary_data_size"] =
          json::Value(static_cast<int64_t>(input->ByteSize()));
    }
    ji["parameters"] = iparams;
    jinputs.Append(std::move(ji));
  }
  req["inputs"] = jinputs;

  if (!outputs.empty()) {
    json::Value joutputs;
    for (const InferRequestedOutput* output : outputs) {
      json::Value jo;
      jo["name"] = json::Value(output->Name());
      json::Value oparams;
      bool has = false;
      if (output->IsSharedMemory()) {
        oparams["shared_memory_region"] =
            json::Value(output->SharedMemoryName());
        oparams["shared_memory_byte_size"] =
            json::Value(static_cast<int64_t>(output->SharedMemoryByteSize()));
        if (output->SharedMemoryOffset() != 0)
          oparams["shared_memory_offset"] = json::Value(
              static_cast<int64_t>(output->SharedMemoryOffset()));
        has = true;
      } else {
        oparams["binary_data"] = json::Value(true);
        has = true;
      }
      if (output->ClassCount() > 0) {
        oparams["classification"] =
            json::Value(static_cast<int64_t>(output->ClassCount()));
        has = true;
      }
      if (has) jo["parameters"] = oparams;
      joutputs.Append(std::move(jo));
    }
    req["outputs"] = joutputs;
  }

  const std::string header = req.Dump();
  *header_length = header.size();
  request_body->assign(header.begin(), header.end());
  for (InferInput* input : inputs) {
    if (input->IsSharedMemory()) continue;
    input->PrepareForRequest();
    const uint8_t* buf;
    size_t size;
    while (input->GetNext(&buf, &size))
      request_body->insert(request_body->end(), buf, buf + size);
  }
  return Error::Success();
}

Error InferenceServerHttpClient::ParseResponseBody(InferResult** result,
                                                   const uint8_t* body,
                                                   size_t size,
                                                   size_t header_length) {
  return InferResultHttp::Create(
      result, std::vector<uint8_t>(body, body + size), header_length);
}

std::string InferenceServerHttpClient::InferPath(
    const InferOptions& options) {
  std::string path = "/v2/models/" + options.model_name;
  if (!options.model_version.empty())
    path += "/versions/" + options.model_version;
  return path + "/infer";
}

Error InferenceServerHttpClient::InferOnce(
    HttpConnection& conn, InferResult** result, const InferOptions& options,
    const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs,
    CompressionType request_compression,
    CompressionType response_compression) {
  RequestTimers timers;
  timers.Capture(RequestTimers::Kind::REQUEST_START);

  std::vector<uint8_t> body;
  size_t header_length = 0;
  Error err = GenerateRequestBody(&body, &header_length, options, inputs,
                                  outputs);
  if (!err.IsOk()) return err;
  return ExecutePrebuilt(conn, result, InferPath(options), body,
                         header_length, timers, request_compression,
                         response_compression, options.client_timeout_us);
}

Error InferenceServerHttpClient::ExecutePrebuilt(
    HttpConnection& conn, InferResult** result, const std::string& path,
    const std::vector<uint8_t>& body, size_t header_length,
    RequestTimers& timers, CompressionType request_compression,
    CompressionType response_compression, uint64_t timeout_us) {
  std::vector<std::pair<std::string, std::string>> headers = {
      {"Content-Type", "application/octet-stream"},
      {kInferHeaderLen, std::to_string(header_length)}};
  for (const auto& kv : default_headers_) headers.push_back(kv);

  // whole-body compression; the inference header length still refers to
  // the UNCOMPRESSED JSON prefix (the server decompresses first) —
  // same semantics as the reference's CompressInput
  std::vector<uint8_t> zbody;
  const std::vector<uint8_t>* wire_body = &body;
  if (request_compression != CompressionType::NONE) {
    Error zerr = ZCompress(body.data(), body.size(),
                           request_compression == CompressionType::GZIP,
                           &zbody);
    if (!zerr.IsOk()) return zerr;
    headers.emplace_back("Content-Encoding",
                         CompressionName(request_compression));
    wire_body = &zbody;
  }
  if (response_compression != CompressionType::NONE) {
    headers.emplace_back("Accept-Encoding",
                         CompressionName(response_compression));
  }

  int status = 0;
  std::map<std::string, std::string> rheaders;
  std::vector<uint8_t> rbody;
  Error err = conn.Request("POST", path, headers,
                           {{wire_body->data(), wire_body->size()}},
                           &status, &rheaders, &rbody, &timers,
                           timeout_us);
  if (!err.IsOk()) return err;

  auto enc_it = rheaders.find("content-encoding");
  if (enc_it != rheaders.end() &&
      (enc_it->second == "gzip" || enc_it->second == "deflate")) {
    std::vector<uint8_t> plain;
    err = ZDecompress(rbody.data(), rbody.size(), &plain);
    if (!err.IsOk()) return err;
    rbody = std::move(plain);
  }

  size_t rheader_len = std::string::npos;
  auto it = rheaders.find("inference-header-content-length");
  if (it != rheaders.end()) {
    errno = 0;
    char* endp = nullptr;
    unsigned long long v = strtoull(it->second.c_str(), &endp, 10);
    if (errno != 0 || endp == it->second.c_str() || *endp != '\0')
      return Error("malformed " + std::string(kInferHeaderLen) + ": " +
                   it->second);
    rheader_len = static_cast<size_t>(v);
  }
  err = InferResultHttp::Create(result, std::move(rbody), rheader_len);
  if (!err.IsOk()) {
    // a non-JSON body on a failed request must not mask the real status
    if (status != 200)
      return Error("HTTP status " + std::to_string(status), status);
    return err;
  }
  if (status != 200 && (*result)->RequestStatus().IsOk()) {
    delete *result;
    *result = nullptr;
    return Error("HTTP status " + std::to_string(status), status);
  }

  timers.Capture(RequestTimers::Kind::REQUEST_END);
  UpdateInferStat(timers);
  return Error::Success();
}

Error InferenceServerHttpClient::Infer(
    InferResult** result, const InferOptions& options,
    const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs,
    CompressionType request_compression,
    CompressionType response_compression) {
  std::lock_guard<std::mutex> lk(sync_mutex_);
  return InferOnce(*sync_conn_, result, options, inputs, outputs,
                   request_compression, response_compression);
}

Error InferenceServerHttpClient::AsyncInfer(
    OnCompleteFn callback, const InferOptions& options,
    const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs,
    CompressionType request_compression,
    CompressionType response_compression) {
  if (callback == nullptr)
    return Error("callback must not be null");
  // build the body here: InferInput cursor state is not thread-safe, so
  // the shared input objects must not be touched by worker threads
  AsyncJob job;
  job.callback = std::move(callback);
  job.path = InferPath(options);
  job.request_compression = request_compression;
  job.response_compression = response_compression;
  job.timeout_us = options.client_timeout_us;
  job.timers.Capture(RequestTimers::Kind::REQUEST_START);
  Error err = GenerateRequestBody(&job.body, &job.header_length, options,
                                  inputs, outputs);
  if (!err.IsOk()) return err;
  {
    std::lock_guard<std::mutex> lk(queue_mutex_);
    queue_.push_back(std::move(job));
  }
  queue_cv_.notify_one();
  return Error::Success();
}

void InferenceServerHttpClient::AsyncWorker() {
  HttpConnection conn(host_, port_, tls_);
  while (true) {
    AsyncJob job;
    {
      std::unique_lock<std::mutex> lk(queue_mutex_);
      queue_cv_.wait(lk, [this] { return exiting_ || !queue_.empty(); });
      if (exiting_ && queue_.empty()) return;
      job = std::move(queue_.front());
      queue_.pop_front();
    }
    InferResult* result = nullptr;
    Error err = ExecutePrebuilt(conn, &result, job.path, job.body,
                                job.header_length, job.timers,
                                job.request_compression,
                                job.response_compression, job.timeout_us);
    if (!err.IsOk()) {
      // surface transport errors through an error-only result
      std::string msg = "{\"error\":" + json::Value(err.Message()).Dump() +
                        "}";
      InferResultHttp::Create(
          &result, std::vector<uint8_t>(msg.begin(), msg.end()),
          std::string::npos);
    }
    job.callback(result);
  }
}

Error InferenceServerHttpClient::InferMulti(
    std::vector<InferResult*>* results,
    const std::vector<InferOptions>& options,
    const std::vector<std::vector<InferInput*>>& inputs,
    const std::vector<std::vector<const InferRequestedOutput*>>& outputs,
    CompressionType request_compression,
    CompressionType response_compression) {
  if (inputs.size() != options.size() && options.size() != 1)
    return Error("options count must be 1 or match inputs count");
  if (!outputs.empty() && outputs.size() != inputs.size() &&
      outputs.size() != 1)
    return Error("outputs count must be 0, 1, or match inputs count");
  results->clear();
  for (size_t i = 0; i < inputs.size(); ++i) {
    const InferOptions& opt = options.size() == 1 ? options[0] : options[i];
    std::vector<const InferRequestedOutput*> outs;
    if (!outputs.empty())
      outs = outputs.size() == 1 ? outputs[0] : outputs[i];
    InferResult* result = nullptr;
    Error err = Infer(&result, opt, inputs[i], outs, request_compression,
                      response_compression);
    if (!err.IsOk()) return err;
    results->push_back(result);
  }
  return Error::Success();
}

Error InferenceServerHttpClient::AsyncInferMulti(
    OnMultiCompleteFn callback, const std::vector<InferOptions>& options,
    const std::vector<std::vector<InferInput*>>& inputs,
    const std::vector<std::vector<const InferRequestedOutput*>>& outputs,
    CompressionType request_compression,
    CompressionType response_compression) {
  // Parity: ref http_client.h:549 AsyncInferMulti — the callback fires
  // once with ALL results (ownership transfers to the callback).
  if (callback == nullptr) return Error("callback must not be null");
  if (inputs.size() != options.size() && options.size() != 1)
    return Error("options count must be 1 or match inputs count");
  if (!outputs.empty() && outputs.size() != inputs.size() &&
      outputs.size() != 1)
    return Error("outputs count must be 0, 1, or match inputs count");
  const size_t n = inputs.size();
  if (n == 0) {
    // fire the completion contract immediately: the callback must run
    // exactly once even for an empty batch
    std::vector<InferResult*> empty;
    callback(&empty);
    return Error::Success();
  }
  struct MultiState {
    OnMultiCompleteFn callback;
    std::vector<InferResult*> results;
    std::atomic<size_t> remaining;
  };
  auto state = std::make_shared<MultiState>();
  state->callback = std::move(callback);
  state->results.assign(n, nullptr);
  state->remaining = n;
  for (size_t i = 0; i < n; ++i) {
    const InferOptions& opt = options.size() == 1 ? options[0] : options[i];
    std::vector<const InferRequestedOutput*> outs;
    if (!outputs.empty())
      outs = outputs.size() == 1 ? outputs[0] : outputs[i];
    Error err = AsyncInfer(
        [state, i](InferResult* result) {
          state->results[i] = result;
          if (state->remaining.fetch_sub(1) == 1) {
            state->callback(&state->results);
          }
        },
        opt, inputs[i], outs, request_compression, response_compression);
    if (!err.IsOk()) {
      // the failed request gets an error-only result and the REST of
      // the batch still issues — the same per-request error-delivery
      // semantics as the gRPC client's AsyncInferMulti, so both
      // protocols agree. The callback fires exactly once with n
      // NON-NULL entries.
      std::string msg = "{\"error\":" +
                        json::Value("request not issued: " +
                                    err.Message())
                            .Dump() +
                        "}";
      InferResult* r = nullptr;
      InferResultHttp::Create(
          &r, std::vector<uint8_t>(msg.begin(), msg.end()),
          std::string::npos);
      state->results[i] = r;
      if (state->remaining.fetch_sub(1) == 1) {
        state->callback(&state->results);
      }
    }
  }
  return Error::Success();
}

}  // namespace client_tpu_torch
