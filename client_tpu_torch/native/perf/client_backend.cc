// Backend seam implementations — see client_backend.h.

#include "client_backend.h"

#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>
#include <fstream>
#include <sstream>

#include "client_tpu_torch/http_client.h"

namespace client_tpu_torch {
namespace perf {

// tfs_backend.cc
Error CreateDirectBackend(std::unique_ptr<PerfBackend>* backend,
                          const std::string& url, bool verbose);
Error CreateTfsBackend(std::unique_ptr<PerfBackend>* backend,
                       const std::string& url, bool verbose,
                       const std::string& signature_name);

namespace {

// ------------------------------------------------------------- HTTP

class HttpPerfBackend : public PerfBackend {
 public:
  static Error Create(
      std::unique_ptr<PerfBackend>* backend, const std::string& url,
      bool verbose, const HttpSslOptions& ssl = HttpSslOptions(),
      const std::vector<std::pair<std::string, std::string>>& headers =
          {}) {
    auto b = std::unique_ptr<HttpPerfBackend>(new HttpPerfBackend());
    Error err = InferenceServerHttpClient::Create(&b->client_, url, verbose,
                                                  /*async_workers=*/8, ssl);
    if (!err.IsOk()) return err;
    if (!headers.empty()) b->client_->SetDefaultHeaders(headers);
    *backend = std::move(b);
    return Error::Success();
  }

  BackendKind Kind() const override { return BackendKind::HTTP; }

  Error ModelMetadata(json::Value* metadata, const std::string& name,
                      const std::string& version) override {
    return client_->ModelMetadata(metadata, name, version);
  }
  Error ModelConfig(json::Value* config, const std::string& name,
                    const std::string& version) override {
    return client_->ModelConfig(config, name, version);
  }
  Error ModelStatistics(json::Value* stats,
                        const std::string& name) override {
    return client_->ModelInferenceStatistics(stats, name);
  }

  Error Infer(InferResult** result, const InferOptions& options,
              const std::vector<InferInput*>& inputs,
              const std::vector<const InferRequestedOutput*>& outputs)
      override {
    return client_->Infer(result, options, inputs, outputs);
  }
  Error AsyncInfer(OnCompleteFn callback, const InferOptions& options,
                   const std::vector<InferInput*>& inputs,
                   const std::vector<const InferRequestedOutput*>& outputs)
      override {
    return client_->AsyncInfer(std::move(callback), options, inputs,
                               outputs);
  }

  Error RegisterSystemSharedMemory(const std::string& name,
                                   const std::string& key,
                                   size_t byte_size) override {
    return client_->RegisterSystemSharedMemory(name, key, byte_size);
  }
  Error RegisterCudaSharedMemory(const std::string& name,
                                 const std::string& raw_handle,
                                 int64_t device_id,
                                 size_t byte_size) override {
    return client_->RegisterCudaSharedMemory(name, raw_handle,
                                             static_cast<int>(device_id),
                                             byte_size);
  }
  Error UnregisterAllSharedMemory() override {
    Error e1 = client_->UnregisterSystemSharedMemory();
    Error e2 = client_->UnregisterCudaSharedMemory();
    return e1.IsOk() ? e2 : e1;
  }

 private:
  std::unique_ptr<InferenceServerHttpClient> client_;
};

// ------------------------------------------------------------- gRPC
#ifdef CLIENT_TPU_TORCH_PERF_GRPC

json::Value StatDuration(const inference::StatisticDuration& d) {
  json::Value v;
  v["count"] = json::Value(static_cast<int64_t>(d.count()));
  v["ns"] = json::Value(static_cast<int64_t>(d.ns()));
  return v;
}

class GrpcPerfBackend : public PerfBackend {
 public:
  static Error Create(
      std::unique_ptr<PerfBackend>* backend, const std::string& url,
      bool verbose, const SslOptions& ssl = SslOptions(),
      const std::string& compression = "",
      const std::vector<std::pair<std::string, std::string>>& headers =
          {}) {
    auto b = std::unique_ptr<GrpcPerfBackend>(new GrpcPerfBackend());
    Error err = InferenceServerGrpcClient::Create(
        &b->client_, url, verbose, KeepAliveOptions(), ssl, compression);
    if (!err.IsOk()) return err;
    if (!headers.empty()) b->client_->SetDefaultMetadata(headers);
    *backend = std::move(b);
    return Error::Success();
  }

  BackendKind Kind() const override { return BackendKind::GRPC; }

  Error ModelMetadata(json::Value* metadata, const std::string& name,
                      const std::string& version) override {
    inference::ModelMetadataResponse resp;
    Error err = client_->ModelMetadata(&resp, name, version);
    if (!err.IsOk()) return err;
    json::Value& v = *metadata;
    v["name"] = json::Value(resp.name());
    auto tensors = [](const auto& list) {
      json::Array arr;
      for (const auto& t : list) {
        json::Value tv;
        tv["name"] = json::Value(t.name());
        tv["datatype"] = json::Value(t.datatype());
        json::Array shape;
        for (int64_t d : t.shape()) shape.push_back(json::Value(d));
        tv["shape"] = json::Value(std::move(shape));
        arr.push_back(std::move(tv));
      }
      return arr;
    };
    v["inputs"] = json::Value(tensors(resp.inputs()));
    v["outputs"] = json::Value(tensors(resp.outputs()));
    return Error::Success();
  }

  Error ModelConfig(json::Value* config, const std::string& name,
                    const std::string& version) override {
    inference::ModelConfigResponse resp;
    Error err = client_->ModelConfig(&resp, name, version);
    if (!err.IsOk()) return err;
    const auto& c = resp.config();
    json::Value& v = *config;
    v["name"] = json::Value(c.name());
    v["max_batch_size"] =
        json::Value(static_cast<int64_t>(c.max_batch_size()));
    json::Value tx;
    tx["decoupled"] =
        json::Value(c.model_transaction_policy().decoupled());
    v["model_transaction_policy"] = std::move(tx);
    if (c.has_sequence_batching()) {
      v["sequence_batching"] = json::Value(json::Object{});
    }
    if (c.has_dynamic_batching()) {
      v["dynamic_batching"] = json::Value(json::Object{});
    }
    return Error::Success();
  }

  Error ModelStatistics(json::Value* stats,
                        const std::string& name) override {
    inference::ModelStatisticsResponse resp;
    Error err = client_->ModelInferenceStatistics(&resp, name);
    if (!err.IsOk()) return err;
    json::Array arr;
    for (const auto& m : resp.model_stats()) {
      json::Value mv;
      mv["name"] = json::Value(m.name());
      mv["version"] = json::Value(m.version());
      mv["inference_count"] =
          json::Value(static_cast<int64_t>(m.inference_count()));
      mv["execution_count"] =
          json::Value(static_cast<int64_t>(m.execution_count()));
      json::Value is;
      is["success"] = StatDuration(m.inference_stats().success());
      is["queue"] = StatDuration(m.inference_stats().queue());
      is["compute_input"] = StatDuration(m.inference_stats().compute_input());
      is["compute_infer"] = StatDuration(m.inference_stats().compute_infer());
      is["compute_output"] =
          StatDuration(m.inference_stats().compute_output());
      mv["inference_stats"] = std::move(is);
      arr.push_back(std::move(mv));
    }
    (*stats)["model_stats"] = json::Value(std::move(arr));
    return Error::Success();
  }

  Error Infer(InferResult** result, const InferOptions& options,
              const std::vector<InferInput*>& inputs,
              const std::vector<const InferRequestedOutput*>& outputs)
      override {
    return client_->Infer(result, options, inputs, outputs);
  }
  Error AsyncInfer(OnCompleteFn callback, const InferOptions& options,
                   const std::vector<InferInput*>& inputs,
                   const std::vector<const InferRequestedOutput*>& outputs)
      override {
    return client_->AsyncInfer(std::move(callback), options, inputs,
                               outputs);
  }
  Error StartStream(OnCompleteFn callback) override {
    return client_->StartStream(std::move(callback));
  }
  Error AsyncStreamInfer(const InferOptions& options,
                         const std::vector<InferInput*>& inputs,
                         const std::vector<const InferRequestedOutput*>&
                             outputs) override {
    return client_->AsyncStreamInfer(options, inputs, outputs);
  }
  Error StopStream() override { return client_->StopStream(); }

  Error RegisterSystemSharedMemory(const std::string& name,
                                   const std::string& key,
                                   size_t byte_size) override {
    return client_->RegisterSystemSharedMemory(name, key, byte_size);
  }
  Error RegisterCudaSharedMemory(const std::string& name,
                                 const std::string& raw_handle,
                                 int64_t device_id,
                                 size_t byte_size) override {
    return client_->RegisterCudaSharedMemory(name, raw_handle, device_id,
                                             byte_size);
  }
  Error UnregisterAllSharedMemory() override {
    Error e1 = client_->UnregisterSystemSharedMemory();
    Error e2 = client_->UnregisterCudaSharedMemory();
    return e1.IsOk() ? e2 : e1;
  }

 private:
  std::unique_ptr<InferenceServerGrpcClient> client_;
};

#endif  // CLIENT_TPU_TORCH_PERF_GRPC

// ------------------------------------------------------- TorchServe
// Parity: ref client_backend/torchserve/torchserve_http_client.cc —
// multipart POST of ONE file to /predictions/{model} (:148, field name
// "data" :325); Infer + client stats only, no metadata/shm/streaming.

class TorchServeResult : public InferResult {
 public:
  TorchServeResult(std::vector<uint8_t> body, Error status)
      : body_(std::move(body)), status_(std::move(status)) {}
  Error RequestStatus() const override { return status_; }
  Error Id(std::string* id) const override {
    id->clear();
    return Error::Success();
  }
  Error ModelName(std::string* name) const override {
    name->clear();
    return Error::Success();
  }
  Error ModelVersion(std::string* version) const override {
    version->clear();
    return Error::Success();
  }
  Error Shape(const std::string&, std::vector<int64_t>* shape)
      const override {
    shape->assign({static_cast<int64_t>(body_.size())});
    return Error::Success();
  }
  Error Datatype(const std::string&, std::string* datatype) const override {
    *datatype = "BYTES";
    return Error::Success();
  }
  Error RawData(const std::string&, const uint8_t** buf,
                size_t* byte_size) const override {
    *buf = body_.data();
    *byte_size = body_.size();
    return Error::Success();
  }
  Error StringData(const std::string&,
                   std::vector<std::string>* out) const override {
    out->assign(1, std::string(body_.begin(), body_.end()));
    return Error::Success();
  }
  std::string DebugString() const override {
    return std::string(body_.begin(), body_.end());
  }

 private:
  std::vector<uint8_t> body_;
  Error status_;
};

class TorchServePerfBackend : public PerfBackend {
 public:
  static Error Create(std::unique_ptr<PerfBackend>* backend,
                      const std::string& url, bool verbose) {
    auto b = std::unique_ptr<TorchServePerfBackend>(
        new TorchServePerfBackend());
    std::string hostport = url;
    auto scheme = hostport.find("://");
    if (scheme != std::string::npos) hostport = hostport.substr(scheme + 3);
    auto colon = hostport.rfind(':');
    b->host_ = colon == std::string::npos ? hostport
                                          : hostport.substr(0, colon);
    b->port_ = colon == std::string::npos
                   ? 8080
                   : atoi(hostport.substr(colon + 1).c_str());
    (void)verbose;
    *backend = std::move(b);
    return Error::Success();
  }

  BackendKind Kind() const override { return BackendKind::TORCHSERVE; }

  // TorchServe exposes no v2 metadata (parity: ref model_parser.cc:311);
  // ModelInfo::Parse synthesizes the single path-typed input instead.
  Error ModelMetadata(json::Value*, const std::string&,
                      const std::string&) override {
    return Error("torchserve exposes no model metadata");
  }
  Error ModelConfig(json::Value*, const std::string&,
                    const std::string&) override {
    return Error("torchserve exposes no model config");
  }
  Error ModelStatistics(json::Value*, const std::string&) override {
    return Error("torchserve exposes no statistics");
  }

  Error Infer(InferResult** result, const InferOptions& options,
              const std::vector<InferInput*>& inputs,
              const std::vector<const InferRequestedOutput*>&) override {
    if (inputs.empty())
      return Error("torchserve requires one BYTES input (a file path)");
    // the input holds a length-prefixed path string (BYTES framing)
    inputs[0]->PrepareForRequest();
    std::string framed;
    const uint8_t* chunk;
    size_t chunk_size;
    while (inputs[0]->GetNext(&chunk, &chunk_size))
      framed.append(reinterpret_cast<const char*>(chunk), chunk_size);
    if (framed.size() < 4)
      return Error("torchserve input holds no path");
    uint32_t len;
    std::memcpy(&len, framed.data(), 4);
    if (framed.size() < 4 + len)
      return Error("torchserve input path framing is short");
    std::string path = framed.substr(4, len);

    std::ifstream f(path, std::ios::binary);
    if (!f.good())
      return Error("torchserve backend cannot read file: " + path);
    std::string payload((std::istreambuf_iterator<char>(f)),
                        std::istreambuf_iterator<char>());

    const std::string boundary = "tpuperf1234567890boundary";
    std::string body = "--" + boundary + "\r\n" +
        "Content-Disposition: form-data; name=\"data\"; "
        "filename=\"input\"\r\n"
        "Content-Type: application/octet-stream\r\n\r\n" + payload +
        "\r\n--" + boundary + "--\r\n";
    std::ostringstream req;
    req << "POST /predictions/" << options.model_name << " HTTP/1.1\r\n"
        << "Host: " << host_ << ':' << port_ << "\r\n"
        << "Connection: close\r\n"
        << "Content-Type: multipart/form-data; boundary=" << boundary
        << "\r\n"
        << "Content-Length: " << body.size() << "\r\n\r\n"
        << body;

    std::string response;
    Error err = RoundTrip(req.str(), &response);
    if (!err.IsOk()) return err;
    auto hdr_end = response.find("\r\n\r\n");
    if (hdr_end == std::string::npos || response.size() < 12)
      return Error("malformed torchserve response");
    int status = atoi(response.substr(9, 3).c_str());
    std::string rbody = response.substr(hdr_end + 4);
    Error result_status =
        status == 200
            ? Error::Success()
            : Error("torchserve status " + std::to_string(status), status);
    *result = new TorchServeResult(
        std::vector<uint8_t>(rbody.begin(), rbody.end()), result_status);
    return result_status;
  }

  Error RegisterSystemSharedMemory(const std::string&, const std::string&,
                                   size_t) override {
    return Error("shared memory not supported by torchserve backend");
  }
  Error RegisterCudaSharedMemory(const std::string&, const std::string&,
                                 int64_t, size_t) override {
    return Error("shared memory not supported by torchserve backend");
  }
  Error UnregisterAllSharedMemory() override { return Error::Success(); }

 private:
  Error RoundTrip(const std::string& request, std::string* response) {
    struct addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    if (getaddrinfo(host_.c_str(), std::to_string(port_).c_str(), &hints,
                    &res) != 0)
      return Error("cannot resolve " + host_);
    int fd = -1;
    for (auto* ai = res; ai != nullptr; ai = ai->ai_next) {
      fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd < 0) continue;
      if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
      close(fd);
      fd = -1;
    }
    freeaddrinfo(res);
    if (fd < 0) return Error("cannot connect to torchserve");
    size_t off = 0;
    while (off < request.size()) {
      ssize_t n = send(fd, request.data() + off, request.size() - off,
                       MSG_NOSIGNAL);
      if (n <= 0) {
        close(fd);
        return Error("torchserve write failed");
      }
      off += static_cast<size_t>(n);
    }
    char buf[65536];
    ssize_t n;
    response->clear();
    while ((n = recv(fd, buf, sizeof(buf), 0)) > 0)
      response->append(buf, static_cast<size_t>(n));
    close(fd);
    return Error::Success();
  }

  std::string host_;
  int port_ = 8080;
};

}  // namespace

Error BackendFactory::Create(std::unique_ptr<PerfBackend>* backend) const {
  if (kind == BackendKind::HTTP) {
    return HttpPerfBackend::Create(backend, url, verbose, http_ssl,
                                   headers);
  }
  if (kind == BackendKind::TORCHSERVE) {
    return TorchServePerfBackend::Create(backend, url, verbose);
  }
  if (kind == BackendKind::DIRECT) {
    return CreateDirectBackend(backend, url, verbose);
  }
#ifdef CLIENT_TPU_TORCH_PERF_GRPC
  if (kind == BackendKind::TFSERVE) {
    return CreateTfsBackend(backend, url, verbose, signature_name);
  }
  return GrpcPerfBackend::Create(backend, url, verbose, grpc_ssl,
                                 grpc_compression, headers);
#else
  return Error(
      "this perf_analyzer was built without protobuf (protoc, its headers "
      "and libprotobuf): the grpc and tfserve kinds are not available");
#endif
}

}  // namespace perf
}  // namespace client_tpu_torch
