// Native HTTP/REST client for the v2 inference protocol.
// API parity role: ref:src/c++/library/http_client.h:106-605
// (InferenceServerHttpClient) — re-designed: self-contained POSIX-socket
// HTTP/1.1 transport with keep-alive instead of libcurl, an async worker
// pool instead of the curl-multi thread, runtime-loaded libssl for TLS
// instead of a build-time OpenSSL dependency; the cuda-shm verbs take
// cuda_shm_handle_v1 tokens (cuda_shm.h) instead of cudaIpc handles.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "client_tpu_torch/common.h"
#include "client_tpu_torch/json.h"
#include "client_tpu_torch/tls_stream.h"

namespace client_tpu_torch {

class HttpConnection;  // socket + HTTP/1.1 framing (internal)

// Parity: ref http_client.h:46-104 HttpSslOptions (PEM only; the
// CERTTYPE/KEYTYPE knobs collapse because libssl here loads PEM).
struct HttpSslOptions {
  bool verify_peer = true;
  bool verify_host = true;
  std::string ca_info;       // CA bundle path (CURLOPT_CAINFO analog)
  std::string cert;          // client certificate (PEM)
  std::string key;           // client private key (PEM)
};

// Parity: ref http_client.h:108 CompressionType.
enum class CompressionType { NONE, DEFLATE, GZIP };

class InferenceServerHttpClient : public InferenceServerClient {
 public:
  using OnCompleteFn = std::function<void(InferResult*)>;
  using OnMultiCompleteFn =
      std::function<void(std::vector<InferResult*>*)>;

  // TLS turns on when the url scheme is https:// or ssl_options.use_ssl
  // would in the reference — here simply when the scheme says so.
  static Error Create(std::unique_ptr<InferenceServerHttpClient>* client,
                      const std::string& server_url, bool verbose = false,
                      size_t async_workers = 4,
                      const HttpSslOptions& ssl_options = HttpSslOptions());
  ~InferenceServerHttpClient() override;

  // health / metadata / control (parity: ref http_client.h:164-397)
  Error IsServerLive(bool* live);
  Error IsServerReady(bool* ready);
  Error IsModelReady(bool* ready, const std::string& model_name,
                     const std::string& model_version = "");
  Error ServerMetadata(json::Value* metadata);
  Error ModelMetadata(json::Value* metadata, const std::string& model_name,
                      const std::string& model_version = "");
  Error ModelConfig(json::Value* config, const std::string& model_name,
                    const std::string& model_version = "");
  Error ModelRepositoryIndex(json::Value* index);
  Error LoadModel(const std::string& model_name,
                  const std::string& config = "");
  Error UnloadModel(const std::string& model_name);
  Error ModelInferenceStatistics(json::Value* stats,
                                 const std::string& model_name = "",
                                 const std::string& model_version = "");

  // shared memory verbs (system + cuda; parity: ref :345-397)
  Error SystemSharedMemoryStatus(json::Value* status);
  Error RegisterSystemSharedMemory(const std::string& name,
                                   const std::string& key, size_t byte_size,
                                   size_t offset = 0);
  Error UnregisterSystemSharedMemory(const std::string& name = "");
  Error CudaSharedMemoryStatus(json::Value* status);
  Error RegisterCudaSharedMemory(const std::string& name,
                                 const std::string& raw_handle,
                                 int device_id, size_t byte_size);
  Error UnregisterCudaSharedMemory(const std::string& name = "");

  // inference (parity: ref :420-598 incl. request/response compression)
  Error Infer(InferResult** result, const InferOptions& options,
              const std::vector<InferInput*>& inputs,
              const std::vector<const InferRequestedOutput*>& outputs = {},
              CompressionType request_compression = CompressionType::NONE,
              CompressionType response_compression = CompressionType::NONE);
  Error AsyncInfer(
      OnCompleteFn callback, const InferOptions& options,
      const std::vector<InferInput*>& inputs,
      const std::vector<const InferRequestedOutput*>& outputs = {},
      CompressionType request_compression = CompressionType::NONE,
      CompressionType response_compression = CompressionType::NONE);
  Error InferMulti(
      std::vector<InferResult*>* results,
      const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs =
          {},
      CompressionType request_compression = CompressionType::NONE,
      CompressionType response_compression = CompressionType::NONE);
  // Parity: ref http_client.h:549 — one callback with all results once
  // every request in the batch completes.
  Error AsyncInferMulti(
      OnMultiCompleteFn callback, const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs =
          {},
      CompressionType request_compression = CompressionType::NONE,
      CompressionType response_compression = CompressionType::NONE);

  // wire-format reuse (parity: ref http_client.h:122-138)
  static Error GenerateRequestBody(
      std::vector<uint8_t>* request_body, size_t* header_length,
      const InferOptions& options, const std::vector<InferInput*>& inputs,
      const std::vector<const InferRequestedOutput*>& outputs);
  static Error ParseResponseBody(InferResult** result,
                                 const uint8_t* body, size_t size,
                                 size_t header_length);

  // Extra headers attached to every request this client sends (the -H
  // surface; parity: ref http_client.h Headers parameter — here
  // client-scoped, which is how the perf analyzer uses it).
  void SetDefaultHeaders(
      const std::vector<std::pair<std::string, std::string>>& headers) {
    default_headers_ = headers;
  }

 private:
  InferenceServerHttpClient(const std::string& url, bool verbose,
                            size_t async_workers,
                            const HttpSslOptions& ssl_options);

  std::unique_ptr<HttpConnection> NewConnection() const;
  Error Get(const std::string& path, json::Value* response, int* status);
  Error Post(const std::string& path, const std::string& body,
             json::Value* response, int* status);
  Error InferOnce(HttpConnection& conn, InferResult** result,
                  const InferOptions& options,
                  const std::vector<InferInput*>& inputs,
                  const std::vector<const InferRequestedOutput*>& outputs,
                  CompressionType request_compression,
                  CompressionType response_compression);
  Error ExecutePrebuilt(HttpConnection& conn, InferResult** result,
                        const std::string& path,
                        const std::vector<uint8_t>& body,
                        size_t header_length, RequestTimers& timers,
                        CompressionType request_compression,
                        CompressionType response_compression,
                        uint64_t timeout_us = 0);
  static std::string InferPath(const InferOptions& options);
  void AsyncWorker();

  std::string host_;
  int port_;
  bool verbose_;
  TlsOptions tls_;

  std::unique_ptr<HttpConnection> sync_conn_;
  std::mutex sync_mutex_;
  std::vector<std::pair<std::string, std::string>> default_headers_;

  // the request body is built on the caller thread (InferInput cursor
  // state is not thread-safe); workers only transport prebuilt bytes
  struct AsyncJob {
    OnCompleteFn callback;
    std::string path;
    std::vector<uint8_t> body;
    size_t header_length = 0;
    RequestTimers timers;
    CompressionType request_compression = CompressionType::NONE;
    CompressionType response_compression = CompressionType::NONE;
    uint64_t timeout_us = 0;
  };
  std::deque<AsyncJob> queue_;
  std::mutex queue_mutex_;
  std::condition_variable queue_cv_;
  std::vector<std::thread> workers_;
  std::atomic<bool> exiting_{false};
};

}  // namespace client_tpu_torch
