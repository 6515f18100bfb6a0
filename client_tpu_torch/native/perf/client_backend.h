// Service-agnostic client backend seam for the native perf analyzer.
//
// Parity: ref:src/c++/perf_analyzer/client_backend/client_backend.h:70-536
// (ClientBackend/ClientBackendFactory virtual interface with
// backend-kind dispatch; unsupported verbs return "not supported by this
// backend"). Backends: HTTP (native POSIX HTTP/1.1 client) and GRPC
// (native HTTP/2+HPACK gRPC client). The load managers and profiler
// consume only this interface.

#pragma once

#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "client_tpu_torch/common.h"
#ifdef CLIENT_TPU_TORCH_PERF_GRPC
#include "client_tpu_torch/grpc_client.h"
#endif
#include "client_tpu_torch/http_client.h"
#include "client_tpu_torch/json.h"

namespace client_tpu_torch {

#ifndef CLIENT_TPU_TORCH_PERF_GRPC
// Built without protobuf (no protoc, headers or libprotobuf): the gRPC
// and TF-Serving kinds are refused at backend creation, and their
// --ssl-grpc-* flags parse into this copy of grpc_client.h's SslOptions.
struct SslOptions {
  bool use_ssl = false;
  std::string root_certificates;
  std::string private_key;
  std::string certificate_chain;
  bool verify_peer = true;
  bool verify_host = true;
};
#endif
namespace perf {

// TORCHSERVE: foreign-protocol backend (parity: ref client_backend.h:104
// BackendKind::TORCHSERVE + torchserve/torchserve_http_client.cc) —
// multipart file upload to /predictions/{model}, Infer only.
// TFSERVE / TORCHSERVE: foreign-protocol backends (parity: ref
// client_backend.h:101-106 BackendKind {TENSORFLOW_SERVING, TORCHSERVE})
// DIRECT: no-RPC in-process backend over a dlopen'd model library
// (parity: ref client_backend.h:100 BackendKind::TRITON_C_API +
// client_backend/triton_c_api/)
enum class BackendKind { HTTP, GRPC, TFSERVE, TORCHSERVE, DIRECT };

class PerfBackend {
 public:
  using OnCompleteFn = std::function<void(InferResult*)>;

  virtual ~PerfBackend() = default;
  virtual BackendKind Kind() const = 0;

  // control plane (JSON shape shared with the HTTP wire format; the gRPC
  // backend converts its protos)
  virtual Error ModelMetadata(json::Value* metadata, const std::string& name,
                              const std::string& version) = 0;
  virtual Error ModelConfig(json::Value* config, const std::string& name,
                            const std::string& version) = 0;
  virtual Error ModelStatistics(json::Value* stats,
                                const std::string& name) = 0;

  // data plane
  virtual Error Infer(InferResult** result, const InferOptions& options,
                      const std::vector<InferInput*>& inputs,
                      const std::vector<const InferRequestedOutput*>&
                          outputs) = 0;
  virtual Error AsyncInfer(OnCompleteFn callback,
                           const InferOptions& options,
                           const std::vector<InferInput*>& inputs,
                           const std::vector<const InferRequestedOutput*>&
                               outputs) {
    return Error("async infer not supported by this backend");
  }
  virtual Error StartStream(OnCompleteFn callback) {
    return Error("streaming not supported by this backend");
  }
  virtual Error AsyncStreamInfer(const InferOptions& options,
                                 const std::vector<InferInput*>& inputs,
                                 const std::vector<
                                     const InferRequestedOutput*>& outputs) {
    return Error("streaming not supported by this backend");
  }
  virtual Error StopStream() { return Error::Success(); }

  // shared-memory verbs
  virtual Error RegisterSystemSharedMemory(const std::string& name,
                                           const std::string& key,
                                           size_t byte_size) = 0;
  virtual Error RegisterCudaSharedMemory(const std::string& name,
                                         const std::string& raw_handle,
                                         int64_t device_id,
                                         size_t byte_size) = 0;
  virtual Error UnregisterAllSharedMemory() = 0;
};

// Parity: ref client_backend.cc:60-110 Create dispatch (incl. the SSL
// and compression options ref client_backend.h:140-194 carries).
struct BackendFactory {
  BackendKind kind = BackendKind::HTTP;
  std::string url = "localhost:8000";
  bool verbose = false;
  std::string signature_name = "serving_default";  // tfserve only
  // --ssl-https-* flag group (PEM paths; parity ref HttpSslOptions)
  HttpSslOptions http_ssl;
  // --ssl-grpc-* flag group (parity ref SslOptions)
  SslOptions grpc_ssl;
  // --grpc-compression-algorithm: "" | identity | gzip | deflate
  std::string grpc_compression;
  // -H NAME:VALUE pairs: HTTP request headers / gRPC metadata
  std::vector<std::pair<std::string, std::string>> headers;

  Error Create(std::unique_ptr<PerfBackend>* backend) const;
};

}  // namespace perf
}  // namespace client_tpu_torch
