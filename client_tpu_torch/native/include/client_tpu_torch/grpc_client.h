// Native gRPC client for the v2 (KServe) inference protocol.
//
// API parity: ref:src/c++/library/grpc_client.h:99-494
// (InferenceServerGrpcClient: control plane with typed protobuf
// responses, Infer/AsyncInfer/InferMulti/AsyncInferMulti, bidi streaming
// StartStream/AsyncStreamInfer/StopStream, KeepAliveOptions, process-wide
// channel sharing). Transport: this repo's own dependency-free HTTP/2 +
// HPACK (client_tpu_torch/http2.h) speaking gRPC framing — the reference
// links grpc++; this stack is self-contained, matching the POSIX-socket
// HTTP/1.1 client's design. The messages (kserve.pb.h) are generated at
// build time from client_tpu_torch/protocol/kserve.proto.
//
// Thread-safety: control-plane and Infer are thread-safe (each call owns
// its stream). AsyncStreamInfer writes are serialized internally; as in
// the reference, responses arrive on the stream callback thread.

#pragma once

#include <atomic>
#include <condition_variable>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "client_tpu_torch/common.h"
#include "client_tpu_torch/http2.h"
#include "kserve.pb.h"

namespace client_tpu_torch {

// Parity: ref grpc_client.h:61 KeepAliveOptions.
struct KeepAliveOptions {
  int64_t keepalive_time_ms = INT32_MAX;
  int64_t keepalive_timeout_ms = 20000;
  bool keepalive_permit_without_calls = false;
};

class InferResultGrpc : public InferResult {
 public:
  static Error Create(InferResult** result,
                      std::shared_ptr<inference::ModelInferResponse> resp,
                      Error status);
  Error RequestStatus() const override { return status_; }
  Error Id(std::string* id) const override;
  Error ModelName(std::string* name) const override;
  Error ModelVersion(std::string* version) const override;
  Error Shape(const std::string& output_name,
              std::vector<int64_t>* shape) const override;
  Error Datatype(const std::string& output_name,
                 std::string* datatype) const override;
  Error RawData(const std::string& output_name, const uint8_t** buf,
                size_t* byte_size) const override;
  Error StringData(const std::string& output_name,
                   std::vector<std::string>* string_result) const override;
  std::string DebugString() const override;

  const inference::ModelInferResponse& Response() const { return *resp_; }

 private:
  InferResultGrpc(std::shared_ptr<inference::ModelInferResponse> resp,
                  Error status);
  const inference::ModelInferResponse::InferOutputTensor* Output(
      const std::string& name, int* index) const;

  std::shared_ptr<inference::ModelInferResponse> resp_;
  Error status_;
};

// Parity: ref grpc_client.h:42 SslOptions (PEM file paths; grpc++'s
// in-memory strings become paths here because libssl loads files).
struct SslOptions {
  bool use_ssl = false;
  std::string root_certificates;   // CA bundle path (PEM)
  std::string private_key;         // client key path (PEM)
  std::string certificate_chain;   // client cert path (PEM)
  bool verify_peer = true;
  bool verify_host = true;
};

class InferenceServerGrpcClient : public InferenceServerClient {
 public:
  using OnCompleteFn = std::function<void(InferResult*)>;
  using OnMultiCompleteFn =
      std::function<void(std::vector<InferResult*>)>;

  // Channel sharing parity (ref grpc_client.cc:81-140): clients with the
  // same url share one HTTP/2 connection, at most
  // CLIENT_TPU_TORCH_GRPC_CHANNEL_MAX_SHARE_COUNT (default 6) per
  // connection.
  // TLS channels (parity: ref grpc_client.h:42 SslOptions via
  // use_ssl+PEM paths) share only with clients using the same options.
  // compression_algorithm: "" | "identity" (no compression) | "gzip" |
  // "deflate" — per-message gRPC compression (grpc-encoding header +
  // message flag byte), the transport-level analog of the reference's
  // --grpc-compression-algorithm channel option. Compressed responses
  // (flag byte set) are decompressed regardless of this setting.
  static Error Create(std::unique_ptr<InferenceServerGrpcClient>* client,
                      const std::string& server_url, bool verbose = false,
                      const KeepAliveOptions& keepalive = {},
                      const SslOptions& ssl = {},
                      const std::string& compression_algorithm = "");
  ~InferenceServerGrpcClient() override;

  // Metadata pairs attached to every call (the -H surface; gRPC
  // equivalent of the HTTP client's SetDefaultHeaders).
  void SetDefaultMetadata(
      const std::vector<std::pair<std::string, std::string>>& md) {
    default_metadata_ = md;
  }

  // ---- health / metadata ----
  Error IsServerLive(bool* live);
  Error IsServerReady(bool* ready);
  Error IsModelReady(bool* ready, const std::string& model_name,
                     const std::string& model_version = "");
  Error ServerMetadata(inference::ServerMetadataResponse* resp);
  Error ModelMetadata(inference::ModelMetadataResponse* resp,
                      const std::string& name,
                      const std::string& version = "");
  Error ModelConfig(inference::ModelConfigResponse* resp,
                    const std::string& name,
                    const std::string& version = "");

  // ---- repository ----
  Error ModelRepositoryIndex(inference::RepositoryIndexResponse* resp);
  Error LoadModel(const std::string& model_name,
                  const std::string& config_json = "");
  Error UnloadModel(const std::string& model_name,
                    bool unload_dependents = false);

  // ---- statistics / trace ----
  Error ModelInferenceStatistics(inference::ModelStatisticsResponse* resp,
                                 const std::string& name = "",
                                 const std::string& version = "");
  Error UpdateTraceSettings(
      inference::TraceSettingResponse* resp,
      const std::string& model_name = "",
      const std::map<std::string, std::vector<std::string>>& settings = {});
  Error GetTraceSettings(inference::TraceSettingResponse* resp,
                         const std::string& model_name = "");

  // ---- shared memory ----
  Error SystemSharedMemoryStatus(
      inference::SystemSharedMemoryStatusResponse* resp,
      const std::string& name = "");
  Error RegisterSystemSharedMemory(const std::string& name,
                                   const std::string& key, size_t byte_size,
                                   size_t offset = 0);
  Error UnregisterSystemSharedMemory(const std::string& name = "");
  Error CudaSharedMemoryStatus(
      inference::CudaSharedMemoryStatusResponse* resp,
      const std::string& name = "");
  // raw_handle: CudaShmGetRawHandle's token (parity: ref
  // grpc_client.h:302 RegisterCudaSharedMemory).
  Error RegisterCudaSharedMemory(const std::string& name,
                                 const std::string& raw_handle,
                                 int64_t device_id, size_t byte_size);
  Error UnregisterCudaSharedMemory(const std::string& name = "");

  // ---- inference ----
  Error Infer(InferResult** result, const InferOptions& options,
              const std::vector<InferInput*>& inputs,
              const std::vector<const InferRequestedOutput*>& outputs = {});
  Error AsyncInfer(
      OnCompleteFn callback, const InferOptions& options,
      const std::vector<InferInput*>& inputs,
      const std::vector<const InferRequestedOutput*>& outputs = {});
  Error InferMulti(
      std::vector<InferResult*>* results,
      const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs =
          {});
  Error AsyncInferMulti(
      OnMultiCompleteFn callback, const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs =
          {});

  // ---- bidi streaming (parity: ref grpc_client.h:439-461) ----
  Error StartStream(OnCompleteFn callback, bool enable_stats = true,
                    uint64_t stream_timeout_us = 0);
  Error AsyncStreamInfer(
      const InferOptions& options, const std::vector<InferInput*>& inputs,
      const std::vector<const InferRequestedOutput*>& outputs = {});
  Error StopStream();

 private:
  explicit InferenceServerGrpcClient(bool verbose);

  Error Call(const std::string& method,
             const google::protobuf::Message& request,
             google::protobuf::Message* response, uint64_t timeout_us = 0);
  void BuildInferRequest(const InferOptions& options,
                         const std::vector<InferInput*>& inputs,
                         const std::vector<const InferRequestedOutput*>& outs,
                         inference::ModelInferRequest* req);
  http2::Headers RequestHeaders(const std::string& method,
                                uint64_t timeout_us) const;
  // serialize + (optionally) compress + length-prefix one message
  std::string Frame(const google::protobuf::Message& msg) const;
  // pop + (if flagged) decompress one message; ok=false when incomplete
  Error Unframe(std::string* buf, std::string* msg, bool* ok) const;

  std::shared_ptr<http2::Connection> conn_;
  bool verbose_ = false;
  std::string compression_;  // "gzip" | "deflate" | "" (none)
  std::vector<std::pair<std::string, std::string>> default_metadata_;

  // streaming state: callbacks capture this context (NOT the client), so
  // a timed-out StopStream / destruction can detach safely
  struct StreamCtx {
    std::mutex mu;
    OnCompleteFn callback;
    std::string buf;  // gRPC message reassembly
    std::condition_variable closed_cv;
    bool closed = false;
    InferenceServerClient* stats_sink = nullptr;
  };
  std::mutex stream_mu_;  // stream_id_/stream_ctx_ + write serialization
  int32_t stream_id_ = 0;
  std::shared_ptr<StreamCtx> stream_ctx_;

  // async-call lifetime: destructor drains before tearing down
  std::mutex async_mu_;
  std::condition_variable async_cv_;
  int async_inflight_ = 0;

  // keepalive
  std::thread keepalive_thread_;
  bool stop_keepalive_ = false;
  std::condition_variable keepalive_cv_;
  std::mutex keepalive_mu_;
};

}  // namespace client_tpu_torch
