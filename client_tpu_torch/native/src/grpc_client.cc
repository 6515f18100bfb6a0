// Native gRPC client — see grpc_client.h.

#include "client_tpu_torch/grpc_client.h"

#include "client_tpu_torch/grpc_framing.h"
#include "client_tpu_torch/zlib_utils.h"

#include <cstdlib>
#include <cstring>
#include <sstream>

namespace client_tpu_torch {

namespace {

constexpr char kServicePath[] = "/inference.GRPCInferenceService/";

// ---- gRPC message framing (1-byte flag + 4-byte BE length) ----

inline Error StatusFromTrailers(const http2::Headers& trailers) {
  return grpc_framing::StatusFromTrailers(trailers);
}

// ---- process-wide channel (connection) sharing ----
// Parity: ref grpc_client.cc:81-140 (<=N stubs per channel, env override).

struct ChannelSlot {
  std::shared_ptr<http2::Connection> conn;
  int use_count = 0;
};
std::mutex g_channel_mu;
std::map<std::string, std::vector<ChannelSlot>> g_channels;

int MaxShareCount() {
  const char* env =
      std::getenv("CLIENT_TPU_TORCH_GRPC_CHANNEL_MAX_SHARE_COUNT");
  if (env != nullptr) {
    int v = atoi(env);
    if (v > 0) return v;
  }
  return 6;
}

std::shared_ptr<http2::Connection> AcquireChannel(const std::string& url,
                                                  const SslOptions& ssl,
                                                  std::string* error) {
  std::lock_guard<std::mutex> lock(g_channel_mu);
  // TLS channels must not be shared with cleartext clients (and vice
  // versa): key the cache on the security mode + cert paths
  std::string key = url;
  if (ssl.use_ssl) {
    key += "|tls|" + ssl.root_certificates + "|" + ssl.certificate_chain +
           "|" + ssl.private_key + "|" + (ssl.verify_peer ? "v" : "n") +
           (ssl.verify_host ? "h" : "n");
  }
  auto& slots = g_channels[key];
  int max_share = MaxShareCount();
  for (auto& slot : slots) {
    if (slot.conn && slot.conn->healthy() && slot.use_count < max_share) {
      slot.use_count++;
      return slot.conn;
    }
  }
  std::unique_ptr<http2::Connection> conn;
  if (ssl.use_ssl) {
    TlsOptions tls;
    tls.enabled = true;
    tls.verify_peer = ssl.verify_peer;
    tls.verify_host = ssl.verify_host;
    tls.ca_cert_path = ssl.root_certificates;
    tls.cert_path = ssl.certificate_chain;
    tls.key_path = ssl.private_key;
    conn = http2::Connection::Connect(url, tls, error);
  } else {
    conn = http2::Connection::Connect(url, error);
  }
  if (!conn) return nullptr;
  std::shared_ptr<http2::Connection> shared(conn.release());
  slots.push_back(ChannelSlot{shared, 1});
  // drop dead connections
  for (auto it = slots.begin(); it != slots.end();) {
    if (!it->conn->healthy() && it->conn.use_count() == 1) {
      it = slots.erase(it);
    } else {
      ++it;
    }
  }
  return shared;
}

void ReleaseChannel(const std::string& url,
                    const std::shared_ptr<http2::Connection>& conn) {
  std::lock_guard<std::mutex> lock(g_channel_mu);
  // TLS channels live under a decorated key ("url|tls|..."), so match on
  // the connection identity across every bucket for this url prefix
  for (auto& entry : g_channels) {
    if (entry.first.compare(0, url.size(), url) != 0) continue;
    for (auto& slot : entry.second) {
      if (slot.conn == conn && slot.use_count > 0) {
        slot.use_count--;
        return;
      }
    }
  }
}

void SetParam(google::protobuf::Map<std::string, inference::InferParameter>*
                  params,
              const std::string& key, int64_t v) {
  (*params)[key].set_int64_param(v);
}
void SetParam(google::protobuf::Map<std::string, inference::InferParameter>*
                  params,
              const std::string& key, bool v) {
  (*params)[key].set_bool_param(v);
}
void SetParam(google::protobuf::Map<std::string, inference::InferParameter>*
                  params,
              const std::string& key, const std::string& v) {
  (*params)[key].set_string_param(v);
}

}  // namespace

// --------------------------------------------------------- InferResultGrpc

InferResultGrpc::InferResultGrpc(
    std::shared_ptr<inference::ModelInferResponse> resp, Error status)
    : resp_(std::move(resp)), status_(std::move(status)) {}

Error InferResultGrpc::Create(
    InferResult** result, std::shared_ptr<inference::ModelInferResponse> resp,
    Error status) {
  *result = new InferResultGrpc(std::move(resp), std::move(status));
  return Error::Success();
}

Error InferResultGrpc::Id(std::string* id) const {
  *id = resp_->id();
  return Error::Success();
}
Error InferResultGrpc::ModelName(std::string* name) const {
  *name = resp_->model_name();
  return Error::Success();
}
Error InferResultGrpc::ModelVersion(std::string* version) const {
  *version = resp_->model_version();
  return Error::Success();
}

const inference::ModelInferResponse::InferOutputTensor*
InferResultGrpc::Output(const std::string& name, int* index) const {
  for (int i = 0; i < resp_->outputs_size(); ++i) {
    if (resp_->outputs(i).name() == name) {
      if (index) *index = i;
      return &resp_->outputs(i);
    }
  }
  return nullptr;
}

Error InferResultGrpc::Shape(const std::string& output_name,
                             std::vector<int64_t>* shape) const {
  auto* out = Output(output_name, nullptr);
  if (!out) return Error("output '" + output_name + "' not found");
  shape->assign(out->shape().begin(), out->shape().end());
  return Error::Success();
}

Error InferResultGrpc::Datatype(const std::string& output_name,
                                std::string* datatype) const {
  auto* out = Output(output_name, nullptr);
  if (!out) return Error("output '" + output_name + "' not found");
  *datatype = out->datatype();
  return Error::Success();
}

Error InferResultGrpc::RawData(const std::string& output_name,
                               const uint8_t** buf, size_t* byte_size) const {
  int idx = -1;
  auto* out = Output(output_name, &idx);
  if (!out) return Error("output '" + output_name + "' not found");
  if (idx < resp_->raw_output_contents_size()) {
    const std::string& raw = resp_->raw_output_contents(idx);
    *buf = reinterpret_cast<const uint8_t*>(raw.data());
    *byte_size = raw.size();
    return Error::Success();
  }
  return Error("output '" + output_name + "' has no raw data");
}

Error InferResultGrpc::StringData(
    const std::string& output_name,
    std::vector<std::string>* string_result) const {
  const uint8_t* buf = nullptr;
  size_t size = 0;
  Error err = RawData(output_name, &buf, &size);
  if (!err.IsOk()) return err;
  string_result->clear();
  size_t off = 0;
  while (off + 4 <= size) {
    uint32_t len;
    memcpy(&len, buf + off, 4);  // little-endian framing
    off += 4;
    if (off + len > size) return Error("malformed BYTES tensor");
    string_result->emplace_back(reinterpret_cast<const char*>(buf + off),
                                len);
    off += len;
  }
  return Error::Success();
}

std::string InferResultGrpc::DebugString() const {
  return resp_->ShortDebugString();
}

// ------------------------------------------------ InferenceServerGrpcClient

InferenceServerGrpcClient::InferenceServerGrpcClient(bool verbose)
    : verbose_(verbose) {}

Error InferenceServerGrpcClient::Create(
    std::unique_ptr<InferenceServerGrpcClient>* client,
    const std::string& server_url, bool verbose,
    const KeepAliveOptions& keepalive, const SslOptions& ssl,
    const std::string& compression_algorithm) {
  if (!compression_algorithm.empty() && compression_algorithm != "none" &&
      compression_algorithm != "identity" &&
      compression_algorithm != "gzip" &&
      compression_algorithm != "deflate") {
    return Error("unsupported compression algorithm '" +
                 compression_algorithm +
                 "' (expected identity, gzip or deflate)");
  }
  std::string error;
  auto conn = AcquireChannel(server_url, ssl, &error);
  if (!conn) return Error("unable to connect: " + error);
  client->reset(new InferenceServerGrpcClient(verbose));
  (*client)->conn_ = std::move(conn);
  if (compression_algorithm == "gzip" || compression_algorithm == "deflate")
    (*client)->compression_ = compression_algorithm;
  if (keepalive.keepalive_time_ms > 0 &&
      keepalive.keepalive_time_ms < INT32_MAX) {
    auto* c = client->get();
    int64_t period = keepalive.keepalive_time_ms;
    c->keepalive_thread_ = std::thread([c, period]() {
      std::unique_lock<std::mutex> lock(c->keepalive_mu_);
      while (!c->stop_keepalive_) {
        if (c->keepalive_cv_.wait_for(
                lock, std::chrono::milliseconds(period),
                [&] { return c->stop_keepalive_; })) {
          break;
        }
        if (c->conn_->healthy()) c->conn_->Ping();
      }
    });
  }
  return Error::Success();
}

InferenceServerGrpcClient::~InferenceServerGrpcClient() {
  StopStream();
  {
    // drain in-flight async calls (their callbacks touch this object)
    std::unique_lock<std::mutex> lock(async_mu_);
    async_cv_.wait_for(lock, std::chrono::seconds(30),
                       [&] { return async_inflight_ == 0; });
  }
  {
    std::lock_guard<std::mutex> lock(keepalive_mu_);
    stop_keepalive_ = true;
  }
  keepalive_cv_.notify_all();
  if (keepalive_thread_.joinable()) keepalive_thread_.join();
  if (conn_) ReleaseChannel(conn_->authority(), conn_);
}

http2::Headers InferenceServerGrpcClient::RequestHeaders(
    const std::string& method, uint64_t timeout_us) const {
  http2::Headers h = {
      {":method", "POST"},
      {":scheme", "http"},
      {":path", std::string(kServicePath) + method},
      {":authority", conn_->authority()},
      {"te", "trailers"},
      {"content-type", "application/grpc"},
      {"user-agent", "client-tpu-torch-native-grpc/0.1"},
  };
  if (timeout_us > 0) {
    // gRPC spec caps TimeoutValue at 8 ASCII digits; rescale to a coarser
    // unit when the microsecond count would overflow that (as grpc-core
    // does), instead of emitting a malformed header
    uint64_t v = timeout_us;
    char unit = 'u';
    if (v > 99999999) { v = (v + 999) / 1000; unit = 'm'; }       // -> ms
    if (v > 99999999) { v = (v + 999) / 1000; unit = 'S'; }       // -> s
    if (v > 99999999) { v = (v + 59) / 60; unit = 'M'; }          // -> min
    if (v > 99999999) { v = (v + 59) / 60; unit = 'H'; }          // -> hr
    if (v > 99999999) v = 99999999;
    h.emplace_back("grpc-timeout", std::to_string(v) + unit);
  }
  if (!compression_.empty()) {
    h.emplace_back("grpc-encoding", compression_);
    h.emplace_back("grpc-accept-encoding", "identity,deflate,gzip");
  }
  for (const auto& kv : default_metadata_) {
    // HTTP/2 header names are lowercase on the wire
    std::string name = kv.first;
    for (auto& c : name) c = static_cast<char>(tolower(c));
    h.emplace_back(std::move(name), kv.second);
  }
  return h;
}

std::string InferenceServerGrpcClient::Frame(
    const google::protobuf::Message& msg) const {
  std::string payload;
  msg.SerializeToString(&payload);
  if (!compression_.empty() && !payload.empty()) {
    std::vector<uint8_t> z;
    Error err = zlib_utils::ZCompress(
        reinterpret_cast<const uint8_t*>(payload.data()), payload.size(),
        compression_ == "gzip", &z);
    if (err.IsOk()) {
      return grpc_framing::FramePayload(
          std::string(reinterpret_cast<const char*>(z.data()), z.size()),
          /*compressed=*/true);
    }
    // compression failure falls through to an identity frame — legal on
    // a compressed stream (flag byte 0 = uncompressed message)
  }
  return grpc_framing::FramePayload(payload);
}

Error InferenceServerGrpcClient::Unframe(std::string* buf, std::string* msg,
                                         bool* ok) const {
  bool compressed = false;
  *ok = grpc_framing::PopMessage(buf, msg, &compressed);
  if (!*ok || !compressed) return Error::Success();
  // flag byte set: payload is encoded per the peer's grpc-encoding.
  // ZDecompress auto-detects the zlib vs gzip wrapper, covering both
  // registered zlib-family encodings.
  std::vector<uint8_t> plain;
  Error err = zlib_utils::ZDecompress(
      reinterpret_cast<const uint8_t*>(msg->data()), msg->size(), &plain);
  if (!err.IsOk()) return err;
  msg->assign(reinterpret_cast<const char*>(plain.data()), plain.size());
  return Error::Success();
}

Error InferenceServerGrpcClient::Call(
    const std::string& method, const google::protobuf::Message& request,
    google::protobuf::Message* response, uint64_t timeout_us) {
  struct CallState {
    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
    std::string buf;
    http2::Headers trailers;
    std::string transport_error;
  };
  auto state = std::make_shared<CallState>();

  http2::StreamEvents events;
  events.on_data = [state](const uint8_t* data, size_t len) {
    std::lock_guard<std::mutex> lock(state->mu);
    state->buf.append(reinterpret_cast<const char*>(data), len);
  };
  events.on_closed = [state](const http2::Headers& trailers,
                             const std::string& err) {
    std::lock_guard<std::mutex> lock(state->mu);
    state->trailers = trailers;
    state->transport_error = err;
    state->done = true;
    state->cv.notify_all();
  };

  std::string error;
  int32_t sid = conn_->StartStream(RequestHeaders(method, timeout_us), false,
                                   std::move(events), &error);
  if (sid == 0) return Error("stream open failed: " + error);
  std::string framed = Frame(request);
  if (!conn_->SendData(sid, reinterpret_cast<const uint8_t*>(framed.data()),
                       framed.size(), true, &error)) {
    return Error("send failed: " + error);
  }

  std::unique_lock<std::mutex> lock(state->mu);
  if (timeout_us > 0) {
    if (!state->cv.wait_for(lock, std::chrono::microseconds(timeout_us),
                            [&] { return state->done; })) {
      lock.unlock();
      conn_->SendRstStream(sid, 8 /* CANCEL */);
      return Error("Deadline Exceeded", 4);
    }
  } else {
    state->cv.wait(lock, [&] { return state->done; });
  }
  if (!state->transport_error.empty()) {
    return Error("transport error: " + state->transport_error);
  }
  Error status = StatusFromTrailers(state->trailers);
  if (!status.IsOk()) return status;
  std::string msg;
  bool got = false;
  Error zerr = Unframe(&state->buf, &msg, &got);
  if (!zerr.IsOk()) return zerr;
  if (!got) {
    return Error("incomplete gRPC response message");
  }
  if (!response->ParseFromString(msg)) {
    return Error("failed to parse " + method + " response");
  }
  if (verbose_) {
    fprintf(stderr, "%s: %s\n", method.c_str(),
            response->ShortDebugString().c_str());
  }
  return Error::Success();
}

// ---- control plane ----

Error InferenceServerGrpcClient::IsServerLive(bool* live) {
  inference::ServerLiveRequest req;
  inference::ServerLiveResponse resp;
  Error err = Call("ServerLive", req, &resp);
  *live = err.IsOk() && resp.live();
  return err;
}

Error InferenceServerGrpcClient::IsServerReady(bool* ready) {
  inference::ServerReadyRequest req;
  inference::ServerReadyResponse resp;
  Error err = Call("ServerReady", req, &resp);
  *ready = err.IsOk() && resp.ready();
  return err;
}

Error InferenceServerGrpcClient::IsModelReady(
    bool* ready, const std::string& model_name,
    const std::string& model_version) {
  inference::ModelReadyRequest req;
  req.set_name(model_name);
  req.set_version(model_version);
  inference::ModelReadyResponse resp;
  Error err = Call("ModelReady", req, &resp);
  *ready = err.IsOk() && resp.ready();
  return err;
}

Error InferenceServerGrpcClient::ServerMetadata(
    inference::ServerMetadataResponse* resp) {
  inference::ServerMetadataRequest req;
  return Call("ServerMetadata", req, resp);
}

Error InferenceServerGrpcClient::ModelMetadata(
    inference::ModelMetadataResponse* resp, const std::string& name,
    const std::string& version) {
  inference::ModelMetadataRequest req;
  req.set_name(name);
  req.set_version(version);
  return Call("ModelMetadata", req, resp);
}

Error InferenceServerGrpcClient::ModelConfig(
    inference::ModelConfigResponse* resp, const std::string& name,
    const std::string& version) {
  inference::ModelConfigRequest req;
  req.set_name(name);
  req.set_version(version);
  return Call("ModelConfig", req, resp);
}

Error InferenceServerGrpcClient::ModelRepositoryIndex(
    inference::RepositoryIndexResponse* resp) {
  inference::RepositoryIndexRequest req;
  return Call("RepositoryIndex", req, resp);
}

Error InferenceServerGrpcClient::LoadModel(const std::string& model_name,
                                           const std::string& config_json) {
  inference::RepositoryModelLoadRequest req;
  req.set_model_name(model_name);
  if (!config_json.empty()) {
    SetParam(req.mutable_parameters(), "config", config_json);
  }
  inference::RepositoryModelLoadResponse resp;
  return Call("RepositoryModelLoad", req, &resp);
}

Error InferenceServerGrpcClient::UnloadModel(const std::string& model_name,
                                             bool unload_dependents) {
  inference::RepositoryModelUnloadRequest req;
  req.set_model_name(model_name);
  if (unload_dependents) {
    SetParam(req.mutable_parameters(), "unload_dependents", true);
  }
  inference::RepositoryModelUnloadResponse resp;
  return Call("RepositoryModelUnload", req, &resp);
}

Error InferenceServerGrpcClient::ModelInferenceStatistics(
    inference::ModelStatisticsResponse* resp, const std::string& name,
    const std::string& version) {
  inference::ModelStatisticsRequest req;
  req.set_name(name);
  req.set_version(version);
  return Call("ModelStatistics", req, resp);
}

Error InferenceServerGrpcClient::UpdateTraceSettings(
    inference::TraceSettingResponse* resp, const std::string& model_name,
    const std::map<std::string, std::vector<std::string>>& settings) {
  inference::TraceSettingRequest req;
  req.set_model_name(model_name);
  for (const auto& kv : settings) {
    auto& val = (*req.mutable_settings())[kv.first];
    for (const auto& v : kv.second) val.add_value(v);
  }
  return Call("TraceSetting", req, resp);
}

Error InferenceServerGrpcClient::GetTraceSettings(
    inference::TraceSettingResponse* resp, const std::string& model_name) {
  inference::TraceSettingRequest req;
  req.set_model_name(model_name);
  return Call("TraceSetting", req, resp);
}

Error InferenceServerGrpcClient::SystemSharedMemoryStatus(
    inference::SystemSharedMemoryStatusResponse* resp,
    const std::string& name) {
  inference::SystemSharedMemoryStatusRequest req;
  req.set_name(name);
  return Call("SystemSharedMemoryStatus", req, resp);
}

Error InferenceServerGrpcClient::RegisterSystemSharedMemory(
    const std::string& name, const std::string& key, size_t byte_size,
    size_t offset) {
  inference::SystemSharedMemoryRegisterRequest req;
  req.set_name(name);
  req.set_key(key);
  req.set_offset(offset);
  req.set_byte_size(byte_size);
  inference::SystemSharedMemoryRegisterResponse resp;
  return Call("SystemSharedMemoryRegister", req, &resp);
}

Error InferenceServerGrpcClient::UnregisterSystemSharedMemory(
    const std::string& name) {
  inference::SystemSharedMemoryUnregisterRequest req;
  req.set_name(name);
  inference::SystemSharedMemoryUnregisterResponse resp;
  return Call("SystemSharedMemoryUnregister", req, &resp);
}

Error InferenceServerGrpcClient::CudaSharedMemoryStatus(
    inference::CudaSharedMemoryStatusResponse* resp, const std::string& name) {
  inference::CudaSharedMemoryStatusRequest req;
  req.set_name(name);
  return Call("CudaSharedMemoryStatus", req, resp);
}

Error InferenceServerGrpcClient::RegisterCudaSharedMemory(
    const std::string& name, const std::string& raw_handle, int64_t device_id,
    size_t byte_size) {
  inference::CudaSharedMemoryRegisterRequest req;
  req.set_name(name);
  req.set_raw_handle(raw_handle);
  req.set_device_id(device_id);
  req.set_byte_size(byte_size);
  inference::CudaSharedMemoryRegisterResponse resp;
  return Call("CudaSharedMemoryRegister", req, &resp);
}

Error InferenceServerGrpcClient::UnregisterCudaSharedMemory(
    const std::string& name) {
  inference::CudaSharedMemoryUnregisterRequest req;
  req.set_name(name);
  inference::CudaSharedMemoryUnregisterResponse resp;
  return Call("CudaSharedMemoryUnregister", req, &resp);
}

// ---- inference ----

void InferenceServerGrpcClient::BuildInferRequest(
    const InferOptions& options, const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs,
    inference::ModelInferRequest* req) {
  req->set_model_name(options.model_name);
  req->set_model_version(options.model_version);
  req->set_id(options.request_id);
  auto* params = req->mutable_parameters();
  if (!options.sequence_id_str.empty()) {
    SetParam(params, "sequence_id", options.sequence_id_str);
  } else if (options.sequence_id != 0) {
    SetParam(params, "sequence_id",
             static_cast<int64_t>(options.sequence_id));
  }
  if (options.sequence_id != 0 || !options.sequence_id_str.empty()) {
    SetParam(params, "sequence_start", options.sequence_start);
    SetParam(params, "sequence_end", options.sequence_end);
  }
  if (options.priority != 0) {
    SetParam(params, "priority", static_cast<int64_t>(options.priority));
  }
  if (options.server_timeout_us != 0) {
    SetParam(params, "timeout",
             static_cast<int64_t>(options.server_timeout_us));
  }
  for (InferInput* input : inputs) {
    auto* t = req->add_inputs();
    t->set_name(input->Name());
    t->set_datatype(input->Datatype());
    for (int64_t d : input->Shape()) t->add_shape(d);
    if (input->IsSharedMemory()) {
      SetParam(t->mutable_parameters(), "shared_memory_region",
               input->SharedMemoryName());
      SetParam(t->mutable_parameters(), "shared_memory_byte_size",
               static_cast<int64_t>(input->SharedMemoryByteSize()));
      if (input->SharedMemoryOffset() != 0) {
        SetParam(t->mutable_parameters(), "shared_memory_offset",
                 static_cast<int64_t>(input->SharedMemoryOffset()));
      }
    } else {
      // gather the scatter-gather buffers into raw_input_contents
      // (parity: ref grpc_client.cc:1290-1302)
      std::string* raw = req->add_raw_input_contents();
      raw->reserve(input->ByteSize());
      input->PrepareForRequest();
      const uint8_t* buf;
      size_t size;
      while (input->GetNext(&buf, &size)) {
        raw->append(reinterpret_cast<const char*>(buf), size);
      }
    }
  }
  for (const InferRequestedOutput* output : outputs) {
    auto* t = req->add_outputs();
    t->set_name(output->Name());
    if (output->ClassCount() > 0) {
      SetParam(t->mutable_parameters(), "classification",
               static_cast<int64_t>(output->ClassCount()));
    }
    if (output->IsSharedMemory()) {
      SetParam(t->mutable_parameters(), "shared_memory_region",
               output->SharedMemoryName());
      SetParam(t->mutable_parameters(), "shared_memory_byte_size",
               static_cast<int64_t>(output->SharedMemoryByteSize()));
      if (output->SharedMemoryOffset() != 0) {
        SetParam(t->mutable_parameters(), "shared_memory_offset",
                 static_cast<int64_t>(output->SharedMemoryOffset()));
      }
    }
  }
}

Error InferenceServerGrpcClient::Infer(
    InferResult** result, const InferOptions& options,
    const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs) {
  RequestTimers timers;
  timers.Capture(RequestTimers::Kind::REQUEST_START);
  inference::ModelInferRequest req;
  BuildInferRequest(options, inputs, outputs, &req);
  auto resp = std::make_shared<inference::ModelInferResponse>();
  timers.Capture(RequestTimers::Kind::SEND_START);
  Error err = Call("ModelInfer", req, resp.get(),
                   options.client_timeout_us);
  timers.Capture(RequestTimers::Kind::SEND_END);
  timers.Capture(RequestTimers::Kind::RECV_START);
  timers.Capture(RequestTimers::Kind::RECV_END);
  timers.Capture(RequestTimers::Kind::REQUEST_END);
  if (err.IsOk()) UpdateInferStat(timers);
  InferResultGrpc::Create(result, std::move(resp), err);
  return err;
}

Error InferenceServerGrpcClient::AsyncInfer(
    OnCompleteFn callback, const InferOptions& options,
    const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs) {
  if (!callback) return Error("callback is required for AsyncInfer");
  inference::ModelInferRequest req;
  BuildInferRequest(options, inputs, outputs, &req);

  struct AsyncState {
    std::string buf;
    std::mutex mu;
    InferenceServerGrpcClient* client;
    OnCompleteFn callback;
    RequestTimers timers;
  };
  auto state = std::make_shared<AsyncState>();
  state->client = this;
  state->callback = std::move(callback);
  state->timers.Capture(RequestTimers::Kind::REQUEST_START);
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    ++async_inflight_;  // the destructor drains before teardown
  }

  http2::StreamEvents events;
  events.on_data = [state](const uint8_t* data, size_t len) {
    std::lock_guard<std::mutex> lock(state->mu);
    state->buf.append(reinterpret_cast<const char*>(data), len);
  };
  events.on_closed = [state](const http2::Headers& trailers,
                             const std::string& terr) {
    state->timers.Capture(RequestTimers::Kind::REQUEST_END);
    Error err;
    auto resp = std::make_shared<inference::ModelInferResponse>();
    if (!terr.empty()) {
      err = Error("transport error: " + terr);
    } else {
      err = StatusFromTrailers(trailers);
      if (err.IsOk()) {
        std::string msg;
        bool got = false;
        std::lock_guard<std::mutex> lock(state->mu);
        Error zerr = state->client->Unframe(&state->buf, &msg, &got);
        if (!zerr.IsOk()) {
          err = zerr;
        } else if (!got || !resp->ParseFromString(msg)) {
          err = Error("failed to parse ModelInfer response");
        }
      }
    }
    InferenceServerGrpcClient* client = state->client;
    if (err.IsOk()) client->UpdateInferStat(state->timers);
    InferResult* result = nullptr;
    InferResultGrpc::Create(&result, std::move(resp), err);
    state->callback(result);
    {
      // notify while still holding async_mu_: the destructor's wait
      // re-acquires the mutex before finishing, so the client cannot be
      // destroyed between our decrement and the notify (which would make
      // async_cv_/async_mu_ dangle under us)
      std::lock_guard<std::mutex> lock(client->async_mu_);
      --client->async_inflight_;
      client->async_cv_.notify_all();
    }
  };

  std::string error;
  int32_t sid = conn_->StartStream(RequestHeaders("ModelInfer",
                                                  options.client_timeout_us),
                                   false, std::move(events), &error);
  if (sid == 0) {
    {
      std::lock_guard<std::mutex> lock(async_mu_);
      --async_inflight_;
      async_cv_.notify_all();
    }
    return Error("stream open failed: " + error);
  }
  std::string framed = Frame(req);
  if (!conn_->SendData(sid, reinterpret_cast<const uint8_t*>(framed.data()),
                       framed.size(), true, &error)) {
    // the stream may still close via callback; don't double-decrement
    return Error("send failed: " + error);
  }
  return Error::Success();
}

Error InferenceServerGrpcClient::InferMulti(
    std::vector<InferResult*>* results,
    const std::vector<InferOptions>& options,
    const std::vector<std::vector<InferInput*>>& inputs,
    const std::vector<std::vector<const InferRequestedOutput*>>& outputs) {
  // Parity semantics (ref grpc_client.cc InferMulti): options/outputs may
  // be size 1 (broadcast) or match inputs.
  if (inputs.empty()) return Error("no inputs provided");
  if (options.size() != 1 && options.size() != inputs.size()) {
    return Error("options size must be 1 or match inputs");
  }
  if (!outputs.empty() && outputs.size() != 1 &&
      outputs.size() != inputs.size()) {
    return Error("outputs size must be 0, 1, or match inputs");
  }
  Error first_error;
  for (size_t i = 0; i < inputs.size(); ++i) {
    const InferOptions& opt = options.size() == 1 ? options[0] : options[i];
    std::vector<const InferRequestedOutput*> outs;
    if (!outputs.empty()) {
      outs = outputs.size() == 1 ? outputs[0] : outputs[i];
    }
    InferResult* result = nullptr;
    Error err = Infer(&result, opt, inputs[i], outs);
    results->push_back(result);
    if (!err.IsOk() && first_error.IsOk()) first_error = err;
  }
  return first_error;
}

Error InferenceServerGrpcClient::AsyncInferMulti(
    OnMultiCompleteFn callback, const std::vector<InferOptions>& options,
    const std::vector<std::vector<InferInput*>>& inputs,
    const std::vector<std::vector<const InferRequestedOutput*>>& outputs) {
  if (!callback) return Error("callback is required for AsyncInferMulti");
  if (inputs.empty()) return Error("no inputs provided");
  if (options.size() != 1 && options.size() != inputs.size()) {
    return Error("options size must be 1 or match inputs");
  }
  if (!outputs.empty() && outputs.size() != 1 &&
      outputs.size() != inputs.size()) {
    return Error("outputs size must be 0, 1, or match inputs");
  }
  struct MultiState {
    std::mutex mu;
    std::vector<InferResult*> results;
    size_t remaining;
    OnMultiCompleteFn callback;
  };
  auto state = std::make_shared<MultiState>();
  state->results.resize(inputs.size(), nullptr);
  state->remaining = inputs.size();
  state->callback = std::move(callback);
  for (size_t i = 0; i < inputs.size(); ++i) {
    const InferOptions& opt = options.size() == 1 ? options[0] : options[i];
    std::vector<const InferRequestedOutput*> outs;
    if (!outputs.empty()) {
      outs = outputs.size() == 1 ? outputs[0] : outputs[i];
    }
    Error err = AsyncInfer(
        [state, i](InferResult* result) {
          bool fire = false;
          {
            std::lock_guard<std::mutex> lock(state->mu);
            state->results[i] = result;
            fire = (--state->remaining == 0);
          }
          if (fire) state->callback(state->results);
        },
        opt, inputs[i], outs);
    if (!err.IsOk()) {
      bool fire = false;
      {
        std::lock_guard<std::mutex> lock(state->mu);
        InferResult* result = nullptr;
        InferResultGrpc::Create(
            &result, std::make_shared<inference::ModelInferResponse>(), err);
        state->results[i] = result;
        fire = (--state->remaining == 0);
      }
      if (fire) state->callback(state->results);
    }
  }
  return Error::Success();
}

// ---- bidi streaming ----

Error InferenceServerGrpcClient::StartStream(OnCompleteFn callback,
                                             bool enable_stats,
                                             uint64_t stream_timeout_us) {
  std::lock_guard<std::mutex> lock(stream_mu_);
  if (stream_id_ != 0) {
    return Error("stream is already active");
  }
  if (!callback) return Error("callback is required for StartStream");
  auto ctx = std::make_shared<StreamCtx>();
  ctx->callback = std::move(callback);
  ctx->stats_sink = enable_stats ? this : nullptr;

  // callbacks capture ONLY ctx: a detached (timed-out/destroyed) client
  // nulls ctx->callback and late frames become no-ops
  http2::StreamEvents events;
  events.on_data = [ctx](const uint8_t* data, size_t len) {
    std::unique_lock<std::mutex> lock(ctx->mu);
    ctx->buf.append(reinterpret_cast<const char*>(data), len);
    std::string msg;
    bool z = false;
    // grpc_framing directly, not the client's Unframe: this lambda must
    // capture only ctx so a detached client stays safe to destroy
    while (grpc_framing::PopMessage(&ctx->buf, &msg, &z)) {
      OnCompleteFn cb = ctx->callback;
      lock.unlock();
      inference::ModelStreamInferResponse stream_resp;
      Error err;
      if (z) {
        std::vector<uint8_t> plain;
        err = zlib_utils::ZDecompress(
            reinterpret_cast<const uint8_t*>(msg.data()), msg.size(),
            &plain);
        if (err.IsOk())
          msg.assign(reinterpret_cast<const char*>(plain.data()),
                     plain.size());
      }
      auto resp = std::make_shared<inference::ModelInferResponse>();
      if (!err.IsOk()) {
        // fall through with the decompression error
      } else if (!stream_resp.ParseFromString(msg)) {
        err = Error("failed to parse stream response");
      } else {
        if (!stream_resp.error_message().empty()) {
          err = Error(stream_resp.error_message());
        }
        *resp = stream_resp.infer_response();
      }
      if (cb) {
        InferResult* result = nullptr;
        InferResultGrpc::Create(&result, std::move(resp), err);
        cb(result);
      }
      lock.lock();
    }
  };
  events.on_closed = [ctx](const http2::Headers& trailers,
                           const std::string& terr) {
    Error status = terr.empty() ? StatusFromTrailers(trailers)
                                : Error("transport error: " + terr);
    OnCompleteFn cb;
    {
      std::lock_guard<std::mutex> lock(ctx->mu);
      cb = ctx->callback;
      ctx->closed = true;
    }
    ctx->closed_cv.notify_all();
    if (!status.IsOk() && cb) {
      InferResult* result = nullptr;
      InferResultGrpc::Create(
          &result, std::make_shared<inference::ModelInferResponse>(),
          status);
      cb(result);
    }
  };

  std::string error;
  int32_t sid = conn_->StartStream(
      RequestHeaders("ModelStreamInfer", stream_timeout_us), false,
      std::move(events), &error);
  if (sid == 0) {
    return Error("stream open failed: " + error);
  }
  stream_id_ = sid;
  stream_ctx_ = std::move(ctx);
  return Error::Success();
}

Error InferenceServerGrpcClient::AsyncStreamInfer(
    const InferOptions& options, const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs) {
  inference::ModelInferRequest req;
  BuildInferRequest(options, inputs, outputs, &req);
  std::string framed = Frame(req);
  // stream_mu_ held across the whole send: chunked DATA frames of two
  // concurrent messages must not interleave on one stream
  std::lock_guard<std::mutex> lock(stream_mu_);
  if (stream_id_ == 0) {
    return Error("stream is not active; call StartStream");
  }
  std::string error;
  if (!conn_->SendData(stream_id_,
                       reinterpret_cast<const uint8_t*>(framed.data()),
                       framed.size(), false, &error)) {
    return Error("stream send failed: " + error);
  }
  return Error::Success();
}

Error InferenceServerGrpcClient::StopStream() {
  int32_t sid;
  std::shared_ptr<StreamCtx> ctx;
  {
    std::lock_guard<std::mutex> lock(stream_mu_);
    sid = stream_id_;
    ctx = stream_ctx_;
    stream_id_ = 0;
    stream_ctx_ = nullptr;
  }
  if (sid == 0 || !ctx) return Error::Success();
  std::string error;
  // half-close our side (WritesDone parity), then wait for server close
  conn_->SendData(sid, nullptr, 0, true, &error);
  std::unique_lock<std::mutex> lock(ctx->mu);
  if (!ctx->closed_cv.wait_for(lock, std::chrono::seconds(10),
                               [&] { return ctx->closed; })) {
    // detach: suppress any late callbacks, then hard-cancel the stream
    ctx->callback = nullptr;
    lock.unlock();
    conn_->SendRstStream(sid, 8 /* CANCEL */);
    return Error("timed out waiting for the stream to close");
  }
  return Error::Success();
}

}  // namespace client_tpu_torch
