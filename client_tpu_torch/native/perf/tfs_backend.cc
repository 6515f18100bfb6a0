// TF-Serving gRPC backend for the native perf analyzer.
//
// Parity: ref:src/c++/perf_analyzer/client_backend/tensorflow_serving/
// tfserve_grpc_client.cc:1-723 — PredictionService.Predict over gRPC
// with TFS TensorProto tensors; Infer/AsyncInfer + client stats only
// (no streaming, no shared memory, no server statistics — the
// reference's subset). The transport is this repo's own HTTP/2+HPACK
// connection; messages come from the same tfs.proto the Python backend
// generates its stubs from (public TFS field numbers).

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>

#include "client_backend.h"
#include "client_tpu_torch/grpc_framing.h"
#include "client_tpu_torch/http2.h"
#include "tfs.pb.h"

namespace client_tpu_torch {
namespace perf {

namespace {

constexpr char kTfsServicePath[] =
    "/tensorflow.serving.PredictionService/";

tensorflow::serving::DataType TfsDtype(const std::string& wire) {
  using tensorflow::serving::DataType;
  if (wire == "FP32") return DataType::DT_FLOAT;
  if (wire == "FP64") return DataType::DT_DOUBLE;
  if (wire == "INT32") return DataType::DT_INT32;
  if (wire == "INT64") return DataType::DT_INT64;
  if (wire == "INT16") return DataType::DT_INT16;
  if (wire == "INT8") return DataType::DT_INT8;
  if (wire == "UINT8") return DataType::DT_UINT8;
  if (wire == "UINT32") return DataType::DT_UINT32;
  if (wire == "UINT64") return DataType::DT_UINT64;
  if (wire == "BOOL") return DataType::DT_BOOL;
  if (wire == "BYTES") return DataType::DT_STRING;
  if (wire == "FP16") return DataType::DT_HALF;
  if (wire == "BF16") return DataType::DT_BFLOAT16;
  return DataType::DT_INVALID;
}

const char* WireOfTfs(int dtype) {
  using tensorflow::serving::DataType;
  switch (dtype) {
    case DataType::DT_FLOAT: return "FP32";
    case DataType::DT_DOUBLE: return "FP64";
    case DataType::DT_INT32: return "INT32";
    case DataType::DT_INT64: return "INT64";
    case DataType::DT_INT16: return "INT16";
    case DataType::DT_INT8: return "INT8";
    case DataType::DT_UINT8: return "UINT8";
    case DataType::DT_UINT32: return "UINT32";
    case DataType::DT_UINT64: return "UINT64";
    case DataType::DT_BOOL: return "BOOL";
    case DataType::DT_STRING: return "BYTES";
    case DataType::DT_HALF: return "FP16";
    case DataType::DT_BFLOAT16: return "BF16";
    default: return "";
  }
}

class TfsResult : public InferResult {
 public:
  TfsResult(tensorflow::serving::PredictResponse resp, Error status)
      : resp_(std::move(resp)), status_(std::move(status)) {}
  Error RequestStatus() const override { return status_; }
  Error Id(std::string* id) const override {
    id->clear();
    return Error::Success();
  }
  Error ModelName(std::string* name) const override {
    *name = resp_.model_spec().name();
    return Error::Success();
  }
  Error ModelVersion(std::string* version) const override {
    version->clear();
    return Error::Success();
  }
  Error Shape(const std::string& output_name,
              std::vector<int64_t>* shape) const override {
    auto it = resp_.outputs().find(output_name);
    if (it == resp_.outputs().end())
      return Error("output '" + output_name + "' not found");
    shape->clear();
    for (const auto& d : it->second.tensor_shape().dim())
      shape->push_back(d.size());
    return Error::Success();
  }
  Error Datatype(const std::string& output_name,
                 std::string* datatype) const override {
    auto it = resp_.outputs().find(output_name);
    if (it == resp_.outputs().end())
      return Error("output '" + output_name + "' not found");
    *datatype = WireOfTfs(it->second.dtype());
    return Error::Success();
  }
  Error RawData(const std::string& output_name, const uint8_t** buf,
                size_t* byte_size) const override {
    auto it = resp_.outputs().find(output_name);
    if (it == resp_.outputs().end())
      return Error("output '" + output_name + "' not found");
    const std::string& content = it->second.tensor_content();
    *buf = reinterpret_cast<const uint8_t*>(content.data());
    *byte_size = content.size();
    return Error::Success();
  }
  Error StringData(const std::string& output_name,
                   std::vector<std::string>* out) const override {
    auto it = resp_.outputs().find(output_name);
    if (it == resp_.outputs().end())
      return Error("output '" + output_name + "' not found");
    out->assign(it->second.string_val().begin(),
                it->second.string_val().end());
    return Error::Success();
  }
  std::string DebugString() const override {
    return resp_.ShortDebugString();
  }

 private:
  tensorflow::serving::PredictResponse resp_;
  Error status_;
};

}  // namespace

class TfsPerfBackend : public PerfBackend {
 public:
  static Error Create(std::unique_ptr<PerfBackend>* backend,
                      const std::string& url, bool verbose,
                      const std::string& signature_name) {
    auto b = std::unique_ptr<TfsPerfBackend>(new TfsPerfBackend());
    b->signature_name_ = signature_name;
    (void)verbose;
    std::string error;
    b->conn_ = http2::Connection::Connect(url, &error);
    if (!b->conn_) return Error("unable to connect: " + error);
    *backend = std::move(b);
    return Error::Success();
  }

  BackendKind Kind() const override { return BackendKind::TFSERVE; }

  // The v2-shaped metadata is synthesized from GetModelMetadata's
  // signature_def so ModelInfo::Parse needs no TFS special case
  // (parity role: ref InitTFServe model_parser.cc:217-305).
  Error ModelMetadata(json::Value* metadata, const std::string& name,
                      const std::string& version) override {
    tensorflow::serving::GetModelMetadataRequest req;
    req.mutable_model_spec()->set_name(name);
    if (!version.empty())
      req.mutable_model_spec()->mutable_version()->set_value(
          atoll(version.c_str()));
    req.add_metadata_field("signature_def");
    tensorflow::serving::GetModelMetadataResponse resp;
    Error err = Call("GetModelMetadata", req, &resp);
    if (!err.IsOk()) return err;
    auto it = resp.metadata().find("signature_def");
    if (it == resp.metadata().end())
      return Error("TF-Serving metadata has no signature_def");
    tensorflow::serving::SignatureDefMap sig_map;
    if (!sig_map.ParseFromString(it->second.value()))
      return Error("cannot parse SignatureDefMap");
    auto sig_it = sig_map.signature_def().find(signature_name_);
    if (sig_it == sig_map.signature_def().end())
      return Error("signature '" + signature_name_ + "' not found");

    json::Value meta;
    meta["name"] = json::Value(name);
    json::Array inputs, outputs;
    for (const auto& section :
         {std::make_pair(&sig_it->second.inputs(), &inputs),
          std::make_pair(&sig_it->second.outputs(), &outputs)}) {
      for (const auto& kv : *section.first) {
        json::Value t;
        t["name"] = json::Value(kv.first);
        t["datatype"] = json::Value(std::string(
            WireOfTfs(kv.second.dtype())));
        json::Array shape;
        for (const auto& d : kv.second.tensor_shape().dim())
          shape.push_back(json::Value(d.size()));
        t["shape"] = json::Value(shape);
        section.second->push_back(t);
      }
    }
    meta["inputs"] = json::Value(inputs);
    meta["outputs"] = json::Value(outputs);
    *metadata = meta;
    return Error::Success();
  }

  Error ModelConfig(json::Value* config, const std::string&,
                    const std::string&) override {
    // TFS exposes no Triton-style config; the user's batch rides the
    // leading tensor dim (ref parity)
    json::Value cfg;
    cfg["max_batch_size"] = json::Value(int64_t(0));
    json::Value policy;
    policy["decoupled"] = json::Value(false);
    cfg["model_transaction_policy"] = policy;
    *config = cfg;
    return Error::Success();
  }

  Error ModelStatistics(json::Value*, const std::string&) override {
    return Error("TF-Serving exposes no statistics");
  }

  Error BuildRequest(tensorflow::serving::PredictRequest* out,
                     const InferOptions& options,
                     const std::vector<InferInput*>& inputs) {
    tensorflow::serving::PredictRequest& req = *out;
    req.mutable_model_spec()->set_name(options.model_name);
    req.mutable_model_spec()->set_signature_name(signature_name_);
    for (InferInput* input : inputs) {
      auto& tensor = (*req.mutable_inputs())[input->Name()];
      tensor.set_dtype(TfsDtype(input->Datatype()));
      for (int64_t d : input->Shape())
        tensor.mutable_tensor_shape()->add_dim()->set_size(d);
      input->PrepareForRequest();
      std::string content;
      const uint8_t* chunk;
      size_t chunk_size;
      while (input->GetNext(&chunk, &chunk_size))
        content.append(reinterpret_cast<const char*>(chunk), chunk_size);
      if (input->Datatype() == "BYTES") {
        // length-prefixed framing -> string_val elements
        size_t off = 0;
        while (off + 4 <= content.size()) {
          uint32_t n;
          std::memcpy(&n, content.data() + off, 4);
          off += 4;
          if (off + n > content.size())
            return Error("malformed BYTES framing for '" +
                         input->Name() + "'");
          tensor.add_string_val(content.substr(off, n));
          off += n;
        }
      } else {
        tensor.set_tensor_content(std::move(content));
      }
    }
    return Error::Success();
  }

  Error Infer(InferResult** result, const InferOptions& options,
              const std::vector<InferInput*>& inputs,
              const std::vector<const InferRequestedOutput*>&) override {
    tensorflow::serving::PredictRequest req;
    Error err = BuildRequest(&req, options, inputs);
    if (!err.IsOk()) return err;
    tensorflow::serving::PredictResponse resp;
    Error status = Call("Predict", req, &resp,
                        options.client_timeout_us);
    *result = new TfsResult(std::move(resp), status);
    return status;
  }

  ~TfsPerfBackend() override {
    // drain in-flight async calls (their threads touch this object)
    std::unique_lock<std::mutex> lock(async_mu_);
    async_cv_.wait_for(lock, std::chrono::seconds(30),
                       [&] { return async_inflight_ == 0; });
  }

  Error AsyncInfer(OnCompleteFn callback, const InferOptions& options,
                   const std::vector<InferInput*>& inputs,
                   const std::vector<const InferRequestedOutput*>& outputs)
      override {
    // genuinely asynchronous: a blocking AsyncInfer would silently cap
    // concurrency at the worker-thread count and misreport every level
    // above it. One detached thread per call; the harness bounds how
    // many are in flight. NOTE: inputs are copied into the request
    // BEFORE the thread starts (cursor state is not thread-safe).
    tensorflow::serving::PredictRequest req;
    Error err = BuildRequest(&req, options, inputs);
    if (!err.IsOk()) return err;
    {
      std::lock_guard<std::mutex> lock(async_mu_);
      ++async_inflight_;
    }
    uint64_t timeout_us = options.client_timeout_us;
    std::thread([this, req = std::move(req), timeout_us,
                 callback = std::move(callback)]() mutable {
      tensorflow::serving::PredictResponse resp;
      Error status = Call("Predict", req, &resp, timeout_us);
      callback(new TfsResult(std::move(resp), status));
      std::lock_guard<std::mutex> lock(async_mu_);
      --async_inflight_;
      async_cv_.notify_all();
    }).detach();
    return Error::Success();
  }

  Error RegisterSystemSharedMemory(const std::string&, const std::string&,
                                   size_t) override {
    return Error("shared memory not supported by TF-Serving backend");
  }
  Error RegisterCudaSharedMemory(const std::string&, const std::string&,
                                 int64_t, size_t) override {
    return Error("shared memory not supported by TF-Serving backend");
  }
  Error UnregisterAllSharedMemory() override { return Error::Success(); }

 private:
  Error Call(const std::string& method,
             const google::protobuf::Message& request,
             google::protobuf::Message* response,
             uint64_t timeout_us = 0) {
    struct CallState {
      std::mutex mu;
      std::condition_variable cv;
      bool done = false;
      std::string buf;
      std::string transport_error;
      http2::Headers trailers;
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

    http2::Headers headers = {
        {":method", "POST"},
        {":scheme", "http"},
        {":path", std::string(kTfsServicePath) + method},
        {":authority", conn_->authority()},
        {"te", "trailers"},
        {"content-type", "application/grpc"},
    };
    std::string error;
    int32_t sid = conn_->StartStream(headers, false, std::move(events),
                                     &error);
    if (sid == 0) return Error("stream open failed: " + error);
    std::string payload;
    request.SerializeToString(&payload);
    std::string framed = grpc_framing::FramePayload(payload);
    if (!conn_->SendData(sid,
                         reinterpret_cast<const uint8_t*>(framed.data()),
                         framed.size(), true, &error)) {
      return Error("send failed: " + error);
    }
    std::unique_lock<std::mutex> lock(state->mu);
    if (timeout_us > 0) {
      if (!state->cv.wait_for(lock, std::chrono::microseconds(timeout_us),
                              [&] { return state->done; })) {
        conn_->SendRstStream(sid, 8 /* CANCEL */);
        return Error("Deadline Exceeded", 4);
      }
    } else {
      state->cv.wait(lock, [&] { return state->done; });
    }
    if (!state->transport_error.empty())
      return Error("transport error: " + state->transport_error);
    Error status = grpc_framing::StatusFromTrailers(state->trailers);
    if (!status.IsOk()) return status;
    std::string msg;
    if (!grpc_framing::PopMessage(&state->buf, &msg) ||
        !response->ParseFromString(msg)) {
      return Error("failed to parse " + method + " response");
    }
    return Error::Success();
  }

  std::string signature_name_;
  std::unique_ptr<http2::Connection> conn_;
  std::mutex async_mu_;
  std::condition_variable async_cv_;
  int async_inflight_ = 0;
};

Error CreateTfsBackend(std::unique_ptr<PerfBackend>* backend,
                       const std::string& url, bool verbose,
                       const std::string& signature_name) {
  return TfsPerfBackend::Create(backend, url, verbose, signature_name);
}

}  // namespace perf
}  // namespace client_tpu_torch
