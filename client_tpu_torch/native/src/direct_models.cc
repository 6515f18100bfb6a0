// Stock "compiled model" library for the DIRECT backend: CPU reference
// models (add_sub INT32/FP32, identity INT32) behind the C ABI in
// direct_model_api.h, with v2-statistics bookkeeping. It is the plain
// version the card's library (direct_models_cuda.cu) is held against.
// A model name may carry its element count after a colon
// ("add_sub:1048576"); without one a model holds 16 elements.
//
// Role parity: the in-process inference target the reference's
// triton_c_api backend measures against (a dlopen'd server +
// add_sub-style model, ref:src/c++/perf_analyzer/client_backend/
// triton_c_api/triton_loader.cc:251-940). The device-backed library
// implements the same ABI; see direct_model_api.h.

#include "client_tpu_torch/direct_model_api.h"

#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string tls_error;

uint64_t NowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Duration {
  uint64_t count = 0;
  uint64_t ns = 0;
  void Add(uint64_t d) {
    ++count;
    ns += d;
  }
};

struct Output {
  std::string name;
  std::string datatype;
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;
};

char* DupString(const std::string& s) {
  char* out = static_cast<char*>(malloc(s.size() + 1));
  memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

}  // namespace

struct DirectResult {
  std::vector<Output> outputs;
};

struct DirectModel {
  std::string name;
  std::string datatype;  // INT32 | FP32
  int64_t size = 16;
  bool identity = false;

  std::mutex stats_mu;
  uint64_t inference_count = 0;
  uint64_t execution_count = 0;
  Duration success, queue, compute_input, compute_infer, compute_output;

  std::string MetadataJson() const {
    const std::string dims = "[" + std::to_string(size) + "]";
    std::string inputs, outputs;
    if (identity) {
      inputs = R"([{"name":"INPUT0","datatype":")" + datatype +
               R"(","shape":)" + dims + "}]";
      outputs = R"([{"name":"OUTPUT0","datatype":")" + datatype +
                R"(","shape":)" + dims + "}]";
    } else {
      inputs = R"([{"name":"INPUT0","datatype":")" + datatype +
               R"(","shape":)" + dims + R"(},{"name":"INPUT1","datatype":")" +
               datatype + R"(","shape":)" + dims + "}]";
      outputs = R"([{"name":"OUTPUT0","datatype":")" + datatype +
                R"(","shape":)" + dims +
                R"(},{"name":"OUTPUT1","datatype":")" + datatype +
                R"(","shape":)" + dims + "}]";
    }
    return R"({"metadata":{"name":")" + name +
           R"(","versions":["1"],"platform":"direct","inputs":)" + inputs +
           R"(,"outputs":)" + outputs +
           R"(},"config":{"name":")" + name +
           R"(","max_batch_size":0,"model_transaction_policy":)"
           R"({"decoupled":false}}})";
  }

  std::string StatsJson() {
    std::lock_guard<std::mutex> lk(stats_mu);
    auto d = [](const Duration& x) {
      return R"({"count":)" + std::to_string(x.count) + R"(,"ns":)" +
             std::to_string(x.ns) + "}";
    };
    return R"({"model_stats":[{"name":")" + name +
           R"(","version":"1","inference_count":)" +
           std::to_string(inference_count) + R"(,"execution_count":)" +
           std::to_string(execution_count) + R"(,"inference_stats":{)" +
           R"("success":)" + d(success) + R"(,"fail":{"count":0,"ns":0},)" +
           R"("queue":)" + d(queue) + R"(,"compute_input":)" +
           d(compute_input) + R"(,"compute_infer":)" + d(compute_infer) +
           R"(,"compute_output":)" + d(compute_output) + "}}]}";
  }
};

extern "C" {

int DirectApiVersion(void) { return CLIENT_TPU_TORCH_DIRECT_API_VERSION; }

int DirectModelCreate(const char* model_name, DirectModel** out,
                      const char** error) {
  std::string name = model_name ? model_name : "";
  auto* m = new DirectModel();
  m->name = name;
  const size_t colon = name.find(':');
  if (colon != std::string::npos) {
    char* end = nullptr;
    const long long n = strtoll(name.c_str() + colon + 1, &end, 10);
    if (n <= 0 || end == nullptr || *end != '\0') {
      delete m;
      tls_error = "bad element count in direct model name '" + name + "'";
      if (error) *error = tls_error.c_str();
      return 1;
    }
    m->size = n;
    name = name.substr(0, colon);
  }
  if (name == "add_sub" || name == "add_sub_int32") {
    m->datatype = "INT32";
  } else if (name == "add_sub_fp32") {
    m->datatype = "FP32";
  } else if (name == "identity" || name == "identity_int32") {
    m->datatype = "INT32";
    m->identity = true;
  } else {
    delete m;
    tls_error = "unknown direct model '" + name +
                "' (available: add_sub, add_sub_fp32, identity)";
    if (error) *error = tls_error.c_str();
    return 1;
  }
  *out = m;
  return 0;
}

void DirectModelDestroy(DirectModel* model) { delete model; }

char* DirectModelMetadataJson(DirectModel* model) {
  return DupString(model->MetadataJson());
}

char* DirectModelStatsJson(DirectModel* model) {
  return DupString(model->StatsJson());
}

int DirectModelInfer(DirectModel* model, const char* const* input_names,
                     const void* const* input_data,
                     const size_t* input_byte_sizes, size_t input_count,
                     DirectResult** out, const char** error) {
  const uint64_t t_start = NowNs();
  const size_t elem = 4;  // INT32 and FP32 are both 4 bytes
  const size_t want = static_cast<size_t>(model->size) * elem;
  const void* in0 = nullptr;
  const void* in1 = nullptr;
  for (size_t i = 0; i < input_count; ++i) {
    const std::string name = input_names[i];
    if (input_byte_sizes[i] < want) {
      tls_error = "input '" + name + "' has " +
                  std::to_string(input_byte_sizes[i]) + " bytes; expected " +
                  std::to_string(want);
      if (error) *error = tls_error.c_str();
      return 1;
    }
    if (name == "INPUT0") in0 = input_data[i];
    if (name == "INPUT1") in1 = input_data[i];
  }
  if (in0 == nullptr || (!model->identity && in1 == nullptr)) {
    tls_error = "missing required input(s) for model '" + model->name + "'";
    if (error) *error = tls_error.c_str();
    return 1;
  }
  const uint64_t t_compute = NowNs();

  auto* result = new DirectResult();
  result->outputs.reserve(2);  // references below must survive the 2nd add
  auto add_output = [&](const char* name) -> Output& {
    result->outputs.emplace_back();
    Output& o = result->outputs.back();
    o.name = name;
    o.datatype = model->datatype;
    o.shape.push_back(model->size);
    o.data.resize(want);
    return o;
  };
  if (model->identity) {
    Output& o = add_output("OUTPUT0");
    memcpy(o.data.data(), in0, want);
  } else {
    Output& sum = add_output("OUTPUT0");
    Output& diff = add_output("OUTPUT1");
    if (model->datatype == "INT32") {
      const int32_t* a = static_cast<const int32_t*>(in0);
      const int32_t* b = static_cast<const int32_t*>(in1);
      int32_t* s = reinterpret_cast<int32_t*>(sum.data.data());
      int32_t* d = reinterpret_cast<int32_t*>(diff.data.data());
      for (int64_t i = 0; i < model->size; ++i) {
        s[i] = a[i] + b[i];
        d[i] = a[i] - b[i];
      }
    } else {
      const float* a = static_cast<const float*>(in0);
      const float* b = static_cast<const float*>(in1);
      float* s = reinterpret_cast<float*>(sum.data.data());
      float* d = reinterpret_cast<float*>(diff.data.data());
      for (int64_t i = 0; i < model->size; ++i) {
        s[i] = a[i] + b[i];
        d[i] = a[i] - b[i];
      }
    }
  }
  const uint64_t t_end = NowNs();
  {
    std::lock_guard<std::mutex> lk(model->stats_mu);
    model->inference_count += 1;
    model->execution_count += 1;
    model->success.Add(t_end - t_start);
    model->queue.Add(0);
    model->compute_input.Add(t_compute - t_start);
    model->compute_infer.Add(t_end - t_compute);
    model->compute_output.Add(0);
  }
  *out = result;
  return 0;
}

size_t DirectResultOutputCount(const DirectResult* result) {
  return result->outputs.size();
}

const char* DirectResultOutputName(const DirectResult* result, size_t i) {
  return result->outputs[i].name.c_str();
}

const char* DirectResultOutputDatatype(const DirectResult* result,
                                       size_t i) {
  return result->outputs[i].datatype.c_str();
}

const int64_t* DirectResultOutputShape(const DirectResult* result, size_t i,
                                       size_t* rank) {
  *rank = result->outputs[i].shape.size();
  return result->outputs[i].shape.data();
}

const void* DirectResultOutputData(const DirectResult* result, size_t i,
                                   size_t* byte_size) {
  *byte_size = result->outputs[i].data.size();
  return result->outputs[i].data.data();
}

void DirectResultDestroy(DirectResult* result) { delete result; }

void DirectStringFree(char* s) { free(s); }

}  // extern "C"
