// The DIRECT model library on a CUDA card: the models of the CPU stock
// library (direct_models.cc: add_sub INT32/FP32, identity INT32) behind
// the same C ABI (direct_model_api.h, version 1), with the same metadata
// and statistics JSON, computed by hand-written kernels.
//
// Parity role: the device-backed DIRECT library (the reference's
// triton_c_api backend drives a real server in-process,
// ref:src/c++/perf_analyzer/client_backend/triton_c_api/
// triton_loader.cc:251-940); it takes the place of a library that
// compiles the models' programs for an accelerator and executes them.
//
// Each call copies its inputs host->device, runs one kernel (add/sub
// writes both outputs in one pass; identity is a copy kernel) and copies
// the outputs back:
//   pinned host staging --H2D--> device inputs --kernel--> device outputs
//   --D2H--> pinned host staging --> the result's own buffers
// compute_input, compute_infer and compute_output are the CUDA-event
// times of the three stages. A model keeps a pool of call slots (device
// buffers, pinned staging, a stream and four events), resident for the
// model's life: a call takes a free slot or makes one, so concurrent
// callers never share buffers. Every call sets the model's device (the
// current device at DirectModelCreate) on its own thread first.
//
// A model name may carry its element count after a colon
// ("add_sub:1048576"); without one a model holds 16 elements, as the
// CPU library's.
//
// Besides the ABI the library exports its kernels' launch counts:
// DirectCudaLaunches("add_sub" | "copy" | "") (the empty name: both);
// a launch counts where it is made. When
// CLIENT_TPU_TORCH_DIRECT_LAUNCH_LOG names a file, the library appends
// its counts there as one JSON line when it is unloaded, so a process
// that drives it (perf_analyzer -i direct) reports them to its parent.
//
// Build (sm_90a, static cudart):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Iinclude -o libdirect_models_cuda.so \
//        src/direct_models_cuda.cu

#include "client_tpu_torch/direct_model_api.h"

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string tls_error;

std::atomic<uint64_t> g_add_sub_launches{0};
std::atomic<uint64_t> g_copy_launches{0};

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

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

int Fail(const char** error, const std::string& msg) {
  tls_error = msg;
  if (error) *error = tls_error.c_str();
  return 1;
}

std::string CudaWhy(const char* what, cudaError_t e) {
  return std::string(what) + ": " + cudaGetErrorName(e) + " (" +
         cudaGetErrorString(e) + ")";
}

// int32 wraps as the CPU library's two's-complement add/sub does on its
// hosts; the float ops round to nearest without contraction, so the card
// and the CPU library agree bit for bit.
__device__ __forceinline__ int32_t AddOp(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t SubOp(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ float AddOp(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float SubOp(float a, float b) {
  return __fsub_rn(a, b);
}

// One pass over the elements writes both outputs: sum = a + b and
// diff = a - b (grid-stride loop).
template <typename T>
__global__ void AddSubKernel(const T* __restrict__ a, const T* __restrict__ b,
                             T* __restrict__ sum, T* __restrict__ diff,
                             int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const T x = a[i];
    const T y = b[i];
    sum[i] = AddOp(x, y);
    diff[i] = SubOp(x, y);
  }
}

__global__ void CopyKernel(const int32_t* __restrict__ in,
                           int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = in[i];
  }
}

// One call's resources: device buffers, pinned staging, a stream and the
// four events that bracket H2D, the kernel and D2H.
struct Slot {
  void* d_in[2] = {nullptr, nullptr};
  void* d_out[2] = {nullptr, nullptr};
  void* h_in[2] = {nullptr, nullptr};
  void* h_out[2] = {nullptr, nullptr};
  cudaStream_t stream = nullptr;
  cudaEvent_t ev[4] = {nullptr, nullptr, nullptr, nullptr};

  ~Slot() {
    for (int i = 0; i < 2; ++i) {
      if (d_in[i]) cudaFree(d_in[i]);
      if (d_out[i]) cudaFree(d_out[i]);
      if (h_in[i]) cudaFreeHost(h_in[i]);
      if (h_out[i]) cudaFreeHost(h_out[i]);
    }
    for (cudaEvent_t e : ev)
      if (e) cudaEventDestroy(e);
    if (stream) cudaStreamDestroy(stream);
  }
};

}  // namespace

struct DirectResult {
  std::vector<Output> outputs;
};

struct DirectModel {
  std::string name;
  std::string datatype;  // INT32 | FP32
  int64_t size = 16;
  bool identity = false;
  int device = 0;

  std::mutex pool_mu;
  std::vector<std::unique_ptr<Slot>> slots;  // every slot, for Destroy
  std::vector<Slot*> free_slots;

  std::mutex stats_mu;
  uint64_t inference_count = 0;
  uint64_t execution_count = 0;
  Duration success, queue, compute_input, compute_infer, compute_output;

  size_t Bytes() const { return static_cast<size_t>(size) * 4; }
  int Tensors() const { return identity ? 1 : 2; }

  // a free slot, or a new one; nullptr (and *why) when CUDA refuses
  Slot* Acquire(std::string* why) {
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      if (!free_slots.empty()) {
        Slot* s = free_slots.back();
        free_slots.pop_back();
        return s;
      }
    }
    auto s = std::unique_ptr<Slot>(new Slot());
    cudaError_t e = cudaStreamCreateWithFlags(&s->stream,
                                              cudaStreamNonBlocking);
    for (int i = 0; e == cudaSuccess && i < 4; ++i)
      e = cudaEventCreate(&s->ev[i]);
    for (int i = 0; e == cudaSuccess && i < Tensors(); ++i) {
      e = cudaMalloc(&s->d_in[i], Bytes());
      if (e == cudaSuccess) e = cudaMalloc(&s->d_out[i], Bytes());
      if (e == cudaSuccess) e = cudaMallocHost(&s->h_in[i], Bytes());
      if (e == cudaSuccess) e = cudaMallocHost(&s->h_out[i], Bytes());
    }
    if (e != cudaSuccess) {
      *why = CudaWhy("allocating a call slot", e);
      return nullptr;
    }
    std::lock_guard<std::mutex> lk(pool_mu);
    slots.push_back(std::move(s));
    return slots.back().get();
  }

  void Release(Slot* s) {
    std::lock_guard<std::mutex> lk(pool_mu);
    free_slots.push_back(s);
  }

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

namespace {

uint64_t ElapsedNs(cudaEvent_t a, cudaEvent_t b) {
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return static_cast<uint64_t>(static_cast<double>(ms) * 1e6);
}

// H2D, the model's kernel, D2H on the slot's stream; waits for the last
// event. The inputs are already in the slot's pinned staging.
cudaError_t RunOnCard(DirectModel* model, Slot* s) {
  const size_t bytes = model->Bytes();
  const int n_in = model->Tensors();
  cudaError_t e = cudaEventRecord(s->ev[0], s->stream);
  for (int i = 0; e == cudaSuccess && i < n_in; ++i)
    e = cudaMemcpyAsync(s->d_in[i], s->h_in[i], bytes,
                        cudaMemcpyHostToDevice, s->stream);
  if (e == cudaSuccess) e = cudaEventRecord(s->ev[1], s->stream);
  if (e != cudaSuccess) return e;
  const int64_t n = model->size;
  const unsigned blocks = static_cast<unsigned>(
      std::min<int64_t>((n + kThreads - 1) / kThreads, kMaxBlocks));
  if (model->identity) {
    CopyKernel<<<blocks, kThreads, 0, s->stream>>>(
        static_cast<const int32_t*>(s->d_in[0]),
        static_cast<int32_t*>(s->d_out[0]), n);
  } else if (model->datatype == "FP32") {
    AddSubKernel<float><<<blocks, kThreads, 0, s->stream>>>(
        static_cast<const float*>(s->d_in[0]),
        static_cast<const float*>(s->d_in[1]),
        static_cast<float*>(s->d_out[0]), static_cast<float*>(s->d_out[1]),
        n);
  } else {
    AddSubKernel<int32_t><<<blocks, kThreads, 0, s->stream>>>(
        static_cast<const int32_t*>(s->d_in[0]),
        static_cast<const int32_t*>(s->d_in[1]),
        static_cast<int32_t*>(s->d_out[0]),
        static_cast<int32_t*>(s->d_out[1]), n);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  (model->identity ? g_copy_launches : g_add_sub_launches)
      .fetch_add(1, std::memory_order_relaxed);
  e = cudaEventRecord(s->ev[2], s->stream);
  const int n_out = model->identity ? 1 : 2;
  for (int i = 0; e == cudaSuccess && i < n_out; ++i)
    e = cudaMemcpyAsync(s->h_out[i], s->d_out[i], bytes,
                        cudaMemcpyDeviceToHost, s->stream);
  if (e == cudaSuccess) e = cudaEventRecord(s->ev[3], s->stream);
  if (e == cudaSuccess) e = cudaEventSynchronize(s->ev[3]);
  return e;
}

// runs at dlclose or process exit
__attribute__((destructor)) void WriteLaunchLog() {
  const char* path = getenv("CLIENT_TPU_TORCH_DIRECT_LAUNCH_LOG");
  if (path == nullptr || path[0] == '\0') return;
  FILE* f = fopen(path, "a");
  if (f == nullptr) return;
  fprintf(f, "{\"add_sub\": %llu, \"copy\": %llu}\n",
          static_cast<unsigned long long>(g_add_sub_launches.load()),
          static_cast<unsigned long long>(g_copy_launches.load()));
  fclose(f);
}

}  // namespace

extern "C" {

int DirectApiVersion(void) { return CLIENT_TPU_TORCH_DIRECT_API_VERSION; }

uint64_t DirectCudaLaunches(const char* kernel) {
  const std::string k = kernel ? kernel : "";
  if (k == "add_sub") return g_add_sub_launches.load();
  if (k == "copy") return g_copy_launches.load();
  return g_add_sub_launches.load() + g_copy_launches.load();
}

int DirectModelCreate(const char* model_name, DirectModel** out,
                      const char** error) {
  int count = 0;
  cudaError_t e = cudaGetDeviceCount(&count);
  if (e != cudaSuccess || count == 0) {
    return Fail(error, e != cudaSuccess
                           ? "no CUDA device for the direct model library: " +
                                 CudaWhy("cudaGetDeviceCount", e)
                           : "no CUDA device for the direct model library");
  }
  std::string name = model_name ? model_name : "";
  auto m = std::unique_ptr<DirectModel>(new DirectModel());
  m->name = name;
  const size_t colon = name.find(':');
  if (colon != std::string::npos) {
    char* end = nullptr;
    const long long n = strtoll(name.c_str() + colon + 1, &end, 10);
    if (n <= 0 || end == nullptr || *end != '\0')
      return Fail(error, "bad element count in direct model name '" + name +
                             "'");
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
    return Fail(error, "unknown direct model '" + name +
                           "' (available: add_sub, add_sub_fp32, identity)");
  }
  e = cudaGetDevice(&m->device);
  if (e != cudaSuccess) return Fail(error, CudaWhy("cudaGetDevice", e));
  *out = m.release();
  return 0;
}

void DirectModelDestroy(DirectModel* model) {
  if (model == nullptr) return;
  cudaSetDevice(model->device);
  delete model;
}

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
  const size_t want = model->Bytes();
  const void* in[2] = {nullptr, nullptr};
  for (size_t i = 0; i < input_count; ++i) {
    const std::string name = input_names[i];
    if (input_byte_sizes[i] < want) {
      return Fail(error, "input '" + name + "' has " +
                             std::to_string(input_byte_sizes[i]) +
                             " bytes; expected " + std::to_string(want));
    }
    if (name == "INPUT0") in[0] = input_data[i];
    if (name == "INPUT1") in[1] = input_data[i];
  }
  if (in[0] == nullptr || (!model->identity && in[1] == nullptr)) {
    return Fail(error,
                "missing required input(s) for model '" + model->name + "'");
  }
  cudaError_t e = cudaSetDevice(model->device);
  if (e != cudaSuccess) return Fail(error, CudaWhy("cudaSetDevice", e));
  std::string why;
  Slot* s = model->Acquire(&why);
  if (s == nullptr) return Fail(error, why);
  for (int i = 0; i < model->Tensors(); ++i) memcpy(s->h_in[i], in[i], want);
  e = RunOnCard(model, s);
  if (e != cudaSuccess) {
    // a failed stream may hold work: the slot is not reused
    return Fail(error, CudaWhy("running the model on the card", e));
  }
  auto* result = new DirectResult();
  const char* names[2] = {"OUTPUT0", "OUTPUT1"};
  for (int i = 0; i < (model->identity ? 1 : 2); ++i) {
    result->outputs.emplace_back();
    Output& o = result->outputs.back();
    o.name = names[i];
    o.datatype = model->datatype;
    o.shape.push_back(model->size);
    o.data.resize(want);
    memcpy(o.data.data(), s->h_out[i], want);
  }
  const uint64_t input_ns = ElapsedNs(s->ev[0], s->ev[1]);
  const uint64_t infer_ns = ElapsedNs(s->ev[1], s->ev[2]);
  const uint64_t output_ns = ElapsedNs(s->ev[2], s->ev[3]);
  model->Release(s);
  const uint64_t t_end = NowNs();
  {
    std::lock_guard<std::mutex> lk(model->stats_mu);
    model->inference_count += 1;
    model->execution_count += 1;
    model->success.Add(t_end - t_start);
    model->queue.Add(0);
    model->compute_input.Add(input_ns);
    model->compute_infer.Add(infer_ns);
    model->compute_output.Add(output_ns);
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
