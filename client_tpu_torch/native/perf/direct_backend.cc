// DIRECT backend: no-RPC measurement path for the native perf analyzer.
//
// Parity: ref:src/c++/perf_analyzer/client_backend/triton_c_api — the
// backend dlopen-loads a shared library and drives inference in-process,
// so the measurement contains zero network. The dlopen/dlsym handling
// follows the reference's SharedLibrary pattern
// (shared_library.cc:38-90: RTLD_NOW|RTLD_LOCAL open, dlerror capture
// per entrypoint); the loaded surface is the C model ABI declared in
// client_tpu_torch/direct_model_api.h. The default library is the
// card's, libdirect_models_cuda.so; the CPU stock library
// (libdirect_models_cpu.so) runs only when named by -u or by
// CLIENT_TPU_TORCH_DIRECT_LIBRARY.

#include <dlfcn.h>
#include <fcntl.h>
#include <limits.h>
#include <sys/mman.h>
#include <unistd.h>

#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "client_backend.h"
#include "client_tpu_torch/direct_model_api.h"
#include "client_tpu_torch/json.h"
#include "client_tpu_torch/shm_utils.h"

namespace client_tpu_torch {
namespace perf {
namespace {

// ---------------------------------------------------------- dlopen layer

class SharedLibrary {
 public:
  ~SharedLibrary() {
    if (handle_ != nullptr) dlclose(handle_);
  }

  Error Open(const std::string& path) {
    dlerror();  // clear stale state
    handle_ = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
    if (handle_ == nullptr) {
      const char* why = dlerror();
      return Error("cannot load direct model library '" + path +
                   "': " + (why ? why : "unknown dlopen error"));
    }
    return Error::Success();
  }

  template <typename Fn>
  Error Entrypoint(const char* name, Fn* fn) {
    dlerror();
    void* sym = dlsym(handle_, name);
    if (sym == nullptr) {
      const char* why = dlerror();
      return Error(std::string("direct model library misses symbol '") +
                   name + "': " + (why ? why : "not found"));
    }
    *fn = reinterpret_cast<Fn>(sym);
    return Error::Success();
  }

 private:
  void* handle_ = nullptr;
};

struct DirectApi {
  decltype(&DirectApiVersion) version = nullptr;
  decltype(&DirectModelCreate) create = nullptr;
  decltype(&DirectModelDestroy) destroy = nullptr;
  decltype(&DirectModelMetadataJson) metadata_json = nullptr;
  decltype(&DirectModelStatsJson) stats_json = nullptr;
  decltype(&DirectModelInfer) infer = nullptr;
  decltype(&DirectResultOutputCount) out_count = nullptr;
  decltype(&DirectResultOutputName) out_name = nullptr;
  decltype(&DirectResultOutputDatatype) out_datatype = nullptr;
  decltype(&DirectResultOutputShape) out_shape = nullptr;
  decltype(&DirectResultOutputData) out_data = nullptr;
  decltype(&DirectResultDestroy) result_destroy = nullptr;
  decltype(&DirectStringFree) string_free = nullptr;
};

Error LoadApi(SharedLibrary* lib, const std::string& path, DirectApi* api) {
  Error err = lib->Open(path);
  if (!err.IsOk()) return err;
#define LOAD(field, symbol)                        \
  err = lib->Entrypoint(#symbol, &api->field);     \
  if (!err.IsOk()) return err;
  LOAD(version, DirectApiVersion)
  LOAD(create, DirectModelCreate)
  LOAD(destroy, DirectModelDestroy)
  LOAD(metadata_json, DirectModelMetadataJson)
  LOAD(stats_json, DirectModelStatsJson)
  LOAD(infer, DirectModelInfer)
  LOAD(out_count, DirectResultOutputCount)
  LOAD(out_name, DirectResultOutputName)
  LOAD(out_datatype, DirectResultOutputDatatype)
  LOAD(out_shape, DirectResultOutputShape)
  LOAD(out_data, DirectResultOutputData)
  LOAD(result_destroy, DirectResultDestroy)
  LOAD(string_free, DirectStringFree)
#undef LOAD
  int got = api->version();
  if (got != CLIENT_TPU_TORCH_DIRECT_API_VERSION)
    return Error("direct model library speaks API v" + std::to_string(got) +
                 "; this analyzer needs v" +
                 std::to_string(CLIENT_TPU_TORCH_DIRECT_API_VERSION));
  return Error::Success();
}

Error DefaultLibraryPath(std::string* path) {
  const char* env = getenv("CLIENT_TPU_TORCH_DIRECT_LIBRARY");
  if (env != nullptr && env[0] != '\0') {
    *path = env;
    return Error::Success();
  }
  // the card's library, next to the running binary (the port's native
  // build puts both there, and builds the library only where nvcc is),
  // else in ../lib/ (an installed prefix keeps the binary in bin/)
  *path = "libdirect_models_cuda.so";
  char exe[PATH_MAX];
  ssize_t n = readlink("/proc/self/exe", exe, sizeof(exe) - 1);
  if (n > 0) {
    exe[n] = '\0';
    std::string dir(exe);
    auto slash = dir.rfind('/');
    if (slash != std::string::npos) {
      dir = dir.substr(0, slash + 1);
      std::string installed = dir + "../lib/" + *path;
      *path = dir + *path;
      if (access(path->c_str(), R_OK) != 0 &&
          access(installed.c_str(), R_OK) == 0)
        *path = installed;
    }
  }
  if (access(path->c_str(), R_OK) != 0) {
    return Error(
        "the default direct model library " + *path +
        " is not built: it is CUDA code, built with nvcc (the CUDA "
        "toolkit), and runs on a CUDA device; name the CPU library with "
        "-u libdirect_models_cpu.so or CLIENT_TPU_TORCH_DIRECT_LIBRARY");
  }
  return Error::Success();
}

// ------------------------------------------------------------- result

class DirectInferResult : public InferResult {
 public:
  DirectInferResult(const DirectApi* api, DirectResult* result,
                    std::string model_name, Error status)
      : api_(api), result_(result), model_name_(std::move(model_name)),
        status_(std::move(status)) {}
  ~DirectInferResult() override {
    if (result_ != nullptr) api_->result_destroy(result_);
  }

  Error RequestStatus() const override { return status_; }
  Error Id(std::string* id) const override {
    id->clear();
    return Error::Success();
  }
  Error ModelName(std::string* name) const override {
    *name = model_name_;
    return Error::Success();
  }
  Error ModelVersion(std::string* version) const override {
    *version = "1";
    return Error::Success();
  }

  Error Shape(const std::string& output_name,
              std::vector<int64_t>* shape) const override {
    size_t idx;
    Error err = Find(output_name, &idx);
    if (!err.IsOk()) return err;
    size_t rank = 0;
    const int64_t* dims = api_->out_shape(result_, idx, &rank);
    shape->assign(dims, dims + rank);
    return Error::Success();
  }
  Error Datatype(const std::string& output_name,
                 std::string* datatype) const override {
    size_t idx;
    Error err = Find(output_name, &idx);
    if (!err.IsOk()) return err;
    *datatype = api_->out_datatype(result_, idx);
    return Error::Success();
  }
  Error RawData(const std::string& output_name, const uint8_t** buf,
                size_t* byte_size) const override {
    size_t idx;
    Error err = Find(output_name, &idx);
    if (!err.IsOk()) return err;
    *buf = static_cast<const uint8_t*>(
        api_->out_data(result_, idx, byte_size));
    return Error::Success();
  }
  Error StringData(const std::string& output_name,
                   std::vector<std::string>* out) const override {
    const uint8_t* buf;
    size_t size;
    Error err = RawData(output_name, &buf, &size);
    if (!err.IsOk()) return err;
    out->clear();
    size_t off = 0;  // BYTES framing: 4-byte LE length prefixes
    while (off + 4 <= size) {
      uint32_t len;
      std::memcpy(&len, buf + off, 4);
      off += 4;
      if (off + len > size) break;
      out->emplace_back(reinterpret_cast<const char*>(buf + off), len);
      off += len;
    }
    return Error::Success();
  }
  std::string DebugString() const override {
    return "direct result (" +
           std::to_string(result_ ? api_->out_count(result_) : 0) +
           " outputs)";
  }

 private:
  Error Find(const std::string& name, size_t* idx) const {
    if (result_ == nullptr) return Error("result carries no outputs");
    size_t n = api_->out_count(result_);
    for (size_t i = 0; i < n; ++i) {
      if (name == api_->out_name(result_, i)) {
        *idx = i;
        return Error::Success();
      }
    }
    return Error("unknown output '" + name + "'");
  }

  const DirectApi* api_;
  DirectResult* result_;
  std::string model_name_;
  Error status_;
};

// ------------------------------------------------------------- backend

class DirectPerfBackend : public PerfBackend {
 public:
  static Error Create(std::unique_ptr<PerfBackend>* backend,
                      const std::string& url, bool verbose) {
    auto b = std::unique_ptr<DirectPerfBackend>(new DirectPerfBackend());
    // -u carries the library path for the direct kind (no server URL
    // exists); empty/default falls back to the env var or the binary dir
    std::string path = url;
    Error err;
    if (path.empty() || path == "localhost:8000") {
      err = DefaultLibraryPath(&path);
      if (!err.IsOk()) return err;
    }
    err = LoadApi(&b->lib_, path, &b->api_);
    if (!err.IsOk()) return err;
    (void)verbose;
    *backend = std::move(b);
    return Error::Success();
  }

  ~DirectPerfBackend() override {
    for (auto& kv : models_) api_.destroy(kv.second);
  }

  BackendKind Kind() const override { return BackendKind::DIRECT; }

  Error ModelMetadata(json::Value* metadata, const std::string& name,
                      const std::string& version) override {
    (void)version;
    json::Value doc;
    Error err = ModelDoc(name, &doc);
    if (!err.IsOk()) return err;
    *metadata = doc.At("metadata");
    return Error::Success();
  }

  Error ModelConfig(json::Value* config, const std::string& name,
                    const std::string& version) override {
    (void)version;
    json::Value doc;
    Error err = ModelDoc(name, &doc);
    if (!err.IsOk()) return err;
    *config = doc.At("config");
    return Error::Success();
  }

  Error ModelStatistics(json::Value* stats,
                        const std::string& name) override {
    DirectModel* model;
    Error err = GetModel(name, &model);
    if (!err.IsOk()) return err;
    char* raw = api_.stats_json(model);
    if (raw == nullptr) return Error("direct library returned no stats");
    try {
      json::Parser parser(raw, strlen(raw));
      *stats = parser.Parse();
    } catch (const json::ParseError& e) {
      api_.string_free(raw);
      return Error(std::string("bad stats JSON from direct library: ") +
                   e.what());
    }
    api_.string_free(raw);
    return Error::Success();
  }

  Error Infer(InferResult** result, const InferOptions& options,
              const std::vector<InferInput*>& inputs,
              const std::vector<const InferRequestedOutput*>&) override {
    DirectModel* model;
    Error err = GetModel(options.model_name, &model);
    if (!err.IsOk()) return err;

    std::vector<const char*> names;
    std::vector<const void*> datas;
    std::vector<size_t> sizes;
    // gathered copies for scatter-gather inputs; shm inputs pass their
    // mapped region pointer straight through (zero-copy)
    std::vector<std::vector<uint8_t>> gathered;
    names.reserve(inputs.size());
    for (auto* in : inputs) {
      names.push_back(in->Name().c_str());
      if (in->IsSharedMemory()) {
        const uint8_t* base;
        size_t sz;
        err = ShmPointer(in->SharedMemoryName(), in->SharedMemoryOffset(),
                         in->SharedMemoryByteSize(), &base, &sz);
        if (!err.IsOk()) return err;
        datas.push_back(base);
        sizes.push_back(sz);
        continue;
      }
      gathered.emplace_back();
      auto& buf = gathered.back();
      buf.reserve(in->ByteSize());
      in->PrepareForRequest();
      const uint8_t* chunk;
      size_t chunk_size;
      while (in->GetNext(&chunk, &chunk_size))
        buf.insert(buf.end(), chunk, chunk + chunk_size);
      datas.push_back(buf.data());
      sizes.push_back(buf.size());
    }

    DirectResult* raw = nullptr;
    const char* why = nullptr;
    int rc = api_.infer(model, names.data(), datas.data(), sizes.data(),
                        names.size(), &raw, &why);
    Error status = rc == 0 ? Error::Success()
                           : Error(why ? why : "direct infer failed");
    *result = new DirectInferResult(&api_, raw, options.model_name, status);
    return status;
  }

  // The in-process call IS the async completion: there is no wire to
  // overlap, so AsyncInfer executes inline and fires the callback — the
  // same shape the reference's C-API backend measures (no-RPC floor).
  Error AsyncInfer(OnCompleteFn callback, const InferOptions& options,
                   const std::vector<InferInput*>& inputs,
                   const std::vector<const InferRequestedOutput*>& outputs)
      override {
    InferResult* result = nullptr;
    Error err = Infer(&result, options, inputs, outputs);
    if (result != nullptr) {
      callback(result);
      return Error::Success();
    }
    return err;
  }

  Error RegisterSystemSharedMemory(const std::string& name,
                                   const std::string& key,
                                   size_t byte_size) override {
    int fd = shm_open(key.c_str(), O_RDWR, 0666);
    if (fd < 0)
      return Error("cannot open shared memory key '" + key + "'");
    void* base = nullptr;
    Error err = MapSharedMemory(fd, 0, byte_size, &base);
    close(fd);
    if (!err.IsOk()) return err;
    std::lock_guard<std::mutex> lk(mu_);
    shm_regions_[name] = {static_cast<uint8_t*>(base), byte_size};
    return Error::Success();
  }
  Error RegisterCudaSharedMemory(const std::string&, const std::string&,
                                 int64_t, size_t) override {
    return Error(
        "CUDA shared memory is not supported by the direct backend (no "
        "server in the in-process path)");
  }
  Error UnregisterAllSharedMemory() override {
    std::lock_guard<std::mutex> lk(mu_);
    shm_regions_.clear();
    return Error::Success();
  }

 private:
  Error GetModel(const std::string& name, DirectModel** out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = models_.find(name);
    if (it != models_.end()) {
      *out = it->second;
      return Error::Success();
    }
    DirectModel* model = nullptr;
    const char* why = nullptr;
    if (api_.create(name.c_str(), &model, &why) != 0)
      return Error(why ? why : "DirectModelCreate failed");
    models_[name] = model;
    *out = model;
    return Error::Success();
  }

  Error ModelDoc(const std::string& name, json::Value* doc) {
    DirectModel* model;
    Error err = GetModel(name, &model);
    if (!err.IsOk()) return err;
    char* raw = api_.metadata_json(model);
    if (raw == nullptr) return Error("direct library returned no metadata");
    try {
      json::Parser parser(raw, strlen(raw));
      *doc = parser.Parse();
    } catch (const json::ParseError& e) {
      api_.string_free(raw);
      return Error(std::string("bad metadata JSON from direct library: ") +
                   e.what());
    }
    api_.string_free(raw);
    return Error::Success();
  }

  Error ShmPointer(const std::string& name, size_t offset, size_t byte_size,
                   const uint8_t** base, size_t* size) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = shm_regions_.find(name);
    if (it == shm_regions_.end())
      return Error("shared memory region '" + name + "' is not registered");
    if (offset + byte_size > it->second.second)
      return Error("shared memory read exceeds region '" + name + "'");
    *base = it->second.first + offset;
    *size = byte_size ? byte_size : it->second.second - offset;
    return Error::Success();
  }

  SharedLibrary lib_;
  DirectApi api_;
  std::mutex mu_;
  std::map<std::string, DirectModel*> models_;
  std::map<std::string, std::pair<uint8_t*, size_t>> shm_regions_;
};

}  // namespace

Error CreateDirectBackend(std::unique_ptr<PerfBackend>* backend,
                          const std::string& url, bool verbose) {
  return DirectPerfBackend::Create(backend, url, verbose);
}

}  // namespace perf
}  // namespace client_tpu_torch
