#include "perf_analyzer.h"

#include <signal.h>
#include <sys/stat.h>
#include <string.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <fstream>
#include <iostream>
#include <sstream>

#include "client_tpu_torch/shm_utils.h"

namespace client_tpu_torch {
namespace perf {

std::atomic<bool> early_exit{false};

void InstallSigintHandler() {
  struct sigaction sa;
  memset(&sa, 0, sizeof(sa));
  sa.sa_handler = [](int) { early_exit = true; };
  sigaction(SIGINT, &sa, nullptr);
}

namespace {

uint64_t NowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

size_t DtypeSize(const std::string& dt) {
  if (dt == "BOOL" || dt == "INT8" || dt == "UINT8") return 1;
  if (dt == "INT16" || dt == "UINT16" || dt == "FP16" || dt == "BF16")
    return 2;
  if (dt == "INT32" || dt == "UINT32" || dt == "FP32") return 4;
  if (dt == "INT64" || dt == "UINT64" || dt == "FP64") return 8;
  return 0;
}

std::string RandomSuffix() {
  static std::atomic<uint64_t> counter{0};
  return std::to_string(getpid()) + "_" + std::to_string(counter++);
}

}  // namespace

// ------------------------------------------------------------- ModelInfo

Error ModelInfo::Parse(ModelInfo* info, PerfBackend& backend,
                       const std::string& name, const std::string& version,
                       int64_t batch_size) {
  if (backend.Kind() == BackendKind::TFSERVE) {
    // TF-Serving: the user-provided batch size is trusted as the max
    // and the signature's leading dim is the batch dim (stripped here,
    // re-added by the load generator) — parity: ref
    // model_parser.cc:217-305 InitTFServe
    json::Value meta;
    Error err = backend.ModelMetadata(&meta, name, version);
    if (!err.IsOk()) return err;
    info->name = meta.At("name").AsString();
    info->version = version;
    info->max_batch_size = batch_size;  // service errors if unsupported
    for (const auto& t : meta.At("inputs").AsArray()) {
      TensorSpec spec;
      spec.name = t.At("name").AsString();
      spec.datatype = t.At("datatype").AsString();
      const auto& dims = t.At("shape").AsArray();
      if (dims.empty())
        return Error("TF-Serving input '" + spec.name +
                     "' has no batch dim in its signature");
      for (size_t i = 1; i < dims.size(); ++i) {  // strip batch dim
        int64_t d = dims[i].AsInt();
        if (d < 0)
          return Error("TF-Serving input '" + spec.name +
                       "' has a dynamic non-batch dim; not supported");
        spec.dims.push_back(d);
      }
      info->inputs.push_back(std::move(spec));
    }
    for (const auto& t : meta.At("outputs").AsArray()) {
      TensorSpec spec;
      spec.name = t.At("name").AsString();
      spec.datatype = t.At("datatype").AsString();
      info->outputs.push_back(std::move(spec));
    }
    return Error::Success();
  }
  if (backend.Kind() == BackendKind::TORCHSERVE) {
    // TorchServe returns no model metadata; the single input holds the
    // upload file path (parity: ref model_parser.cc:307-326)
    if (batch_size > 1)
      return Error("torchserve supports batch size 1 only");
    info->name = name;
    info->version = version;
    info->max_batch_size = 0;
    TensorSpec spec;
    spec.name = "TORCHSERVE_INPUT";
    spec.datatype = "BYTES";
    spec.dims.push_back(1);
    info->inputs.push_back(std::move(spec));
    return Error::Success();
  }
  json::Value meta, config;
  Error err = backend.ModelMetadata(&meta, name, version);
  if (!err.IsOk()) return err;
  err = backend.ModelConfig(&config, name, version);
  if (!err.IsOk()) return err;

  info->name = meta.At("name").AsString();
  info->version = version;
  info->max_batch_size = config.At("max_batch_size").AsInt();
  info->decoupled =
      config.At("model_transaction_policy").At("decoupled").IsBool() &&
      config.At("model_transaction_policy").At("decoupled").AsBool();
  info->sequence = config.Has("sequence_batching");
  if (batch_size > 1 && info->max_batch_size == 0)
    return Error("model does not support batching; requested batch size " +
                 std::to_string(batch_size));
  if (info->max_batch_size > 0 && batch_size > info->max_batch_size)
    return Error("batch size exceeds max_batch_size");

  for (const auto& t : meta.At("inputs").AsArray()) {
    TensorSpec spec;
    spec.name = t.At("name").AsString();
    spec.datatype = t.At("datatype").AsString();
    const auto& dims = t.At("shape").AsArray();
    for (size_t i = 0; i < dims.size(); ++i) {
      int64_t d = dims[i].AsInt();
      if (i == 0 && info->max_batch_size > 0 && d == -1)
        continue;  // strip the metadata batch dim
      // dynamic dims (-1) survive parsing; DataGen requires a --shape
      // override to resolve them before any data is generated
      spec.dims.push_back(d);
    }
    info->inputs.push_back(std::move(spec));
  }
  for (const auto& t : meta.At("outputs").AsArray()) {
    TensorSpec spec;
    spec.name = t.At("name").AsString();
    spec.datatype = t.At("datatype").AsString();
    info->outputs.push_back(std::move(spec));
  }
  return Error::Success();
}

Error ResolveShapes(ModelInfo* info, const Options& opts) {
  // --shape overrides replace a spec's per-request dims entirely; any
  // remaining dynamic dim is an error BEFORE data generation, shm
  // sizing or replay — one resolution point so every consumer
  // (DataGen, InitFromFile, ShmSetup) sees concrete dims (parity: ref
  // main.cc --shape validation, same contract as the Python twin).
  for (auto& spec : info->inputs) {
    auto it = opts.shape_overrides.find(spec.name);
    if (it != opts.shape_overrides.end()) {
      spec.dims = it->second;
      continue;
    }
    for (int64_t d : spec.dims) {
      if (d < 0) {
        return Error("input '" + spec.name +
                     "' has dynamic shape; use --shape " + spec.name +
                     ":<dims>");
      }
    }
  }
  for (const auto& kv : opts.shape_overrides) {
    bool known = false;
    for (const auto& spec : info->inputs) known |= spec.name == kv.first;
    if (!known)
      return Error("--shape names unknown input '" + kv.first + "'");
  }
  return Error::Success();
}

// --------------------------------------------------------------- DataGen

namespace {

// JSON value array -> little-endian raw buffer for a dtype
Error JsonArrayToRaw(const json::Array& data, const std::string& dt,
                     std::vector<uint8_t>* out) {
  auto push = [&out](const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    out->insert(out->end(), b, b + n);
  };
  for (const auto& v : data) {
    if (dt == "BOOL") {
      uint8_t x = v.IsBool() ? (v.AsBool() ? 1 : 0) : (v.AsInt() ? 1 : 0);
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
      const std::string& str = v.AsString();
      uint32_t len = static_cast<uint32_t>(str.size());
      push(&len, 4);
      push(str.data(), str.size());
    } else {
      return Error("--input-data cannot convert JSON for datatype " + dt);
    }
  }
  return Error::Success();
}

}  // namespace

Error DataGen::InitFromFile(const ModelInfo& info, const Options& opts) {
  struct stat st;
  if (stat(opts.input_data.c_str(), &st) != 0) {
    return Error("--input-data path not found: " + opts.input_data);
  }
  const bool is_dir = S_ISDIR(st.st_mode);
  json::Value doc;
  const json::Object* step = nullptr;
  if (!is_dir) {
    std::ifstream f(opts.input_data);
    std::string text((std::istreambuf_iterator<char>(f)),
                     std::istreambuf_iterator<char>());
    try {
      doc = json::Parser(text.data(), text.size()).Parse();
    } catch (const std::exception& e) {
      return Error(opts.input_data + ": bad JSON: " + e.what());
    }
    if (!doc.Has("data") || !doc.At("data").IsArray() ||
        doc.At("data").AsArray().empty()) {
      return Error(opts.input_data + ": missing non-empty 'data' array");
    }
    // first stream; a stream is a step-object or a list of steps —
    // native replay uses the first step (see header note)
    const json::Value* stream = &doc.At("data").AsArray()[0];
    if (stream->IsArray()) {
      if (stream->AsArray().empty())
        return Error(opts.input_data + ": empty stream");
      stream = &stream->AsArray()[0];
    }
    if (!stream->IsObject())
      return Error(opts.input_data + ": step must be an object");
    step = &stream->AsObject();
  }

  for (const auto& spec : info.inputs) {
    Buf buf;
    buf.name = spec.name;
    buf.datatype = spec.datatype;
    int64_t elements = 1;
    if (info.max_batch_size > 0) buf.shape.push_back(opts.batch_size);
    for (int64_t d : spec.dims) buf.shape.push_back(d);  // post-resolve
    for (int64_t d : buf.shape) elements *= d;

    std::vector<uint8_t> row;  // one batch row (the step's data)
    if (is_dir) {
      // ref ReadDataFromDir: file named after the input holds raw bytes
      std::string path = opts.input_data + "/" + spec.name;
      std::ifstream f(path, std::ios::binary);
      if (!f.good()) return Error("--input-data: cannot read " + path);
      row.assign((std::istreambuf_iterator<char>(f)),
                 std::istreambuf_iterator<char>());
      if (spec.datatype == "BYTES") {
        // directory files hold ONE string element: length-prefix it
        std::vector<uint8_t> framed;
        uint32_t n = static_cast<uint32_t>(row.size());
        for (int i = 0; i < 4; ++i)
          framed.push_back(static_cast<uint8_t>((n >> (8 * i)) & 0xff));
        framed.insert(framed.end(), row.begin(), row.end());
        row = std::move(framed);
      }
    } else {
      auto it = step->find(spec.name);
      if (it == step->end())
        return Error("--input-data: no entry for input '" + spec.name +
                     "'");
      const json::Value& val = it->second;
      const json::Value* content = &val;
      if (val.IsObject()) {
        if (val.Has("b64")) {
          std::string decoded;
          Error err = Base64Decode(val.At("b64").AsString(), &decoded);
          row.assign(decoded.begin(), decoded.end());
          if (!err.IsOk()) return err;
        } else if (val.Has("content")) {
          content = &val.At("content");
        } else {
          return Error("--input-data: unsupported value object for '" +
                       spec.name + "'");
        }
      }
      if (row.empty() && content->IsArray()) {
        Error err =
            JsonArrayToRaw(content->AsArray(), spec.datatype, &row);
        if (!err.IsOk()) return err;
      } else if (row.empty()) {
        return Error("--input-data: value for '" + spec.name +
                     "' must be an array or {b64: ...}");
      }
    }

    // size validation: a short payload must fail here with a clear
    // message, not as an opaque server-side byte-size error
    if (spec.datatype != "BYTES") {
      size_t per_row = 1;
      for (int64_t d : spec.dims) per_row *= static_cast<size_t>(d);
      per_row *= DtypeSize(spec.datatype);
      if (row.size() != per_row) {
        return Error("--input-data: input '" + spec.name + "' needs " +
                     std::to_string(per_row) + " bytes per batch row, " +
                     "got " + std::to_string(row.size()));
      }
    }
    (void)elements;
    // tile the row across the batch (the loader stacks batch copies,
    // ref load_manager InitManagerInputs semantics)
    int64_t copies =
        (info.max_batch_size > 0) ? std::max<int64_t>(opts.batch_size, 1)
                                  : 1;
    buf.data.reserve(row.size() * copies);
    for (int64_t i = 0; i < copies; ++i)
      buf.data.insert(buf.data.end(), row.begin(), row.end());
    buf.nbytes = buf.data.size();
    if (spec.datatype == "BYTES") {
      // reconstruct strings for the non-shm AppendFromString path
      size_t off = 0;
      while (off + 4 <= buf.data.size()) {
        uint32_t n = buf.data[off] | (buf.data[off + 1] << 8) |
                     (buf.data[off + 2] << 16) | (buf.data[off + 3] << 24);
        off += 4;
        if (off + n > buf.data.size())
          return Error("--input-data: malformed BYTES framing for '" +
                       spec.name + "'");
        buf.strings.emplace_back(
            reinterpret_cast<const char*>(buf.data.data() + off), n);
        off += n;
      }
    }
    bufs_.push_back(std::move(buf));
  }
  return Error::Success();
}

Error DataGen::Init(const ModelInfo& info, const Options& opts,
                    unsigned seed) {
  const int64_t batch_size = opts.batch_size;
  const bool zero_data = opts.zero_data;
  const size_t string_length = opts.string_length;
  if (!opts.input_data.empty()) return InitFromFile(info, opts);
  std::mt19937 rng(seed);
  for (const auto& spec : info.inputs) {
    Buf buf;
    buf.name = spec.name;
    buf.datatype = spec.datatype;
    int64_t elements = 1;
    if (info.max_batch_size > 0) buf.shape.push_back(batch_size);
    for (int64_t d : spec.dims) {  // resolved by ResolveShapes
      buf.shape.push_back(d);
    }
    for (int64_t d : buf.shape) elements *= d;
    if (spec.datatype == "BYTES") {
      static const char alphabet[] =
          "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz";
      std::uniform_int_distribution<size_t> pick(0, sizeof(alphabet) - 2);
      size_t total = 0;
      for (int64_t i = 0; i < elements; ++i) {
        // --string-data: every element is the given payload (parity:
        // ref main.cc string_data); else random/zeroed string_length
        std::string s;
        if (!opts.string_data.empty()) {
          s = opts.string_data;
        } else {
          for (size_t j = 0; j < string_length; ++j)
            s += zero_data ? 'a' : alphabet[pick(rng)];
        }
        total += 4 + s.size();
        buf.strings.push_back(std::move(s));
      }
      buf.nbytes = total;
      // also keep the 4-byte-LE-length-prefixed serialization: shm modes
      // memcpy InputData() for nbytes bytes, which would otherwise read
      // past the empty vector
      buf.data.reserve(total);
      for (const auto& s : buf.strings) {
        uint32_t n = static_cast<uint32_t>(s.size());
        buf.data.push_back(static_cast<uint8_t>(n & 0xff));
        buf.data.push_back(static_cast<uint8_t>((n >> 8) & 0xff));
        buf.data.push_back(static_cast<uint8_t>((n >> 16) & 0xff));
        buf.data.push_back(static_cast<uint8_t>((n >> 24) & 0xff));
        buf.data.insert(buf.data.end(), s.begin(), s.end());
      }
    } else {
      size_t bytes = elements * DtypeSize(spec.datatype);
      buf.data.resize(bytes);
      buf.nbytes = bytes;
      if (!zero_data) {
        std::uniform_int_distribution<int> byte(0, 127);
        for (auto& b : buf.data) b = static_cast<uint8_t>(byte(rng));
      }
    }
    bufs_.push_back(std::move(buf));
  }
  return Error::Success();
}

std::vector<InferInput*> DataGen::MakeInputs() {
  std::vector<InferInput*> inputs;
  for (auto& buf : bufs_) {
    InferInput* input = nullptr;
    InferInput::Create(&input, buf.name, buf.shape, buf.datatype);
    if (buf.datatype == "BYTES") {
      input->AppendFromString(buf.strings);
    } else {
      input->AppendRaw(buf.data.data(), buf.data.size());
    }
    owned_.push_back(input);
    inputs.push_back(input);
  }
  return inputs;
}

DataGen::~DataGen() {
  for (InferInput* i : owned_) delete i;
}

// -------------------------------------------------------------- ShmSetup

Error ShmSetup::Init(const Options& opts, const ModelInfo& info,
                     DataGen& gen, PerfBackend& backend) {
  cuda_ = (opts.shared_memory == "cuda");
  output_shm_size_ = opts.output_shm_size;
  for (size_t i = 0; i < info.inputs.size(); ++i) {
    const auto& spec = info.inputs[i];
    Region region;
    region.name = "perf_in_" + spec.name;
    region.byte_size = gen.InputByteSize(i);
    input_sizes_.push_back(region.byte_size);
    input_names_.push_back(spec.name);
    input_dtypes_.push_back(spec.datatype);
    std::vector<int64_t> shape;
    if (info.max_batch_size > 0) shape.push_back(opts.batch_size);
    for (int64_t d : spec.dims) shape.push_back(d);
    input_shapes_.push_back(shape);
    if (cuda_) {
      Error err = CudaShmCreate(&region.cuda, region.name, region.byte_size, 0,
                                opts.shm_device);
      if (!err.IsOk()) return err;
      err = CudaShmSet(*region.cuda, 0, gen.InputData(i), region.byte_size);
      if (!err.IsOk()) return err;
      std::string raw;
      CudaShmGetRawHandle(*region.cuda, &raw);
      err = backend.RegisterCudaSharedMemory(
          region.name, raw, region.cuda->DeviceId(), region.byte_size);
      if (!err.IsOk()) return err;
    } else {
      region.key = "/" + region.name + "_" + RandomSuffix();
      Error err = CreateSharedMemoryRegion(region.key, region.byte_size,
                                           &region.fd);
      if (!err.IsOk()) return err;
      void* addr = nullptr;
      err = MapSharedMemory(region.fd, 0, region.byte_size, &addr);
      if (!err.IsOk()) return err;
      region.base = static_cast<uint8_t*>(addr);
      memcpy(region.base, gen.InputData(i), region.byte_size);
      err = backend.RegisterSystemSharedMemory(region.name, region.key,
                                               region.byte_size);
      if (!err.IsOk()) return err;
    }
    input_regions_.push_back(std::move(region));
  }
  for (const auto& spec : info.outputs) {
    Region region;
    region.name = "perf_out_" + spec.name;
    region.byte_size = output_shm_size_;
    output_names_.push_back(spec.name);
    if (cuda_) {
      Error err = CudaShmCreate(&region.cuda, region.name, region.byte_size, 0,
                                opts.shm_device);
      if (!err.IsOk()) return err;
      std::string raw;
      CudaShmGetRawHandle(*region.cuda, &raw);
      err = backend.RegisterCudaSharedMemory(
          region.name, raw, region.cuda->DeviceId(), region.byte_size);
      if (!err.IsOk()) return err;
    } else {
      region.key = "/" + region.name + "_" + RandomSuffix();
      Error err = CreateSharedMemoryRegion(region.key, region.byte_size,
                                           &region.fd);
      if (!err.IsOk()) return err;
      void* addr = nullptr;
      err = MapSharedMemory(region.fd, 0, region.byte_size, &addr);
      if (!err.IsOk()) return err;
      region.base = static_cast<uint8_t*>(addr);
      err = backend.RegisterSystemSharedMemory(region.name, region.key,
                                               region.byte_size);
      if (!err.IsOk()) return err;
    }
    output_regions_.push_back(std::move(region));
  }
  return Error::Success();
}

std::vector<InferInput*> ShmSetup::MakeInputs() {
  std::vector<InferInput*> inputs;
  for (size_t i = 0; i < input_regions_.size(); ++i) {
    InferInput* input = nullptr;
    InferInput::Create(&input, input_names_[i], input_shapes_[i],
                       input_dtypes_[i]);
    input->SetSharedMemory(input_regions_[i].name, input_sizes_[i]);
    inputs.push_back(input);  // caller owns
  }
  return inputs;
}

std::vector<const InferRequestedOutput*> ShmSetup::MakeOutputs() {
  std::vector<const InferRequestedOutput*> outputs;
  for (size_t i = 0; i < output_regions_.size(); ++i) {
    InferRequestedOutput* output = nullptr;
    InferRequestedOutput::Create(&output, output_names_[i]);
    output->SetSharedMemory(output_regions_[i].name, output_shm_size_);
    outputs.push_back(output);  // caller owns
  }
  return outputs;
}

void ShmSetup::Cleanup(PerfBackend& backend) {
  backend.UnregisterAllSharedMemory();
}

ShmSetup::~ShmSetup() {
  for (auto* regions : {&input_regions_, &output_regions_}) {
    for (auto& r : *regions) {
      if (r.base != nullptr) UnmapSharedMemory(r.base, r.byte_size);
      if (r.fd >= 0) {
        CloseSharedMemory(r.fd);
        UnlinkSharedMemoryRegion(r.key);
      }
      // r.cuda unlinks itself in its destructor
    }
  }
}

// ----------------------------------------------------------- LoadManager

LoadManager::LoadManager(const Options& opts, const ModelInfo& info,
                         const BackendFactory& factory, ShmSetup* shm)
    : opts_(opts), info_(info), factory_(factory), shm_(shm) {
  next_seq_id_ = opts.sequence_id_start;
  if (info.sequence) {
    for (int i = 0; i < opts.num_of_sequences; ++i) {
      sequences_.emplace_back(new SequenceStat());
    }
  }
}

LoadManager::~LoadManager() { Stop(); }

void LoadManager::Stop() {
  stop_ = true;
  for (auto& t : threads_)
    if (t.joinable()) t.join();
  threads_.clear();
  stats_.clear();
  stop_ = false;
}

std::vector<InferInput*> LoadManager::MakeInputs(DataGen* gen) {
  if (shm_ != nullptr) return shm_->MakeInputs();
  return gen->MakeInputs();  // gen owns these
}

std::vector<const InferRequestedOutput*> LoadManager::MakeOutputs() {
  if (shm_ != nullptr) return shm_->MakeOutputs();
  return {};
}

void LoadManager::SequenceOptions(int slot, InferOptions* options) {
  SequenceStat& seq = *sequences_[slot % sequences_.size()];
  std::lock_guard<std::mutex> lock(seq.mutex);
  if (seq.remaining == 0) {
    {
      std::lock_guard<std::mutex> idlock(seq_id_mutex_);
      seq.seq_id = next_seq_id_++;
      if (opts_.sequence_id_end > 0 &&
          next_seq_id_ >= opts_.sequence_id_end) {
        next_seq_id_ = opts_.sequence_id_start;
      }
      // length jitter +/-20% (parity: ref GetRandomLength)
      int jitter = opts_.sequence_length / 5;
      seq.remaining = std::max(
          1, opts_.sequence_length +
                 (jitter > 0 ? static_cast<int>(seq_rng_() % (2 * jitter + 1))
                                   - jitter
                             : 0));
    }
    options->sequence_start = true;
  } else {
    options->sequence_start = false;
  }
  options->sequence_id = seq.seq_id;
  seq.remaining--;
  options->sequence_end = (seq.remaining == 0);
}

void LoadManager::DrainSequences(PerfBackend& backend, ThreadStat* stat) {
  // graceful early exit: close live sequences
  // (parity: ref concurrency_manager.cc:228-284)
  if (sequences_.empty()) return;
  DataGen gen;
  gen.Init(info_, opts_, 7);
  std::vector<InferInput*> inputs = MakeInputs(&gen);
  std::vector<const InferRequestedOutput*> outputs = MakeOutputs();
  for (auto& seq_ptr : sequences_) {
    SequenceStat& seq = *seq_ptr;
    std::lock_guard<std::mutex> lock(seq.mutex);
    if (seq.remaining > 0) {
      InferOptions options(info_.name);
      options.model_version = info_.version;
      options.sequence_id = seq.seq_id;
      options.sequence_end = true;
      seq.remaining = 0;
      InferResult* result = nullptr;
      backend.Infer(&result, options, inputs, outputs);
      delete result;
    }
  }
  if (shm_ != nullptr) {
    for (auto* i : inputs) delete i;
    for (auto* o : outputs) delete o;
  }
}

void LoadManager::ChangeConcurrency(int concurrency) {
  Stop();
  if (opts_.async_mode || opts_.streaming) {
    int n_threads = std::min(opts_.max_threads, concurrency);
    int share = concurrency / n_threads;
    int extra = concurrency % n_threads;
    for (int i = 0; i < n_threads; ++i) {
      int slots = share + (i < extra ? 1 : 0);
      if (slots == 0) continue;
      stats_.emplace_back(new ThreadStat());
      if (opts_.streaming) {
        threads_.emplace_back(&LoadManager::StreamWorker, this,
                              stats_.back().get(), slots, i);
      } else {
        threads_.emplace_back(&LoadManager::AsyncWorker, this,
                              stats_.back().get(), slots, i);
      }
    }
  } else {
    for (int i = 0; i < concurrency; ++i) {
      stats_.emplace_back(new ThreadStat());
      threads_.emplace_back(&LoadManager::SyncWorker, this,
                            stats_.back().get(), i);
    }
  }
}

Error LoadManager::ChangeRequestRate(double rate) {
  Stop();
  // schedule covering max(2x window, 1s)
  // (parity: ref request_rate_manager.cc:117 GenerateSchedule)
  gen_duration_ns_ = static_cast<uint64_t>(
      std::max(2.0 * opts_.measurement_interval_ms / 1e3, 1.0) * 1e9);
  std::mt19937 rng(0);
  std::exponential_distribution<double> expo(rate);
  const double gap = 1e9 / rate;
  schedule_.clear();
  double t = 0;
  while (t < gen_duration_ns_) {
    t += opts_.poisson ? expo(rng) * 1e9 : gap;
    schedule_.push_back(static_cast<uint64_t>(t));
  }
  size_t n_threads = std::min<size_t>(8, schedule_.size());
  for (size_t i = 0; i < n_threads; ++i) {
    stats_.emplace_back(new ThreadStat());
    threads_.emplace_back(&LoadManager::RateWorker, this,
                          stats_.back().get(), i, n_threads);
  }
  return Error::Success();
}

Error LoadManager::InitCustomIntervals(double* rate) {
  // replay user-supplied inter-request intervals
  // (parity: ref custom_load_manager.cc:64 InitCustomIntervals)
  Stop();
  std::ifstream f(opts_.request_intervals_file);
  if (!f) {
    return Error("cannot read intervals file: " +
                 opts_.request_intervals_file);
  }
  schedule_.clear();
  uint64_t t = 0, interval_ns = 0, sum = 0;
  size_t n = 0;
  while (f >> interval_ns) {
    t += interval_ns;
    sum += interval_ns;
    ++n;
    schedule_.push_back(t);
  }
  if (schedule_.empty()) return Error("intervals file is empty");
  gen_duration_ns_ = t;
  *rate = n / (sum / 1e9);
  size_t n_threads = std::min<size_t>(8, schedule_.size());
  for (size_t i = 0; i < n_threads; ++i) {
    stats_.emplace_back(new ThreadStat());
    threads_.emplace_back(&LoadManager::RateWorker, this,
                          stats_.back().get(), i, n_threads);
  }
  return Error::Success();
}

void LoadManager::SyncWorker(ThreadStat* stat, int slot_base) {
  std::unique_ptr<PerfBackend> backend;
  Error err = factory_.Create(&backend);
  if (!err.IsOk()) {
    std::lock_guard<std::mutex> lk(stat->mutex);
    stat->error = err.Message();
    return;
  }
  DataGen gen;
  gen.Init(info_, opts_,
           static_cast<unsigned>(slot_base + 1));
  std::vector<InferInput*> inputs = MakeInputs(&gen);
  std::vector<const InferRequestedOutput*> outputs = MakeOutputs();
  InferOptions options(info_.name);
  options.model_version = info_.version;

  while (!stop_ && !early_exit) {
    if (!sequences_.empty()) SequenceOptions(slot_base, &options);
    InferResult* result = nullptr;
    uint64_t start = NowNs();
    err = backend->Infer(&result, options, inputs, outputs);
    uint64_t end = NowNs();
    if (!err.IsOk() || !result->RequestStatus().IsOk()) {
      std::lock_guard<std::mutex> lk(stat->mutex);
      stat->error = err.IsOk() ? result->RequestStatus().Message()
                               : err.Message();
      delete result;
      break;
    }
    delete result;
    std::lock_guard<std::mutex> lk(stat->mutex);
    stat->timestamps.push_back({start, end, options.sequence_end, false});
  }
  if (early_exit) DrainSequences(*backend, stat);
  if (shm_ != nullptr) {
    for (auto* i : inputs) delete i;
    for (auto* o : outputs) delete o;
  }
}

void LoadManager::AsyncWorker(ThreadStat* stat, int slots, int widx) {
  std::unique_ptr<PerfBackend> backend;
  Error err = factory_.Create(&backend);
  if (!err.IsOk()) {
    std::lock_guard<std::mutex> lk(stat->mutex);
    stat->error = err.Message();
    return;
  }
  DataGen gen;
  gen.Init(info_, opts_,
           static_cast<unsigned>(widx + 101));
  std::vector<InferInput*> inputs = MakeInputs(&gen);
  std::vector<const InferRequestedOutput*> outputs = MakeOutputs();

  std::mutex mu;
  std::condition_variable cv;
  int inflight = 0;
  int ctx = 0;

  while (!stop_ && !early_exit) {
    {
      std::unique_lock<std::mutex> lock(mu);
      cv.wait_for(lock, std::chrono::milliseconds(100),
                  [&] { return inflight < slots || stop_ || early_exit; });
      if (stop_ || early_exit || inflight >= slots) continue;
      ++inflight;
    }
    InferOptions options(info_.name);
    options.model_version = info_.version;
    if (!sequences_.empty()) {
      SequenceOptions(widx * slots + (ctx++ % std::max(1, slots)),
                      &options);
    }
    uint64_t start = NowNs();
    bool seq_end = options.sequence_end;
    err = backend->AsyncInfer(
        [this, stat, start, seq_end, &mu, &cv, &inflight](
            InferResult* result) {
          uint64_t end = NowNs();
          if (result != nullptr && !result->RequestStatus().IsOk()) {
            std::lock_guard<std::mutex> lk(stat->mutex);
            stat->error = result->RequestStatus().Message();
          } else {
            std::lock_guard<std::mutex> lk(stat->mutex);
            stat->timestamps.push_back({start, end, seq_end, false});
          }
          delete result;
          {
            std::lock_guard<std::mutex> lock(mu);
            --inflight;
          }
          cv.notify_one();
        },
        options, inputs, outputs);
    if (!err.IsOk()) {
      {
        std::lock_guard<std::mutex> lock(mu);
        --inflight;
      }
      std::lock_guard<std::mutex> lk(stat->mutex);
      stat->error = err.Message();
      break;
    }
  }
  {
    // drain in-flight before the backend (and its callbacks) go away
    std::unique_lock<std::mutex> lock(mu);
    cv.wait_for(lock, std::chrono::seconds(30),
                [&] { return inflight == 0; });
  }
  if (early_exit) DrainSequences(*backend, stat);
  if (shm_ != nullptr) {
    for (auto* i : inputs) delete i;
    for (auto* o : outputs) delete o;
  }
}

void LoadManager::StreamWorker(ThreadStat* stat, int slots, int widx) {
  std::unique_ptr<PerfBackend> backend;
  Error err = factory_.Create(&backend);
  if (!err.IsOk()) {
    std::lock_guard<std::mutex> lk(stat->mutex);
    stat->error = err.Message();
    return;
  }
  DataGen gen;
  gen.Init(info_, opts_,
           static_cast<unsigned>(widx + 201));
  std::vector<InferInput*> inputs = MakeInputs(&gen);
  std::vector<const InferRequestedOutput*> outputs = MakeOutputs();

  std::mutex mu;
  std::condition_variable cv;
  int inflight = 0;
  std::map<std::string, std::pair<uint64_t, bool>> pending;  // id->start

  err = backend->StartStream([&](InferResult* result) {
    uint64_t end = NowNs();
    std::string id;
    uint64_t start = end;
    bool seq_end = false;
    if (result != nullptr) {
      result->Id(&id);
      std::lock_guard<std::mutex> lock(mu);
      auto it = pending.find(id);
      if (it != pending.end()) {
        start = it->second.first;
        seq_end = it->second.second;
        pending.erase(it);
      }
    }
    if (result != nullptr && !result->RequestStatus().IsOk()) {
      std::lock_guard<std::mutex> lk(stat->mutex);
      stat->error = result->RequestStatus().Message();
    } else {
      std::lock_guard<std::mutex> lk(stat->mutex);
      stat->timestamps.push_back({start, end, seq_end, false});
    }
    delete result;
    {
      std::lock_guard<std::mutex> lock(mu);
      --inflight;
    }
    cv.notify_one();
  });
  if (!err.IsOk()) {
    std::lock_guard<std::mutex> lk(stat->mutex);
    stat->error = err.Message();
    return;
  }

  uint64_t rid = 0;
  while (!stop_ && !early_exit) {
    {
      std::unique_lock<std::mutex> lock(mu);
      cv.wait_for(lock, std::chrono::milliseconds(100),
                  [&] { return inflight < slots || stop_ || early_exit; });
      if (stop_ || early_exit || inflight >= slots) continue;
      ++inflight;
    }
    InferOptions options(info_.name);
    options.model_version = info_.version;
    options.request_id = "s" + std::to_string(widx) + "_" +
                         std::to_string(rid++);
    if (!sequences_.empty()) SequenceOptions(widx, &options);
    {
      std::lock_guard<std::mutex> lock(mu);
      pending[options.request_id] = {NowNs(), options.sequence_end};
    }
    err = backend->AsyncStreamInfer(options, inputs, outputs);
    if (!err.IsOk()) {
      {
        std::lock_guard<std::mutex> lock(mu);
        --inflight;
        pending.erase(options.request_id);
      }
      std::lock_guard<std::mutex> lk(stat->mutex);
      stat->error = err.Message();
      break;
    }
  }
  {
    std::unique_lock<std::mutex> lock(mu);
    cv.wait_for(lock, std::chrono::seconds(30),
                [&] { return inflight == 0; });
  }
  backend->StopStream();
  if (early_exit) DrainSequences(*backend, stat);
  if (shm_ != nullptr) {
    for (auto* i : inputs) delete i;
    for (auto* o : outputs) delete o;
  }
}

void LoadManager::RateWorker(ThreadStat* stat, size_t offset,
                             size_t stride) {
  std::unique_ptr<PerfBackend> backend;
  Error err = factory_.Create(&backend);
  if (!err.IsOk()) {
    std::lock_guard<std::mutex> lk(stat->mutex);
    stat->error = err.Message();
    return;
  }
  DataGen gen;
  gen.Init(info_, opts_,
           static_cast<unsigned>(offset));
  std::vector<InferInput*> inputs = MakeInputs(&gen);
  std::vector<const InferRequestedOutput*> outputs = MakeOutputs();
  InferOptions options(info_.name);
  options.model_version = info_.version;

  const uint64_t start_time = NowNs();
  size_t index = offset;
  constexpr uint64_t kDelayedNs = 10'000'000;  // late by >10ms => delayed

  while (!stop_ && !early_exit) {
    const uint64_t wrap =
        (index / schedule_.size()) * gen_duration_ns_;
    const uint64_t target =
        start_time + wrap + schedule_[index % schedule_.size()];
    index += stride;
    // sleep in slices so Stop() is observed within ~50ms even when the
    // schedule gap is seconds long
    while (!stop_ && !early_exit && NowNs() < target) {
      const uint64_t remain = target - NowNs();
      std::this_thread::sleep_for(std::chrono::nanoseconds(
          std::min<uint64_t>(remain, 50'000'000)));
    }
    if (stop_ || early_exit) break;
    const bool delayed = NowNs() > target + kDelayedNs;
    if (!sequences_.empty()) {
      SequenceOptions(static_cast<int>(offset), &options);
    }
    InferResult* result = nullptr;
    uint64_t start = NowNs();
    err = backend->Infer(&result, options, inputs, outputs);
    uint64_t end = NowNs();
    if (!err.IsOk() || !result->RequestStatus().IsOk()) {
      std::lock_guard<std::mutex> lk(stat->mutex);
      stat->error = err.IsOk() ? result->RequestStatus().Message()
                               : err.Message();
      delete result;
      break;
    }
    delete result;
    std::lock_guard<std::mutex> lk(stat->mutex);
    stat->timestamps.push_back({start, end, options.sequence_end, delayed});
  }
  if (early_exit) DrainSequences(*backend, stat);
  if (shm_ != nullptr) {
    for (auto* i : inputs) delete i;
    for (auto* o : outputs) delete o;
  }
}

std::vector<Timestamp> LoadManager::SwapTimestamps() {
  std::vector<Timestamp> out;
  for (auto& stat : stats_) {
    std::lock_guard<std::mutex> lk(stat->mutex);
    out.insert(out.end(), stat->timestamps.begin(),
               stat->timestamps.end());
    stat->timestamps.clear();
  }
  return out;
}

Error LoadManager::CheckHealth() {
  for (auto& stat : stats_) {
    std::lock_guard<std::mutex> lk(stat->mutex);
    if (!stat->error.empty())
      return Error("worker thread failed: " + stat->error);
  }
  return Error::Success();
}

// -------------------------------------------------------------- Profiler

Profiler::Profiler(const Options& opts, const ModelInfo& info,
                   LoadManager& manager, PerfBackend& backend)
    : opts_(opts), info_(info), manager_(manager), backend_(backend) {}

std::vector<PerfStatus> Profiler::ProfileConcurrencyRange() {
  std::vector<PerfStatus> results;
  if (opts_.binary_search && opts_.latency_threshold_us > 0 &&
      opts_.concurrency_end > opts_.concurrency_start) {
    // --binary-search (parity: ref main.cc search_mode): bisect
    // [start, end] for the highest concurrency whose stabilized
    // latency stays under -l; every probed point is reported
    const double limit = static_cast<double>(opts_.latency_threshold_us);
    auto measure = [&](int c) {
      manager_.ChangeConcurrency(c);
      PerfStatus status = Stabilize();
      status.concurrency = c;
      results.push_back(status);
      return StabilityLatency(status) <= limit;
    };
    int lo = opts_.concurrency_start, hi = opts_.concurrency_end;
    if (!early_exit && measure(lo)) {
      if (!early_exit && measure(hi)) {
        lo = hi;  // even the top of the range meets the threshold
      } else {
        while (!early_exit && hi - lo > std::max(1, opts_.concurrency_step)) {
          int mid = lo + (hi - lo) / 2;
          if (measure(mid)) lo = mid; else hi = mid;
        }
      }
    }
    manager_.Stop();
    return results;
  }
  for (int c = opts_.concurrency_start; c <= opts_.concurrency_end;
       c += opts_.concurrency_step) {
    if (early_exit) break;
    manager_.ChangeConcurrency(c);
    PerfStatus status = Stabilize();
    status.concurrency = c;
    results.push_back(status);
    if (opts_.latency_threshold_us > 0 &&
        StabilityLatency(status) >
            static_cast<double>(opts_.latency_threshold_us))
      break;
  }
  manager_.Stop();
  return results;
}

std::vector<PerfStatus> Profiler::ProfileRateRange() {
  std::vector<PerfStatus> results;
  for (double r = opts_.rate_start; r <= opts_.rate_end + 1e-9;
       r += opts_.rate_step) {
    if (early_exit) break;
    manager_.ChangeRequestRate(r);
    PerfStatus status = Stabilize();
    status.request_rate = r;
    results.push_back(status);
    if (opts_.latency_threshold_us > 0 &&
        StabilityLatency(status) >
            static_cast<double>(opts_.latency_threshold_us))
      break;
    if (opts_.rate_step <= 0) break;
  }
  manager_.Stop();
  return results;
}

std::vector<PerfStatus> Profiler::ProfileCustom() {
  std::vector<PerfStatus> results;
  double rate = 0;
  Error err = manager_.InitCustomIntervals(&rate);
  if (!err.IsOk()) {
    std::cerr << "error: " << err.Message() << std::endl;
    return results;
  }
  PerfStatus status = Stabilize();
  status.request_rate = rate;
  results.push_back(status);
  manager_.Stop();
  return results;
}

double Profiler::StabilityLatency(const PerfStatus& s) const {
  if (opts_.stability_percentile > 0) {
    auto it = s.latency.percentile_us.find(opts_.stability_percentile);
    if (it != s.latency.percentile_us.end()) return it->second;
  }
  return s.latency.avg_us;
}

PerfStatus Profiler::Stabilize() {
  // sliding window of 3, both infer/s and latency within the threshold
  // (parity: ref inference_profiler.cc:557-681 ProfileHelper)
  std::vector<PerfStatus> window;
  PerfStatus last;
  for (int trial = 0; trial < opts_.max_trials && !early_exit; ++trial) {
    Error err = manager_.CheckHealth();
    if (!err.IsOk()) {
      std::cerr << "error: " << err.Message() << std::endl;
      return last;
    }
    PerfStatus status = Measure();
    last = status;
    if (status.valid_count == 0) continue;
    window.push_back(status);
    if (window.size() > 3) window.erase(window.begin());
    if (opts_.latency_threshold_us > 0 &&
        StabilityLatency(status) >
            static_cast<double>(opts_.latency_threshold_us))
      return status;  // over threshold: stop early
    if (window.size() == 3) {
      double avg_ips = 0, avg_lat = 0;
      for (const auto& w : window) {
        avg_ips += w.infer_per_sec;
        avg_lat += StabilityLatency(w);
      }
      avg_ips /= 3;
      avg_lat /= 3;
      bool stable = avg_ips > 0 && avg_lat > 0;
      for (const auto& w : window) {
        if (std::abs(w.infer_per_sec - avg_ips) / avg_ips >
                opts_.stability_threshold ||
            std::abs(StabilityLatency(w) - avg_lat) / avg_lat >
                opts_.stability_threshold)
          stable = false;
      }
      if (stable) {
        last.stabilized = true;
        return last;
      }
    }
  }
  return last;
}

bool Profiler::FetchServerSnapshot(ServerSideStats* out) {
  json::Value stats;
  if (!backend_.ModelStatistics(&stats, info_.name).IsOk()) return false;
  const auto& arr = stats.At("model_stats").AsArray();
  if (arr.empty()) return false;
  const auto& m = arr[0];
  out->inference_count = m.At("inference_count").AsInt();
  out->execution_count = m.At("execution_count").AsInt();
  const auto& is = m.At("inference_stats");
  auto ns_of = [&is](const char* key) -> int64_t {
    return is.At(key).At("ns").AsInt();
  };
  // store raw sums in the *_us fields temporarily; Measure() converts the
  // deltas to per-request averages
  out->queue_us = static_cast<double>(ns_of("queue"));
  out->compute_input_us = static_cast<double>(ns_of("compute_input"));
  out->compute_infer_us = static_cast<double>(ns_of("compute_infer"));
  out->compute_output_us = static_cast<double>(ns_of("compute_output"));
  return true;
}

PerfStatus Profiler::Measure() {
  ServerSideStats before, after;
  bool have_server = FetchServerSnapshot(&before);

  std::vector<Timestamp> timestamps;
  const uint64_t window_start = NowNs();
  if (opts_.count_windows) {
    // poll until enough requests collected, cap at 10x the window
    // (parity: ref inference_profiler.cc:718-748 count windows)
    const uint64_t deadline =
        window_start +
        static_cast<uint64_t>(opts_.measurement_interval_ms) * 10 * 1000000;
    size_t collected = 0;
    while (collected < static_cast<size_t>(opts_.measurement_request_count)
           && NowNs() < deadline && !early_exit) {
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
      std::vector<Timestamp> batch = manager_.SwapTimestamps();
      collected += batch.size();
      timestamps.insert(timestamps.end(), batch.begin(), batch.end());
    }
  } else {
    const uint64_t deadline =
        window_start +
        static_cast<uint64_t>(opts_.measurement_interval_ms) * 1000000;
    while (NowNs() < deadline && !early_exit) {
      std::this_thread::sleep_for(std::chrono::milliseconds(
          std::min<int64_t>(50, (deadline - NowNs()) / 1000000 + 1)));
    }
  }
  const uint64_t window_end = NowNs();

  have_server = have_server && FetchServerSnapshot(&after);
  {
    std::vector<Timestamp> tail = manager_.SwapTimestamps();
    timestamps.insert(timestamps.end(), tail.begin(), tail.end());
  }

  PerfStatus status;
  const double window_s = (window_end - window_start) / 1e9;
  std::vector<double> lat_us;
  int seq_ends = 0;
  for (const auto& ts : timestamps) {
    if (ts.start_ns < window_start || ts.end_ns > window_end)
      continue;  // only requests fully inside the window
    if (ts.delayed) {
      status.delayed_count++;
      continue;  // excluded from rate conclusions
    }
    status.valid_count++;
    if (ts.sequence_end) ++seq_ends;
    lat_us.push_back((ts.end_ns - ts.start_ns) / 1e3);
  }
  status.infer_per_sec =
      status.valid_count * static_cast<double>(opts_.batch_size) / window_s;
  status.sequence_per_sec = seq_ends / window_s;

  if (!lat_us.empty()) {
    std::sort(lat_us.begin(), lat_us.end());
    const size_t n = lat_us.size();
    double sum = 0;
    for (double v : lat_us) sum += v;
    status.latency.avg_us = sum / n;
    double var = 0;
    for (double v : lat_us)
      var += (v - status.latency.avg_us) * (v - status.latency.avg_us);
    status.latency.std_us = n > 1 ? std::sqrt(var / n) : 0;
    status.latency.min_us = lat_us.front();
    status.latency.max_us = lat_us.back();
    std::vector<int> pcts = {50, 90, 95, 99};
    if (opts_.stability_percentile > 0 &&
        std::find(pcts.begin(), pcts.end(), opts_.stability_percentile) ==
            pcts.end()) {
      pcts.push_back(opts_.stability_percentile);
    }
    for (int p : pcts) {
      size_t idx = std::min(
          n - 1, static_cast<size_t>(std::max(
                     0.0, std::ceil(p / 100.0 * n) - 1)));
      status.latency.percentile_us[p] = lat_us[idx];
    }
  }

  if (have_server) {
    status.server.inference_count =
        after.inference_count - before.inference_count;
    status.server.execution_count =
        after.execution_count - before.execution_count;
    const double reqs =
        std::max<int64_t>(1, status.server.inference_count);
    status.server.queue_us = (after.queue_us - before.queue_us) / reqs / 1e3;
    status.server.compute_input_us =
        (after.compute_input_us - before.compute_input_us) / reqs / 1e3;
    status.server.compute_infer_us =
        (after.compute_infer_us - before.compute_infer_us) / reqs / 1e3;
    status.server.compute_output_us =
        (after.compute_output_us - before.compute_output_us) / reqs / 1e3;
  }
  return status;
}

// ---------------------------------------------------------------- report

void PrintReport(const std::vector<PerfStatus>& results,
                 const ModelInfo& info, bool concurrency_mode) {
  std::cout << "*** Measurement Results: " << info.name << " ***"
            << std::endl;
  for (const auto& r : results) {
    if (concurrency_mode)
      std::cout << "\nConcurrency: " << r.concurrency << std::endl;
    else
      std::cout << "\nRequest Rate: " << r.request_rate << std::endl;
    if (!r.stabilized)
      std::cout << "  [WARNING] measurement did not stabilize" << std::endl;
    std::cout << "  Request count: " << r.valid_count << std::endl;
    if (r.delayed_count)
      std::cout << "  Delayed request count: " << r.delayed_count
                << std::endl;
    std::cout << "  Throughput: " << r.infer_per_sec << " infer/sec"
              << std::endl;
    if (info.sequence)
      std::cout << "  Sequence throughput: " << r.sequence_per_sec
                << " seq/sec" << std::endl;
    std::cout << "  Avg latency: " << static_cast<int64_t>(r.latency.avg_us)
              << " usec (std " << static_cast<int64_t>(r.latency.std_us)
              << " usec)" << std::endl;
    for (const auto& kv : r.latency.percentile_us)
      std::cout << "  p" << kv.first << " latency: "
                << static_cast<int64_t>(kv.second) << " usec" << std::endl;
    if (r.server.inference_count) {
      std::cout << "  Server inference count: " << r.server.inference_count
                << std::endl;
      std::cout << "  Server queue: "
                << static_cast<int64_t>(r.server.queue_us) << " usec"
                << std::endl;
      std::cout << "  Server compute input: "
                << static_cast<int64_t>(r.server.compute_input_us)
                << " usec" << std::endl;
      std::cout << "  Server compute infer: "
                << static_cast<int64_t>(r.server.compute_infer_us)
                << " usec" << std::endl;
      std::cout << "  Server compute output: "
                << static_cast<int64_t>(r.server.compute_output_us)
                << " usec" << std::endl;
    }
  }
}

Error WriteCsv(const std::string& path,
               const std::vector<PerfStatus>& results,
               bool concurrency_mode) {
  std::ofstream f(path);
  if (!f) return Error("cannot open " + path);
  f << (concurrency_mode ? "Concurrency" : "Request Rate")
    << ",Inferences/Second,Client Send,Network+Server Send/Recv,"
       "Server Queue,Server Compute Input,Server Compute Infer,"
       "Server Compute Output,Client Recv,p50 latency,p90 latency,"
       "p95 latency,p99 latency,Avg latency\n";
  for (const auto& r : results) {
    const double server_us = r.server.queue_us + r.server.compute_input_us +
                             r.server.compute_infer_us +
                             r.server.compute_output_us;
    const double net_us = std::max(0.0, r.latency.avg_us - server_us);
    if (concurrency_mode)
      f << r.concurrency;
    else
      f << r.request_rate;
    f << "," << r.infer_per_sec << ",0," << static_cast<int64_t>(net_us)
      << "," << static_cast<int64_t>(r.server.queue_us) << ","
      << static_cast<int64_t>(r.server.compute_input_us) << ","
      << static_cast<int64_t>(r.server.compute_infer_us) << ","
      << static_cast<int64_t>(r.server.compute_output_us) << ",0";
    for (int p : {50, 90, 95, 99}) {
      auto it = r.latency.percentile_us.find(p);
      f << ","
        << static_cast<int64_t>(
               it == r.latency.percentile_us.end() ? 0 : it->second);
    }
    f << "," << static_cast<int64_t>(r.latency.avg_us) << "\n";
  }
  return Error::Success();
}

}  // namespace perf
}  // namespace client_tpu_torch
