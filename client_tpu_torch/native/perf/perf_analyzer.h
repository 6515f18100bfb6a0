// Native perf analyzer: load generation + latency profiling over the
// pluggable client-backend seam (HTTP / gRPC).
// Parity role: ref:src/c++/perf_analyzer/{inference_profiler,
// concurrency_manager,request_rate_manager,custom_load_manager,
// model_parser,data_loader,load_manager} — same measurement semantics
// (stability window of 3 on both infer/s and latency, valid-latency
// window filtering, delayed-request exclusion, server-stat deltas,
// count windows, SIGINT-driven graceful early exit with sequence
// draining), re-designed on this library's clients.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "client_backend.h"
#include "client_tpu_torch/cuda_shm.h"

namespace client_tpu_torch {
namespace perf {

// SIGINT => finish in-flight work, drain sequences, report what we have
// (parity: ref perf_utils.h:61 early_exit + main.cc:1776).
extern std::atomic<bool> early_exit;
void InstallSigintHandler();

struct TensorSpec {
  std::string name;
  std::string datatype;
  std::vector<int64_t> dims;
};

// Parity: ref model_parser.{h,cc}
struct ModelInfo {
  std::string name;
  std::string version;
  int64_t max_batch_size = 0;
  bool decoupled = false;
  bool sequence = false;
  std::vector<TensorSpec> inputs;
  std::vector<TensorSpec> outputs;

  static Error Parse(ModelInfo* info, PerfBackend& backend,
                     const std::string& name, const std::string& version,
                     int64_t batch_size);
};

// Apply --shape overrides onto info->inputs and reject any remaining
// dynamic dim; call once right after ModelInfo::Parse so DataGen,
// replay and shm sizing all see concrete dims.
Error ResolveShapes(ModelInfo* info, const struct Options& opts);

// One request observation (parity: ref perf_utils.h:53 TimestampVector).
struct Timestamp {
  uint64_t start_ns;
  uint64_t end_ns;
  bool sequence_end;
  bool delayed;
};

struct ThreadStat {
  std::mutex mutex;
  std::vector<Timestamp> timestamps;
  std::string error;
};

// Live sequence slot (parity: ref load_manager.h:262 SequenceStat).
struct SequenceStat {
  std::mutex mutex;
  uint64_t seq_id = 0;
  int remaining = 0;
};

struct Options;  // forward

// Input tensors, one shared buffer per input: synthetic random/zero
// (parity: ref data_loader GenerateData) or replayed from --input-data
// JSON / directory (parity: ref data_loader.cc ReadDataFromJSON /
// ReadDataFromDir; native replay uses the first stream's first step —
// multi-stream sequencing lives in the Python harness).
class DataGen {
 public:
  Error Init(const ModelInfo& info, const Options& opts, unsigned seed);
  // builds (and owns) InferInput objects bound to the generated buffers
  std::vector<InferInput*> MakeInputs();
  size_t InputByteSize(size_t index) const { return bufs_[index].nbytes; }
  const uint8_t* InputData(size_t index) const {
    return bufs_[index].data.data();
  }
  ~DataGen();

 private:
  Error InitFromFile(const ModelInfo& info, const Options& opts);
  struct Buf {
    std::string name;
    std::string datatype;
    std::vector<int64_t> shape;
    std::vector<uint8_t> data;
    std::vector<std::string> strings;
    size_t nbytes = 0;
  };
  std::vector<Buf> bufs_;
  std::vector<InferInput*> owned_;
};

struct LatencyStats {
  double avg_us = 0, std_us = 0, min_us = 0, max_us = 0;
  std::map<int, double> percentile_us;
};

struct ServerSideStats {
  int64_t inference_count = 0;
  int64_t execution_count = 0;
  double queue_us = 0, compute_input_us = 0, compute_infer_us = 0,
         compute_output_us = 0;
};

struct PerfStatus {
  int concurrency = 0;
  double request_rate = 0;
  double infer_per_sec = 0;
  double sequence_per_sec = 0;
  int valid_count = 0;
  int delayed_count = 0;
  LatencyStats latency;
  ServerSideStats server;
  bool stabilized = false;
};

struct Options {
  std::string url = "localhost:8000";
  BackendKind protocol = BackendKind::HTTP;
  std::string model_name;
  std::string model_version;
  int64_t batch_size = 1;
  // load mode
  bool async_mode = false;
  bool streaming = false;
  int max_threads = 16;  // async-mode worker threads
  // concurrency search
  int concurrency_start = 1, concurrency_end = 1, concurrency_step = 1;
  bool binary_search = false;  // bisect the range against -l
  // open-loop rate search (0 = disabled)
  double rate_start = 0, rate_end = 0, rate_step = 0;
  bool poisson = false;
  std::string request_intervals_file;  // custom replay (ns per line)
  // measurement
  bool count_windows = false;
  int measurement_request_count = 50;
  int measurement_interval_ms = 5000;
  double stability_threshold = 0.10;
  int max_trials = 10;
  int64_t latency_threshold_us = 0;
  int stability_percentile = 0;  // 0 = average
  // shared memory
  std::string shared_memory = "none";  // none | system | cuda
  // the device a cuda region's token names ("" = cuda:0; --device)
  std::string shm_device;
  size_t output_shm_size = 100 * 1024;
  // sequences
  int sequence_length = 20;
  int num_of_sequences = 4;
  uint64_t sequence_id_start = 1, sequence_id_end = 0;
  // data
  bool zero_data = false;
  size_t string_length = 128;
  std::string string_data;  // fixed BYTES payload (--string-data)
  std::string input_data;  // path to JSON file or directory ("" = random)
  // --shape name:d1,d2,... overrides for dynamic dims (parity: ref
  // main.cc --shape; required when an input has a -1 dim and data is
  // synthetic)
  std::map<std::string, std::vector<int64_t>> shape_overrides;
  std::string signature_name = "serving_default";  // tfserve
  // transport security + compression (--ssl-* groups,
  // --grpc-compression-algorithm)
  HttpSslOptions http_ssl;
  SslOptions grpc_ssl;
  std::string grpc_compression;
  // -H NAME:VALUE request headers / gRPC metadata
  std::vector<std::pair<std::string, std::string>> headers;
  // output
  std::string csv_file;
  bool verbose = false;
};

// Shared-memory region setup: create + fill + register input/output
// regions once; requests then reference them by name
// (parity: ref load_manager.cc:260-452 InitSharedMemory).
class ShmSetup {
 public:
  Error Init(const Options& opts, const ModelInfo& info, DataGen& gen,
             PerfBackend& backend);
  // per-request descriptors referencing the registered regions
  std::vector<InferInput*> MakeInputs();
  std::vector<const InferRequestedOutput*> MakeOutputs();
  void Cleanup(PerfBackend& backend);
  ~ShmSetup();

 private:
  struct Region {
    std::string name;
    std::string key;          // system shm
    int fd = -1;
    uint8_t* base = nullptr;
    size_t byte_size = 0;
    std::unique_ptr<CudaShmHandle> cuda;  // cuda shm
  };
  std::vector<Region> input_regions_;
  std::vector<Region> output_regions_;
  std::vector<size_t> input_sizes_;
  std::vector<std::string> input_names_;
  std::vector<std::string> input_dtypes_;
  std::vector<std::vector<int64_t>> input_shapes_;
  std::vector<std::string> output_names_;
  size_t output_shm_size_ = 0;
  bool cuda_ = false;
};

// Load generator: closed-loop concurrency (sync / async / streaming) or
// open-loop schedule (constant / poisson / custom intervals).
// (parity: ref concurrency_manager + request_rate_manager +
// custom_load_manager)
class LoadManager {
 public:
  LoadManager(const Options& opts, const ModelInfo& info,
              const BackendFactory& factory, ShmSetup* shm);
  ~LoadManager();

  void ChangeConcurrency(int concurrency);
  Error ChangeRequestRate(double rate);
  // custom intervals: returns the implied request rate
  Error InitCustomIntervals(double* rate);
  void Stop();

  std::vector<Timestamp> SwapTimestamps();
  Error CheckHealth();

 private:
  struct WorkerCtx;
  void SyncWorker(ThreadStat* stat, int slot_base);
  void AsyncWorker(ThreadStat* stat, int slots, int widx);
  void StreamWorker(ThreadStat* stat, int slots, int widx);
  void RateWorker(ThreadStat* stat, size_t offset, size_t stride);
  // sequence bookkeeping (parity: ref SetInferSequenceOptions)
  void SequenceOptions(int slot, InferOptions* options);
  void DrainSequences(PerfBackend& backend, ThreadStat* stat);
  std::vector<InferInput*> MakeInputs(DataGen* gen);
  std::vector<const InferRequestedOutput*> MakeOutputs();

  const Options& opts_;
  const ModelInfo& info_;
  const BackendFactory& factory_;
  ShmSetup* shm_;
  std::atomic<bool> stop_{false};
  std::vector<std::thread> threads_;
  std::vector<std::unique_ptr<ThreadStat>> stats_;
  std::vector<std::unique_ptr<SequenceStat>> sequences_;
  std::mutex seq_id_mutex_;
  uint64_t next_seq_id_ = 1;
  std::mt19937 seq_rng_{12345};
  std::vector<uint64_t> schedule_;
  uint64_t gen_duration_ns_ = 0;
};

// Measurement + stabilization (parity: ref inference_profiler.cc:557-855).
class Profiler {
 public:
  Profiler(const Options& opts, const ModelInfo& info, LoadManager& manager,
           PerfBackend& backend);
  std::vector<PerfStatus> ProfileConcurrencyRange();
  std::vector<PerfStatus> ProfileRateRange();
  std::vector<PerfStatus> ProfileCustom();

 private:
  PerfStatus Stabilize();
  PerfStatus Measure();
  double StabilityLatency(const PerfStatus& s) const;
  bool FetchServerSnapshot(ServerSideStats* out);

  const Options& opts_;
  const ModelInfo& info_;
  LoadManager& manager_;
  PerfBackend& backend_;
};

void PrintReport(const std::vector<PerfStatus>& results,
                 const ModelInfo& info, bool concurrency_mode);
Error WriteCsv(const std::string& path,
               const std::vector<PerfStatus>& results, bool concurrency_mode);

}  // namespace perf
}  // namespace client_tpu_torch
