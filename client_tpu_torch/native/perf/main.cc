// perf_analyzer CLI.
// Parity role: ref:src/c++/perf_analyzer/main.cc (getopt_long flag
// surface): protocol selection, sync/async/streaming load, concurrency +
// request-rate sweeps + custom interval replay, time/count measurement
// windows, shared memory (system + cuda), sequences, SIGINT graceful
// early exit, CSV export.
#include <getopt.h>

#include <cstdlib>
#include <iostream>

#include "perf_analyzer.h"

using namespace client_tpu_torch;        // NOLINT
using namespace client_tpu_torch::perf;  // NOLINT

namespace {

void Usage() {
  std::cerr <<
      "Usage: perf_analyzer -m <model> [options]\n"
      "  -m <model>                 model name (required)\n"
      "  -x <version>               model version\n"
      "  -u <url>                   server url (default localhost:8000)\n"
      "  -i <protocol>              http|grpc|tfserve|torchserve|direct "
      "(default http;\n"
      "                             direct = no-RPC in-process model "
      "library, -u = its path)\n"
      "  -H NAME:VALUE              extra request header (HTTP) /\n"
      "                             metadata pair (gRPC); repeatable\n"
      "  -b <n>                     batch size (default 1)\n"
      "  --sync / --async           load mode (default sync)\n"
      "  --streaming                gRPC bidi streaming (implies async)\n"
      "  --max-threads <n>          async worker threads (default 16)\n"
      "  --concurrency-range a:b:c  closed-loop sweep (default 1)\n"
      "  --request-rate-range a:b:c open-loop sweep (infer/sec)\n"
      "  --request-distribution d   constant|poisson (default constant)\n"
      "  --request-intervals <file> replay inter-request intervals (ns)\n"
      "  --measurement-mode m       time_windows|count_windows\n"
      "  --measurement-request-count <n>  count-window size (default 50)\n"
      "  -p, --measurement-interval <ms>  window (default 5000)\n"
      "  -s, --stability-percentage <pct> stability gate (default 10)\n"
      "  -r, --max-trials <n>       max trials (default 10)\n"
      "  -l, --latency-threshold <usec>   latency threshold\n"
      "  --binary-search            bisect the concurrency range\n"
      "                             against -l (instead of linear)\n"
      "  --percentile <p>           stabilize on pN instead of average\n"
      "  --shared-memory t          none|system|cuda (default none)\n"
      "  --device d                 device a cuda region names\n"
      "                             (default cuda:0; cpu for a CPU\n"
      "                             server)\n"
      "  --output-shared-memory-size <bytes>  (default 102400)\n"
      "  --sequence-length <n>      mean sequence length (default 20)\n"
      "  --num-of-sequences <n>     concurrent sequences (default 4)\n"
      "  --sequence-id-range a:b    correlation id range\n"
      "  -z, --zero-data            send zeros instead of random data\n"
      "  --input-data <x>           random | zero | <json file> | <dir>\n"
      "  --data-directory <dir>     alias of --input-data <dir>\n"
      "  --model-signature-name <s>  TF-Serving signature (default\n"
      "                             serving_default)\n"
      "  --string-length <n>        BYTES element length (default 128)\n"
      "  --string-data <s>          fixed BYTES payload (instead of random)\n"
      "  --shape name:d1,d2,...     dims override for a dynamic-shape input\n"
      "                             (repeatable)\n"
      "  --grpc-compression-algorithm a  identity|gzip|deflate\n"
      "  --ssl-grpc-use-ssl         TLS for -i grpc\n"
      "  --ssl-grpc-root-certifications-file <pem>\n"
      "  --ssl-grpc-private-key-file <pem>\n"
      "  --ssl-grpc-certificate-chain-file <pem>\n"
      "  --ssl-https-verify-peer <0|1>    (default 1)\n"
      "  --ssl-https-verify-host <0|2>    (default 2; 0 disables)\n"
      "  --ssl-https-ca-certificates-file <pem>\n"
      "  --ssl-https-client-certificate-file <pem>\n"
      "  --ssl-https-client-certificate-type t  PEM only\n"
      "  --ssl-https-private-key-file <pem>\n"
      "  --ssl-https-private-key-type t         PEM only\n"
      "  -f <file>                  CSV output file\n"
      "  -v                         verbose\n";
  std::exit(2);
}

// "name:d1,d2,..." for --shape (parity: ref main.cc ParseTensorShape)
bool ParseShape(const std::string& spec, std::string* name,
                std::vector<int64_t>* dims) {
  size_t colon = spec.rfind(':');
  if (colon == std::string::npos || colon == 0) return false;
  *name = spec.substr(0, colon);
  dims->clear();
  std::string rest = spec.substr(colon + 1);
  size_t pos = 0;
  while (pos <= rest.size()) {
    size_t comma = rest.find(',', pos);
    std::string tok = rest.substr(
        pos, comma == std::string::npos ? std::string::npos : comma - pos);
    if (tok.empty()) return false;
    char* end = nullptr;
    long v = std::strtol(tok.c_str(), &end, 10);
    if (end == nullptr || *end != '\0' || v <= 0) return false;
    dims->push_back(v);
    if (comma == std::string::npos) break;
    pos = comma + 1;
  }
  return !dims->empty();
}

void ParseRange(const std::string& spec, double* a, double* b, double* c) {
  *a = *b = 1;
  *c = 1;
  size_t p1 = spec.find(':');
  *a = std::atof(spec.substr(0, p1).c_str());
  *b = *a;
  if (p1 != std::string::npos) {
    size_t p2 = spec.find(':', p1 + 1);
    *b = std::atof(spec.substr(p1 + 1, p2 - p1 - 1).c_str());
    if (p2 != std::string::npos)
      *c = std::atof(spec.substr(p2 + 1).c_str());
  }
}

}  // namespace

int main(int argc, char** argv) {
  Options opts;
  bool rate_mode = false;

  static struct option long_opts[] = {
      {"concurrency-range", required_argument, nullptr, 1},
      {"request-rate-range", required_argument, nullptr, 2},
      {"request-distribution", required_argument, nullptr, 3},
      {"percentile", required_argument, nullptr, 4},
      {"zero-data", no_argument, nullptr, 5},
      {"input-data", required_argument, nullptr, 25},
      {"model-signature-name", required_argument, nullptr, 26},
      {"string-length", required_argument, nullptr, 6},
      {"async", no_argument, nullptr, 7},
      {"sync", no_argument, nullptr, 8},
      {"streaming", no_argument, nullptr, 9},
      {"max-threads", required_argument, nullptr, 10},
      {"shared-memory", required_argument, nullptr, 11},
      {"output-shared-memory-size", required_argument, nullptr, 12},
      {"request-intervals", required_argument, nullptr, 13},
      {"measurement-mode", required_argument, nullptr, 14},
      {"measurement-request-count", required_argument, nullptr, 15},
      {"sequence-length", required_argument, nullptr, 16},
      {"num-of-sequences", required_argument, nullptr, 17},
      {"sequence-id-range", required_argument, nullptr, 18},
      {"shape", required_argument, nullptr, 19},
      {"string-data", required_argument, nullptr, 20},
      {"grpc-compression-algorithm", required_argument, nullptr, 21},
      {"ssl-grpc-use-ssl", no_argument, nullptr, 22},
      {"ssl-grpc-root-certifications-file", required_argument, nullptr, 23},
      {"ssl-grpc-private-key-file", required_argument, nullptr, 24},
      {"ssl-grpc-certificate-chain-file", required_argument, nullptr, 27},
      {"ssl-https-verify-peer", required_argument, nullptr, 28},
      {"ssl-https-verify-host", required_argument, nullptr, 29},
      {"ssl-https-ca-certificates-file", required_argument, nullptr, 30},
      {"ssl-https-client-certificate-file", required_argument, nullptr, 31},
      {"ssl-https-client-certificate-type", required_argument, nullptr, 32},
      {"ssl-https-private-key-file", required_argument, nullptr, 33},
      {"ssl-https-private-key-type", required_argument, nullptr, 34},
      {"measurement-interval", required_argument, nullptr, 35},
      {"data-directory", required_argument, nullptr, 36},
      {"binary-search", no_argument, nullptr, 37},
      {"latency-threshold", required_argument, nullptr, 38},
      {"stability-percentage", required_argument, nullptr, 39},
      {"max-trials", required_argument, nullptr, 40},
      {"device", required_argument, nullptr, 41},
      {nullptr, 0, nullptr, 0}};

  int opt;
  // -z/-a: short aliases kept for reference-CLI muscle memory
  while ((opt = getopt_long(argc, argv, "m:x:u:i:b:p:s:r:l:f:H:vza",
                            long_opts, nullptr)) != -1) {
    switch (opt) {
      case 'z': opts.zero_data = true; break;
      case 'a': opts.async_mode = true; break;
      case 'H': {
        std::string spec = optarg;
        size_t colon = spec.find(':');
        if (colon == std::string::npos || colon == 0) {
          std::cerr << "error: -H expects NAME:VALUE" << std::endl;
          return 2;
        }
        std::string name = spec.substr(0, colon);
        // trim the name like the Python harness (name.strip()) so
        // " Authorization" cannot slip past the duplicate guard as a
        // distinct header
        size_t b = name.find_first_not_of(" \t");
        size_t e = name.find_last_not_of(" \t");
        name = b == std::string::npos ? "" : name.substr(b, e - b + 1);
        if (name.empty()) {
          std::cerr << "error: -H expects NAME:VALUE" << std::endl;
          return 2;
        }
        for (const auto& h : opts.headers) {
          if (h.first == name) {
            // keeping only the last value would silently send
            // different wire traffic than asked for; refuse instead
            // (exit-2 usage error, matching the Python harness)
            std::cerr << "error: duplicate -H header '" << name << "'"
                      << std::endl;
            return 2;
          }
        }
        std::string value = spec.substr(colon + 1);
        size_t ws = value.find_first_not_of(" \t");
        opts.headers.emplace_back(
            std::move(name),
            ws == std::string::npos ? "" : value.substr(ws));
        break;
      }
      case 'm': opts.model_name = optarg; break;
      case 'x': opts.model_version = optarg; break;
      case 'u': opts.url = optarg; break;
      case 'i':
        if (std::string(optarg) == "grpc") {
          opts.protocol = BackendKind::GRPC;
        } else if (std::string(optarg) == "http") {
          opts.protocol = BackendKind::HTTP;
        } else if (std::string(optarg) == "torchserve") {
          opts.protocol = BackendKind::TORCHSERVE;
        } else if (std::string(optarg) == "tfserve") {
          opts.protocol = BackendKind::TFSERVE;
        } else if (std::string(optarg) == "direct") {
          // no-RPC in-process kind: -u names the dlopen'd model library
          // (default: libdirect_models_cuda.so next to this binary)
          opts.protocol = BackendKind::DIRECT;
          if (opts.url == "localhost:8000") opts.url.clear();
        } else {
          Usage();
        }
        break;
      case 'b': opts.batch_size = std::atoll(optarg); break;
      case 'p': opts.measurement_interval_ms = std::atoi(optarg); break;
      case 's': opts.stability_threshold = std::atof(optarg) / 100; break;
      case 'r': opts.max_trials = std::atoi(optarg); break;
      case 'l': opts.latency_threshold_us = std::atoll(optarg); break;
      case 'f': opts.csv_file = optarg; break;
      case 'v': opts.verbose = true; break;
      case 1: {
        double a, b, c;
        ParseRange(optarg, &a, &b, &c);
        opts.concurrency_start = static_cast<int>(a);
        opts.concurrency_end = static_cast<int>(b);
        opts.concurrency_step = std::max(1, static_cast<int>(c));
        break;
      }
      case 2: {
        ParseRange(optarg, &opts.rate_start, &opts.rate_end,
                   &opts.rate_step);
        rate_mode = true;
        break;
      }
      case 3: opts.poisson = std::string(optarg) == "poisson"; break;
      case 4: opts.stability_percentile = std::atoi(optarg); break;
      case 5: opts.zero_data = true; break;
      case 25: {
        std::string v = optarg;
        if (v == "zero") {
          opts.zero_data = true;
        } else if (v != "random") {
          opts.input_data = v;
        }
        break;
      }
      case 26: opts.signature_name = optarg; break;
      case 6: opts.string_length = std::atoll(optarg); break;
      case 7: opts.async_mode = true; break;
      case 8: opts.async_mode = false; break;
      case 9: opts.streaming = true; break;
      case 10: opts.max_threads = std::atoi(optarg); break;
      case 11: opts.shared_memory = optarg; break;
      case 12: opts.output_shm_size = std::atoll(optarg); break;
      case 13: opts.request_intervals_file = optarg; break;
      case 14: opts.count_windows =
                   std::string(optarg) == "count_windows";
               break;
      case 15: opts.measurement_request_count = std::atoi(optarg); break;
      case 16: opts.sequence_length = std::atoi(optarg); break;
      case 17: opts.num_of_sequences = std::atoi(optarg); break;
      case 18: {
        double a, b, c;
        ParseRange(optarg, &a, &b, &c);
        opts.sequence_id_start = static_cast<uint64_t>(a);
        opts.sequence_id_end = static_cast<uint64_t>(b);
        break;
      }
      case 19: {
        std::string name;
        std::vector<int64_t> dims;
        if (!ParseShape(optarg, &name, &dims)) {
          std::cerr << "error: --shape expects name:d1,d2,... with "
                       "positive dims" << std::endl;
          return 2;
        }
        opts.shape_overrides[name] = std::move(dims);
        break;
      }
      case 20: opts.string_data = optarg; break;
      case 21: opts.grpc_compression = optarg; break;
      case 22: opts.grpc_ssl.use_ssl = true; break;
      case 23: opts.grpc_ssl.root_certificates = optarg; break;
      case 24: opts.grpc_ssl.private_key = optarg; break;
      case 27: opts.grpc_ssl.certificate_chain = optarg; break;
      case 28: opts.http_ssl.verify_peer = std::atoi(optarg) != 0; break;
      case 29: opts.http_ssl.verify_host = std::atoi(optarg) != 0; break;
      case 30: opts.http_ssl.ca_info = optarg; break;
      case 31: opts.http_ssl.cert = optarg; break;
      case 32:
      case 34:
        // this library loads PEM only (libssl file loaders); the
        // reference's CERTTYPE/KEYTYPE knobs collapse to validation
        if (std::string(optarg) != "PEM") {
          std::cerr << "error: only PEM certificates/keys are supported"
                    << std::endl;
          return 2;
        }
        break;
      case 33: opts.http_ssl.key = optarg; break;
      // long-name aliases for the short measurement flags (parity:
      // ref main.cc long_options 6/8/9/10) + --data-directory (alias
      // of --input-data <dir>, ref long_options 4) + --binary-search
      case 35: opts.measurement_interval_ms = std::atoi(optarg); break;
      case 36: opts.input_data = optarg; break;
      case 37: opts.binary_search = true; break;
      case 38: opts.latency_threshold_us = std::atoll(optarg); break;
      case 39: opts.stability_threshold = std::atof(optarg) / 100; break;
      case 40: opts.max_trials = std::atoi(optarg); break;
      case 41: opts.shm_device = optarg; break;
      default: Usage();
    }
  }
  if (opts.model_name.empty()) Usage();
  // flag-combination validation (parity: ref main.cc:1550-1620)
  if (opts.streaming && opts.protocol != BackendKind::GRPC) {
    std::cerr << "error: --streaming requires -i grpc" << std::endl;
    return 2;
  }
  if (opts.shared_memory != "none" && opts.shared_memory != "system" &&
      opts.shared_memory != "cuda") {
    std::cerr << "error: --shared-memory must be none|system|cuda"
              << std::endl;
    return 2;
  }

  InstallSigintHandler();

  if (!opts.grpc_compression.empty() &&
      opts.protocol != BackendKind::GRPC) {
    std::cerr << "error: --grpc-compression-algorithm requires -i grpc"
              << std::endl;
    return 2;
  }
  if (!opts.headers.empty() && opts.protocol != BackendKind::HTTP &&
      opts.protocol != BackendKind::GRPC) {
    std::cerr << "error: -H is only supported with -i http|grpc"
              << std::endl;
    return 2;
  }
  if (opts.binary_search && opts.latency_threshold_us <= 0) {
    // without a latency bound there is nothing to bisect against; a
    // silent linear sweep would misrepresent what ran
    std::cerr << "error: --binary-search requires -l <usec>" << std::endl;
    return 2;
  }

  BackendFactory factory;
  factory.kind = opts.protocol;
  factory.url = opts.url;
  factory.verbose = opts.verbose;
  factory.signature_name = opts.signature_name;
  factory.http_ssl = opts.http_ssl;
  factory.grpc_ssl = opts.grpc_ssl;
  factory.grpc_compression = opts.grpc_compression;
  factory.headers = opts.headers;

  std::unique_ptr<PerfBackend> backend;
  Error err = factory.Create(&backend);
  if (!err.IsOk()) {
    std::cerr << "error: " << err.Message() << std::endl;
    return 1;
  }
  ModelInfo info;
  err = ModelInfo::Parse(&info, *backend, opts.model_name,
                         opts.model_version, opts.batch_size);
  if (!err.IsOk()) {
    std::cerr << "error: " << err.Message() << std::endl;
    return 1;
  }
  err = ResolveShapes(&info, opts);
  if (!err.IsOk()) {
    std::cerr << "error: " << err.Message() << std::endl;
    return 1;
  }
  if (info.decoupled && !opts.streaming) {
    std::cerr << "error: decoupled models require --streaming -i grpc"
              << std::endl;
    return 1;
  }

  DataGen gen;
  {
    Error derr = gen.Init(info, opts, 1);
    if (!derr.IsOk()) {
      std::cerr << "error: " << derr.Message() << std::endl;
      return 1;
    }
  }
  std::unique_ptr<ShmSetup> shm;
  if (opts.shared_memory != "none") {
    shm.reset(new ShmSetup());
    err = shm->Init(opts, info, gen, *backend);
    if (!err.IsOk()) {
      std::cerr << "error: shared memory setup: " << err.Message()
                << std::endl;
      return 1;
    }
  }

  LoadManager manager(opts, info, factory, shm.get());
  Profiler profiler(opts, info, manager, *backend);
  std::vector<PerfStatus> results;
  if (!opts.request_intervals_file.empty()) {
    results = profiler.ProfileCustom();
    rate_mode = true;
  } else if (rate_mode) {
    results = profiler.ProfileRateRange();
  } else {
    results = profiler.ProfileConcurrencyRange();
  }
  PrintReport(results, info, !rate_mode);
  if (!opts.csv_file.empty()) {
    err = WriteCsv(opts.csv_file, results, !rate_mode);
    if (!err.IsOk()) {
      std::cerr << "error: " << err.Message() << std::endl;
      return 1;
    }
    std::cout << "CSV written to " << opts.csv_file << std::endl;
  }
  if (shm) shm->Cleanup(*backend);
  bool any_valid = false;
  for (const auto& r : results) any_valid |= r.valid_count > 0;
  return any_valid ? 0 : 1;
}
