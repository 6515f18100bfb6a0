// Memory-growth loop: -r iterations of inference on the selected
// protocol; fails if resident memory grows materially after warmup.
//
// Parity: ref:src/c++/tests/memory_leak_test.cc:1-301 (the reference
// binary relies on external valgrind/massif; this one self-checks RSS
// from /proc so CI catches gross leaks without tooling).
//
// Usage: memory_leak_test [-i http|grpc] [-u url] [-r iterations]
#include <unistd.h>

#include <cstdint>
#include <fstream>
#include <iostream>
#include <memory>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

namespace {

size_t RssKb() {
  std::ifstream f("/proc/self/statm");
  size_t pages_total = 0, pages_resident = 0;
  f >> pages_total >> pages_resident;
  return pages_resident * static_cast<size_t>(getpagesize()) / 1024;
}

template <typename ClientT>
int RunLoop(ClientT* client, int iterations) {
  std::vector<int32_t> in0(16), in1(16, 1);
  for (int i = 0; i < 16; ++i) in0[i] = i;

  auto one = [&]() -> bool {
    InferInput* i0;
    InferInput* i1;
    InferInput::Create(&i0, "INPUT0", {16}, "INT32");
    InferInput::Create(&i1, "INPUT1", {16}, "INT32");
    std::unique_ptr<InferInput> o0(i0), o1(i1);
    i0->AppendRaw(reinterpret_cast<uint8_t*>(in0.data()),
                  in0.size() * sizeof(int32_t));
    i1->AppendRaw(reinterpret_cast<uint8_t*>(in1.data()),
                  in1.size() * sizeof(int32_t));
    InferOptions options("add_sub");
    InferResult* result = nullptr;
    Error err = client->Infer(&result, options, {i0, i1});
    std::unique_ptr<InferResult> owned(result);
    return err.IsOk() && result->RequestStatus().IsOk();
  };

  // warmup: allocators/caches reach steady state
  for (int i = 0; i < 50; ++i)
    if (!one()) {
      std::cerr << "FAIL : warmup inference failed" << std::endl;
      return 1;
    }
  size_t before_kb = RssKb();
  for (int i = 0; i < iterations; ++i)
    if (!one()) {
      std::cerr << "FAIL : inference failed at iteration " << i
                << std::endl;
      return 1;
    }
  size_t after_kb = RssKb();
  long growth = static_cast<long>(after_kb) - static_cast<long>(before_kb);
  std::cout << "rss before=" << before_kb << "KB after=" << after_kb
            << "KB growth=" << growth << "KB over " << iterations
            << " iterations" << std::endl;
  // per-request leak of even 100 bytes over 1000 iterations ≈ 100KB;
  // allow modest allocator slack
  if (growth > 4096) {
    std::cerr << "FAIL : resident memory grew " << growth << "KB"
              << std::endl;
    return 1;
  }
  std::cout << "PASS : no material memory growth" << std::endl;
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string protocol = "http";
  std::string url;
  int iterations = 1000;
  for (int i = 1; i < argc - 1; ++i) {
    std::string a = argv[i];
    if (a == "-i") protocol = argv[i + 1];
    if (a == "-u") url = argv[i + 1];
    if (a == "-r") iterations = atoi(argv[i + 1]);
  }
  if (url.empty())
    url = (protocol == "grpc") ? "localhost:8001" : "localhost:8000";

  if (protocol == "grpc") {
    std::unique_ptr<InferenceServerGrpcClient> client;
    Error err = InferenceServerGrpcClient::Create(&client, url);
    if (!err.IsOk()) {
      std::cerr << "cannot connect: " << err.Message() << std::endl;
      return 2;
    }
    return RunLoop(client.get(), iterations);
  }
  std::unique_ptr<InferenceServerHttpClient> client;
  Error err = InferenceServerHttpClient::Create(&client, url);
  if (!err.IsOk()) {
    std::cerr << "cannot connect: " << err.Message() << std::endl;
    return 2;
  }
  return RunLoop(client.get(), iterations);
}
