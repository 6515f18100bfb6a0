// Async gRPC inference: callbacks on the transport's completion thread.
// Parity: ref:src/c++/examples/simple_grpc_async_infer_client.cc.
#include <condition_variable>
#include <cstdint>
#include <iostream>
#include <memory>
#include <mutex>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = ParseUrl(argc, argv, "localhost:8001");
  std::unique_ptr<InferenceServerGrpcClient> client;
  FAIL_IF_ERR(InferenceServerGrpcClient::Create(&client, url), "create");

  constexpr int kRequests = 8;
  constexpr size_t kN = 16;
  std::vector<int32_t> input0(kN), input1(kN);
  for (size_t i = 0; i < kN; ++i) {
    input0[i] = static_cast<int32_t>(i);
    input1[i] = 1;
  }

  InferInput* i0;
  InferInput* i1;
  FAIL_IF_ERR(InferInput::Create(&i0, "INPUT0", {kN}, "INT32"), "INPUT0");
  FAIL_IF_ERR(InferInput::Create(&i1, "INPUT1", {kN}, "INT32"), "INPUT1");
  std::unique_ptr<InferInput> i0_owned(i0), i1_owned(i1);
  FAIL_IF_ERR(i0->AppendRaw(reinterpret_cast<uint8_t*>(input0.data()),
                            kN * sizeof(int32_t)),
              "INPUT0 data");
  FAIL_IF_ERR(i1->AppendRaw(reinterpret_cast<uint8_t*>(input1.data()),
                            kN * sizeof(int32_t)),
              "INPUT1 data");

  std::mutex mu;
  std::condition_variable cv;
  int done = 0, failed = 0;

  InferOptions options("add_sub");
  for (int r = 0; r < kRequests; ++r) {
    Error err = client->AsyncInfer(
        [&](InferResult* result) {
          std::unique_ptr<InferResult> owned(result);
          bool ok = result->RequestStatus().IsOk();
          if (ok) {
            const uint8_t* buf;
            size_t size;
            ok = result->RawData("OUTPUT1", &buf, &size).IsOk() &&
                 size == kN * sizeof(int32_t) &&
                 reinterpret_cast<const int32_t*>(buf)[5] == 5 - 1;
          }
          std::lock_guard<std::mutex> lk(mu);
          ++done;
          if (!ok) ++failed;
          cv.notify_one();
        },
        options, {i0, i1});
    FAIL_IF_ERR(err, "async infer");
  }

  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done == kRequests; });
  if (failed != 0) {
    std::cerr << "FAIL : " << failed << " async requests failed"
              << std::endl;
    return 1;
  }
  std::cout << "PASS : " << kRequests << " async grpc inferences"
            << std::endl;
  return 0;
}
