// Decoupled-model streaming: one request produces N responses on the
// bidi stream (repeat_int32 emits each input element as its own
// response, with per-response delays server-side).
// Parity: ref:src/c++/examples/simple_grpc_custom_repeat.cc.
#include <chrono>
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

  constexpr int kRepeat = 6;
  std::vector<int32_t> in_values(kRepeat);
  std::vector<int32_t> waits(kRepeat, 1000);  // 1ms between responses
  for (int i = 0; i < kRepeat; ++i) in_values[i] = 100 + i;

  std::mutex mu;
  std::condition_variable cv;
  std::vector<int32_t> got;
  bool final_seen = false;
  int errors = 0;

  FAIL_IF_ERR(client->StartStream([&](InferResult* result) {
    std::unique_ptr<InferResult> owned(result);
    std::lock_guard<std::mutex> lk(mu);
    if (!result->RequestStatus().IsOk()) {
      ++errors;
      cv.notify_one();
      return;
    }
    const uint8_t* buf;
    size_t size;
    if (result->RawData("OUT", &buf, &size).IsOk() &&
        size == sizeof(int32_t)) {
      got.push_back(*reinterpret_cast<const int32_t*>(buf));
    } else {
      // the decoupled final-marker response carries no tensor
      final_seen = true;
    }
    cv.notify_one();
  }),
              "start stream");

  InferInput* in;
  InferInput* wait;
  FAIL_IF_ERR(InferInput::Create(&in, "IN", {kRepeat}, "INT32"), "IN");
  FAIL_IF_ERR(InferInput::Create(&wait, "WAIT", {kRepeat}, "INT32"),
              "WAIT");
  std::unique_ptr<InferInput> in_o(in), wait_o(wait);
  FAIL_IF_ERR(in->AppendRaw(reinterpret_cast<uint8_t*>(in_values.data()),
                            in_values.size() * sizeof(int32_t)),
              "IN data");
  FAIL_IF_ERR(wait->AppendRaw(reinterpret_cast<uint8_t*>(waits.data()),
                              waits.size() * sizeof(int32_t)),
              "WAIT data");

  InferOptions options("repeat_int32");
  FAIL_IF_ERR(client->AsyncStreamInfer(options, {in, wait}),
              "stream infer");

  {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait_for(lk, std::chrono::seconds(30),
                [&] { return errors > 0 ||
                             static_cast<int>(got.size()) >= kRepeat; });
  }
  FAIL_IF_ERR(client->StopStream(), "stop stream");

  if (errors != 0 || static_cast<int>(got.size()) != kRepeat) {
    std::cerr << "FAIL : errors=" << errors << " responses=" << got.size()
              << std::endl;
    return 1;
  }
  int rc = 0;
  for (int i = 0; i < kRepeat; ++i) {
    std::cout << "response " << i << ": " << got[i] << std::endl;
    if (got[i] != in_values[i]) rc = 1;
  }
  std::cout << (rc == 0 ? "PASS : decoupled repeat"
                        : "FAIL : decoupled repeat mismatch")
            << std::endl;
  return rc;
}
