// Stateful-sequence inference over the bidi stream: all steps of a
// sequence ride ONE gRPC stream; responses arrive on the reader thread.
// Parity: ref:src/c++/examples/simple_grpc_sequence_stream_client.cc.
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

  const std::vector<int32_t> values = {2, 4, 6, 8};
  std::mutex mu;
  std::condition_variable cv;
  std::vector<int32_t> outputs;
  int errors = 0;

  FAIL_IF_ERR(client->StartStream([&](InferResult* result) {
    std::unique_ptr<InferResult> owned(result);
    std::lock_guard<std::mutex> lk(mu);
    if (!result->RequestStatus().IsOk()) {
      ++errors;
    } else {
      const uint8_t* buf;
      size_t size;
      if (result->RawData("OUTPUT", &buf, &size).IsOk() &&
          size == sizeof(int32_t)) {
        outputs.push_back(*reinterpret_cast<const int32_t*>(buf));
      } else {
        ++errors;
      }
    }
    cv.notify_one();
  }),
              "start stream");

  const uint64_t seq_id = 77;
  for (size_t i = 0; i < values.size(); ++i) {
    int32_t v = values[i];
    InferInput* input;
    FAIL_IF_ERR(InferInput::Create(&input, "INPUT", {1}, "INT32"),
                "INPUT");
    std::unique_ptr<InferInput> owned(input);
    FAIL_IF_ERR(
        input->AppendRaw(reinterpret_cast<uint8_t*>(&v), sizeof(int32_t)),
        "INPUT data");
    InferOptions options("accumulator");
    options.sequence_id = seq_id;
    options.sequence_start = (i == 0);
    options.sequence_end = (i + 1 == values.size());
    FAIL_IF_ERR(client->AsyncStreamInfer(options, {input}),
                "stream infer");
  }

  {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait_for(lk, std::chrono::seconds(30), [&] {
      return outputs.size() + errors >= values.size();
    });
  }
  FAIL_IF_ERR(client->StopStream(), "stop stream");

  if (errors != 0 || outputs.size() != values.size()) {
    std::cerr << "FAIL : stream errors=" << errors << " responses="
              << outputs.size() << std::endl;
    return 1;
  }
  int32_t sum = 0;
  int rc = 0;
  for (size_t i = 0; i < values.size(); ++i) {
    sum += values[i];
    std::cout << "step " << i << ": got " << outputs[i] << " want " << sum
              << std::endl;
    if (outputs[i] != sum) rc = 1;
  }
  std::cout << (rc == 0 ? "PASS : sequence stream"
                        : "FAIL : sequence stream mismatch")
            << std::endl;
  return rc;
}
