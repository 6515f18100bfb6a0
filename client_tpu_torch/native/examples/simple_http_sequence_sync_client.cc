// Stateful-sequence inference over HTTP (correlation id + start/end
// flags ride the request parameters).
// Parity: ref:src/c++/examples/simple_http_sequence_sync_client.cc.
#include <cstdint>
#include <iostream>
#include <memory>
#include <vector>

#include "client_tpu_torch/http_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

namespace {

int SendStep(InferenceServerHttpClient* client, uint64_t seq_id,
             int32_t value, bool start, bool end, int32_t* out) {
  InferInput* input;
  if (!InferInput::Create(&input, "INPUT", {1}, "INT32").IsOk()) return 1;
  std::unique_ptr<InferInput> owned(input);
  if (!input
           ->AppendRaw(reinterpret_cast<uint8_t*>(&value),
                       sizeof(int32_t))
           .IsOk())
    return 1;
  InferOptions options("accumulator");
  options.sequence_id = seq_id;
  options.sequence_start = start;
  options.sequence_end = end;
  InferResult* result = nullptr;
  Error err = client->Infer(&result, options, {input});
  if (!err.IsOk()) {
    std::cerr << "error: sequence step: " << err.Message() << std::endl;
    return 1;
  }
  std::unique_ptr<InferResult> rowned(result);
  if (!result->RequestStatus().IsOk()) return 1;
  const uint8_t* buf;
  size_t size;
  if (!result->RawData("OUTPUT", &buf, &size).IsOk() ||
      size != sizeof(int32_t))
    return 1;
  *out = *reinterpret_cast<const int32_t*>(buf);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string url = ParseUrl(argc, argv, "localhost:8000");
  std::unique_ptr<InferenceServerHttpClient> client;
  FAIL_IF_ERR(InferenceServerHttpClient::Create(&client, url), "create");

  const std::vector<int32_t> values = {3, 5, 7};
  const uint64_t seq_a = 3001, seq_b = 3002;
  int32_t sum_a = 0, sum_b = 0;
  int rc = 0;
  for (size_t i = 0; i < values.size(); ++i) {
    const bool start = (i == 0);
    const bool end = (i + 1 == values.size());
    int32_t got_a = 0, got_b = 0;
    if (SendStep(client.get(), seq_a, values[i], start, end, &got_a))
      return 1;
    if (SendStep(client.get(), seq_b, -values[i], start, end, &got_b))
      return 1;
    sum_a += values[i];
    sum_b -= values[i];
    std::cout << "step " << i << ": seqA=" << got_a << " (want " << sum_a
              << "), seqB=" << got_b << " (want " << sum_b << ")"
              << std::endl;
    if (got_a != sum_a || got_b != sum_b) rc = 1;
  }
  std::cout << (rc == 0 ? "PASS : http sequence sync"
                        : "FAIL : sequence state mixed up")
            << std::endl;
  return rc;
}
