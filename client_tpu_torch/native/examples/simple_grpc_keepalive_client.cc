// KeepAlive-configured gRPC client: HTTP/2 PINGs keep the channel warm
// between requests.
// Parity: ref:src/c++/examples/simple_grpc_keepalive_client.cc
// (KeepAliveOptions grpc_client.h:61).
#include <chrono>
#include <cstdint>
#include <iostream>
#include <memory>
#include <thread>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = ParseUrl(argc, argv, "localhost:8001");

  KeepAliveOptions keepalive;
  keepalive.keepalive_time_ms = 200;          // ping every 200ms
  keepalive.keepalive_timeout_ms = 1000;
  keepalive.keepalive_permit_without_calls = true;

  std::unique_ptr<InferenceServerGrpcClient> client;
  FAIL_IF_ERR(
      InferenceServerGrpcClient::Create(&client, url, false, keepalive),
      "create");

  constexpr size_t kN = 16;
  std::vector<int32_t> input0(kN), input1(kN, 1);
  for (size_t i = 0; i < kN; ++i) input0[i] = static_cast<int32_t>(i);

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

  InferOptions options("add_sub");
  // idle gap longer than several keepalive periods: the pings must keep
  // the connection healthy for the second request
  for (int round = 0; round < 2; ++round) {
    InferResult* result = nullptr;
    FAIL_IF_ERR(client->Infer(&result, options, {i0, i1}), "infer");
    std::unique_ptr<InferResult> owned(result);
    FAIL_IF_ERR(result->RequestStatus(), "request failed");
    const uint8_t* buf;
    size_t size;
    FAIL_IF_ERR(result->RawData("OUTPUT0", &buf, &size), "OUTPUT0");
    if (reinterpret_cast<const int32_t*>(buf)[3] != 3 + 1) {
      std::cerr << "FAIL : wrong result" << std::endl;
      return 1;
    }
    if (round == 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(800));
  }
  std::cout << "PASS : keepalive channel survived idle gap" << std::endl;
  return 0;
}
