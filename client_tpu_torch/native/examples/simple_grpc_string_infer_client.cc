// BYTES (string) tensors over gRPC: numeric strings in, sum/difference
// strings out.
// Parity: ref:src/c++/examples/simple_grpc_string_infer_client.cc.
#include <cstdint>
#include <iostream>
#include <memory>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = ParseUrl(argc, argv, "localhost:8001");
  std::unique_ptr<InferenceServerGrpcClient> client;
  FAIL_IF_ERR(InferenceServerGrpcClient::Create(&client, url), "create");

  constexpr size_t kN = 16;
  std::vector<std::string> input0(kN), input1(kN);
  for (size_t i = 0; i < kN; ++i) {
    input0[i] = std::to_string(i);
    input1[i] = "1";
  }

  InferInput* i0;
  InferInput* i1;
  FAIL_IF_ERR(InferInput::Create(&i0, "INPUT0", {kN}, "BYTES"), "INPUT0");
  FAIL_IF_ERR(InferInput::Create(&i1, "INPUT1", {kN}, "BYTES"), "INPUT1");
  std::unique_ptr<InferInput> i0_owned(i0), i1_owned(i1);
  FAIL_IF_ERR(i0->AppendFromString(input0), "INPUT0 data");
  FAIL_IF_ERR(i1->AppendFromString(input1), "INPUT1 data");

  InferOptions options("add_sub_string");
  InferResult* result;
  FAIL_IF_ERR(client->Infer(&result, options, {i0, i1}), "infer");
  std::unique_ptr<InferResult> owned(result);
  FAIL_IF_ERR(result->RequestStatus(), "request failed");

  std::vector<std::string> out0, out1;
  FAIL_IF_ERR(result->StringData("OUTPUT0", &out0), "OUTPUT0");
  FAIL_IF_ERR(result->StringData("OUTPUT1", &out1), "OUTPUT1");
  if (out0.size() != kN || out1.size() != kN) {
    std::cerr << "FAIL : wrong output counts" << std::endl;
    return 1;
  }
  int rc = 0;
  for (size_t i = 0; i < kN; ++i) {
    std::cout << input0[i] << " + 1 = " << out0[i] << ", - 1 = " << out1[i]
              << std::endl;
    if (out0[i] != std::to_string(static_cast<int>(i) + 1) ||
        out1[i] != std::to_string(static_cast<int>(i) - 1))
      rc = 1;
  }
  std::cout << (rc == 0 ? "PASS : grpc string infer"
                        : "FAIL : string mismatch")
            << std::endl;
  return rc;
}
