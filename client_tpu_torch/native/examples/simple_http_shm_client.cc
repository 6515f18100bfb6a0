// System shared-memory inference over HTTP: inputs and outputs ride a
// POSIX shm region instead of the request/response body.
// Parity: ref:src/c++/examples/simple_http_shm_client.cc (add_sub with
// register/unregister + shm-resident outputs).
#include <sys/types.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <iostream>
#include <memory>
#include <vector>

#include "client_tpu_torch/http_client.h"
#include "client_tpu_torch/shm_utils.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = ParseUrl(argc, argv, "localhost:8000");
  std::unique_ptr<InferenceServerHttpClient> client;
  FAIL_IF_ERR(InferenceServerHttpClient::Create(&client, url), "create");

  constexpr size_t kN = 16;
  constexpr size_t kTensorBytes = kN * sizeof(int32_t);
  const std::string in_key =
      "/simple_http_in_" + std::to_string(getpid());
  const std::string out_key =
      "/simple_http_out_" + std::to_string(getpid());

  // input region: INPUT0 then INPUT1 back to back
  int in_fd = -1;
  void* in_base = nullptr;
  FAIL_IF_ERR(CreateSharedMemoryRegion(in_key, 2 * kTensorBytes, &in_fd),
              "create input region");
  FAIL_IF_ERR(MapSharedMemory(in_fd, 0, 2 * kTensorBytes, &in_base),
              "map input region");
  int32_t* in0 = static_cast<int32_t*>(in_base);
  int32_t* in1 = in0 + kN;
  for (size_t i = 0; i < kN; ++i) {
    in0[i] = static_cast<int32_t>(i);
    in1[i] = 1;
  }

  int out_fd = -1;
  void* out_base = nullptr;
  FAIL_IF_ERR(CreateSharedMemoryRegion(out_key, 2 * kTensorBytes, &out_fd),
              "create output region");
  FAIL_IF_ERR(MapSharedMemory(out_fd, 0, 2 * kTensorBytes, &out_base),
              "map output region");

  FAIL_IF_ERR(client->RegisterSystemSharedMemory("input_data", in_key,
                                                 2 * kTensorBytes),
              "register input region");
  FAIL_IF_ERR(client->RegisterSystemSharedMemory("output_data", out_key,
                                                 2 * kTensorBytes),
              "register output region");

  InferInput* i0;
  InferInput* i1;
  FAIL_IF_ERR(InferInput::Create(&i0, "INPUT0", {kN}, "INT32"), "INPUT0");
  FAIL_IF_ERR(InferInput::Create(&i1, "INPUT1", {kN}, "INT32"), "INPUT1");
  std::unique_ptr<InferInput> i0_owned(i0), i1_owned(i1);
  FAIL_IF_ERR(i0->SetSharedMemory("input_data", kTensorBytes, 0),
              "INPUT0 shm");
  FAIL_IF_ERR(i1->SetSharedMemory("input_data", kTensorBytes, kTensorBytes),
              "INPUT1 shm");

  InferRequestedOutput* o0;
  InferRequestedOutput* o1;
  FAIL_IF_ERR(InferRequestedOutput::Create(&o0, "OUTPUT0"), "OUTPUT0");
  FAIL_IF_ERR(InferRequestedOutput::Create(&o1, "OUTPUT1"), "OUTPUT1");
  std::unique_ptr<InferRequestedOutput> o0_owned(o0), o1_owned(o1);
  FAIL_IF_ERR(o0->SetSharedMemory("output_data", kTensorBytes, 0),
              "OUTPUT0 shm");
  FAIL_IF_ERR(o1->SetSharedMemory("output_data", kTensorBytes,
                                  kTensorBytes),
              "OUTPUT1 shm");

  InferOptions options("add_sub");
  InferResult* result;
  FAIL_IF_ERR(client->Infer(&result, options, {i0, i1}, {o0, o1}),
              "infer");
  std::unique_ptr<InferResult> result_owned(result);
  FAIL_IF_ERR(result->RequestStatus(), "request failed");

  const int32_t* out0 = static_cast<int32_t*>(out_base);
  const int32_t* out1 = out0 + kN;
  int rc = 0;
  for (size_t i = 0; i < kN; ++i) {
    std::cout << in0[i] << " + " << in1[i] << " = " << out0[i] << ", - = "
              << out1[i] << std::endl;
    if (out0[i] != in0[i] + in1[i] || out1[i] != in0[i] - in1[i]) rc = 1;
  }

  FAIL_IF_ERR(client->UnregisterSystemSharedMemory("input_data"),
              "unregister input");
  FAIL_IF_ERR(client->UnregisterSystemSharedMemory("output_data"),
              "unregister output");
  UnmapSharedMemory(in_base, 2 * kTensorBytes);
  UnmapSharedMemory(out_base, 2 * kTensorBytes);
  CloseSharedMemory(in_fd);
  CloseSharedMemory(out_fd);
  UnlinkSharedMemoryRegion(in_key);
  UnlinkSharedMemoryRegion(out_key);

  std::cout << (rc == 0 ? "PASS : shm infer" : "FAIL : shm mismatch")
            << std::endl;
  return rc;
}
