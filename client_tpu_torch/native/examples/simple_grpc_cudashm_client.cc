// CUDA shared-memory inference over gRPC.
// Parity role: ref:src/c++/examples/simple_grpc_cudashm_client.cc with
// cuda_shm_handle_v1 tokens (src/cuda_shm.cc) instead of cudaIpc handles.
// Usage: simple_grpc_cudashm_client [-u host:port] [--device cpu]
// (the regions name cuda:0 unless --device names another device).
#include <cstdint>
#include <iostream>
#include <memory>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "client_tpu_torch/cuda_shm.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = ParseUrl(argc, argv, "localhost:8001");
  std::string device = ParseArg(argc, argv, "--device", "");
  std::unique_ptr<InferenceServerGrpcClient> client;
  FAIL_IF_ERR(InferenceServerGrpcClient::Create(&client, url), "create");

  constexpr size_t kN = 16;
  constexpr size_t kTensorBytes = kN * sizeof(int32_t);

  std::vector<int32_t> input0(kN), input1(kN);
  for (size_t i = 0; i < kN; ++i) {
    input0[i] = static_cast<int32_t>(i);
    input1[i] = 1;
  }

  struct Bind {
    const char* region;
    std::unique_ptr<CudaShmHandle> handle;
  };
  Bind in0{"g_cudashm_in0", nullptr}, in1{"g_cudashm_in1", nullptr},
      out0{"g_cudashm_out0", nullptr}, out1{"g_cudashm_out1", nullptr};
  for (auto* b : {&in0, &in1, &out0, &out1}) {
    FAIL_IF_ERR(
        CudaShmCreate(&b->handle, b->region, kTensorBytes, 0, device),
        b->region);
    std::string raw;
    FAIL_IF_ERR(CudaShmGetRawHandle(*b->handle, &raw), "raw handle");
    FAIL_IF_ERR(client->RegisterCudaSharedMemory(
                    b->region, raw, b->handle->DeviceId(), kTensorBytes),
                "register region");
  }
  FAIL_IF_ERR(CudaShmSet(*in0.handle, 0, input0.data(), kTensorBytes),
              "set INPUT0");
  FAIL_IF_ERR(CudaShmSet(*in1.handle, 0, input1.data(), kTensorBytes),
              "set INPUT1");

  inference::CudaSharedMemoryStatusResponse status;
  FAIL_IF_ERR(client->CudaSharedMemoryStatus(&status), "shm status");

  InferInput* i0;
  InferInput* i1;
  FAIL_IF_ERR(InferInput::Create(&i0, "INPUT0", {kN}, "INT32"), "INPUT0");
  FAIL_IF_ERR(InferInput::Create(&i1, "INPUT1", {kN}, "INT32"), "INPUT1");
  std::unique_ptr<InferInput> i0_owned(i0), i1_owned(i1);
  FAIL_IF_ERR(i0->SetSharedMemory("g_cudashm_in0", kTensorBytes, 0),
              "INPUT0 shm");
  FAIL_IF_ERR(i1->SetSharedMemory("g_cudashm_in1", kTensorBytes, 0),
              "INPUT1 shm");

  InferRequestedOutput* o0;
  InferRequestedOutput* o1;
  FAIL_IF_ERR(InferRequestedOutput::Create(&o0, "OUTPUT0"), "OUTPUT0");
  FAIL_IF_ERR(InferRequestedOutput::Create(&o1, "OUTPUT1"), "OUTPUT1");
  std::unique_ptr<InferRequestedOutput> o0_owned(o0), o1_owned(o1);
  FAIL_IF_ERR(o0->SetSharedMemory("g_cudashm_out0", kTensorBytes, 0),
              "OUTPUT0 shm");
  FAIL_IF_ERR(o1->SetSharedMemory("g_cudashm_out1", kTensorBytes, 0),
              "OUTPUT1 shm");

  InferOptions options("add_sub");
  InferResult* result;
  FAIL_IF_ERR(client->Infer(&result, options, {i0, i1}, {o0, o1}),
              "infer");
  std::unique_ptr<InferResult> result_owned(result);
  FAIL_IF_ERR(result->RequestStatus(), "request failed");

  std::vector<int32_t> got0(kN), got1(kN);
  FAIL_IF_ERR(CudaShmRead(*out0.handle, 0, got0.data(), kTensorBytes),
              "read OUTPUT0");
  FAIL_IF_ERR(CudaShmRead(*out1.handle, 0, got1.data(), kTensorBytes),
              "read OUTPUT1");

  int rc = 0;
  for (size_t i = 0; i < kN; ++i) {
    std::cout << input0[i] << " + " << input1[i] << " = " << got0[i]
              << ", - = " << got1[i] << std::endl;
    if (got0[i] != input0[i] + input1[i] ||
        got1[i] != input0[i] - input1[i])
      rc = 1;
  }

  FAIL_IF_ERR(client->UnregisterCudaSharedMemory(), "unregister all");
  std::cout << (rc == 0 ? "PASS : grpc cudashm infer"
                        : "FAIL : grpc cudashm mismatch")
            << std::endl;
  return rc;
}
