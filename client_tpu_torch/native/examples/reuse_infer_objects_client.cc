// Reuse InferInput/InferRequestedOutput/InferOptions objects across many
// requests and across both protocols — exercises the cursor-reset and
// proto-reuse paths.
// Parity: ref:src/c++/examples/reuse_infer_objects_client.cc.
#include <cstdint>
#include <iostream>
#include <memory>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "client_tpu_torch/http_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

namespace {

template <typename ClientT>
int RunRounds(ClientT* client, InferOptions& options,
              std::vector<InferInput*>& inputs,
              std::vector<const InferRequestedOutput*>& outputs,
              std::vector<int32_t>& input0,
              const char* label) {
  for (int round = 0; round < 4; ++round) {
    // mutate the input buffer between rounds: AppendRaw holds pointers,
    // so the same objects must transport fresh data each time
    for (size_t i = 0; i < input0.size(); ++i)
      input0[i] = static_cast<int32_t>(i + round);
    InferResult* result = nullptr;
    Error err = client->Infer(&result, options, inputs, outputs);
    if (!err.IsOk()) {
      std::cerr << "error: " << label << " round " << round << ": "
                << err.Message() << std::endl;
      return 1;
    }
    std::unique_ptr<InferResult> owned(result);
    if (!result->RequestStatus().IsOk()) return 1;
    const uint8_t* buf;
    size_t size;
    if (!result->RawData("OUTPUT0", &buf, &size).IsOk()) return 1;
    const int32_t* out = reinterpret_cast<const int32_t*>(buf);
    for (size_t i = 0; i < input0.size(); ++i) {
      if (out[i] != input0[i] + 1) {
        std::cerr << "FAIL : " << label << " round " << round
                  << " reused objects produced stale data" << std::endl;
        return 1;
      }
    }
  }
  std::cout << "PASS : " << label << " object reuse" << std::endl;
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string http_url = "localhost:8000";
  std::string grpc_url = "localhost:8001";
  for (int i = 1; i < argc - 1; ++i) {
    if (std::string(argv[i]) == "-u") http_url = argv[i + 1];
    if (std::string(argv[i]) == "-g") grpc_url = argv[i + 1];
  }

  constexpr size_t kN = 16;
  std::vector<int32_t> input0(kN), input1(kN, 1);

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

  InferRequestedOutput* o0;
  FAIL_IF_ERR(InferRequestedOutput::Create(&o0, "OUTPUT0"), "OUTPUT0");
  std::unique_ptr<InferRequestedOutput> o0_owned(o0);

  std::vector<InferInput*> inputs = {i0, i1};
  std::vector<const InferRequestedOutput*> outputs = {o0};
  InferOptions options("add_sub");

  std::unique_ptr<InferenceServerHttpClient> http;
  FAIL_IF_ERR(InferenceServerHttpClient::Create(&http, http_url),
              "http client");
  if (RunRounds(http.get(), options, inputs, outputs, input0, "http"))
    return 1;

  std::unique_ptr<InferenceServerGrpcClient> grpc;
  FAIL_IF_ERR(InferenceServerGrpcClient::Create(&grpc, grpc_url),
              "grpc client");
  // the SAME input/output/options objects now ride the other protocol
  if (RunRounds(grpc.get(), options, inputs, outputs, input0, "grpc"))
    return 1;
  return 0;
}
