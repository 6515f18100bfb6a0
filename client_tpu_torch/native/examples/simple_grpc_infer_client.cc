// Parity: ref:src/c++/examples/simple_grpc_infer_client.cc — INT32
// add_sub over the native gRPC client (unary Infer, raw tensor path).

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"

using namespace client_tpu_torch;

#define FAIL_IF_ERR(X, MSG)                                     \
  do {                                                          \
    Error err__ = (X);                                          \
    if (!err__.IsOk()) {                                        \
      fprintf(stderr, "error: %s: %s\n", (MSG),                 \
              err__.Message().c_str());                         \
      exit(1);                                                  \
    }                                                           \
  } while (false)

int main(int argc, char** argv) {
  std::string url = "localhost:8001";
  bool verbose = false;
  for (int i = 1; i < argc; ++i) {
    if (!strcmp(argv[i], "-u") && i + 1 < argc) url = argv[++i];
    if (!strcmp(argv[i], "-v")) verbose = true;
  }

  std::unique_ptr<InferenceServerGrpcClient> client;
  FAIL_IF_ERR(InferenceServerGrpcClient::Create(&client, url, verbose),
              "unable to create grpc client");

  std::vector<int32_t> input0_data(16), input1_data(16);
  for (int i = 0; i < 16; ++i) {
    input0_data[i] = i;
    input1_data[i] = 1;
  }

  InferInput* input0;
  InferInput* input1;
  FAIL_IF_ERR(InferInput::Create(&input0, "INPUT0", {16}, "INT32"),
              "creating INPUT0");
  FAIL_IF_ERR(InferInput::Create(&input1, "INPUT1", {16}, "INT32"),
              "creating INPUT1");
  std::unique_ptr<InferInput> input0_ptr(input0), input1_ptr(input1);
  FAIL_IF_ERR(
      input0->AppendRaw(reinterpret_cast<uint8_t*>(input0_data.data()),
                        input0_data.size() * sizeof(int32_t)),
      "setting INPUT0 data");
  FAIL_IF_ERR(
      input1->AppendRaw(reinterpret_cast<uint8_t*>(input1_data.data()),
                        input1_data.size() * sizeof(int32_t)),
      "setting INPUT1 data");

  InferOptions options("add_sub");
  InferResult* results;
  FAIL_IF_ERR(client->Infer(&results, options, {input0, input1}),
              "running inference");
  std::unique_ptr<InferResult> results_ptr(results);

  const uint8_t* output0;
  size_t output0_size;
  FAIL_IF_ERR(results->RawData("OUTPUT0", &output0, &output0_size),
              "getting OUTPUT0");
  const uint8_t* output1;
  size_t output1_size;
  FAIL_IF_ERR(results->RawData("OUTPUT1", &output1, &output1_size),
              "getting OUTPUT1");
  const int32_t* sum = reinterpret_cast<const int32_t*>(output0);
  const int32_t* diff = reinterpret_cast<const int32_t*>(output1);
  for (int i = 0; i < 16; ++i) {
    printf("%d + %d = %d, %d - %d = %d\n", input0_data[i], input1_data[i],
           sum[i], input0_data[i], input1_data[i], diff[i]);
    if (sum[i] != input0_data[i] + input1_data[i] ||
        diff[i] != input0_data[i] - input1_data[i]) {
      fprintf(stderr, "error: incorrect result\n");
      return 1;
    }
  }
  printf("PASS : Infer\n");
  return 0;
}
