// BYTES/string tensors against add_sub_string.
// Parity: ref:src/c++/examples/simple_http_string_infer_client.cc.
#include <iostream>
#include <string>
#include <vector>

#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = "localhost:8000";
  for (int i = 1; i < argc - 1; ++i)
    if (std::string(argv[i]) == "-u") url = argv[i + 1];

  std::unique_ptr<InferenceServerHttpClient> client;
  InferenceServerHttpClient::Create(&client, url);

  std::vector<std::string> in0, in1;
  for (int i = 0; i < 16; ++i) {
    in0.push_back(std::to_string(i));
    in1.push_back("1");
  }
  InferInput* i0;
  InferInput* i1;
  InferInput::Create(&i0, "INPUT0", {16}, "BYTES");
  InferInput::Create(&i1, "INPUT1", {16}, "BYTES");
  std::unique_ptr<InferInput> i0_owned(i0), i1_owned(i1);
  i0->AppendFromString(in0);
  i1->AppendFromString(in1);

  InferOptions options("add_sub_string");
  InferResult* result;
  Error err = client->Infer(&result, options, {i0, i1});
  if (!err.IsOk()) {
    std::cerr << "error: " << err.Message() << std::endl;
    return 1;
  }
  std::unique_ptr<InferResult> result_owned(result);
  std::vector<std::string> out0;
  err = result->StringData("OUTPUT0", &out0);
  if (!err.IsOk() || out0.size() != 16) {
    std::cerr << "error: bad OUTPUT0" << std::endl;
    return 1;
  }
  for (int i = 0; i < 16; ++i) {
    if (std::stoi(out0[i]) != i + 1) {
      std::cerr << "error: incorrect string result" << std::endl;
      return 1;
    }
  }
  std::cout << "PASS : string infer" << std::endl;
  return 0;
}
