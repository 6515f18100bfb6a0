// Sync HTTP inference against add_sub; exits non-zero on mismatch.
// Parity: ref:src/c++/examples/simple_http_infer_client.cc.
#include <cstdint>
#include <iostream>
#include <vector>

#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

#define FAIL_IF_ERR(X, MSG)                                        \
  do {                                                             \
    const Error& err__ = (X);                                      \
    if (!err__.IsOk()) {                                           \
      std::cerr << "error: " << (MSG) << ": " << err__.Message()   \
                << std::endl;                                      \
      return 1;                                                    \
    }                                                              \
  } while (0)

int main(int argc, char** argv) {
  std::string url = "localhost:8000";
  for (int i = 1; i < argc - 1; ++i)
    if (std::string(argv[i]) == "-u") url = argv[i + 1];

  std::unique_ptr<InferenceServerHttpClient> client;
  FAIL_IF_ERR(InferenceServerHttpClient::Create(&client, url),
              "unable to create client");

  std::vector<int32_t> input0(16), input1(16);
  for (int i = 0; i < 16; ++i) {
    input0[i] = i;
    input1[i] = 1;
  }
  InferInput* i0;
  InferInput* i1;
  FAIL_IF_ERR(InferInput::Create(&i0, "INPUT0", {16}, "INT32"), "INPUT0");
  FAIL_IF_ERR(InferInput::Create(&i1, "INPUT1", {16}, "INT32"), "INPUT1");
  std::unique_ptr<InferInput> i0_owned(i0), i1_owned(i1);
  FAIL_IF_ERR(i0->AppendRaw(reinterpret_cast<uint8_t*>(input0.data()),
                            input0.size() * sizeof(int32_t)),
              "setting INPUT0");
  FAIL_IF_ERR(i1->AppendRaw(reinterpret_cast<uint8_t*>(input1.data()),
                            input1.size() * sizeof(int32_t)),
              "setting INPUT1");

  InferOptions options("add_sub");
  InferResult* result;
  FAIL_IF_ERR(client->Infer(&result, options, {i0, i1}), "infer");
  std::unique_ptr<InferResult> result_owned(result);
  FAIL_IF_ERR(result->RequestStatus(), "request failed");

  const uint8_t* buf;
  size_t size;
  FAIL_IF_ERR(result->RawData("OUTPUT0", &buf, &size), "OUTPUT0");
  const int32_t* out0 = reinterpret_cast<const int32_t*>(buf);
  FAIL_IF_ERR(result->RawData("OUTPUT1", &buf, &size), "OUTPUT1");
  const int32_t* out1 = reinterpret_cast<const int32_t*>(buf);
  for (int i = 0; i < 16; ++i) {
    std::cout << input0[i] << " + " << input1[i] << " = " << out0[i]
              << ", - = " << out1[i] << std::endl;
    if (out0[i] != input0[i] + input1[i] ||
        out1[i] != input0[i] - input1[i]) {
      std::cerr << "error: incorrect result" << std::endl;
      return 1;
    }
  }
  std::cout << "PASS : infer" << std::endl;
  return 0;
}
