// Ensemble client: uploads an ENCODED image (any format PIL decodes) as
// a BYTES tensor to the preprocess->resnet ensemble; the server decodes,
// resizes, and classifies.
// Parity: ref:src/c++/examples/ensemble_image_client.cc.
#include <algorithm>
#include <cstdint>
#include <fstream>
#include <iostream>
#include <memory>
#include <string>
#include <vector>

#include "client_tpu_torch/http_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = "localhost:8000";
  std::string model = "preprocess_resnet50";
  std::string image_path;
  int topk = 3;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "-u" && i + 1 < argc) url = argv[++i];
    else if (a == "-m" && i + 1 < argc) model = argv[++i];
    else if (a == "-c" && i + 1 < argc) topk = atoi(argv[++i]);
    else image_path = a;
  }
  if (image_path.empty()) {
    std::cerr << "usage: ensemble_image_client [-u url] [-m model] "
                 "[-c topk] image.{jpg,png,...}" << std::endl;
    return 2;
  }

  std::ifstream f(image_path, std::ios::binary);
  if (!f.good()) {
    std::cerr << "error: cannot read " << image_path << std::endl;
    return 1;
  }
  std::string encoded((std::istreambuf_iterator<char>(f)),
                      std::istreambuf_iterator<char>());

  InferInput* input;
  FAIL_IF_ERR(InferInput::Create(&input, "raw_image", {1, 1}, "BYTES"),
              "input");
  std::unique_ptr<InferInput> input_owned(input);
  FAIL_IF_ERR(input->AppendFromString({encoded}), "input data");

  std::unique_ptr<InferenceServerHttpClient> client;
  FAIL_IF_ERR(InferenceServerHttpClient::Create(&client, url), "client");

  InferOptions options(model);
  InferResult* result = nullptr;
  FAIL_IF_ERR(client->Infer(&result, options, {input}), "infer");
  std::unique_ptr<InferResult> owned(result);
  FAIL_IF_ERR(result->RequestStatus(), "request failed");

  const uint8_t* buf;
  size_t size;
  FAIL_IF_ERR(result->RawData("logits", &buf, &size), "logits");
  const float* logits = reinterpret_cast<const float*>(buf);
  size_t classes = size / sizeof(float);
  std::vector<int> idx(classes);
  for (size_t i = 0; i < classes; ++i) idx[i] = static_cast<int>(i);
  std::partial_sort(idx.begin(),
                    idx.begin() + std::min<size_t>(topk, classes),
                    idx.end(), [&](int a, int b) {
                      return logits[a] > logits[b];
                    });
  for (int i = 0; i < topk && i < static_cast<int>(classes); ++i)
    std::cout << "class " << idx[i] << " score " << logits[idx[i]]
              << std::endl;
  std::cout << "PASS : ensemble classification" << std::endl;
  return 0;
}
