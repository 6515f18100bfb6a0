// Image classification client: loads a PPM (P6) image, preprocesses
// (resize + NONE/VGG/INCEPTION scaling), batches, infers over HTTP or
// gRPC, and prints top-K classifications.
//
// Parity role: ref:src/c++/examples/image_client.cc:1-1120 — re-designed
// without the OpenCV dependency: PPM input + nearest-neighbor resize
// keep this example dependency-free (the Python image_client handles
// arbitrary formats via PIL).
//
// Usage: image_client [-i http|grpc] [-u url] [-m model] [-b batch]
//                     [-c topk] [-s NONE|VGG|INCEPTION] image.ppm
#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <memory>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "client_tpu_torch/http_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

namespace {

constexpr int kSide = 224;

bool LoadPpm(const std::string& path, std::vector<uint8_t>* rgb, int* w,
             int* h) {
  std::ifstream f(path, std::ios::binary);
  if (!f.good()) return false;
  std::string magic;
  f >> magic;
  if (magic != "P6") return false;
  auto skip_ws_comments = [&f]() {
    while (true) {
      int c = f.peek();
      if (c == '#') {
        std::string line;
        std::getline(f, line);
      } else if (isspace(c)) {
        f.get();
      } else {
        break;
      }
    }
  };
  skip_ws_comments();
  int maxval = 0;
  f >> *w;
  skip_ws_comments();
  f >> *h;
  skip_ws_comments();
  f >> maxval;
  f.get();  // single whitespace after maxval
  if (*w <= 0 || *h <= 0 || maxval != 255) return false;
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  f.read(reinterpret_cast<char*>(rgb->data()), rgb->size());
  return f.gcount() == static_cast<std::streamsize>(rgb->size());
}

// Nearest-neighbor resize + channel scaling into [224,224,3] fp32.
// Scaling parity: ref image_client.cc:85-130 (NONE / VGG mean-subtract /
// INCEPTION [-1,1]).
void Preprocess(const std::vector<uint8_t>& rgb, int w, int h,
                const std::string& scale, std::vector<float>* out) {
  out->resize(kSide * kSide * 3);
  const float vgg_mean[3] = {123.68f, 116.779f, 103.939f};
  for (int y = 0; y < kSide; ++y) {
    int sy = y * h / kSide;
    for (int x = 0; x < kSide; ++x) {
      int sx = x * w / kSide;
      for (int c = 0; c < 3; ++c) {
        float v = rgb[(static_cast<size_t>(sy) * w + sx) * 3 + c];
        if (scale == "INCEPTION") {
          v = v / 127.5f - 1.0f;
        } else if (scale == "VGG") {
          v = v - vgg_mean[c];
        }
        (*out)[(static_cast<size_t>(y) * kSide + x) * 3 + c] = v;
      }
    }
  }
}

struct TopK {
  float score;
  int index;
};

void PrintTopK(const float* logits, size_t n, int k, int batch_index) {
  std::vector<TopK> entries(n);
  for (size_t i = 0; i < n; ++i)
    entries[i] = {logits[i], static_cast<int>(i)};
  std::partial_sort(entries.begin(),
                    entries.begin() + std::min<size_t>(k, n),
                    entries.end(),
                    [](const TopK& a, const TopK& b) {
                      return a.score > b.score;
                    });
  for (int i = 0; i < k && i < static_cast<int>(n); ++i) {
    std::cout << "  image " << batch_index << ": class "
              << entries[i].index << " score " << entries[i].score
              << std::endl;
  }
}

}  // namespace

int main(int argc, char** argv) {
  std::string protocol = "http";
  std::string url;
  std::string model = "resnet50";
  std::string scale = "INCEPTION";
  std::string image_path;
  int batch = 1, topk = 3;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "-i" && i + 1 < argc) protocol = argv[++i];
    else if (a == "-u" && i + 1 < argc) url = argv[++i];
    else if (a == "-m" && i + 1 < argc) model = argv[++i];
    else if (a == "-b" && i + 1 < argc) batch = atoi(argv[++i]);
    else if (a == "-c" && i + 1 < argc) topk = atoi(argv[++i]);
    else if (a == "-s" && i + 1 < argc) scale = argv[++i];
    else image_path = a;
  }
  if (image_path.empty()) {
    std::cerr << "usage: image_client [-i http|grpc] [-u url] [-m model] "
                 "[-b batch] [-c topk] [-s NONE|VGG|INCEPTION] image.ppm"
              << std::endl;
    return 2;
  }
  if (url.empty())
    url = (protocol == "grpc") ? "localhost:8001" : "localhost:8000";

  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!LoadPpm(image_path, &rgb, &w, &h)) {
    std::cerr << "error: cannot load PPM (P6) image " << image_path
              << std::endl;
    return 1;
  }
  std::vector<float> one;
  Preprocess(rgb, w, h, scale, &one);

  // batch = the same image repeated (parity: ref image_client batching)
  std::vector<float> batched;
  batched.reserve(one.size() * batch);
  for (int b = 0; b < batch; ++b)
    batched.insert(batched.end(), one.begin(), one.end());

  InferInput* input;
  FAIL_IF_ERR(InferInput::Create(&input, "image",
                                 {batch, kSide, kSide, 3}, "FP32"),
              "input");
  std::unique_ptr<InferInput> input_owned(input);
  FAIL_IF_ERR(
      input->AppendRaw(reinterpret_cast<uint8_t*>(batched.data()),
                       batched.size() * sizeof(float)),
      "input data");

  InferOptions options(model);
  InferResult* result = nullptr;
  if (protocol == "grpc") {
    std::unique_ptr<InferenceServerGrpcClient> client;
    FAIL_IF_ERR(InferenceServerGrpcClient::Create(&client, url), "client");
    FAIL_IF_ERR(client->Infer(&result, options, {input}), "infer");
  } else {
    std::unique_ptr<InferenceServerHttpClient> client;
    FAIL_IF_ERR(InferenceServerHttpClient::Create(&client, url), "client");
    FAIL_IF_ERR(client->Infer(&result, options, {input}), "infer");
  }
  std::unique_ptr<InferResult> owned(result);
  FAIL_IF_ERR(result->RequestStatus(), "request failed");

  const uint8_t* buf;
  size_t size;
  FAIL_IF_ERR(result->RawData("logits", &buf, &size), "logits");
  const float* logits = reinterpret_cast<const float*>(buf);
  size_t classes = size / sizeof(float) / batch;
  for (int b = 0; b < batch; ++b) {
    PrintTopK(logits + b * classes, classes, topk, b);
  }
  std::cout << "PASS : classified " << batch << " image(s)" << std::endl;
  return 0;
}
