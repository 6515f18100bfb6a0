// Model lifecycle: unload -> verify -> load -> verify.
// Parity: ref:src/c++/examples/simple_http_model_control.cc.
#include <iostream>

#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = "localhost:8000";
  std::string model = "identity";
  for (int i = 1; i < argc - 1; ++i) {
    if (std::string(argv[i]) == "-u") url = argv[i + 1];
    if (std::string(argv[i]) == "-m") model = argv[i + 1];
  }

  std::unique_ptr<InferenceServerHttpClient> client;
  InferenceServerHttpClient::Create(&client, url);

  bool ready = false;
  client->IsModelReady(&ready, model);
  if (!ready) {
    std::cerr << "error: model should start ready" << std::endl;
    return 1;
  }
  Error err = client->UnloadModel(model);
  if (!err.IsOk()) {
    std::cerr << "error: unload: " << err.Message() << std::endl;
    return 1;
  }
  client->IsModelReady(&ready, model);
  if (ready) {
    std::cerr << "error: model still ready after unload" << std::endl;
    return 1;
  }
  err = client->LoadModel(model);
  if (!err.IsOk()) {
    std::cerr << "error: load: " << err.Message() << std::endl;
    return 1;
  }
  client->IsModelReady(&ready, model);
  if (!ready) {
    std::cerr << "error: model not ready after load" << std::endl;
    return 1;
  }
  std::cout << "PASS : model control" << std::endl;
  return 0;
}
