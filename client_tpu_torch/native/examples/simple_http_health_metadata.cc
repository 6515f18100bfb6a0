// Health + metadata probes.
// Parity: ref:src/c++/examples/simple_http_health_metadata.cc.
#include <iostream>

#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = "localhost:8000";
  for (int i = 1; i < argc - 1; ++i)
    if (std::string(argv[i]) == "-u") url = argv[i + 1];

  std::unique_ptr<InferenceServerHttpClient> client;
  InferenceServerHttpClient::Create(&client, url);

  bool live = false, ready = false, model_ready = false;
  if (!client->IsServerLive(&live).IsOk() || !live) {
    std::cerr << "error: server not live" << std::endl;
    return 1;
  }
  if (!client->IsServerReady(&ready).IsOk() || !ready) {
    std::cerr << "error: server not ready" << std::endl;
    return 1;
  }
  if (!client->IsModelReady(&model_ready, "add_sub").IsOk() ||
      !model_ready) {
    std::cerr << "error: add_sub not ready" << std::endl;
    return 1;
  }
  json::Value meta;
  if (!client->ServerMetadata(&meta).IsOk() || !meta.Has("name")) {
    std::cerr << "error: bad server metadata" << std::endl;
    return 1;
  }
  std::cout << "server: " << meta.At("name").AsString() << std::endl;
  json::Value mmeta;
  if (!client->ModelMetadata(&mmeta, "add_sub").IsOk()) {
    std::cerr << "error: bad model metadata" << std::endl;
    return 1;
  }
  json::Value stats;
  if (!client->ModelInferenceStatistics(&stats, "add_sub").IsOk()) {
    std::cerr << "error: bad statistics" << std::endl;
    return 1;
  }
  std::cout << "PASS : health metadata" << std::endl;
  return 0;
}
