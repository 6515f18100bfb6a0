// Model lifecycle over gRPC: repository index, unload, readiness flip,
// load, readiness restored.
// Parity: ref:src/c++/examples/simple_grpc_model_control.cc.
#include <iostream>
#include <memory>

#include "client_tpu_torch/grpc_client.h"
#include "example_utils.h"

using namespace client_tpu_torch;  // NOLINT

int main(int argc, char** argv) {
  std::string url = ParseUrl(argc, argv, "localhost:8001");
  std::unique_ptr<InferenceServerGrpcClient> client;
  FAIL_IF_ERR(InferenceServerGrpcClient::Create(&client, url), "create");

  const std::string model = "identity";
  bool ready = false;
  FAIL_IF_ERR(client->IsModelReady(&ready, model), "ready probe");
  if (!ready) {
    std::cerr << "FAIL : " << model << " should start ready" << std::endl;
    return 1;
  }

  inference::RepositoryIndexResponse index;
  FAIL_IF_ERR(client->ModelRepositoryIndex(&index), "repo index");
  bool found = false;
  for (const auto& m : index.models())
    if (m.name() == model) found = true;
  if (!found) {
    std::cerr << "FAIL : " << model << " missing from repository index"
              << std::endl;
    return 1;
  }

  FAIL_IF_ERR(client->UnloadModel(model), "unload");
  FAIL_IF_ERR(client->IsModelReady(&ready, model), "ready after unload");
  if (ready) {
    std::cerr << "FAIL : " << model << " still ready after unload"
              << std::endl;
    return 1;
  }

  FAIL_IF_ERR(client->LoadModel(model), "load");
  FAIL_IF_ERR(client->IsModelReady(&ready, model), "ready after load");
  if (!ready) {
    std::cerr << "FAIL : " << model << " not ready after load"
              << std::endl;
    return 1;
  }
  std::cout << "PASS : grpc model control" << std::endl;
  return 0;
}
