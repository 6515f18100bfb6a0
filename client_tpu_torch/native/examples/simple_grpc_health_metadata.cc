// Parity: ref:src/c++/examples/simple_grpc_health_metadata.cc — health +
// metadata over the native gRPC client.

#include <cstdio>
#include <cstring>
#include <string>

#include "client_tpu_torch/grpc_client.h"

using namespace client_tpu_torch;

int main(int argc, char** argv) {
  std::string url = "localhost:8001";
  for (int i = 1; i < argc; ++i) {
    if (!strcmp(argv[i], "-u") && i + 1 < argc) url = argv[++i];
  }

  std::unique_ptr<InferenceServerGrpcClient> client;
  Error err = InferenceServerGrpcClient::Create(&client, url);
  if (!err.IsOk()) {
    fprintf(stderr, "error: %s\n", err.Message().c_str());
    return 1;
  }

  bool live = false, ready = false;
  err = client->IsServerLive(&live);
  if (!err.IsOk()) {
    fprintf(stderr, "error: IsServerLive: %s\n", err.Message().c_str());
    return 1;
  }
  printf("Server Live: %s\n", live ? "true" : "false");
  client->IsServerReady(&ready);
  printf("Server Ready: %s\n", ready ? "true" : "false");

  inference::ServerMetadataResponse meta;
  err = client->ServerMetadata(&meta);
  if (!err.IsOk()) {
    fprintf(stderr, "error: ServerMetadata: %s\n", err.Message().c_str());
    return 1;
  }
  printf("Server Name: %s\nServer Version: %s\nExtensions:",
         meta.name().c_str(), meta.version().c_str());
  for (const auto& ext : meta.extensions()) printf(" %s", ext.c_str());
  printf("\n");
  return live && ready ? 0 : 1;
}
