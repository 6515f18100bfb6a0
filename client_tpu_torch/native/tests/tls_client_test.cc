// TLS round trips for both native clients against TLS-terminating
// servers: HTTPS (HTTP/1.1 over libssl) and gRPC over TLS (HTTP/2 ALPN
// h2 over libssl).
// Parity role: the reference's HttpSslOptions/SslOptions paths
// (ref:src/c++/library/http_client.h:46, grpc_client.h:42), validated
// by the server repo's qa/L0_https job; here a self-signed CA is passed
// explicitly.
//
// Usage: tls_client_test -u host:https_port -g host:grpc_tls_port
//        -c ca.pem
#include <cstdint>
#include <iostream>
#include <memory>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

namespace {

int CheckAddSub(InferResult* result) {
  std::unique_ptr<InferResult> owned(result);
  if (!result->RequestStatus().IsOk()) {
    std::cerr << "FAIL : request: " << result->RequestStatus().Message()
              << std::endl;
    return 1;
  }
  const uint8_t* buf;
  size_t size;
  if (!result->RawData("OUTPUT0", &buf, &size).IsOk() ||
      size != 16 * sizeof(int32_t)) {
    std::cerr << "FAIL : OUTPUT0 missing" << std::endl;
    return 1;
  }
  const int32_t* out = reinterpret_cast<const int32_t*>(buf);
  for (int i = 0; i < 16; ++i) {
    if (out[i] != i + 1) {
      std::cerr << "FAIL : value mismatch" << std::endl;
      return 1;
    }
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string https_url, grpc_url, ca;
  for (int i = 1; i < argc - 1; ++i) {
    std::string a = argv[i];
    if (a == "-u") https_url = argv[i + 1];
    if (a == "-g") grpc_url = argv[i + 1];
    if (a == "-c") ca = argv[i + 1];
  }
  if (https_url.empty() || ca.empty()) {
    std::cerr << "usage: tls_client_test -u host:port -g host:port "
                 "-c ca.pem" << std::endl;
    return 2;
  }
  if (!TlsStream::Available()) {
    std::cerr << "SKIP : no libssl on this system" << std::endl;
    return 0;
  }

  std::vector<int32_t> input0(16), input1(16, 1);
  for (int i = 0; i < 16; ++i) input0[i] = i;

  auto make_inputs = [&](std::vector<std::unique_ptr<InferInput>>* owned) {
    InferInput* i0;
    InferInput* i1;
    InferInput::Create(&i0, "INPUT0", {16}, "INT32");
    InferInput::Create(&i1, "INPUT1", {16}, "INT32");
    owned->emplace_back(i0);
    owned->emplace_back(i1);
    i0->AppendRaw(reinterpret_cast<uint8_t*>(input0.data()),
                  16 * sizeof(int32_t));
    i1->AppendRaw(reinterpret_cast<uint8_t*>(input1.data()),
                  16 * sizeof(int32_t));
    return std::vector<InferInput*>{i0, i1};
  };

  // ---- HTTPS ----
  {
    HttpSslOptions ssl;
    ssl.ca_info = ca;
    std::unique_ptr<InferenceServerHttpClient> client;
    Error err = InferenceServerHttpClient::Create(
        &client, "https://" + https_url, false, 2, ssl);
    if (!err.IsOk()) {
      std::cerr << "FAIL : https client: " << err.Message() << std::endl;
      return 1;
    }
    bool live = false;
    err = client->IsServerLive(&live);
    if (!err.IsOk() || !live) {
      std::cerr << "FAIL : https liveness: " << err.Message() << std::endl;
      return 1;
    }
    std::vector<std::unique_ptr<InferInput>> owned;
    auto inputs = make_inputs(&owned);
    InferOptions options("add_sub");
    InferResult* result = nullptr;
    err = client->Infer(&result, options, inputs);
    if (!err.IsOk()) {
      std::cerr << "FAIL : https infer: " << err.Message() << std::endl;
      return 1;
    }
    if (CheckAddSub(result)) return 1;
    // compressed request over TLS too
    result = nullptr;
    err = client->Infer(&result, options, inputs, {},
                        CompressionType::GZIP, CompressionType::GZIP);
    if (!err.IsOk()) {
      std::cerr << "FAIL : https gzip infer: " << err.Message()
                << std::endl;
      return 1;
    }
    if (CheckAddSub(result)) return 1;
    std::cout << "ok https (+gzip)" << std::endl;
  }

  // ---- gRPC over TLS ----
  if (!grpc_url.empty()) {
    SslOptions ssl;
    ssl.use_ssl = true;
    ssl.root_certificates = ca;
    std::unique_ptr<InferenceServerGrpcClient> client;
    Error err = InferenceServerGrpcClient::Create(&client, grpc_url, false,
                                                  {}, ssl);
    if (!err.IsOk()) {
      std::cerr << "FAIL : grpc tls client: " << err.Message()
                << std::endl;
      return 1;
    }
    bool live = false;
    err = client->IsServerLive(&live);
    if (!err.IsOk() || !live) {
      std::cerr << "FAIL : grpc tls liveness: " << err.Message()
                << std::endl;
      return 1;
    }
    std::vector<std::unique_ptr<InferInput>> owned;
    auto inputs = make_inputs(&owned);
    InferOptions options("add_sub");
    InferResult* result = nullptr;
    err = client->Infer(&result, options, inputs);
    if (!err.IsOk()) {
      std::cerr << "FAIL : grpc tls infer: " << err.Message() << std::endl;
      return 1;
    }
    if (CheckAddSub(result)) return 1;
    std::cout << "ok grpc-tls" << std::endl;
  }

  std::cout << "PASS : TLS round trips" << std::endl;
  return 0;
}
