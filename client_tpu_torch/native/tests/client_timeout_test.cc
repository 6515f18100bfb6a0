// Client-timeout behavior: sync and async, HTTP and gRPC, against a
// model that delays longer than the configured client timeout.
//
// Parity: ref:src/c++/tests/client_timeout_test.cc:1-391 (CLI harness,
// not gtest) — validates the Deadline Exceeded paths. The serving side
// registers identity_slow (make_identity(delay_s=...)).
//
// Usage: client_timeout_test [-i http|grpc] [-u url] [-m model]
//        [-t timeout_us]
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <iostream>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

namespace {

bool IsTimeoutError(const Error& err) {
  if (err.IsOk()) return false;
  const std::string& m = err.Message();
  return m.find("Deadline") != std::string::npos ||
         m.find("deadline") != std::string::npos ||
         m.find("DEADLINE") != std::string::npos ||
         err.StatusCode() == 499 || err.StatusCode() == 4 /* grpc */;
}

template <typename ClientT>
int RunSync(ClientT* client, const std::string& model,
            uint64_t timeout_us) {
  std::vector<int32_t> data(16, 3);
  InferInput* input;
  InferInput::Create(&input, "INPUT0", {16}, "INT32");
  std::unique_ptr<InferInput> owned(input);
  input->AppendRaw(reinterpret_cast<uint8_t*>(data.data()),
                   data.size() * sizeof(int32_t));
  InferOptions options(model);
  options.client_timeout_us = timeout_us;
  InferResult* result = nullptr;
  Error err = client->Infer(&result, options, {input});
  if (result != nullptr && err.IsOk()) err = result->RequestStatus();
  delete result;
  if (!IsTimeoutError(err)) {
    std::cerr << "FAIL : sync expected a deadline error, got: "
              << (err.IsOk() ? "success" : err.Message()) << std::endl;
    return 1;
  }
  std::cout << "ok sync timeout: " << err.Message() << std::endl;
  return 0;
}

template <typename ClientT>
int RunAsync(ClientT* client, const std::string& model,
             uint64_t timeout_us) {
  std::vector<int32_t> data(16, 3);
  InferInput* input;
  InferInput::Create(&input, "INPUT0", {16}, "INT32");
  std::unique_ptr<InferInput> owned(input);
  input->AppendRaw(reinterpret_cast<uint8_t*>(data.data()),
                   data.size() * sizeof(int32_t));
  InferOptions options(model);
  options.client_timeout_us = timeout_us;

  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  Error got;
  Error err = client->AsyncInfer(
      [&](InferResult* result) {
        std::lock_guard<std::mutex> lk(mu);
        got = result ? result->RequestStatus() : Error("null result");
        delete result;
        done = true;
        cv.notify_one();
      },
      options, {input});
  if (!err.IsOk()) {
    std::cerr << "FAIL : async submit: " << err.Message() << std::endl;
    return 1;
  }
  std::unique_lock<std::mutex> lk(mu);
  if (!cv.wait_for(lk, std::chrono::seconds(30), [&] { return done; })) {
    std::cerr << "FAIL : async callback never fired" << std::endl;
    return 1;
  }
  if (!IsTimeoutError(got)) {
    std::cerr << "FAIL : async expected a deadline error, got: "
              << (got.IsOk() ? "success" : got.Message()) << std::endl;
    return 1;
  }
  std::cout << "ok async timeout: " << got.Message() << std::endl;
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string protocol = "http";
  std::string url;
  std::string model = "identity_slow";
  uint64_t timeout_us = 100 * 1000;  // 100ms << the model's delay
  for (int i = 1; i < argc - 1; ++i) {
    std::string a = argv[i];
    if (a == "-i") protocol = argv[i + 1];
    if (a == "-u") url = argv[i + 1];
    if (a == "-m") model = argv[i + 1];
    if (a == "-t") timeout_us = strtoull(argv[i + 1], nullptr, 10);
  }
  if (url.empty())
    url = (protocol == "grpc") ? "localhost:8001" : "localhost:8000";

  int rc = 0;
  if (protocol == "grpc") {
    std::unique_ptr<InferenceServerGrpcClient> client;
    Error err = InferenceServerGrpcClient::Create(&client, url);
    if (!err.IsOk()) {
      std::cerr << "cannot connect: " << err.Message() << std::endl;
      return 2;
    }
    rc |= RunSync(client.get(), model, timeout_us);
    rc |= RunAsync(client.get(), model, timeout_us);
  } else {
    std::unique_ptr<InferenceServerHttpClient> client;
    Error err = InferenceServerHttpClient::Create(&client, url);
    if (!err.IsOk()) {
      std::cerr << "cannot connect: " << err.Message() << std::endl;
      return 2;
    }
    rc |= RunSync(client.get(), model, timeout_us);
    rc |= RunAsync(client.get(), model, timeout_us);
  }
  if (rc == 0)
    std::cout << "PASS : " << protocol << " client timeouts" << std::endl;
  return rc;
}
