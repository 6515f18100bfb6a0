// Native gRPC client smoke test against a live server.
// Usage: grpc_smoke <host:port>
// Exercises: health, metadata, config, statistics, unary Infer (add_sub
// INT32), InferMulti broadcast, AsyncInfer, bidi streaming
// (AsyncStreamInfer on add_sub), error path (unknown model), shm status.
// Parity role: ref:src/c++/tests/cc_client_test.cc (gRPC half).

#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>

#include "client_tpu_torch/grpc_client.h"

using client_tpu_torch::Error;
using client_tpu_torch::InferenceServerGrpcClient;
using client_tpu_torch::InferInput;
using client_tpu_torch::InferOptions;
using client_tpu_torch::InferRequestedOutput;
using client_tpu_torch::InferResult;

#define CHECK_OK(err, what)                                          \
  do {                                                               \
    const Error& e__ = (err);                                        \
    if (!e__.IsOk()) {                                               \
      fprintf(stderr, "FAIL %s: %s\n", what, e__.Message().c_str()); \
      return 1;                                                      \
    }                                                                \
    printf("ok: %s\n", what);                                        \
  } while (0)

static int CheckAddSubResult(InferResult* result, const int32_t* a,
                             const int32_t* b, const char* what) {
  const uint8_t* buf = nullptr;
  size_t size = 0;
  Error err = result->RawData("OUTPUT0", &buf, &size);
  if (!err.IsOk() || size != 16 * sizeof(int32_t)) {
    fprintf(stderr, "FAIL %s: OUTPUT0 raw (%s)\n", what,
            err.Message().c_str());
    return 1;
  }
  const int32_t* sum = reinterpret_cast<const int32_t*>(buf);
  for (int i = 0; i < 16; ++i) {
    if (sum[i] != a[i] + b[i]) {
      fprintf(stderr, "FAIL %s: sum[%d]=%d != %d\n", what, i, sum[i],
              a[i] + b[i]);
      return 1;
    }
  }
  err = result->RawData("OUTPUT1", &buf, &size);
  if (!err.IsOk()) {
    fprintf(stderr, "FAIL %s: OUTPUT1 raw\n", what);
    return 1;
  }
  const int32_t* diff = reinterpret_cast<const int32_t*>(buf);
  for (int i = 0; i < 16; ++i) {
    if (diff[i] != a[i] - b[i]) {
      fprintf(stderr, "FAIL %s: diff[%d]\n", what, i);
      return 1;
    }
  }
  printf("ok: %s\n", what);
  return 0;
}

int main(int argc, char** argv) {
  std::string url = argc > 1 ? argv[1] : "localhost:8001";
  std::unique_ptr<InferenceServerGrpcClient> client;
  CHECK_OK(InferenceServerGrpcClient::Create(&client, url), "Create");

  bool live = false, ready = false;
  CHECK_OK(client->IsServerLive(&live), "IsServerLive");
  if (!live) {
    fprintf(stderr, "FAIL server not live\n");
    return 1;
  }
  CHECK_OK(client->IsServerReady(&ready), "IsServerReady");
  bool model_ready = false;
  CHECK_OK(client->IsModelReady(&model_ready, "add_sub"),
           "IsModelReady(add_sub)");
  if (!model_ready) {
    fprintf(stderr, "FAIL add_sub not ready\n");
    return 1;
  }

  inference::ServerMetadataResponse server_meta;
  CHECK_OK(client->ServerMetadata(&server_meta), "ServerMetadata");
  if (server_meta.name() != "client-tpu-torch-server") {
    fprintf(stderr, "FAIL server name '%s'\n", server_meta.name().c_str());
    return 1;
  }
  inference::ModelMetadataResponse model_meta;
  CHECK_OK(client->ModelMetadata(&model_meta, "add_sub"), "ModelMetadata");
  if (model_meta.inputs_size() != 2) {
    fprintf(stderr, "FAIL metadata inputs %d\n", model_meta.inputs_size());
    return 1;
  }
  inference::ModelConfigResponse config;
  CHECK_OK(client->ModelConfig(&config, "add_sub"), "ModelConfig");
  inference::RepositoryIndexResponse index;
  CHECK_OK(client->ModelRepositoryIndex(&index), "RepositoryIndex");

  // unary infer
  int32_t a[16], b[16];
  for (int i = 0; i < 16; ++i) {
    a[i] = i;
    b[i] = 2 * i + 1;
  }
  InferInput* in0 = nullptr;
  InferInput* in1 = nullptr;
  InferInput::Create(&in0, "INPUT0", {16}, "INT32");
  InferInput::Create(&in1, "INPUT1", {16}, "INT32");
  in0->AppendRaw(reinterpret_cast<uint8_t*>(a), sizeof(a));
  in1->AppendRaw(reinterpret_cast<uint8_t*>(b), sizeof(b));
  InferOptions options("add_sub");
  InferResult* result = nullptr;
  CHECK_OK(client->Infer(&result, options, {in0, in1}), "Infer");
  if (CheckAddSubResult(result, a, b, "Infer result")) return 1;
  delete result;

  // InferMulti with broadcast options
  std::vector<InferResult*> results;
  CHECK_OK(client->InferMulti(&results, {options},
                              {{in0, in1}, {in0, in1}}),
           "InferMulti");
  for (auto* r : results) {
    if (CheckAddSubResult(r, a, b, "InferMulti result")) return 1;
    delete r;
  }

  // async infer
  {
    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
    int rc = -1;
    Error err = client->AsyncInfer(
        [&](InferResult* r) {
          int check = r->RequestStatus().IsOk()
                          ? CheckAddSubResult(r, a, b, "AsyncInfer result")
                          : 1;
          delete r;
          std::lock_guard<std::mutex> lock(mu);
          rc = check;
          done = true;
          cv.notify_all();
        },
        options, {in0, in1});
    CHECK_OK(err, "AsyncInfer submit");
    std::unique_lock<std::mutex> lock(mu);
    if (!cv.wait_for(lock, std::chrono::seconds(30),
                     [&] { return done; }) ||
        rc != 0) {
      fprintf(stderr, "FAIL AsyncInfer\n");
      return 1;
    }
  }

  // bidi streaming: N requests, N responses
  {
    constexpr int kN = 8;
    std::mutex mu;
    std::condition_variable cv;
    int got = 0, bad = 0;
    CHECK_OK(client->StartStream([&](InferResult* r) {
             int check = r->RequestStatus().IsOk()
                             ? CheckAddSubResult(r, a, b, "stream result")
                             : 1;
             delete r;
             std::lock_guard<std::mutex> lock(mu);
             bad += check;
             ++got;
             cv.notify_all();
           }),
           "StartStream");
    for (int i = 0; i < kN; ++i) {
      InferOptions sopt("add_sub");
      sopt.request_id = "stream_" + std::to_string(i);
      CHECK_OK(client->AsyncStreamInfer(sopt, {in0, in1}),
               "AsyncStreamInfer");
    }
    std::unique_lock<std::mutex> lock(mu);
    if (!cv.wait_for(lock, std::chrono::seconds(30),
                     [&] { return got == kN; }) ||
        bad != 0) {
      fprintf(stderr, "FAIL streaming: got %d bad %d\n", got, bad);
      return 1;
    }
    lock.unlock();
    CHECK_OK(client->StopStream(), "StopStream");
  }

  // statistics (after traffic)
  inference::ModelStatisticsResponse stats;
  CHECK_OK(client->ModelInferenceStatistics(&stats, "add_sub"),
           "ModelStatistics");
  if (stats.model_stats_size() < 1 ||
      stats.model_stats(0).inference_count() < 1) {
    fprintf(stderr, "FAIL statistics show no inferences\n");
    return 1;
  }

  // shm status verbs
  inference::SystemSharedMemoryStatusResponse sys_status;
  CHECK_OK(client->SystemSharedMemoryStatus(&sys_status),
           "SystemSharedMemoryStatus");
  inference::CudaSharedMemoryStatusResponse cuda_status;
  CHECK_OK(client->CudaSharedMemoryStatus(&cuda_status),
           "CudaSharedMemoryStatus");

  // error path: unknown model must fail with a precise message
  {
    InferResult* r = nullptr;
    InferOptions bad_options("definitely_missing_model");
    Error err = client->Infer(&r, bad_options, {in0, in1});
    if (err.IsOk()) {
      fprintf(stderr, "FAIL unknown model did not error\n");
      return 1;
    }
    printf("ok: unknown model rejected (%s)\n", err.Message().c_str());
    delete r;
  }

  // client stats accumulated
  client_tpu_torch::InferStat stat;
  client->ClientInferStat(&stat);
  if (stat.completed_request_count < 3) {
    fprintf(stderr, "FAIL client stats (%llu)\n",
            (unsigned long long)stat.completed_request_count);
    return 1;
  }

  delete in0;
  delete in1;
  printf("ALL GRPC SMOKE TESTS PASS\n");
  return 0;
}
