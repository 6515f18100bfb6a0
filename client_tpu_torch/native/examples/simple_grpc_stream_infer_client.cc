// Parity: ref:src/c++/examples/simple_grpc_sequence_stream_client.cc
// (streaming shape) — N add_sub requests over one bidi
// ModelStreamInfer stream.

#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"

using namespace client_tpu_torch;

int main(int argc, char** argv) {
  std::string url = "localhost:8001";
  int n = 8;
  for (int i = 1; i < argc; ++i) {
    if (!strcmp(argv[i], "-u") && i + 1 < argc) url = argv[++i];
    if (!strcmp(argv[i], "-n") && i + 1 < argc) n = atoi(argv[++i]);
  }

  std::unique_ptr<InferenceServerGrpcClient> client;
  Error err = InferenceServerGrpcClient::Create(&client, url);
  if (!err.IsOk()) {
    fprintf(stderr, "error: %s\n", err.Message().c_str());
    return 1;
  }

  std::vector<int32_t> a(16), b(16);
  for (int i = 0; i < 16; ++i) {
    a[i] = i;
    b[i] = 1;
  }
  InferInput *in0, *in1;
  InferInput::Create(&in0, "INPUT0", {16}, "INT32");
  InferInput::Create(&in1, "INPUT1", {16}, "INT32");
  std::unique_ptr<InferInput> p0(in0), p1(in1);
  in0->AppendRaw(reinterpret_cast<uint8_t*>(a.data()),
                 a.size() * sizeof(int32_t));
  in1->AppendRaw(reinterpret_cast<uint8_t*>(b.data()),
                 b.size() * sizeof(int32_t));

  std::mutex mu;
  std::condition_variable cv;
  int got = 0, failed = 0;
  err = client->StartStream([&](InferResult* result) {
    std::unique_ptr<InferResult> r(result);
    std::string id;
    r->Id(&id);
    if (!r->RequestStatus().IsOk()) {
      fprintf(stderr, "stream error for %s: %s\n", id.c_str(),
              r->RequestStatus().Message().c_str());
      std::lock_guard<std::mutex> lock(mu);
      ++failed;
      ++got;
      cv.notify_all();
      return;
    }
    const uint8_t* out;
    size_t out_size;
    r->RawData("OUTPUT0", &out, &out_size);
    printf("response %s: OUTPUT0[0]=%d\n", id.c_str(),
           reinterpret_cast<const int32_t*>(out)[0]);
    std::lock_guard<std::mutex> lock(mu);
    ++got;
    cv.notify_all();
  });
  if (!err.IsOk()) {
    fprintf(stderr, "error: StartStream: %s\n", err.Message().c_str());
    return 1;
  }

  for (int i = 0; i < n; ++i) {
    InferOptions options("add_sub");
    options.request_id = std::to_string(i);
    err = client->AsyncStreamInfer(options, {in0, in1});
    if (!err.IsOk()) {
      fprintf(stderr, "error: AsyncStreamInfer: %s\n",
              err.Message().c_str());
      return 1;
    }
  }

  std::unique_lock<std::mutex> lock(mu);
  if (!cv.wait_for(lock, std::chrono::seconds(30),
                   [&] { return got == n; })) {
    fprintf(stderr, "error: timed out (%d/%d)\n", got, n);
    return 1;
  }
  lock.unlock();
  client->StopStream();
  if (failed) {
    fprintf(stderr, "FAIL: %d stream errors\n", failed);
    return 1;
  }
  printf("PASS : %d responses over one stream\n", n);
  return 0;
}
