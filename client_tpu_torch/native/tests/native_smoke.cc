// End-to-end smoke binary for the native client library.
// Role parity: ref:src/c++/examples/simple_http_infer_client.cc +
// simple_http_shm_client.cc (exits non-zero on any mismatch; server QA
// runs these as black-box checks).
//
// Usage: native_smoke <url>   (expects the demo add_sub model: INT32[16],
// OUTPUT0 = INPUT0+INPUT1, OUTPUT1 = INPUT0-INPUT1)
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <iostream>
#include <mutex>
#include <vector>

#include "client_tpu_torch/http_client.h"
#include "client_tpu_torch/shm_utils.h"

using namespace client_tpu_torch;  // NOLINT

#define CHECK_OK(err)                                              \
  do {                                                             \
    const Error& e__ = (err);                                      \
    if (!e__.IsOk()) {                                             \
      std::cerr << "FAIL " << __LINE__ << ": " << e__.Message()    \
                << std::endl;                                      \
      return 1;                                                    \
    }                                                              \
  } while (0)

#define CHECK_TRUE(cond, msg)                                      \
  do {                                                             \
    if (!(cond)) {                                                 \
      std::cerr << "FAIL " << __LINE__ << ": " << (msg)            \
                << std::endl;                                      \
      return 1;                                                    \
    }                                                              \
  } while (0)

int main(int argc, char** argv) {
  const std::string url = argc > 1 ? argv[1] : "localhost:8000";
  std::unique_ptr<InferenceServerHttpClient> client;
  CHECK_OK(InferenceServerHttpClient::Create(&client, url));

  bool live = false, ready = false;
  CHECK_OK(client->IsServerLive(&live));
  CHECK_TRUE(live, "server not live");
  CHECK_OK(client->IsServerReady(&ready));
  CHECK_TRUE(ready, "server not ready");

  json::Value meta;
  CHECK_OK(client->ServerMetadata(&meta));
  CHECK_TRUE(meta.Has("name"), "metadata missing name");
  CHECK_OK(client->ModelMetadata(&meta, "add_sub"));
  CHECK_TRUE(meta.At("name").AsString() == "add_sub", "wrong model name");
  CHECK_OK(client->ModelConfig(&meta, "add_sub"));
  json::Value stats;
  CHECK_OK(client->ModelInferenceStatistics(&stats, "add_sub"));
  CHECK_TRUE(stats.Has("model_stats"), "missing model_stats");

  // ---- binary-protocol infer ----
  std::vector<int32_t> in0(16), in1(16);
  for (int i = 0; i < 16; ++i) {
    in0[i] = i;
    in1[i] = 1;
  }
  InferInput* i0 = nullptr;
  InferInput* i1 = nullptr;
  CHECK_OK(InferInput::Create(&i0, "INPUT0", {16}, "INT32"));
  CHECK_OK(InferInput::Create(&i1, "INPUT1", {16}, "INT32"));
  CHECK_OK(i0->AppendRaw(reinterpret_cast<uint8_t*>(in0.data()),
                         in0.size() * 4));
  CHECK_OK(i1->AppendRaw(reinterpret_cast<uint8_t*>(in1.data()),
                         in1.size() * 4));
  InferRequestedOutput* o0 = nullptr;
  InferRequestedOutput* o1 = nullptr;
  CHECK_OK(InferRequestedOutput::Create(&o0, "OUTPUT0"));
  CHECK_OK(InferRequestedOutput::Create(&o1, "OUTPUT1"));

  InferOptions options("add_sub");
  InferResult* result = nullptr;
  CHECK_OK(client->Infer(&result, options, {i0, i1}, {o0, o1}));
  CHECK_OK(result->RequestStatus());
  const uint8_t* buf;
  size_t size;
  CHECK_OK(result->RawData("OUTPUT0", &buf, &size));
  CHECK_TRUE(size == 64, "OUTPUT0 wrong size");
  const int32_t* out0 = reinterpret_cast<const int32_t*>(buf);
  for (int i = 0; i < 16; ++i)
    CHECK_TRUE(out0[i] == in0[i] + in1[i], "OUTPUT0 mismatch");
  CHECK_OK(result->RawData("OUTPUT1", &buf, &size));
  const int32_t* out1 = reinterpret_cast<const int32_t*>(buf);
  for (int i = 0; i < 16; ++i)
    CHECK_TRUE(out1[i] == in0[i] - in1[i], "OUTPUT1 mismatch");
  std::vector<int64_t> shape;
  CHECK_OK(result->Shape("OUTPUT0", &shape));
  CHECK_TRUE(shape.size() == 1 && shape[0] == 16, "bad shape");
  delete result;

  // ---- async infer ----
  std::mutex mu;
  std::condition_variable cv;
  int done = 0;
  bool async_ok = true;
  for (int k = 0; k < 4; ++k) {
    CHECK_OK(client->AsyncInfer(
        [&](InferResult* r) {
          const uint8_t* b;
          size_t s;
          if (!r->RequestStatus().IsOk() ||
              !r->RawData("OUTPUT0", &b, &s).IsOk() || s != 64) {
            async_ok = false;
          }
          delete r;
          std::lock_guard<std::mutex> lk(mu);
          ++done;
          cv.notify_one();
        },
        options, {i0, i1}, {o0, o1}));
  }
  {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return done == 4; });
  }
  CHECK_TRUE(async_ok, "async infer failed");

  // ---- system shared memory round-trip ----
  const std::string shm_key = "/native_smoke_shm";
  int shm_fd = -1;
  UnlinkSharedMemoryRegion(shm_key);  // stale region from a failed run
  CHECK_OK(CreateSharedMemoryRegion(shm_key, 256, &shm_fd));
  void* shm_base = nullptr;
  CHECK_OK(MapSharedMemory(shm_fd, 0, 256, &shm_base));
  std::memcpy(shm_base, in0.data(), 64);
  std::memcpy(static_cast<char*>(shm_base) + 64, in1.data(), 64);
  CHECK_OK(client->RegisterSystemSharedMemory("native_smoke", shm_key, 256));

  InferInput* s0 = nullptr;
  InferInput* s1 = nullptr;
  CHECK_OK(InferInput::Create(&s0, "INPUT0", {16}, "INT32"));
  CHECK_OK(InferInput::Create(&s1, "INPUT1", {16}, "INT32"));
  CHECK_OK(s0->SetSharedMemory("native_smoke", 64, 0));
  CHECK_OK(s1->SetSharedMemory("native_smoke", 64, 64));
  InferRequestedOutput* so0 = nullptr;
  CHECK_OK(InferRequestedOutput::Create(&so0, "OUTPUT0"));
  CHECK_OK(so0->SetSharedMemory("native_smoke", 64, 128));

  CHECK_OK(client->Infer(&result, options, {s0, s1}, {so0, o1}));
  CHECK_OK(result->RequestStatus());
  const int32_t* shm_out =
      reinterpret_cast<const int32_t*>(static_cast<char*>(shm_base) + 128);
  for (int i = 0; i < 16; ++i)
    CHECK_TRUE(shm_out[i] == in0[i] + in1[i], "shm OUTPUT0 mismatch");
  delete result;

  CHECK_OK(client->UnregisterSystemSharedMemory("native_smoke"));
  CHECK_OK(UnmapSharedMemory(shm_base, 256));
  CHECK_OK(CloseSharedMemory(shm_fd));
  CHECK_OK(UnlinkSharedMemoryRegion(shm_key));

  // ---- client stats ----
  InferStat stat;
  CHECK_OK(client->ClientInferStat(&stat));
  CHECK_TRUE(stat.completed_request_count >= 6, "stat count too low");

  delete i0;
  delete i1;
  delete o0;
  delete o1;
  delete s0;
  delete s1;
  delete so0;
  std::cout << "native_smoke PASS" << std::endl;
  return 0;
}
