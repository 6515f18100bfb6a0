// Typed client test matrix: the SAME cases run against BOTH native
// clients (HTTP and gRPC), selected per run via -i.
//
// Parity role: ref:src/c++/tests/cc_client_test.cc:132-1043 — the gtest
// TYPED_TEST_P suite instantiated for InferenceServerGrpcClient and
// InferenceServerHttpClient. This environment has no gtest, so a small
// macro harness provides the same structure: each CASE runs for the
// selected client type, failures are collected, exit code is the count.
//
// Requires a live server exposing add_sub (INT32 [16]) on both
// protocols (tests/test_native.py launches it).
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <iostream>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "client_tpu_torch/grpc_client.h"
#include "client_tpu_torch/http_client.h"

using namespace client_tpu_torch;  // NOLINT

namespace {

int g_failures = 0;
std::string g_current;

#define CHECK_MSG(cond, msg)                                          \
  do {                                                                \
    if (!(cond)) {                                                    \
      std::cerr << "FAIL[" << g_current << "]: " << msg << std::endl; \
      ++g_failures;                                                   \
      return;                                                         \
    }                                                                 \
  } while (0)

#define CHECK_OK(err) CHECK_MSG((err).IsOk(), (err).Message())

constexpr size_t kN = 16;

// -- client-type traits: uniform Create/InferMulti/AsyncInferMulti ----

template <typename T>
struct ClientTraits;

template <>
struct ClientTraits<InferenceServerHttpClient> {
  static constexpr const char* kName = "http";
  static constexpr bool kHasCompression = true;
  static Error Create(std::unique_ptr<InferenceServerHttpClient>* c,
                      const std::string& url) {
    return InferenceServerHttpClient::Create(c, url);
  }
  static Error AsyncInferMulti(
      InferenceServerHttpClient* c,
      std::function<void(std::vector<InferResult*>)> cb,
      const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs) {
    return c->AsyncInferMulti(
        [cb](std::vector<InferResult*>* results) { cb(*results); },
        options, inputs, outputs);
  }
};

template <>
struct ClientTraits<InferenceServerGrpcClient> {
  static constexpr const char* kName = "grpc";
  static constexpr bool kHasCompression = false;
  static Error Create(std::unique_ptr<InferenceServerGrpcClient>* c,
                      const std::string& url) {
    return InferenceServerGrpcClient::Create(c, url);
  }
  static Error AsyncInferMulti(
      InferenceServerGrpcClient* c,
      std::function<void(std::vector<InferResult*>)> cb,
      const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs) {
    return c->AsyncInferMulti(std::move(cb), options, inputs, outputs);
  }
};

// -- shared fixtures --------------------------------------------------

struct Request {
  std::vector<int32_t> in0, in1;
  std::vector<InferInput*> inputs;
  std::vector<std::unique_ptr<InferInput>> owned;

  explicit Request(int bias) : in0(kN), in1(kN) {
    for (size_t i = 0; i < kN; ++i) {
      in0[i] = static_cast<int32_t>(i) + bias;
      in1[i] = 1;
    }
    InferInput* i0;
    InferInput* i1;
    InferInput::Create(&i0, "INPUT0", {kN}, "INT32");
    InferInput::Create(&i1, "INPUT1", {kN}, "INT32");
    owned.emplace_back(i0);
    owned.emplace_back(i1);
    i0->AppendRaw(reinterpret_cast<uint8_t*>(in0.data()),
                  kN * sizeof(int32_t));
    i1->AppendRaw(reinterpret_cast<uint8_t*>(in1.data()),
                  kN * sizeof(int32_t));
    inputs = {i0, i1};
  }
};

bool ValidateResult(InferResult* result, const Request& req,
                    bool expect_out0, bool expect_out1,
                    std::string* why) {
  if (!result->RequestStatus().IsOk()) {
    *why = "request failed: " + result->RequestStatus().Message();
    return false;
  }
  const uint8_t* buf;
  size_t size;
  if (expect_out0) {
    Error err = result->RawData("OUTPUT0", &buf, &size);
    if (!err.IsOk() || size != kN * sizeof(int32_t)) {
      *why = "OUTPUT0 missing/short";
      return false;
    }
    const int32_t* out = reinterpret_cast<const int32_t*>(buf);
    for (size_t i = 0; i < kN; ++i) {
      if (out[i] != req.in0[i] + req.in1[i]) {
        *why = "OUTPUT0 value mismatch";
        return false;
      }
    }
  }
  if (expect_out1) {
    Error err = result->RawData("OUTPUT1", &buf, &size);
    if (!err.IsOk() || size != kN * sizeof(int32_t)) {
      *why = "OUTPUT1 missing/short";
      return false;
    }
    const int32_t* out = reinterpret_cast<const int32_t*>(buf);
    for (size_t i = 0; i < kN; ++i) {
      if (out[i] != req.in0[i] - req.in1[i]) {
        *why = "OUTPUT1 value mismatch";
        return false;
      }
    }
  }
  return true;
}

std::vector<const InferRequestedOutput*> MakeOutputs(
    bool want0, bool want1,
    std::vector<std::unique_ptr<InferRequestedOutput>>* owned) {
  std::vector<const InferRequestedOutput*> outs;
  if (want0) {
    InferRequestedOutput* o;
    InferRequestedOutput::Create(&o, "OUTPUT0");
    owned->emplace_back(o);
    outs.push_back(o);
  }
  if (want1) {
    InferRequestedOutput* o;
    InferRequestedOutput::Create(&o, "OUTPUT1");
    owned->emplace_back(o);
    outs.push_back(o);
  }
  return outs;
}

// -- the typed case list ----------------------------------------------

template <typename ClientT>
class ClientTest {
 public:
  explicit ClientTest(const std::string& url) {
    Error err = ClientTraits<ClientT>::Create(&client_, url);
    if (!err.IsOk()) {
      std::cerr << "cannot create " << ClientTraits<ClientT>::kName
                << " client: " << err.Message() << std::endl;
      exit(2);
    }
  }

  void RunAll() {
    Case("InferSingle", [this] { InferSingle(); });
    Case("InferRequestId", [this] { InferRequestId(); });
    Case("InferWrongShape", [this] { InferWrongShape(); });
    Case("InferUnknownModel", [this] { InferUnknownModel(); });
    Case("InferUnknownOutput", [this] { InferUnknownOutput(); });
    Case("InferMultiSameOptions", [this] { InferMultiSameOptions(); });
    Case("InferMultiDifferentOptions",
         [this] { InferMultiDifferentOptions(); });
    Case("InferMultiDifferentOutputs",
         [this] { InferMultiDifferentOutputs(); });
    Case("InferMultiOneOutputSet", [this] { InferMultiOneOutputSet(); });
    Case("InferMultiNoOutputs", [this] { InferMultiNoOutputs(); });
    Case("InferMultiMismatchOptions",
         [this] { InferMultiMismatchOptions(); });
    Case("InferMultiMismatchOutputs",
         [this] { InferMultiMismatchOutputs(); });
    Case("AsyncInferMultiSameOptions",
         [this] { AsyncMulti(4, true, true); });
    Case("AsyncInferMultiDifferentOutputs",
         [this] { AsyncMultiDifferentOutputs(); });
    Case("AsyncInferMultiNoOutputs",
         [this] { AsyncMulti(3, false, false); });
    Case("AsyncInferMultiMismatch", [this] { AsyncMultiMismatch(); });
    if (ClientTraits<ClientT>::kHasCompression) {
      Case("InferCompressed", [this] { InferCompressed(); });
    }
    Case("InferStats", [this] { InferStats(); });
  }

 private:
  void Case(const char* name, std::function<void()> body) {
    g_current = std::string(ClientTraits<ClientT>::kName) + "." + name;
    body();
    std::cout << "ok " << g_current << std::endl;
  }

  // 1
  void InferSingle() {
    Request req(0);
    InferOptions options("add_sub");
    InferResult* result = nullptr;
    CHECK_OK(client_->Infer(&result, options, req.inputs));
    std::unique_ptr<InferResult> owned(result);
    std::string why;
    CHECK_MSG(ValidateResult(result, req, true, true, &why), why);
  }

  // 2
  void InferRequestId() {
    Request req(1);
    InferOptions options("add_sub");
    options.request_id = "my-req-42";
    InferResult* result = nullptr;
    CHECK_OK(client_->Infer(&result, options, req.inputs));
    std::unique_ptr<InferResult> owned(result);
    std::string id;
    CHECK_OK(result->Id(&id));
    CHECK_MSG(id == "my-req-42", "request id not echoed: '" + id + "'");
  }

  // 3
  void InferWrongShape() {
    Request req(0);
    req.inputs[0]->SetShape({kN + 4});
    InferOptions options("add_sub");
    InferResult* result = nullptr;
    Error err = client_->Infer(&result, options, req.inputs);
    bool failed = !err.IsOk() ||
                  (result != nullptr && !result->RequestStatus().IsOk());
    delete result;
    CHECK_MSG(failed, "mismatched shape must be rejected");
  }

  // 4
  void InferUnknownModel() {
    Request req(0);
    InferOptions options("definitely_not_a_model");
    InferResult* result = nullptr;
    Error err = client_->Infer(&result, options, req.inputs);
    bool failed = !err.IsOk() ||
                  (result != nullptr && !result->RequestStatus().IsOk());
    delete result;
    CHECK_MSG(failed, "unknown model must be rejected");
  }

  // 5
  void InferUnknownOutput() {
    Request req(0);
    std::vector<std::unique_ptr<InferRequestedOutput>> owned_outs;
    InferRequestedOutput* o;
    InferRequestedOutput::Create(&o, "NOT_AN_OUTPUT");
    owned_outs.emplace_back(o);
    InferOptions options("add_sub");
    InferResult* result = nullptr;
    Error err = client_->Infer(&result, options, req.inputs, {o});
    bool failed = !err.IsOk() ||
                  (result != nullptr && !result->RequestStatus().IsOk());
    delete result;
    CHECK_MSG(failed, "unknown requested output must be rejected");
  }

  // 6: one option set broadcast over N requests (ref :132)
  void InferMultiSameOptions() {
    std::vector<Request> reqs;
    for (int i = 0; i < 3; ++i) reqs.emplace_back(i);
    std::vector<std::vector<InferInput*>> inputs;
    for (auto& r : reqs) inputs.push_back(r.inputs);
    std::vector<InferResult*> results;
    CHECK_OK(client_->InferMulti(&results, {InferOptions("add_sub")},
                                 inputs));
    CHECK_MSG(results.size() == reqs.size(), "result count");
    for (size_t i = 0; i < results.size(); ++i) {
      std::unique_ptr<InferResult> owned(results[i]);
      std::string why;
      CHECK_MSG(ValidateResult(results[i], reqs[i], true, true, &why),
                why);
    }
  }

  // 7: per-request options with distinct request ids (ref :200)
  void InferMultiDifferentOptions() {
    std::vector<Request> reqs;
    std::vector<InferOptions> options;
    std::vector<std::vector<InferInput*>> inputs;
    for (int i = 0; i < 3; ++i) {
      reqs.emplace_back(10 * i);
      InferOptions o("add_sub");
      o.request_id = "multi-" + std::to_string(i);
      options.push_back(o);
      inputs.push_back(reqs.back().inputs);
    }
    std::vector<InferResult*> results;
    CHECK_OK(client_->InferMulti(&results, options, inputs));
    CHECK_MSG(results.size() == 3, "result count");
    for (size_t i = 0; i < results.size(); ++i) {
      std::unique_ptr<InferResult> owned(results[i]);
      std::string id;
      CHECK_OK(results[i]->Id(&id));
      CHECK_MSG(id == "multi-" + std::to_string(i),
                "per-request id not preserved");
    }
  }

  // 8: different outputs per request (ref :418)
  void InferMultiDifferentOutputs() {
    std::vector<Request> reqs;
    for (int i = 0; i < 2; ++i) reqs.emplace_back(i);
    std::vector<std::vector<InferInput*>> inputs;
    for (auto& r : reqs) inputs.push_back(r.inputs);
    std::vector<std::unique_ptr<InferRequestedOutput>> owned_outs;
    std::vector<std::vector<const InferRequestedOutput*>> outputs;
    outputs.push_back(MakeOutputs(true, false, &owned_outs));   // only 0
    outputs.push_back(MakeOutputs(false, true, &owned_outs));   // only 1
    std::vector<InferResult*> results;
    CHECK_OK(client_->InferMulti(&results, {InferOptions("add_sub")},
                                 inputs, outputs));
    CHECK_MSG(results.size() == 2, "result count");
    std::unique_ptr<InferResult> r0(results[0]), r1(results[1]);
    std::string why;
    CHECK_MSG(ValidateResult(results[0], reqs[0], true, false, &why), why);
    CHECK_MSG(ValidateResult(results[1], reqs[1], false, true, &why), why);
    // the non-requested output must be absent
    const uint8_t* buf;
    size_t size;
    CHECK_MSG(!results[0]->RawData("OUTPUT1", &buf, &size).IsOk(),
              "OUTPUT1 must be absent when only OUTPUT0 was requested");
  }

  // 9: a single output set broadcast (ref :500)
  void InferMultiOneOutputSet() {
    std::vector<Request> reqs;
    for (int i = 0; i < 3; ++i) reqs.emplace_back(i);
    std::vector<std::vector<InferInput*>> inputs;
    for (auto& r : reqs) inputs.push_back(r.inputs);
    std::vector<std::unique_ptr<InferRequestedOutput>> owned_outs;
    std::vector<std::vector<const InferRequestedOutput*>> outputs;
    outputs.push_back(MakeOutputs(true, false, &owned_outs));
    std::vector<InferResult*> results;
    CHECK_OK(client_->InferMulti(&results, {InferOptions("add_sub")},
                                 inputs, outputs));
    for (size_t i = 0; i < results.size(); ++i) {
      std::unique_ptr<InferResult> owned(results[i]);
      std::string why;
      CHECK_MSG(ValidateResult(results[i], reqs[i], true, false, &why),
                why);
    }
  }

  // 10: no outputs requested => all model outputs (ref :576)
  void InferMultiNoOutputs() {
    std::vector<Request> reqs;
    for (int i = 0; i < 2; ++i) reqs.emplace_back(5 * i);
    std::vector<std::vector<InferInput*>> inputs;
    for (auto& r : reqs) inputs.push_back(r.inputs);
    std::vector<InferResult*> results;
    CHECK_OK(client_->InferMulti(&results, {InferOptions("add_sub")},
                                 inputs));
    for (size_t i = 0; i < results.size(); ++i) {
      std::unique_ptr<InferResult> owned(results[i]);
      std::string why;
      CHECK_MSG(ValidateResult(results[i], reqs[i], true, true, &why),
                why);
    }
  }

  // 11: options count mismatch => error (ref :652)
  void InferMultiMismatchOptions() {
    Request a(0), b(1);
    std::vector<InferOptions> options(2, InferOptions("add_sub"));
    std::vector<std::vector<InferInput*>> inputs = {a.inputs, b.inputs,
                                                    a.inputs};
    std::vector<InferResult*> results;
    Error err = client_->InferMulti(&results, options, inputs);
    for (auto* r : results) delete r;
    CHECK_MSG(!err.IsOk(), "mismatched options count must be rejected");
  }

  // 12: outputs count mismatch => error (ref :700)
  void InferMultiMismatchOutputs() {
    Request a(0), b(1), c(2);
    std::vector<std::vector<InferInput*>> inputs = {a.inputs, b.inputs,
                                                    c.inputs};
    std::vector<std::unique_ptr<InferRequestedOutput>> owned_outs;
    std::vector<std::vector<const InferRequestedOutput*>> outputs;
    outputs.push_back(MakeOutputs(true, true, &owned_outs));
    outputs.push_back(MakeOutputs(true, true, &owned_outs));
    std::vector<InferResult*> results;
    Error err = client_->InferMulti(&results, {InferOptions("add_sub")},
                                    inputs, outputs);
    for (auto* r : results) delete r;
    CHECK_MSG(!err.IsOk(), "mismatched outputs count must be rejected");
  }

  // 13-15: AsyncInferMulti happy paths (ref :750-950)
  void AsyncMulti(int n, bool explicit_outputs, bool want1) {
    std::vector<Request> reqs;
    for (int i = 0; i < n; ++i) reqs.emplace_back(i);
    std::vector<std::vector<InferInput*>> inputs;
    for (auto& r : reqs) inputs.push_back(r.inputs);
    std::vector<std::unique_ptr<InferRequestedOutput>> owned_outs;
    std::vector<std::vector<const InferRequestedOutput*>> outputs;
    if (explicit_outputs)
      outputs.push_back(MakeOutputs(true, want1, &owned_outs));

    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
    std::vector<InferResult*> got;
    Error err = ClientTraits<ClientT>::AsyncInferMulti(
        client_.get(),
        [&](std::vector<InferResult*> results) {
          std::lock_guard<std::mutex> lk(mu);
          got = std::move(results);
          done = true;
          cv.notify_one();
        },
        {InferOptions("add_sub")}, inputs, outputs);
    CHECK_OK(err);
    {
      std::unique_lock<std::mutex> lk(mu);
      CHECK_MSG(cv.wait_for(lk, std::chrono::seconds(30),
                            [&] { return done; }),
                "async multi callback never fired");
    }
    CHECK_MSG(got.size() == static_cast<size_t>(n),
              "async multi result count");
    for (int i = 0; i < n; ++i) {
      std::unique_ptr<InferResult> owned(got[i]);
      std::string why;
      CHECK_MSG(got[i] != nullptr, "missing result");
      CHECK_MSG(ValidateResult(got[i], reqs[i], true,
                               want1 || !explicit_outputs, &why),
                why);
    }
  }

  void AsyncMultiDifferentOutputs() {
    std::vector<Request> reqs;
    reqs.emplace_back(0);
    reqs.emplace_back(7);
    std::vector<std::vector<InferInput*>> inputs = {reqs[0].inputs,
                                                    reqs[1].inputs};
    std::vector<std::unique_ptr<InferRequestedOutput>> owned_outs;
    std::vector<std::vector<const InferRequestedOutput*>> outputs;
    outputs.push_back(MakeOutputs(true, false, &owned_outs));
    outputs.push_back(MakeOutputs(false, true, &owned_outs));

    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
    std::vector<InferResult*> got;
    CHECK_OK(ClientTraits<ClientT>::AsyncInferMulti(
        client_.get(),
        [&](std::vector<InferResult*> results) {
          std::lock_guard<std::mutex> lk(mu);
          got = std::move(results);
          done = true;
          cv.notify_one();
        },
        {InferOptions("add_sub")}, inputs, outputs));
    {
      std::unique_lock<std::mutex> lk(mu);
      CHECK_MSG(cv.wait_for(lk, std::chrono::seconds(30),
                            [&] { return done; }),
                "async multi callback never fired");
    }
    CHECK_MSG(got.size() == 2, "result count");
    std::unique_ptr<InferResult> r0(got[0]), r1(got[1]);
    std::string why;
    CHECK_MSG(ValidateResult(got[0], reqs[0], true, false, &why), why);
    CHECK_MSG(ValidateResult(got[1], reqs[1], false, true, &why), why);
  }

  void AsyncMultiMismatch() {
    Request a(0);
    std::vector<InferOptions> options(3, InferOptions("add_sub"));
    std::vector<std::vector<InferInput*>> inputs = {a.inputs};
    Error err = ClientTraits<ClientT>::AsyncInferMulti(
        client_.get(), [](std::vector<InferResult*> results) {
          for (auto* r : results) delete r;
        },
        options, inputs, {});
    CHECK_MSG(!err.IsOk(),
              "async multi with mismatched options must be rejected");
  }

  // gzip + deflate request/response round trips (HTTP only; parity:
  // ref CompressionType http_client.h:108)
  void InferCompressed() {
    DoInferCompressed(client_.get());
  }
  void DoInferCompressed(InferenceServerGrpcClient*) {}
  void DoInferCompressed(InferenceServerHttpClient* http) {
    for (auto algo : {CompressionType::GZIP, CompressionType::DEFLATE}) {
      Request req(4);
      InferOptions options("add_sub");
      InferResult* result = nullptr;
      CHECK_OK(http->Infer(&result, options, req.inputs, {}, algo, algo));
      std::unique_ptr<InferResult> owned(result);
      std::string why;
      CHECK_MSG(ValidateResult(result, req, true, true, &why),
                std::string("compressed infer: ") + why);
    }
  }

  // 17: client stat accounting (ref UpdateInferStat)
  void InferStats() {
    InferStat stat;
    CHECK_OK(client_->ClientInferStat(&stat));
    CHECK_MSG(stat.completed_request_count > 0,
              "completed_request_count did not advance");
  }

  std::unique_ptr<ClientT> client_;
};

}  // namespace

int main(int argc, char** argv) {
  std::string protocol = "http";
  std::string url;
  for (int i = 1; i < argc - 1; ++i) {
    if (std::string(argv[i]) == "-i") protocol = argv[i + 1];
    if (std::string(argv[i]) == "-u") url = argv[i + 1];
  }
  if (url.empty())
    url = (protocol == "grpc") ? "localhost:8001" : "localhost:8000";

  if (protocol == "grpc") {
    ClientTest<InferenceServerGrpcClient>(url).RunAll();
  } else {
    ClientTest<InferenceServerHttpClient>(url).RunAll();
  }
  if (g_failures == 0) {
    std::cout << "PASS : all " << protocol << " client cases" << std::endl;
  } else {
    std::cerr << g_failures << " case(s) failed" << std::endl;
  }
  return g_failures;
}
