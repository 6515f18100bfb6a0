// Native client library common core.
// API parity role: ref:src/c++/library/common.h:62-624 (Error,
// InferenceServerClient base, InferOptions, InferInput,
// InferRequestedOutput, InferResult, RequestTimers, InferStat) —
// re-designed for the port's stack (no CUDA types; a cuda-shm handle is
// an opaque token registered with the serving process).
#pragma once

#include <chrono>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace client_tpu_torch {

class Error {
 public:
  Error() : ok_(true) {}
  explicit Error(std::string msg, int status = 0)
      : ok_(false), msg_(std::move(msg)), status_(status) {}

  static Error Success() { return Error(); }
  bool IsOk() const { return ok_; }
  const std::string& Message() const { return msg_; }
  int StatusCode() const { return status_; }

 private:
  bool ok_;
  std::string msg_;
  int status_ = 0;
};

// Nanosecond stamps around one request (parity: ref common.h:519-599).
class RequestTimers {
 public:
  enum class Kind { REQUEST_START, REQUEST_END, SEND_START, SEND_END,
                    RECV_START, RECV_END, COUNT__ };

  void Capture(Kind kind) {
    stamp_[static_cast<int>(kind)] =
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now().time_since_epoch())
            .count();
  }
  uint64_t Get(Kind kind) const { return stamp_[static_cast<int>(kind)]; }
  uint64_t Duration(Kind start, Kind end) const {
    uint64_t s = Get(start), e = Get(end);
    return (s == 0 || e == 0 || e < s) ? 0 : e - s;
  }

 private:
  uint64_t stamp_[static_cast<int>(Kind::COUNT__)] = {0};
};

// Client-side aggregate statistics (parity: ref common.h:94 InferStat).
struct InferStat {
  uint64_t completed_request_count = 0;
  uint64_t cumulative_total_request_time_ns = 0;
  uint64_t cumulative_send_time_ns = 0;
  uint64_t cumulative_receive_time_ns = 0;
};

// Per-request options (parity: ref common.h:159 InferOptions).
struct InferOptions {
  explicit InferOptions(std::string model_name)
      : model_name(std::move(model_name)) {}

  std::string model_name;
  std::string model_version;
  std::string request_id;
  // int-or-string correlation id (string wins when non-empty)
  uint64_t sequence_id = 0;
  std::string sequence_id_str;
  bool sequence_start = false;
  bool sequence_end = false;
  uint64_t priority = 0;
  uint64_t server_timeout_us = 0;
  uint64_t client_timeout_us = 0;
};

// Input tensor: zero-copy scatter-gather over caller buffers
// (parity: ref common.h:224 InferInput; AppendRaw captures pointers).
class InferInput {
 public:
  static Error Create(InferInput** result, const std::string& name,
                      const std::vector<int64_t>& dims,
                      const std::string& datatype) {
    *result = new InferInput(name, dims, datatype);
    return Error::Success();
  }

  const std::string& Name() const { return name_; }
  const std::string& Datatype() const { return datatype_; }
  const std::vector<int64_t>& Shape() const { return shape_; }
  Error SetShape(const std::vector<int64_t>& dims) {
    shape_ = dims;
    return Error::Success();
  }

  Error Reset() {
    bufs_.clear();
    str_bufs_.clear();
    shm_name_.clear();
    cursor_buf_ = 0;
    cursor_off_ = 0;
    return Error::Success();
  }

  // Zero-copy: records (ptr, size); caller keeps the memory alive.
  Error AppendRaw(const uint8_t* data, size_t size) {
    bufs_.emplace_back(data, size);
    total_bytes_ += size;
    return Error::Success();
  }

  // BYTES elements: 4-byte-LE length prefix framing; owns copies.
  Error AppendFromString(const std::vector<std::string>& strings) {
    for (const auto& s : strings) {
      std::string buf;
      uint32_t len = static_cast<uint32_t>(s.size());
      buf.append(reinterpret_cast<const char*>(&len), 4);
      buf.append(s);
      str_bufs_.push_back(std::move(buf));
      const auto& owned = str_bufs_.back();
      bufs_.emplace_back(reinterpret_cast<const uint8_t*>(owned.data()),
                         owned.size());
      total_bytes_ += owned.size();
    }
    return Error::Success();
  }

  Error SetSharedMemory(const std::string& region_name, size_t byte_size,
                        size_t offset = 0) {
    shm_name_ = region_name;
    shm_byte_size_ = byte_size;
    shm_offset_ = offset;
    return Error::Success();
  }

  bool IsSharedMemory() const { return !shm_name_.empty(); }
  const std::string& SharedMemoryName() const { return shm_name_; }
  size_t SharedMemoryByteSize() const { return shm_byte_size_; }
  size_t SharedMemoryOffset() const { return shm_offset_; }
  size_t ByteSize() const { return total_bytes_; }

  // Scatter-gather cursor (parity: ref common.h:338 GetNext).
  void PrepareForRequest() {
    cursor_buf_ = 0;
    cursor_off_ = 0;
  }
  bool GetNext(const uint8_t** buf, size_t* size) {
    if (cursor_buf_ >= bufs_.size()) return false;
    *buf = bufs_[cursor_buf_].first + cursor_off_;
    *size = bufs_[cursor_buf_].second - cursor_off_;
    ++cursor_buf_;
    cursor_off_ = 0;
    return true;
  }

 private:
  InferInput(std::string name, std::vector<int64_t> dims,
             std::string datatype)
      : name_(std::move(name)), shape_(std::move(dims)),
        datatype_(std::move(datatype)) {}

  std::string name_;
  std::vector<int64_t> shape_;
  std::string datatype_;
  std::vector<std::pair<const uint8_t*, size_t>> bufs_;
  std::deque<std::string> str_bufs_;
  size_t total_bytes_ = 0;
  std::string shm_name_;
  size_t shm_byte_size_ = 0;
  size_t shm_offset_ = 0;
  size_t cursor_buf_ = 0;
  size_t cursor_off_ = 0;
};

// Requested output (parity: ref common.h:369).
class InferRequestedOutput {
 public:
  static Error Create(InferRequestedOutput** result, const std::string& name,
                      size_t class_count = 0) {
    *result = new InferRequestedOutput(name, class_count);
    return Error::Success();
  }

  const std::string& Name() const { return name_; }
  size_t ClassCount() const { return class_count_; }

  Error SetSharedMemory(const std::string& region_name, size_t byte_size,
                        size_t offset = 0) {
    shm_name_ = region_name;
    shm_byte_size_ = byte_size;
    shm_offset_ = offset;
    return Error::Success();
  }
  Error UnsetSharedMemory() {
    shm_name_.clear();
    return Error::Success();
  }
  bool IsSharedMemory() const { return !shm_name_.empty(); }
  const std::string& SharedMemoryName() const { return shm_name_; }
  size_t SharedMemoryByteSize() const { return shm_byte_size_; }
  size_t SharedMemoryOffset() const { return shm_offset_; }

 private:
  InferRequestedOutput(std::string name, size_t class_count)
      : name_(std::move(name)), class_count_(class_count) {}

  std::string name_;
  size_t class_count_;
  std::string shm_name_;
  size_t shm_byte_size_ = 0;
  size_t shm_offset_ = 0;
};

// Result interface (parity: ref common.h:447 InferResult).
class InferResult {
 public:
  virtual ~InferResult() = default;
  virtual Error RequestStatus() const = 0;
  virtual Error Id(std::string* id) const = 0;
  virtual Error ModelName(std::string* name) const = 0;
  virtual Error ModelVersion(std::string* version) const = 0;
  virtual Error Shape(const std::string& output_name,
                      std::vector<int64_t>* shape) const = 0;
  virtual Error Datatype(const std::string& output_name,
                         std::string* datatype) const = 0;
  virtual Error RawData(const std::string& output_name, const uint8_t** buf,
                        size_t* byte_size) const = 0;
  virtual Error StringData(const std::string& output_name,
                           std::vector<std::string>* string_result) const = 0;
  virtual std::string DebugString() const = 0;
};

// Base client: shared InferStat bookkeeping
// (parity: ref common.h:120 InferenceServerClient).
class InferenceServerClient {
 public:
  virtual ~InferenceServerClient() = default;

  Error ClientInferStat(InferStat* stat) const {
    std::lock_guard<std::mutex> lk(stat_mutex_);
    *stat = infer_stat_;
    return Error::Success();
  }

 protected:
  void UpdateInferStat(const RequestTimers& timers) {
    std::lock_guard<std::mutex> lk(stat_mutex_);
    infer_stat_.completed_request_count++;
    infer_stat_.cumulative_total_request_time_ns +=
        timers.Duration(RequestTimers::Kind::REQUEST_START,
                        RequestTimers::Kind::REQUEST_END);
    infer_stat_.cumulative_send_time_ns += timers.Duration(
        RequestTimers::Kind::SEND_START, RequestTimers::Kind::SEND_END);
    infer_stat_.cumulative_receive_time_ns += timers.Duration(
        RequestTimers::Kind::RECV_START, RequestTimers::Kind::RECV_END);
  }

  mutable std::mutex stat_mutex_;
  InferStat infer_stat_;
};

}  // namespace client_tpu_torch
