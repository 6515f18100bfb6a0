// HPACK (RFC 7541) header compression for the native gRPC client.
//
// Role parity: the reference links grpc++ which brings its own chttp2
// HPACK; this repo's native stack is dependency-free (like its HTTP/1.1
// client, src/http_client.cc), so HPACK is implemented here.
//
// Encoder: emits "literal header field without indexing -- new name"
// (no Huffman, no dynamic table) -- always legal, always interoperable.
// Decoder: full static table, dynamic table (RFC 7541 S2.3.2/S4),
// Huffman decoding (Appendix B table), all literal forms and the
// dynamic-table-size-update opcode.

#pragma once

#include <cstdint>
#include <string>
#include <utility>
#include <vector>

namespace client_tpu_torch {
namespace hpack {

using Header = std::pair<std::string, std::string>;

// Append the encoding of one header to |out|.
void EncodeHeader(const std::string& name, const std::string& value,
                  std::string* out);

class Decoder {
 public:
  explicit Decoder(size_t max_dynamic_table = 4096);

  // Decode a complete header block. Returns false on malformed input.
  bool Decode(const uint8_t* data, size_t len, std::vector<Header>* out);

 private:
  struct Entry {
    std::string name;
    std::string value;
  };
  bool LookupIndex(uint64_t idx, std::string* name, std::string* value,
                   bool name_only);
  void InsertDynamic(const std::string& name, const std::string& value);
  void EvictTo(size_t target);

  std::vector<Entry> dynamic_;  // front = most recent
  size_t dynamic_size_ = 0;     // RFC size (bytes + 32 per entry)
  size_t max_dynamic_;
  size_t settings_max_dynamic_;
};

// Huffman-decode |len| bytes; returns false on invalid padding/codes.
// Exposed for tests (RFC 7541 Appendix C vectors).
bool HuffmanDecode(const uint8_t* data, size_t len, std::string* out);

}  // namespace hpack
}  // namespace client_tpu_torch
