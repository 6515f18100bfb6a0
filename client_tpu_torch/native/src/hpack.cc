// HPACK (RFC 7541) implementation — see hpack.h.

#include "client_tpu_torch/hpack.h"

#include <cstring>
#include <memory>

namespace client_tpu_torch {
namespace hpack {

// ---------------------------------------------------------------- encode

static void EncodeInt(uint64_t value, uint8_t prefix_bits, uint8_t flags,
                      std::string* out) {
  const uint64_t max_prefix = (1u << prefix_bits) - 1;
  if (value < max_prefix) {
    out->push_back(static_cast<char>(flags | value));
    return;
  }
  out->push_back(static_cast<char>(flags | max_prefix));
  value -= max_prefix;
  while (value >= 128) {
    out->push_back(static_cast<char>((value & 0x7f) | 0x80));
    value >>= 7;
  }
  out->push_back(static_cast<char>(value));
}

void EncodeHeader(const std::string& name, const std::string& value,
                  std::string* out) {
  // literal header field without indexing -- new name (0x00 prefix),
  // no Huffman: maximally interoperable, zero shared state
  out->push_back(0x00);
  EncodeInt(name.size(), 7, 0x00, out);
  out->append(name);
  EncodeInt(value.size(), 7, 0x00, out);
  out->append(value);
}

// ------------------------------------------------------- static table

namespace {
struct StaticEntry {
  const char* name;
  const char* value;
};
const StaticEntry kStaticTable[] = {
    {"", ""},  // 1-indexed
    {":authority", ""},
    {":method", "GET"},
    {":method", "POST"},
    {":path", "/"},
    {":path", "/index.html"},
    {":scheme", "http"},
    {":scheme", "https"},
    {":status", "200"},
    {":status", "204"},
    {":status", "206"},
    {":status", "304"},
    {":status", "400"},
    {":status", "404"},
    {":status", "500"},
    {"accept-charset", ""},
    {"accept-encoding", "gzip, deflate"},
    {"accept-language", ""},
    {"accept-ranges", ""},
    {"accept", ""},
    {"access-control-allow-origin", ""},
    {"age", ""},
    {"allow", ""},
    {"authorization", ""},
    {"cache-control", ""},
    {"content-disposition", ""},
    {"content-encoding", ""},
    {"content-language", ""},
    {"content-length", ""},
    {"content-location", ""},
    {"content-range", ""},
    {"content-type", ""},
    {"cookie", ""},
    {"date", ""},
    {"etag", ""},
    {"expect", ""},
    {"expires", ""},
    {"from", ""},
    {"host", ""},
    {"if-match", ""},
    {"if-modified-since", ""},
    {"if-none-match", ""},
    {"if-range", ""},
    {"if-unmodified-since", ""},
    {"last-modified", ""},
    {"link", ""},
    {"location", ""},
    {"max-forwards", ""},
    {"proxy-authenticate", ""},
    {"proxy-authorization", ""},
    {"range", ""},
    {"referer", ""},
    {"refresh", ""},
    {"retry-after", ""},
    {"server", ""},
    {"set-cookie", ""},
    {"strict-transport-security", ""},
    {"transfer-encoding", ""},
    {"user-agent", ""},
    {"vary", ""},
    {"via", ""},
    {"www-authenticate", ""},
};
constexpr size_t kStaticCount = 61;

// ------------------------------------------------- Huffman (Appendix B)

struct HuffSym {
  uint32_t code;
  uint8_t bits;
};
const HuffSym kHuff[257] = {
    {0x1ff8, 13},     {0x7fffd8, 23},   {0xfffffe2, 28},  {0xfffffe3, 28},
    {0xfffffe4, 28},  {0xfffffe5, 28},  {0xfffffe6, 28},  {0xfffffe7, 28},
    {0xfffffe8, 28},  {0xffffea, 24},   {0x3ffffffc, 30}, {0xfffffe9, 28},
    {0xfffffea, 28},  {0x3ffffffd, 30}, {0xfffffeb, 28},  {0xfffffec, 28},
    {0xfffffed, 28},  {0xfffffee, 28},  {0xfffffef, 28},  {0xffffff0, 28},
    {0xffffff1, 28},  {0xffffff2, 28},  {0x3ffffffe, 30}, {0xffffff3, 28},
    {0xffffff4, 28},  {0xffffff5, 28},  {0xffffff6, 28},  {0xffffff7, 28},
    {0xffffff8, 28},  {0xffffff9, 28},  {0xffffffa, 28},  {0xffffffb, 28},
    {0x14, 6},        {0x3f8, 10},      {0x3f9, 10},      {0xffa, 12},
    {0x1ff9, 13},     {0x15, 6},        {0xf8, 8},        {0x7fa, 11},
    {0x3fa, 10},      {0x3fb, 10},      {0xf9, 8},        {0x7fb, 11},
    {0xfa, 8},        {0x16, 6},        {0x17, 6},        {0x18, 6},
    {0x0, 5},         {0x1, 5},         {0x2, 5},         {0x19, 6},
    {0x1a, 6},        {0x1b, 6},        {0x1c, 6},        {0x1d, 6},
    {0x1e, 6},        {0x1f, 6},        {0x5c, 7},        {0xfb, 8},
    {0x7ffc, 15},     {0x20, 6},        {0xffb, 12},      {0x3fc, 10},
    {0x1ffa, 13},     {0x21, 6},        {0x5d, 7},        {0x5e, 7},
    {0x5f, 7},        {0x60, 7},        {0x61, 7},        {0x62, 7},
    {0x63, 7},        {0x64, 7},        {0x65, 7},        {0x66, 7},
    {0x67, 7},        {0x68, 7},        {0x69, 7},        {0x6a, 7},
    {0x6b, 7},        {0x6c, 7},        {0x6d, 7},        {0x6e, 7},
    {0x6f, 7},        {0x70, 7},        {0x71, 7},        {0x72, 7},
    {0xfc, 8},        {0x73, 7},        {0xfd, 8},        {0x1ffb, 13},
    {0x7fff0, 19},    {0x1ffc, 13},     {0x3ffc, 14},     {0x22, 6},
    {0x7ffd, 15},     {0x3, 5},         {0x23, 6},        {0x4, 5},
    {0x24, 6},        {0x5, 5},         {0x25, 6},        {0x26, 6},
    {0x27, 6},        {0x6, 5},         {0x74, 7},        {0x75, 7},
    {0x28, 6},        {0x29, 6},        {0x2a, 6},        {0x7, 5},
    {0x2b, 6},        {0x76, 7},        {0x2c, 6},        {0x8, 5},
    {0x9, 5},         {0x2d, 6},        {0x77, 7},        {0x78, 7},
    {0x79, 7},        {0x7a, 7},        {0x7b, 7},        {0x7ffe, 15},
    {0x7fc, 11},      {0x3ffd, 14},     {0x1ffd, 13},     {0xffffffc, 28},
    {0xfffe6, 20},    {0x3fffd2, 22},   {0xfffe7, 20},    {0xfffe8, 20},
    {0x3fffd3, 22},   {0x3fffd4, 22},   {0x3fffd5, 22},   {0x7fffd9, 23},
    {0x3fffd6, 22},   {0x7fffda, 23},   {0x7fffdb, 23},   {0x7fffdc, 23},
    {0x7fffdd, 23},   {0x7fffde, 23},   {0xffffeb, 24},   {0x7fffdf, 23},
    {0xffffec, 24},   {0xffffed, 24},   {0x3fffd7, 22},   {0x7fffe0, 23},
    {0xffffee, 24},   {0x7fffe1, 23},   {0x7fffe2, 23},   {0x7fffe3, 23},
    {0x7fffe4, 23},   {0x1fffdc, 21},   {0x3fffd8, 22},   {0x7fffe5, 23},
    {0x3fffd9, 22},   {0x7fffe6, 23},   {0x7fffe7, 23},   {0xffffef, 24},
    {0x3fffda, 22},   {0x1fffdd, 21},   {0xfffe9, 20},    {0x3fffdb, 22},
    {0x3fffdc, 22},   {0x7fffe8, 23},   {0x7fffe9, 23},   {0x1fffde, 21},
    {0x7fffea, 23},   {0x3fffdd, 22},   {0x3fffde, 22},   {0xfffff0, 24},
    {0x1fffdf, 21},   {0x3fffdf, 22},   {0x7fffeb, 23},   {0x7fffec, 23},
    {0x1fffe0, 21},   {0x1fffe1, 21},   {0x3fffe0, 22},   {0x1fffe2, 21},
    {0x7fffed, 23},   {0x3fffe1, 22},   {0x7fffee, 23},   {0x7fffef, 23},
    {0xfffea, 20},    {0x3fffe2, 22},   {0x3fffe3, 22},   {0x3fffe4, 22},
    {0x7ffff0, 23},   {0x3fffe5, 22},   {0x3fffe6, 22},   {0x7ffff1, 23},
    {0x3ffffe0, 26},  {0x3ffffe1, 26},  {0xfffeb, 20},    {0x7fff1, 19},
    {0x3fffe7, 22},   {0x7ffff2, 23},   {0x3fffe8, 22},   {0x1ffffec, 25},
    {0x3ffffe2, 26},  {0x3ffffe3, 26},  {0x3ffffe4, 26},  {0x7ffffde, 27},
    {0x7ffffdf, 27},  {0x3ffffe5, 26},  {0xfffff1, 24},   {0x1ffffed, 25},
    {0x7fff2, 19},    {0x1fffe3, 21},   {0x3ffffe6, 26},  {0x7ffffe0, 27},
    {0x7ffffe1, 27},  {0x3ffffe7, 26},  {0x7ffffe2, 27},  {0xfffff2, 24},
    {0x1fffe4, 21},   {0x1fffe5, 21},   {0x3ffffe8, 26},  {0x3ffffe9, 26},
    {0xffffffd, 28},  {0x7ffffe3, 27},  {0x7ffffe4, 27},  {0x7ffffe5, 27},
    {0xfffec, 20},    {0xfffff3, 24},   {0xfffed, 20},    {0x1fffe6, 21},
    {0x3fffe9, 22},   {0x1fffe7, 21},   {0x1fffe8, 21},   {0x7ffff3, 23},
    {0x3fffea, 22},   {0x3fffeb, 22},   {0x1ffffee, 25},  {0x1ffffef, 25},
    {0xfffff4, 24},   {0xfffff5, 24},   {0x3ffffea, 26},  {0x7ffff4, 23},
    {0x3ffffeb, 26},  {0x7ffffe6, 27},  {0x3ffffec, 26},  {0x3ffffed, 26},
    {0x7ffffe7, 27},  {0x7ffffe8, 27},  {0x7ffffe9, 27},  {0x7ffffea, 27},
    {0x7ffffeb, 27},  {0xffffffe, 28},  {0x7ffffec, 27},  {0x7ffffed, 27},
    {0x7ffffee, 27},  {0x7ffffef, 27},  {0x7fffff0, 27},  {0x3ffffee, 26},
    {0x3fffffff, 30},
};

// binary trie for decoding, built once
struct HuffNode {
  int16_t sym = -1;  // >=0: leaf
  int32_t child[2] = {-1, -1};
};

class HuffTrie {
 public:
  HuffTrie() {
    nodes_.emplace_back();
    for (int s = 0; s <= 256; ++s) {
      uint32_t code = kHuff[s].code;
      int bits = kHuff[s].bits;
      int node = 0;
      for (int b = bits - 1; b >= 0; --b) {
        int bit = (code >> b) & 1;
        if (nodes_[node].child[bit] < 0) {
          nodes_[node].child[bit] = static_cast<int32_t>(nodes_.size());
          nodes_.emplace_back();
        }
        node = nodes_[node].child[bit];
      }
      nodes_[node].sym = static_cast<int16_t>(s);
    }
  }
  const std::vector<HuffNode>& nodes() const { return nodes_; }

 private:
  std::vector<HuffNode> nodes_;
};

const HuffTrie& Trie() {
  static HuffTrie* trie = new HuffTrie();
  return *trie;
}

}  // namespace

bool HuffmanDecode(const uint8_t* data, size_t len, std::string* out) {
  const auto& nodes = Trie().nodes();
  int node = 0;
  int depth = 0;  // bits consumed since last symbol (for padding check)
  for (size_t i = 0; i < len; ++i) {
    for (int b = 7; b >= 0; --b) {
      int bit = (data[i] >> b) & 1;
      int next = nodes[node].child[bit];
      if (next < 0) return false;
      node = next;
      ++depth;
      if (nodes[node].sym >= 0) {
        if (nodes[node].sym == 256) return false;  // EOS in stream
        out->push_back(static_cast<char>(nodes[node].sym));
        node = 0;
        depth = 0;
      }
    }
  }
  // remaining bits must be a prefix of EOS (all ones), < 8 bits
  if (depth >= 8) return false;
  // walk the path taken so far: it must consist of 1-bits only; we can't
  // recover the bits from the node, so check differently: the padding is
  // valid iff the current node is on the all-ones path from the root.
  if (depth > 0) {
    int n = 0;
    for (int i = 0; i < depth; ++i) {
      n = nodes[n].child[1];
      if (n < 0) return false;
    }
    if (n != node) return false;
  }
  return true;
}

// ---------------------------------------------------------------- decode

namespace {
bool DecodeInt(const uint8_t*& p, const uint8_t* end, uint8_t prefix_bits,
               uint64_t* value) {
  if (p >= end) return false;
  const uint64_t max_prefix = (1u << prefix_bits) - 1;
  uint64_t v = *p++ & max_prefix;
  if (v < max_prefix) {
    *value = v;
    return true;
  }
  uint64_t m = 0;
  while (true) {
    if (p >= end || m > 56) return false;
    uint8_t b = *p++;
    v += static_cast<uint64_t>(b & 0x7f) << m;
    m += 7;
    if ((b & 0x80) == 0) break;
  }
  *value = v;
  return true;
}

bool DecodeString(const uint8_t*& p, const uint8_t* end, std::string* out) {
  if (p >= end) return false;
  bool huff = (*p & 0x80) != 0;
  uint64_t len;
  if (!DecodeInt(p, end, 7, &len)) return false;
  if (static_cast<uint64_t>(end - p) < len) return false;
  if (huff) {
    if (!HuffmanDecode(p, len, out)) return false;
  } else {
    out->append(reinterpret_cast<const char*>(p), len);
  }
  p += len;
  return true;
}
}  // namespace

Decoder::Decoder(size_t max_dynamic_table)
    : max_dynamic_(max_dynamic_table),
      settings_max_dynamic_(max_dynamic_table) {}

bool Decoder::LookupIndex(uint64_t idx, std::string* name,
                          std::string* value, bool name_only) {
  if (idx == 0) return false;
  if (idx <= kStaticCount) {
    *name = kStaticTable[idx].name;
    if (!name_only) *value = kStaticTable[idx].value;
    return true;
  }
  size_t di = idx - kStaticCount - 1;
  if (di >= dynamic_.size()) return false;
  *name = dynamic_[di].name;
  if (!name_only) *value = dynamic_[di].value;
  return true;
}

void Decoder::EvictTo(size_t target) {
  while (dynamic_size_ > target && !dynamic_.empty()) {
    const Entry& e = dynamic_.back();
    dynamic_size_ -= e.name.size() + e.value.size() + 32;
    dynamic_.pop_back();
  }
}

void Decoder::InsertDynamic(const std::string& name,
                            const std::string& value) {
  size_t sz = name.size() + value.size() + 32;
  if (sz > max_dynamic_) {
    EvictTo(0);
    return;
  }
  EvictTo(max_dynamic_ - sz);
  dynamic_.insert(dynamic_.begin(), Entry{name, value});
  dynamic_size_ += sz;
}

bool Decoder::Decode(const uint8_t* data, size_t len,
                     std::vector<Header>* out) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  while (p < end) {
    uint8_t b = *p;
    if (b & 0x80) {  // indexed header field
      uint64_t idx;
      if (!DecodeInt(p, end, 7, &idx)) return false;
      std::string name, value;
      if (!LookupIndex(idx, &name, &value, false)) return false;
      out->emplace_back(std::move(name), std::move(value));
    } else if (b & 0x40) {  // literal with incremental indexing
      uint64_t idx;
      if (!DecodeInt(p, end, 6, &idx)) return false;
      std::string name, value, dummy;
      if (idx) {
        if (!LookupIndex(idx, &name, &dummy, true)) return false;
      } else if (!DecodeString(p, end, &name)) {
        return false;
      }
      if (!DecodeString(p, end, &value)) return false;
      InsertDynamic(name, value);
      out->emplace_back(std::move(name), std::move(value));
    } else if (b & 0x20) {  // dynamic table size update
      uint64_t sz;
      if (!DecodeInt(p, end, 5, &sz)) return false;
      if (sz > settings_max_dynamic_) return false;
      max_dynamic_ = sz;
      EvictTo(max_dynamic_);
    } else {  // literal without indexing (0x00) / never indexed (0x10)
      uint64_t idx;
      if (!DecodeInt(p, end, 4, &idx)) return false;
      std::string name, value, dummy;
      if (idx) {
        if (!LookupIndex(idx, &name, &dummy, true)) return false;
      } else if (!DecodeString(p, end, &name)) {
        return false;
      }
      if (!DecodeString(p, end, &value)) return false;
      out->emplace_back(std::move(name), std::move(value));
    }
  }
  return true;
}

}  // namespace hpack
}  // namespace client_tpu_torch
