// HPACK/Huffman unit test: RFC 7541 Appendix C vectors (C.4 huffman
// strings, C.6 response header blocks with dynamic table).
#include "client_tpu_torch/hpack.h"
#include <cstdio>
#include <cstring>
#include <vector>
using namespace client_tpu_torch::hpack;

static std::vector<uint8_t> hexv(const char* h) {
  std::vector<uint8_t> v;
  for (size_t i = 0; h[i] && h[i+1]; i += 2) {
    unsigned x; sscanf(h + i, "%2x", &x); v.push_back(x);
  }
  return v;
}

int check(const char* hex, const char* expect) {
  auto v = hexv(hex);
  std::string out;
  if (!HuffmanDecode(v.data(), v.size(), &out)) { printf("FAIL decode %s\n", hex); return 1; }
  if (out != expect) { printf("FAIL %s -> '%s' != '%s'\n", hex, out.c_str(), expect); return 1; }
  printf("ok: %s\n", expect);
  return 0;
}

int main() {
  int rc = 0;
  // RFC 7541 Appendix C.4 / C.6 vectors
  rc |= check("f1e3c2e5f23a6ba0ab90f4ff", "www.example.com");
  rc |= check("a8eb10649cbf", "no-cache");
  rc |= check("25a849e95ba97d7f", "custom-key");
  rc |= check("25a849e95bb8e8b4bf", "custom-value");
  rc |= check("6402", "302");
  rc |= check("aec3771a4b", "private");
  rc |= check("d07abe941054d444a8200595040b8166e082a62d1bff", "Mon, 21 Oct 2013 20:13:21 GMT");
  rc |= check("9d29ad171863c78f0b97c8e9ae82ae43d3", "https://www.example.com");
  rc |= check("640eff", "307");
  rc |= check("9bd9ab", "gzip");
  rc |= check("94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587316065c003ed4ee5b1063d5007", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1");
  // full header block decode: C.6.1 (response, huffman, dynamic table)
  Decoder d(256);
  std::vector<Header> hs;
  auto blk = hexv("488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3");
  if (!d.Decode(blk.data(), blk.size(), &hs)) { printf("FAIL block decode\n"); return 1; }
  const char* exp[][2] = {{":status","302"},{"cache-control","private"},
    {"date","Mon, 21 Oct 2013 20:13:21 GMT"},{"location","https://www.example.com"}};
  for (int i = 0; i < 4; ++i) {
    if (hs[i].first != exp[i][0] || hs[i].second != exp[i][1]) {
      printf("FAIL hdr %d: %s: %s\n", i, hs[i].first.c_str(), hs[i].second.c_str()); rc = 1;
    } else printf("ok hdr: %s: %s\n", hs[i].first.c_str(), hs[i].second.c_str());
  }
  if (!rc) printf("ALL HPACK VECTORS PASS\n");
  return rc;
}
