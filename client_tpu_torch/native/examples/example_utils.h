// Shared bits for the example clients (arg parsing + error macro).
// Parity role: the reference examples repeat this inline per file
// (ref:src/c++/examples/simple_http_infer_client.cc:38-55); one header
// keeps ours honest without 23 copies.
#pragma once

#include <iostream>
#include <string>

#define FAIL_IF_ERR(X, MSG)                                        \
  do {                                                             \
    const client_tpu_torch::Error& err__ = (X);                    \
    if (!err__.IsOk()) {                                           \
      std::cerr << "error: " << (MSG) << ": " << err__.Message()   \
                << std::endl;                                      \
      return 1;                                                    \
    }                                                              \
  } while (0)

// the value after `flag` ("-u", "--device", ...), or `fallback`
inline std::string ParseArg(int argc, char** argv, const std::string& flag,
                            const std::string& fallback) {
  for (int i = 1; i < argc - 1; ++i)
    if (std::string(argv[i]) == flag) return argv[i + 1];
  return fallback;
}

inline std::string ParseUrl(int argc, char** argv,
                            const std::string& fallback) {
  return ParseArg(argc, argv, "-u", fallback);
}
