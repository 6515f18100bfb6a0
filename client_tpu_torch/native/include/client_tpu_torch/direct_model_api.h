// C ABI for "compiled model" shared libraries driven by the perf
// analyzer's DIRECT (no-RPC) backend kind.
//
// Parity role: the reference's triton_c_api backend dlopen-loads the
// server library and measures inference with no network in the path
// (ref:src/c++/perf_analyzer/client_backend/triton_c_api/
// shared_library.cc:38-90 dlopen/dlsym;
// triton_loader.cc:251-940 start/infer/stats). Here the dlopen surface
// is a minimal model ABI instead of a whole server: a library exports
// the functions below, the backend resolves them with dlsym and drives
// inference in-process. Two libraries implement it: the CPU stock
// library (src/direct_models.cc, libdirect_models_cpu.so: reference
// models add_sub / add_sub_fp32 / identity computed on the host) and the
// card's (src/direct_models_cuda.cu, libdirect_models_cuda.so: the same
// models, each call H2D -> hand-written kernels -> D2H).
//
// Lifetime rules:
// - const char* error strings are owned by the library (thread-local),
//   valid until the next call on the same thread.
// - Strings returned by *Json() are malloc'd; free with
//   DirectStringFree.
// - DirectResult outputs are valid until DirectResultDestroy.
// All functions are thread-safe; a DirectModel may be shared across
// threads.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define CLIENT_TPU_TORCH_DIRECT_API_VERSION 1

typedef struct DirectModel DirectModel;
typedef struct DirectResult DirectResult;

// API-version handshake (mismatch => refuse to drive the library).
int DirectApiVersion(void);

// 0 on success; on failure returns nonzero and sets *error.
int DirectModelCreate(const char* model_name, DirectModel** out,
                      const char** error);
void DirectModelDestroy(DirectModel* model);

// {"metadata": <v2 model metadata>, "config": <model config>} — malloc'd.
char* DirectModelMetadataJson(DirectModel* model);

// {"model_stats": [...]} in the v2 statistics-extension shape — malloc'd.
// (Role parity: triton_loader.cc:905-940 ModelInferenceStatistics
// serialization.)
char* DirectModelStatsJson(DirectModel* model);

// Run one inference. Inputs are parallel arrays of length input_count;
// each data pointer holds the packed little-endian tensor bytes.
int DirectModelInfer(DirectModel* model, const char* const* input_names,
                     const void* const* input_data,
                     const size_t* input_byte_sizes, size_t input_count,
                     DirectResult** out, const char** error);

size_t DirectResultOutputCount(const DirectResult* result);
const char* DirectResultOutputName(const DirectResult* result, size_t i);
const char* DirectResultOutputDatatype(const DirectResult* result,
                                       size_t i);
const int64_t* DirectResultOutputShape(const DirectResult* result, size_t i,
                                       size_t* rank);
const void* DirectResultOutputData(const DirectResult* result, size_t i,
                                   size_t* byte_size);
void DirectResultDestroy(DirectResult* result);

void DirectStringFree(char* s);

#ifdef __cplusplus
}  // extern "C"
#endif
