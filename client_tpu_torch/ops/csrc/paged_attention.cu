// Paged (block-table) decode attention for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded through ctypes by
// client_tpu_torch/ops/paged_attention.py).
//
// Replaces the Pallas TPU kernel client_tpu/ops/paged_attention.py:_kernel
// (wrapper paged_decode_attention, pallas_call at :134). It computes the
// same function, not the same blocks:
//   - one query row per slot, q [S, H, Dh]; K/V read straight out of one
//     layer's slabs of the block pool, [N, bl, Hkv, Dh] each, through the
//     slot's block table tables[s, :] (int32 pool block ids), so the
//     gathered [S, B*bl, Hkv, Dh] copy the einsum path builds never exists;
//   - grouped-query attention folded as in the reference: the r = H/Hkv
//     query heads of KV head g are rows g*r .. g*r+r-1, K/V unexpanded;
//   - only the live blocks b < min(pos[s]/bl + 1, B) are read, and rows at
//     positions past pos[s] are masked to -1e30;
//   - the reference's rounding points: q, k, v upcast to f32, logits
//     scaled by Dh^-0.5 in f32, the running max starting at -1e30, the
//     probabilities kept in f32 for the PV product (unlike the flash
//     kernel, P is not rounded to the input dtype), f32 accumulation, one
//     division by the running sum at the end and one cast.
//
// Design: one CUDA block of 128 threads per (slot, KV head). The block
// walks its slot's live table entries in order. For each it stages the
// block's bl K and V rows of its head in shared memory as f32, scores its
// r query rows against them (one thread per (row, key)), updates each
// row's running max and sum, and adds P V into an f32 accumulator in
// shared memory (one thread per (row, column)). A block id outside
// [0, N) makes the block write NaN instead of reading out of bounds.
//
// Bound at the generation slice's shape (S 16, H = Hkv = 12, Dh 64, bl 16,
// bf16, every slot at position 191 with a table of 12 blocks): one call
// reads the K and V rows of the live blocks, 16 x 192 x 12 x 64 x 2 bytes
// x 2 = 9.4 MB, plus q and writes o (49 KB), about 2.8 us at an H100 SXM's
// 3.35 TB/s; its 2 x 2 x 16 x 12 x 192 x 64 flops are nothing next to that.
// The call is bound by memory. This kernel is not near that bound: each
// block's loop is serial (load, sync, score, sync, softmax, sync, PV) with
// no load in flight during the compute, and 192 blocks fill 132 SMs
// unevenly. Split-K over the table (several blocks per slot and head, a
// second pass to merge), cp.async or TMA double buffering and tensor-core
// products are the later steps. chip_smoke.py measures the kernel beside
// this bound on the card it runs on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 128;
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

struct PoolStrides {
  long long n, t, h;  // in elements; the last (head_dim) stride is 1
};

// Shared memory in floats: Q [r][D+1], K [bl][D+1], V [bl][D], P [r][bl],
// the accumulator [r][D], and the running max, sum and rescale [r] each.
// The +1 pads keep the column reads of Q and K free of bank conflicts.
inline size_t smem_floats(int r, int D, int bl) {
  return (size_t)r * (D + 1) + (size_t)bl * (D + 1) + (size_t)bl * D +
         (size_t)r * bl + (size_t)r * D + 3 * (size_t)r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ o, int H,
                    int Hkv, int D, int N, int bl, int B, long long sq_s,
                    long long sq_h, PoolStrides sk, PoolStrides sv,
                    long long stab_s, long long so_s, long long so_h,
                    float scale) {
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int r = H / Hkv;
  const int DP = D + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* Qs = smem;            // [r][DP]
  float* Ks = Qs + r * DP;     // [bl][DP]
  float* Vs = Ks + bl * DP;    // [bl][D]
  float* Ps = Vs + bl * D;     // [r][bl]: logits, then probabilities
  float* Acc = Ps + r * bl;    // [r][D]
  float* Mx = Acc + r * D;     // [r] running max
  float* Sum = Mx + r;         // [r] running sum
  float* Corr = Sum + r;       // [r] this block's rescale of the old state
  __shared__ int bad_id;

  const int p = pos[s];
  // live blocks hold positions <= p (the reference's pos // bl + 1, capped
  // at the table width; a negative position attends nothing)
  const int live = p < 0 ? 0 : min(p / bl + 1, B);
  const T* qs = q + s * sq_s + (long long)g * r * sq_h;
  for (int e = tid; e < r * D; e += kThreads) {
    const int i = e / D, d = e % D;
    Qs[i * DP + d] = to_f32(qs[i * sq_h + d]);
    Acc[e] = 0.f;
  }
  for (int i = tid; i < r; i += kThreads) {
    Mx[i] = kMaskValue;
    Sum[i] = 0.f;
  }
  if (tid == 0) bad_id = 0;

  const int* tab = tables + s * stab_s;
  for (int b = 0; b < live; ++b) {
    const int bid = tab[b];  // the same value in every thread
    if (bid < 0 || bid >= N) {
      if (tid == 0) bad_id = 1;
      continue;
    }
    __syncthreads();  // the previous block's K, V and P are no longer read
    const T* kb = kp + bid * sk.n + g * sk.h;
    const T* vb = vp + bid * sv.n + g * sv.h;
    for (int e = tid; e < bl * D; e += kThreads) {
      const int t = e / D, d = e % D;
      Ks[t * DP + d] = to_f32(kb[t * sk.t + d]);
      Vs[t * D + d] = to_f32(vb[t * sv.t + d]);
    }
    __syncthreads();

    // logits of row i against key t, scaled, masked past the position
    for (int e = tid; e < r * bl; e += kThreads) {
      const int i = e / bl, t = e % bl;
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc = fmaf(Qs[i * DP + d], Ks[t * DP + d], acc);
      Ps[e] = (b * bl + t <= p) ? acc * scale : kMaskValue;
    }
    __syncthreads();

    // online softmax, one thread per query row
    for (int i = tid; i < r; i += kThreads) {
      float* row = Ps + i * bl;
      float bmax = row[0];
      for (int t = 1; t < bl; ++t) bmax = fmaxf(bmax, row[t]);
      const float m_new = fmaxf(Mx[i], bmax);
      const float corr = expf(Mx[i] - m_new);
      float psum = 0.f;
      for (int t = 0; t < bl; ++t) {
        const float pv = expf(row[t] - m_new);
        row[t] = pv;
        psum += pv;
      }
      Sum[i] = Sum[i] * corr + psum;
      Mx[i] = m_new;
      Corr[i] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V, one thread per (row, column)
    for (int e = tid; e < r * D; e += kThreads) {
      const int i = e / D, d = e % D;
      float a = Acc[e] * Corr[i];
      const float* prow = Ps + i * bl;
      for (int t = 0; t < bl; ++t) a = fmaf(prow[t], Vs[t * D + d], a);
      Acc[e] = a;
    }
  }
  __syncthreads();

  T* os = o + s * so_s + (long long)g * r * so_h;
  for (int e = tid; e < r * D; e += kThreads) {
    const int i = e / D, d = e % D;
    const float out = bad_id ? NAN : Acc[e] / Sum[i];
    os[i * so_h + d] = from_f32<T>(out);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* pos, void* o, int S, int H,
                   int Hkv, int D, int N, int bl, int B, long long sq_s,
                   long long sq_h, PoolStrides sk, PoolStrides sv,
                   long long stab_s, long long so_s, long long so_h,
                   float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T>;
  const size_t smem = sizeof(float) * smem_floats(H / Hkv, D, bl);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(S, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, pos, static_cast<T*>(o), H, Hkv, D,
      N, bl, B, sq_s, sq_h, sk, sv, stab_s, so_s, so_h, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and o share it). tables
// [S, B] and pos [S] are int32; strides are in elements, the last dim of
// every tensor contiguous. Returns the CUDA error code of the launch (0 on
// success); the kernel runs asynchronously on `stream`.
int paged_decode_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* tables, const void* pos, void* o, int S, int H, int Hkv,
    int D, int N, int bl, int B, long long sq_s, long long sq_h,
    long long sk_n, long long sk_t, long long sk_h, long long sv_n,
    long long sv_t, long long sv_h, long long stab_s, long long so_s,
    long long so_h, float scale, void* stream) {
  if (S < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 || D > kMaxHeadDim ||
      N < 1 || bl < 1 || B < 1 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const PoolStrides sk{sk_n, sk_t, sk_h}, sv{sv_n, sv_t, sv_h};
  const int* tab = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, tab, ps, o, S, H, Hkv, D, N, bl, B,
                              sq_s, sq_h, sk, sv, stab_s, so_s, so_h, scale,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, tab, ps, o, S, H, Hkv, D, N,
                                      bl, B, sq_s, sq_h, sk, sv, stab_s, so_s,
                                      so_h, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
