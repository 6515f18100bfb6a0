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
// Bound at the generation slice's shape (S 16, H = Hkv = 12, Dh 64, bl 16,
// bf16, every slot at position 191 with a table of 12 blocks): one call
// reads the K and V rows of the live blocks, 16 x 192 x 12 x 64 x 2 bytes
// x 2 = 9.4 MB, plus q and writes o (49 KB), about 2.8 us at an H100 SXM's
// 3.35 TB/s; its 2 x 2 x 16 x 12 x 192 x 64 flops are nothing next to that.
// The call is bound by memory, and at 192 (slot, head) pairs by latency.
//
// Design: split-K over the table inside one launch. Each (slot, KV head)
// gets a thread-block cluster of C CTAs (C <= 8, from the table width:
// about 3 table entries a CTA, so C = 4 at width 12, 768 CTAs). CTA c
// scores the contiguous share [c * per, (c + 1) * per) of the slot's live
// blocks, per = max(3, ceil(live / 8)), and keeps a partial state (running
// max m, sum l, f32 accumulator); the cluster then
// merges the C states through distributed shared memory
// (cooperative_groups::this_cluster, map_shared_rank, cluster.sync), each
// weighted by exp(m_c - max m). A CTA with no live block keeps m = -1e30,
// l = 0, acc = 0, which the merge weights to exactly zero. One launch per
// layer, no second merge kernel: the engine that calls this is host-bound,
// and a merge launch would double its K2 launches.
// Every quantity that orders a slot's f32 sums (its share size, its stage
// boundaries every kPasses * rpc rows of a share, the row -> thread map and
// the reductions) follows from the slot's own live count and compile-time
// constants, never from the table width B or the cluster size C: the
// shares past a slot's last one are empty and merge to exactly nothing, so
// a slot's output is bit-equal whichever co-runners set the launch's B.
// Inside a CTA (128 threads): a row of Dh elements is lpr lanes x 16 bytes
// (8 lanes at bf16 Dh 64, so a warp covers 4 rows per load); each thread
// issues the 16-byte cp.async copies of every K and V chunk it will read
// before any math, so all of the CTA's bytes are in flight at once (shares
// longer than a stage are double-buffered). q stays in registers; a row's
// dot product is EPC FMAs a lane plus a shuffle over its lpr lanes; the
// softmax max is a CTA-wide reduction; PV accumulates each lane's EPC
// columns in f32 and reduces across row groups at the end. Grouped queries
// loop over up to 4 query rows against the same K/V chunks.
// No tensor cores: at r = 1 the product is a matrix-vector product, and the
// reference keeps P in f32, which a bf16 or TF32 PV would round.
// A block id outside [0, N) makes its slot's output NaN instead of an
// out-of-bounds read. A scalar-load instantiation of the same kernel takes
// inputs whose pointers, strides or Dh are not 16-byte aligned.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxCluster = 8;       // the portable cluster size limit
constexpr int kBlocksPerCta = 3;     // table entries per CTA that set C
constexpr int kPasses = 8;           // row passes per stage
constexpr int kMaxSmem = 232448;     // what one block may use on sm_90
constexpr int kMaxDevices = 64;
constexpr float kMaskValue = -1e30f;

struct PoolStrides {
  long long n, t, h;  // in elements; the last (head_dim) stride is 1
};

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

// 16 bytes of T (8 bf16 or 4 f32) widened to f32
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[4]) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = f[i];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages one 16-byte chunk (EPC elements from column ch * EPC) of a pool
// row into its slot in shared memory: a cp.async copy, or element loads
// with the columns past D zeroed.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_chunk(unsigned char* dst,
                                            const T* __restrict__ src, int ch,
                                            int D) {
  constexpr int EPC = 16 / sizeof(T);
  if (kVec) {
    cp_async16(dst, src + ch * EPC);
  } else {
    __align__(16) T x[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const int d = ch * EPC + e;
      x[e] = d < D ? src[d] : from_f32<T>(0.f);
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(x);
  }
}

// One CTA of the cluster for (slot s, KV head g); RQ query rows at a time.
// Dynamic shared memory: [n_bufs][K, V][buf_rows][lpr x 16 bytes], then
// the slot's table row (B ints). buf_rows holds a stage of the widest share
// that the launch's B allows (stage_rows, or the whole share if shorter).
template <typename T, int RQ, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ o, int H,
                    int Hkv, int D, int N, int bl, int B, int lpr,
                    int stage_rows, int buf_rows, int n_bufs, long long sq_s,
                    long long sq_h, PoolStrides sk, PoolStrides sv,
                    long long stab_s, long long so_s, long long so_h,
                    float scale) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / C;
  const int g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r = H / Hkv;
  const int rpc = kThreads / lpr;   // rows per CTA pass
  const int grp = tid / lpr;        // this thread's row in a pass
  const int ch = tid % lpr;         // ... and its 16-byte chunk of the row
  const bool has_chunk = ch * EPC < D;
  const int slot_bytes = lpr * 16;  // one staged row
  const int buf_bytes = 2 * buf_rows * slot_bytes;

  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem + n_bufs * buf_bytes);
  __shared__ float red[2][kWarps][RQ];            // stage maxima, by parity
  __shared__ float part[kWarps][RQ][kMaxHeadDim];  // warp sums of acc
  __shared__ float lpart[kWarps][RQ];
  // the CTA's partial state, read by the whole cluster
  __shared__ float acc_c[RQ][kMaxHeadDim];
  __shared__ float m_c[RQ], l_c[RQ];
  __shared__ int bad_c;

  // position and table row in one round trip
  const int p = pos[s];
  for (int i = tid; i < B; i += kThreads) tab[i] = tables[s * stab_s + i];
  __syncthreads();

  // live blocks hold positions <= p (the reference's pos // bl + 1, capped
  // at the table width; a negative position attends nothing)
  const int live = p < 0 ? 0 : min(p / bl + 1, B);
  // ceil(live / per) <= C for every live <= B (see launch)
  const int per = max(kBlocksPerCta, (live + kMaxCluster - 1) / kMaxCluster);
  const int b0 = min(rank * per, live), b1 = min(b0 + per, live);
  const int n_rows = (b1 - b0) * bl;
  bool bad = false;
  for (int b = b0; b < b1; ++b) bad |= (unsigned)tab[b] >= (unsigned)N;
  const int n_stages = (n_rows + stage_rows - 1) / stage_rows;

  // issues the copies of stage st: each thread the chunks it reads later
  auto stage = [&](int st) {
    unsigned char* kb = smem + (st % n_bufs) * buf_bytes;
    unsigned char* vb = kb + buf_rows * slot_bytes;
    const int row0 = st * stage_rows;
    const int rows = min(stage_rows, n_rows - row0);
    if (has_chunk) {
      for (int ri = grp; ri < rows; ri += rpc) {
        const int i = row0 + ri;
        const int bid = tab[b0 + i / bl], t = i % bl;
        if ((unsigned)bid >= (unsigned)N) continue;  // output is NaN
        stage_chunk<T, kVec>(kb + ri * slot_bytes + ch * 16,
                             kp + bid * sk.n + t * sk.t + g * sk.h, ch, D);
        stage_chunk<T, kVec>(vb + ri * slot_bytes + ch * 16,
                             vp + bid * sv.n + t * sv.t + g * sv.h, ch, D);
      }
    }
    cp_async_commit();
  };

  int parity = 0;
  for (int i0 = 0; i0 < r; i0 += RQ) {
    const int nq = min(RQ, r - i0);
    // this thread's chunk of each query row, in f32
    float qv[RQ][EPC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int e = 0; e < EPC; ++e) qv[i][e] = 0.f;
    if (has_chunk) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        if (i >= nq) break;
        const T* qr = q + s * sq_s + (long long)(g * r + i0 + i) * sq_h;
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const int d = ch * EPC + e;
          if (kVec || d < D) qv[i][e] = to_f32(qr[d]);
        }
      }
    }
    float m[RQ], lsum[RQ], acc[RQ][EPC];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      m[i] = kMaskValue;
      lsum[i] = 0.f;
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[i][e] = 0.f;
    }

    if (n_stages > 0) stage(0);
    for (int st = 0; st < n_stages; ++st) {
      if (n_bufs > 1 && st + 1 < n_stages) {
        stage(st + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // every chunk read below was copied by this thread: no CTA barrier
      const unsigned char* kb = smem + (st % n_bufs) * buf_bytes;
      const unsigned char* vb = kb + buf_rows * slot_bytes;
      const int row0 = st * stage_rows;
      const int rows = min(stage_rows, n_rows - row0);

      // logits of this thread's rows, scaled, masked past the position
      float lg[RQ][kPasses];
      float mx[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) mx[i] = kMaskValue;
#pragma unroll
      for (int j = 0; j < kPasses; ++j) {
        const int ri = j * rpc + grp;
        float dot[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dot[i] = 0.f;
        if (ri < rows && has_chunk) {
          float kf[EPC];
          widen(*reinterpret_cast<const uint4*>(kb + ri * slot_bytes + ch * 16),
                kf);
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              dot[i] = fmaf(qv[i][e], kf[e], dot[i]);
        }
        for (int off = lpr / 2; off > 0; off >>= 1)
#pragma unroll
          for (int i = 0; i < RQ; ++i)
            dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
        // the row's position is b0 * bl + row0 + ri
        const bool keep = ri < rows && b0 * bl + row0 + ri <= p;
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          lg[i][j] = keep ? dot[i] * scale : kMaskValue;
          mx[i] = fmaxf(mx[i], lg[i][j]);
        }
      }
      // the stage's max of each query row over the CTA
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        for (int off = 16; off > 0; off >>= 1)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
        if (lane == 0) red[parity][warp][i] = mx[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float m_new = m[i];
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          m_new = fmaxf(m_new, red[parity][w][i]);
        const float corr = expf(m[i] - m_new);
        m[i] = m_new;
        lsum[i] *= corr;
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[i][e] *= corr;
      }
      parity ^= 1;

      // acc += P V over this thread's rows and columns, P in f32
#pragma unroll
      for (int j = 0; j < kPasses; ++j) {
        const int ri = j * rpc + grp;
        if (ri >= rows) continue;
        float pr[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          pr[i] = expf(lg[i][j] - m[i]);
          lsum[i] += pr[i];
        }
        if (!has_chunk) continue;
        float vf[EPC];
        widen(*reinterpret_cast<const uint4*>(vb + ri * slot_bytes + ch * 16),
              vf);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[i][e] = fmaf(pr[i], vf[e], acc[i][e]);
      }
    }

    // the CTA's state: sum over the row groups of each warp by shuffles,
    // then over the warps; every lane of a row group holds the same lsum
    for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], off);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
      }
    if (lane < lpr && has_chunk) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int e = 0; e < EPC; ++e) part[warp][i][ch * EPC + e] = acc[i][e];
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) lpart[warp][i] = lsum[i];
    }
    __syncthreads();
    for (int e = tid; e < nq * D; e += kThreads) {
      const int i = e / D, d = e % D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += part[w][i][d];
      acc_c[i][d] = a;
    }
    if (tid == 0) {  // m is the same in every thread
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float l = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) l += lpart[w][i];
        l_c[i] = l;
        m_c[i] = m[i];
      }
      bad_c = bad;
    }
    cluster.sync();  // every CTA's state is written and visible

    // merge: the cluster's threads share the nq x D outputs
    for (int e = rank * kThreads + tid; e < nq * D; e += C * kThreads) {
      const int i = e / D, d = e % D;
      float mm = kMaskValue;
      for (int c = 0; c < C; ++c)
        mm = fmaxf(mm, cluster.map_shared_rank(&m_c[0], c)[i]);
      float a = 0.f, l = 0.f;
      int any_bad = 0;
      for (int c = 0; c < C; ++c) {
        const float w = expf(cluster.map_shared_rank(&m_c[0], c)[i] - mm);
        a = fmaf(w, cluster.map_shared_rank(&acc_c[i][d], c)[0], a);
        l = fmaf(w, cluster.map_shared_rank(&l_c[0], c)[i], l);
        any_bad |= *cluster.map_shared_rank(&bad_c, c);
      }
      o[s * so_s + (long long)(g * r + i0 + i) * so_h + d] =
          from_f32<T>(any_bad ? NAN : a / l);
    }
    cluster.sync();  // no CTA's state is overwritten or freed while read
  }
}

// Per kernel instantiation and device: whether the dynamic shared-memory
// limit is raised, and the largest dynamic shared memory with which each
// cluster size was found placeable. Written once per value; two threads
// may both write the same value, which is harmless.
struct LaunchCache {
  int smem_limit[kMaxDevices];
  int placeable[kMaxDevices][kMaxCluster + 1];
};

template <typename T, int RQ, bool kVec>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* pos, void* o, int S, int H,
                   int Hkv, int D, int N, int bl, int B, long long sq_s,
                   long long sq_h, PoolStrides sk, PoolStrides sv,
                   long long stab_s, long long so_s, long long so_h,
                   float scale, cudaStream_t stream) {
  static LaunchCache cache;
  auto kernel = paged_decode_kernel<T, RQ, kVec>;
  constexpr int EPC = 16 / sizeof(T);
  // lanes per row: a power of two covering the row's 16-byte chunks
  const int chunks = (D + EPC - 1) / EPC;
  int lpr = 1;
  while (lpr < chunks) lpr *= 2;
  const int rpc = kThreads / lpr;
  // C covers every slot's shares: for live <= 24 a share is 3 blocks and
  // ceil(live / 3) <= ceil(B / 3); past 24, B > 24 gives C = 8
  const int C =
      min(kMaxCluster, max(1, (B + kBlocksPerCta - 1) / kBlocksPerCta));
  // the widest share any slot of this launch can have (per of live = B)
  const int max_rows =
      max(kBlocksPerCta, (B + kMaxCluster - 1) / kMaxCluster) * bl;
  // stage boundaries at fixed row counts of a share, whatever B is
  const int stage_rows = kPasses * rpc;
  const int buf_rows = min(stage_rows, (max_rows + rpc - 1) / rpc * rpc);
  const int n_bufs = max_rows > stage_rows ? 2 : 1;
  const int smem =
      n_bufs * 2 * buf_rows * lpr * 16 + ((B * 4 + 15) / 16) * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if ((long long)S * C > 0x7fffffffLL || Hkv > 65535)
    return cudaErrorInvalidValue;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (smem > 48 * 1024 && !(cached && cache.smem_limit[dev] >= smem)) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int limit = kMaxSmem - (int)attr.sharedSizeBytes;
    if (smem > limit) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    if (cached) cache.smem_limit[dev] = limit;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * C, Hkv, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  // a cluster that cannot be placed is an error, not a smaller launch
  if (!(cached && cache.placeable[dev][C] >= smem)) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (cached) cache.placeable[dev][C] = smem;
  }
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, pos, static_cast<T*>(o), H, Hkv, D, N,
      bl, B, lpr, stage_rows, buf_rows, n_bufs, sq_s, sq_h, sk, sv, stab_s,
      so_s, so_h, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_rows(int r, const void* q, const void* k, const void* v,
                        const int* tables, const int* pos, void* o, int S,
                        int H, int Hkv, int D, int N, int bl, int B,
                        long long sq_s, long long sq_h, PoolStrides sk,
                        PoolStrides sv, long long stab_s, long long so_s,
                        long long so_h, float scale, cudaStream_t stream) {
  if (r == 1)
    return launch<T, 1, kVec>(q, k, v, tables, pos, o, S, H, Hkv, D, N, bl,
                              B, sq_s, sq_h, sk, sv, stab_s, so_s, so_h,
                              scale, stream);
  return launch<T, 4, kVec>(q, k, v, tables, pos, o, S, H, Hkv, D, N, bl, B,
                            sq_s, sq_h, sk, sv, stab_s, so_s, so_h, scale,
                            stream);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* tables, const int* pos, void* o, int S,
                         int H, int Hkv, int D, int N, int bl, int B,
                         long long sq_s, long long sq_h, PoolStrides sk,
                         PoolStrides sv, long long stab_s, long long so_s,
                         long long so_h, float scale, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows: otherwise the scalar-load
  // instantiation of the same kernel
  constexpr int EPC = 16 / sizeof(T);
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = D % EPC == 0 && a16(k) && a16(v) && sk.n % EPC == 0 &&
                   sk.t % EPC == 0 && sk.h % EPC == 0 && sv.n % EPC == 0 &&
                   sv.t % EPC == 0 && sv.h % EPC == 0;
  const int r = H / Hkv;
  if (vec)
    return launch_rows<T, true>(r, q, k, v, tables, pos, o, S, H, Hkv, D, N,
                                bl, B, sq_s, sq_h, sk, sv, stab_s, so_s, so_h,
                                scale, stream);
  return launch_rows<T, false>(r, q, k, v, tables, pos, o, S, H, Hkv, D, N,
                               bl, B, sq_s, sq_h, sk, sv, stab_s, so_s, so_h,
                               scale, stream);
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
      N < 1 || bl < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const PoolStrides sk{sk_n, sk_t, sk_h}, sv{sv_n, sv_t, sv_h};
  const int* tab = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dtype<float>(q, k, v, tab, ps, o, S, H, Hkv, D, N, bl,
                                    B, sq_s, sq_h, sk, sv, stab_s, so_s, so_h,
                                    scale, st);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(q, k, v, tab, ps, o, S, H, Hkv, D,
                                            N, bl, B, sq_s, sq_h, sk, sv,
                                            stab_s, so_s, so_h, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
