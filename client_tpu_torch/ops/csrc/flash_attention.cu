// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by client_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas TPU kernel client_tpu/ops/flash_attention.py:_kernel
// (wrapper flash_attention, pallas_call at :95). It computes the same
// function, not the same blocks:
//   - non-paged self-attention, q/k/v/o [B, L, H, D], read and written in
//     that layout through strides (the last dim contiguous), so the two
//     [B*H, L, D] transposes the Pallas version pays around its call are gone;
//   - f32 or bf16 inputs, optional causal mask, any L (the ragged edge is
//     masked here, so the reference's mha_attention fallback for shapes
//     that do not tile has no counterpart on the card), D <= 128;
//   - the online softmax keeps the reference's rounding points: logits
//     summed in f32 and scaled by D^-0.5 in f32, probabilities summed in
//     f32, P rounded to the input dtype before the PV product, PV
//     accumulated in f32, one division by the row sum at the end.
//
// Bound at the encoder slice's shape (B 256, L 128, H 12, D 64, bf16, not
// causal): one call reads q, k and v and writes o, 4 x 50.3 MB = 201 MB,
// about 60 us at an H100 SXM's 3.35 TB/s, against 12.9 GFLOP, about 13 us
// at its 989 TFLOP/s of dense bf16 tensor-core rate: the call is bound by
// memory. chip_smoke.py measures the kernel beside this bound.
//
// bf16 design (flash_fwd_bf16_kernel), the FlashAttention-2 structure:
//   - one CTA of 8 warps per (batch, head, 128 query rows), so at L 128 the
//     K and V rows of a head are read once; each warp owns 16 query rows;
//   - Q, K and V tiles stay bf16 in shared memory, staged by 16-byte
//     cp.async copies into a layout whose 16-byte chunks are XOR-swizzled
//     by row (chunk ^ row % 8), so ldmatrix reads are free of bank
//     conflicts; K/V tiles of 64 keys are double-buffered, so the next
//     tile is in flight during the current tile's math; rows past L and
//     columns past D are zero-filled (cp.async with a source size of 0);
//   - S = Q K^T and O += P V run on the tensor cores as mma.sync m16n8k16
//     (bf16 in, f32 accumulators in registers), V through ldmatrix.trans.
//     mma.sync rather than wgmma: the call is bound by memory (12.9 GFLOP
//     at half the 989 TFLOP/s peak is 26 us, under the 60 us byte bound),
//     and mma.sync keeps each warp's rows and their softmax in registers;
//   - the online softmax runs in registers: each row's max and sum are
//     reduced over the 4 lanes of a quad by shuffles; the row sum takes
//     the f32 probabilities, and only the PV operand is rounded to bf16,
//     converted from the S accumulator fragments with no trip through
//     shared memory;
//   - O is divided once at the end, staged in the warp's own Q rows of
//     shared memory, and written with 16-byte stores.
// A scalar-load instantiation of the same kernel takes inputs whose
// pointers, strides or D are not 16-byte aligned.
//
// f32 inputs keep the CUDA-core kernel (flash_fwd_f32_kernel): TF32 tensor
// cores keep about three decimal digits and would break the 2e-4 f32
// tolerance the JAX suite holds this kernel to. No main path runs f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxDevices = 64;

struct Strides {
  long long b, l, h;  // in elements; the last (head_dim) stride is 1
};

// Raises a kernel's dynamic shared-memory limit once per device, not on
// every launch. Two threads may both do it the first time; that is
// harmless.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// ---------------------------------------------------------------- f32 path
// One block per (batch, head, 64 query rows), 256 threads; Q and each K/V
// tile of 64 keys staged in shared memory; each thread owns 4 query rows x
// 4 keys of the score tile and 4 query rows x D/16 output columns. Products
// on the CUDA cores in f32.

constexpr int kBlockQ = 64;     // query rows per CUDA block
constexpr int kBlockK = 64;     // keys per K/V tile
constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr int kLanes = 16;      // lanes sharing one query row
constexpr int kRows = kBlockQ / (kThreads / kLanes);  // query rows per thread (4)
constexpr int kKeys = kBlockK / kLanes;               // keys per thread (4)

// Shared memory per block: Q and K tiles [64][DP + 1], V tile [64][DP],
// P tile [64][65], all f32. The +1 pads keep the column reads of Q, K and
// P free of bank conflicts.
template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * kBlockQ * (DP + 1) + kBlockK * DP +
                          kBlockQ * (kBlockK + 1));
}

template <int DP>
__device__ __forceinline__ void load_tile_f32(float* dst, int dst_stride,
                                              const float* __restrict__ src,
                                              long long row_stride, int row0,
                                              int L, int D) {
  for (int i = threadIdx.x; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    const int row = row0 + r;
    float x = 0.f;  // rows past L and columns past D are zero
    if (row < L && d < D) x = src[(long long)row * row_stride + d];
    dst[r * dst_stride + d] = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so, int L,
                     int D, int causal, float scale) {
  constexpr int QS = DP + 1;       // Q/K row stride in shared memory
  constexpr int PS = kBlockK + 1;  // P row stride
  constexpr int kCols = DP / kLanes;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * QS;
  float* Vs = Ks + kBlockK * QS;
  float* Ps = Vs + kBlockK * DP;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % kLanes;    // column lane within a row group
  const int r0 = (threadIdx.x / kLanes) * kRows;  // first of this thread's rows

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  load_tile_f32<DP>(Qs, QS, qb, sq.l, q0, L, D);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (L + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile_f32<DP>(Ks, QS, kb, sk.l, k0, L, D);
    load_tile_f32<DP>(Vs, DP, vb, sv.l, k0, L, D);
    __syncthreads();

    // S = Q K^T for rows r0 + i and keys lane + 16 j, f32 accumulation
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[kRows], bk[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(r0 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) bk[j] = Ks[(lane + kLanes * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // online softmax, one row at a time; every row processed here has at
    // least one key that is not masked, so the running max is finite
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + r0 + i;
      float bmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int col = k0 + lane + kLanes * j;
        const bool keep = col < L && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        bmax = fmaxf(bmax, s[i][j]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float new_m = fmaxf(m[i], bmax);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - new_m);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - new_m);
        psum += p;
        Ps[(r0 + i) * PS + lane + kLanes * j] = p;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = new_m;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the whole P tile is written

    // O += P V for rows r0 + i and columns lane + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[kk * DP + lane + kLanes * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Ps[(r0 + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + kLanes * c;
      if (d < D) ob[(long long)row * so.l + d] = acc[i][c] / l[i];
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int L, int H, int D, Strides sq, Strides sk,
                       Strides sv, Strides so, int causal, float scale,
                       cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  auto kernel = flash_fwd_f32_kernel<DP>;
  constexpr int smem = (int)f32_smem_bytes<DP>();
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so, L,
      D, causal, scale);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 path

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcBlockQ = kTcWarps * 16;  // 16 query rows per warp
constexpr int kTcBlockK = 64;             // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: Q [128][DP], K [2][64][DP], V [2][64][DP], bf16.
template <int DP>
constexpr int bf16_smem_bytes() {
  return (int)sizeof(bf16) * DP * (kTcBlockQ + 4 * kTcBlockK);
}

// Element offset of 16-byte chunk `chunk` of tile row `row`: rows of DP
// bf16 (8 or 16 chunks), chunks XOR-swizzled by the row's low 3 bits, so
// the 8 rows one ldmatrix phase reads land on 8 distinct bank groups.
template <int DP>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * DP + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes 0 fills the chunk with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16x16 bf16 (row-major fragment), b 16x8 bf16 (column
// fragment), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to nearest even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stages rows row0 .. row0 + ROWS - 1 of a [L, D] slice (row stride
// `row_stride`) into a swizzled [ROWS][DP] tile; rows past L and columns
// past D are zero. kVec: 16-byte cp.async copies (D % 8 == 0, aligned);
// otherwise element loads of the same layout.
template <int DP, int ROWS, bool kVec>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           long long row_stride, int row0,
                                           int L, int D) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    bf16* d = dst + swz<DP>(r, c);
    if (kVec) {
      const bool in = row < L && c * 8 < D;
      cp_async16(d, in ? src + (long long)row * row_stride + c * 8 : src,
                 in ? 16 : 0);
    } else {
      __align__(16) bf16 x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c * 8 + e;
        x[e] = (row < L && col < D) ? src[(long long)row * row_stride + col]
                                    : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(x);
    }
  }
}

// The warp's 16 query rows (rows wq .. wq + 15 of the Q tile, wrow0 ..
// in the sequence) against the 64 keys from k0 of one K/V tile: S = Q K^T
// on the tensor cores, the online softmax in registers, O += P V. Each
// thread holds rows wrow0 + g (lo) and wrow0 + g + 8 (hi), its quad's
// share of their running max m, sums l and accumulator acc.
template <int DP>
__device__ __forceinline__ void attend_tile(const bf16* Qs, const bf16* Kt,
                                            const bf16* Vt, int wq, int wrow0,
                                            int k0, int L, int causal,
                                            float scale,
                                            float (&acc)[DP / 8][4],
                                            float (&m)[2], float (&l)[2]) {
  constexpr int kDTiles = DP / 8;   // 8-column tiles of O
  constexpr int kKSteps = DP / 16;  // 16-deep steps of Q K^T
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // quad and lane in quad
  const int row_lo = wrow0 + g, row_hi = row_lo + 8;

  // S = Q K^T: 8 key tiles of 8, f32 accumulators
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, Qs + swz<DP>(wq + (lane & 7) + ((lane >> 3) & 1) * 8,
                                2 * ks + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kf[4];
      ldmatrix_x4(kf, Kt + swz<DP>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                   2 * ks + ((lane >> 3) & 1)));
      mma_bf16(s[2 * np], a, kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
    }
  }

  // scale, and mask where a key can be past L or the diagonal; element e
  // of key tile j is row (e < 2 ? lo : hi), key k0 + 8 j + 2 t + (e & 1)
  const bool masked = causal || k0 + kTcBlockK > L;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      if (masked) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        if (key >= L || (causal && key > row)) s[j][e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // every row has an unmasked key in tile 0, so the max is finite from
    // there on
    const float new_m = fmaxf(m[i], mx[i]);
    corr[i] = m[i] == -INFINITY ? 0.f : exp2f((m[i] - new_m) * kLog2e);
    m[i] = new_m;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }

  // P: the f32 probabilities go into the row sums, their bf16 roundings
  // into the A fragments of P V (16 keys per k-step); exp(x - m) as
  // exp2(x log2e - m log2e), one FFMA an element
  const float ml0 = m[0] * kLog2e, ml1 = m[1] * kLog2e;
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2f(fmaf(s[j][0], kLog2e, -ml0));
    const float p1 = exp2f(fmaf(s[j][1], kLog2e, -ml0));
    const float p2 = exp2f(fmaf(s[j][2], kLog2e, -ml1));
    const float p3 = exp2f(fmaf(s[j][3], kLog2e, -ml1));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }

  // O += P V
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int dp = 0; dp < kDTiles / 2; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(
          vf, Vt + swz<DP>(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                           2 * dp + (lane >> 4)));
      mma_bf16(acc[2 * dp], pa[ks], vf[0], vf[1]);
      mma_bf16(acc[2 * dp + 1], pa[ks], vf[2], vf[3]);
    }
}

// The warp's rows of O: the row sums over the quad, one division, bf16
// into the warp's own rows of the Q tile, then 16-byte stores of whole
// rows (element stores for the scalar-load instantiation).
template <int DP, bool kVec>
__device__ __forceinline__ void store_rows(bf16* Qs, int wq, int wrow0,
                                           int L, int D,
                                           bf16* __restrict__ ob,
                                           long long row_stride,
                                           const float (&acc)[DP / 8][4],
                                           float (&l)[2]) {
  constexpr int kDTiles = DP / 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + swz<DP>(wq + g, n) + 2 * t) =
        pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(Qs + swz<DP>(wq + g + 8, n) + 2 * t) =
        pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kDTiles; i += 32) {
    const int r = i / kDTiles, c = i % kDTiles;
    const int row = wrow0 + r;
    if (row >= L || c * 8 >= D) continue;
    const bf16* src = Qs + swz<DP>(wq + r, c);
    bf16* dst = ob + (long long)row * row_stride + c * 8;
    if (kVec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < D; ++e) dst[e] = src[e];
    }
  }
}

template <int DP, bool kVec>
__global__ void __launch_bounds__(kTcThreads, DP == 64 ? 2 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so, int L,
                      int D, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [128][DP]
  bf16* Ks = Qs + kTcBlockQ * DP;                // [2][64][DP]
  bf16* Vs = Ks + 2 * kTcBlockK * DP;            // [2][64][DP]

  const int q0 = blockIdx.x * kTcBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  int n_tiles = (L + kTcBlockK - 1) / kTcBlockK;
  if (causal)  // keys up to the diagonal of the CTA's last row
    n_tiles = min(n_tiles, (min(q0 + kTcBlockQ, L) - 1) / kTcBlockK + 1);

  // prologue: Q with K/V tile 0 in one group, tile 1 in the next (empty
  // when there is none), so every iteration waits for all but one group
  stage_tile<DP, kTcBlockQ, kVec>(Qs, qb, sq.l, q0, L, D);
  stage_tile<DP, kTcBlockK, kVec>(Ks, kb, sk.l, 0, L, D);
  stage_tile<DP, kTcBlockK, kVec>(Vs, vb, sv.l, 0, L, D);
  cp_async_commit();
  if (n_tiles > 1) {
    stage_tile<DP, kTcBlockK, kVec>(Ks + kTcBlockK * DP, kb, sk.l, kTcBlockK,
                                    L, D);
    stage_tile<DP, kTcBlockK, kVec>(Vs + kTcBlockK * DP, vb, sv.l, kTcBlockK,
                                    L, D);
  }
  cp_async_commit();

  const int wq = (threadIdx.x / 32) * 16;  // the warp's first Q tile row
  const int wrow0 = q0 + wq;               // ... and sequence row
  const bool warp_live = wrow0 < L;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows lo, hi
  float l[2] = {0.f, 0.f};              // this thread's share of the sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait_all_but_one();
    __syncthreads();  // tile kt is in shared memory for every warp
    const int k0 = kt * kTcBlockK;
    // a warp skips a tile past its rows' diagonal: every key is masked
    if (warp_live && !(causal && k0 > wrow0 + 15))
      attend_tile<DP>(Qs, Ks + (kt & 1) * kTcBlockK * DP,
                      Vs + (kt & 1) * kTcBlockK * DP, wq, wrow0, k0, L,
                      causal, scale, acc, m, l);
    __syncthreads();  // every warp is done with this tile's buffers
    if (kt + 2 < n_tiles) {
      const int nb = (kt & 1) * kTcBlockK * DP;
      stage_tile<DP, kTcBlockK, kVec>(Ks + nb, kb, sk.l, k0 + 2 * kTcBlockK,
                                      L, D);
      stage_tile<DP, kTcBlockK, kVec>(Vs + nb, vb, sv.l, k0 + 2 * kTcBlockK,
                                      L, D);
    }
    cp_async_commit();
  }
  if (warp_live)
    store_rows<DP, kVec>(Qs, wq, wrow0, L, D, o + b * so.b + h * so.h, so.l,
                         acc, l);
}

template <int DP, bool kVec>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int L, int H, int D, Strides sq, Strides sk,
                        Strides sv, Strides so, int causal, float scale,
                        cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  auto kernel = flash_fwd_bf16_kernel<DP, kVec>;
  constexpr int smem = bf16_smem_bytes<DP>();
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kTcBlockQ - 1) / kTcBlockQ, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, sv, so, L,
      D, causal, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.l % 8 == 0 && s.h % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// CUDA error code of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int L, int H, int D,
                        long long sq_b, long long sq_l, long long sq_h,
                        long long sk_b, long long sk_l, long long sk_h,
                        long long sv_b, long long sv_l, long long sv_h,
                        long long so_b, long long so_l, long long so_h,
                        int causal, float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || D < 1 || D > 128 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_l, sq_h}, sk{sk_b, sk_l, sk_h};
  const Strides sv{sv_b, sv_l, sv_h}, so{so_b, so_l, so_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(D <= 64 ? launch_f32<64>(q, k, v, o, B, L, H, D, sq, sk, sv,
                                          so, causal, scale, s)
                         : launch_f32<128>(q, k, v, o, B, L, H, D, sq, sk, sv,
                                           so, causal, scale, s));
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows: otherwise the scalar-load
  // instantiation of the same kernel
  const bool vec = D % 8 == 0 && aligned16(q, sq) && aligned16(k, sk) &&
                   aligned16(v, sv) && aligned16(o, so);
  cudaError_t err;
  if (D <= 64)
    err = vec ? launch_bf16<64, true>(q, k, v, o, B, L, H, D, sq, sk, sv, so,
                                      causal, scale, s)
              : launch_bf16<64, false>(q, k, v, o, B, L, H, D, sq, sk, sv,
                                       so, causal, scale, s);
  else
    err = vec ? launch_bf16<128, true>(q, k, v, o, B, L, H, D, sq, sk, sv,
                                       so, causal, scale, s)
              : launch_bf16<128, false>(q, k, v, o, B, L, H, D, sq, sk, sv,
                                        so, causal, scale, s);
  return (int)err;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
