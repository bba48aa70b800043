// Shared pieces of the flash-attention kernels (flash_fwd.cu: B1,
// flash_bwd.cu: B2 and B3): tile geometry, shared-memory tile loads, the
// register-blocked tile product and the causal / sliding-window mask.
//
// Every kernel works on one head of q, k, v laid out (S, DH) row-major, in
// tiles of 64 query rows by 64 key columns, with 256 threads in a 16 x 16
// grid. Thread (ty, tx) owns a 4 x 4 micro-tile of a score tile (rows
// 4ty..4ty+3, columns 4tx..4tx+3) and a 4 x DH/16 micro-tile of an output
// tile. All products are float32 FFMA with float32 sums: no TF32.
#pragma once

#include <cuda_runtime.h>

namespace rbr_flash {

constexpr int TILE = 64;          // query rows and key columns per tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int PAD = 4;            // keeps float4 rows aligned, spreads stores over banks
constexpr int TLD = TILE + PAD;   // row stride of a tile stored [k][TILE]
constexpr float NEG_INF = -1e30f; // the reference's sentinel for masked scores
constexpr float EPS = 1e-30f;

// Row stride of a tile stored [row][DH].
template <int DH>
__host__ __device__ constexpr int row_ld() { return DH + PAD; }

// Copy rows [row0, row0 + TILE) of src (S, DH) into dst transposed,
// dst[d * TLD + r], for products that contract over d. Rows >= S read 0.
template <int DH>
__device__ __forceinline__ void load_t(const float* __restrict__ src, int row0, int S,
                                       float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < TILE * DH / 4; idx += THREADS) {
    const int r = idx / (DH / 4);
    const int d = (idx % (DH / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * DH + d);
    dst[(d + 0) * TLD + r] = v.x;
    dst[(d + 1) * TLD + r] = v.y;
    dst[(d + 2) * TLD + r] = v.z;
    dst[(d + 3) * TLD + r] = v.w;
  }
}

// Copy the same rows into dst row-major, dst[r * (DH + PAD) + d].
template <int DH>
__device__ __forceinline__ void load_r(const float* __restrict__ src, int row0, int S,
                                       float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < TILE * DH / 4; idx += THREADS) {
    const int r = idx / (DH / 4);
    const int d = (idx % (DH / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * DH + d);
    *reinterpret_cast<float4*>(dst + r * row_ld<DH>() + d) = v;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&b)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    b[0] = t.x; b[1] = t.y; b[2] = t.z; b[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    b[0] = t.x; b[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = p[j];
  }
}

// acc[i][j] += sum_k A[k * lda + a0 + i] * B[k * ldb + b0 + j], for i < 4,
// j < NC: one thread's micro-tile of a product whose operands sit in shared
// memory with the contracted index k outermost. Each output is one FMA
// chain over k in order.
template <int NK, int NC>
__device__ __forceinline__ void tile_fma(float (&acc)[4][NC], const float* A, int lda, int a0,
                                         const float* B, int ldb, int b0) {
#pragma unroll 8
  for (int k = 0; k < NK; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(A + k * lda + a0);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[NC];
    load_vec<NC>(B + k * ldb + b0, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Whether query row r sees key column j: r is a row of the tensor, j is one
// of the seq_len valid keys, and the causal and window (window < 0: none)
// conditions hold. The reference's _tile_mask, plus the row bound that its
// zero padding gave it.
__device__ __forceinline__ bool visible(int r, int j, int S, int seq_len, int causal,
                                        int window) {
  return r < S && j < seq_len && (!causal || j <= r) && (window < 0 || j > r - window);
}

// Key tiles [lo, hi) that can hold a visible column for the query tile at q0.
__device__ __forceinline__ void key_tiles(int q0, int seq_len, int causal, int window,
                                          int& lo, int& hi) {
  const int lo_col = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int hi_col = causal ? min(seq_len, q0 + TILE) : seq_len;
  lo = lo_col / TILE;
  hi = (hi_col + TILE - 1) / TILE;
}

// Query tiles [lo, hi) that can hold a row seeing a column of the key tile at k0.
__device__ __forceinline__ void query_tiles(int k0, int S, int seq_len, int causal, int window,
                                            int& lo, int& hi) {
  if (k0 >= seq_len) {
    lo = hi = 0;
    return;
  }
  const int lo_row = causal ? k0 : 0;
  // j > r - window  <=>  r < j + window, and j < k0 + TILE
  const int hi_row = window >= 0 ? min(S, k0 + TILE - 1 + window) : S;
  lo = lo_row / TILE;
  hi = (hi_row + TILE - 1) / TILE;
}

// Sum or max over the 16 threads that share a row group (tx = 0..15 are
// neighbouring lanes of one warp).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Raise the kernel's dynamic shared-memory limit to `bytes` and launch it.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, size_t bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace rbr_flash
