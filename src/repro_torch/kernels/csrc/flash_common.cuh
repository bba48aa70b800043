// Shared pieces of the flash-attention kernels: the causal / sliding-window
// mask, the ranges of keys or queries a block walks, the probabilities and
// score gradients of a wgmma score tile, the launches and, for the mma.sync
// kernels, their block geometry. Which kernel serves which entry point and
// head width:
//   B1 float32:  flash_fwd_f32.cu (wgmma) at 64 and 128, flash_fwd.cu
//                (mma.sync) at 16 and 32
//   B2, B3 float32:  flash_bwd_f32.cu (wgmma) at 128, flash_bwd.cu
//                (mma.sync) at 16, 32 and 64
//   B1, B2, B3 bf16:  flash_fwd_bf16.cu, flash_bwd_bf16.cu (wgmma) at
//                every width
// The wgmma kernels own 64-row tiles (wgmma.cuh, wgmma_tf32.cuh,
// wgmma_bf16.cuh). 64 and 128 are the full-width configurations' head
// widths: the float32 B2 and B3 on wgmma were slower than on mma.sync at 64
// (flash_bwd_f32.cu, "Widths"), so they serve 128 only. 16 and 32 (the
// smoke configurations and the tests) keep the float32 mma.sync kernels,
// whose A/B against wgmma was never made.
//
// The mma.sync kernels work on one head of q, k, v laid out (S, DH)
// row-major. A block owns ROWS rows (one m16 fragment of mma.sync: query
// rows in B1 and B2, keys in B3) and splits the range it has to walk over
// its MMA_WARPS warps in steps of STEP rows (keys in B1 and B2, queries in
// B3): warp w of W takes steps w, w + W, ... All products run on the tensor
// cores in 3xTF32 (tf32_mma.cuh), which keeps float32 accuracy. Each is a
// template on its head width DH; q, k, v, dO, L and D are float32.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

// Blocks in the grid of the last launch of B1, B2 and B3, in that order, as
// `launch` recorded them (0 before the first launch): callers read the grid a
// launch used instead of recomputing it. Defined in flash_fwd.cu.
extern "C" int rbr_flash_blocks[3];

namespace rbr_flash {

enum LaunchSlot { SLOT_FWD = 0, SLOT_DQ = 1, SLOT_DKV = 2 };  // rbr_flash_blocks' entries

constexpr int ROWS = 16;                   // rows a block owns
constexpr int STEP = 16;                   // rows of one warp step
constexpr int LDP = STEP + 4;              // row stride of a warp's P or dS tile: 20 = 4 * odd
constexpr float NEG_INF = -1e30f;          // the reference's sentinel for masked scores
constexpr float EPS = 1e-30f;

constexpr int MMA_WARPS = 8;               // warps of an mma.sync block

// Elements of T in one 16-byte cp.async copy.
template <typename T>
constexpr int CHUNK = 16 / (int)sizeof(T);

// Whether query row r sees key column j: r is a row of the tensor, j is one
// of the seq_len valid keys, and the causal and window (window < 0: none)
// conditions hold. The reference's _tile_mask, plus the row bound that its
// zero padding gave it.
__device__ __forceinline__ bool visible(int r, int j, int S, int seq_len, int causal,
                                        int window) {
  return r < S && j < seq_len && (!causal || j <= r) && (window < 0 || j > r - window);
}

// Key steps [lo, hi) of K_STEP keys that can hold a visible key (one of the
// first seq_len) for query rows [q0, q0 + Q_ROWS). The wgmma kernels walk
// 64-key tiles for 64 query rows: key_steps<64, 64>.
template <int Q_ROWS = ROWS, int K_STEP = STEP>
__device__ __forceinline__ void key_steps(int q0, int seq_len, int causal, int window, int& lo,
                                          int& hi) {
  const int lo_col = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int hi_col = causal ? min(seq_len, q0 + Q_ROWS) : seq_len;
  lo = lo_col / K_STEP;
  hi = (hi_col + K_STEP - 1) / K_STEP;
}

// Whether every query row of [q0, q0 + R) sees every key of [k0, k0 + R):
// the rows lie below S, the keys below seq_len, and the causal and window
// conditions hold for every pair. Then the tile needs no mask.
template <int R>
__device__ __forceinline__ bool whole_tile(int q0, int k0, int S, int seq_len, int causal,
                                           int window) {
  return q0 + R <= S && k0 + R <= seq_len && (!causal || k0 + R - 1 <= q0) &&
         (window < 0 || k0 > q0 + R - 1 - window);
}

// The keys [clo[h], chi[h]] that each of a wgmma D fragment's two rows sees
// (row 16 w + g + 8 h of the 64 query rows from q0; none past S): the
// causal diagonal, the window and seq_len.
__device__ __forceinline__ void fragment_keys(int q0, int warp, int g, int S, int seq_len,
                                              int causal, int window, int (&clo)[2],
                                              int (&chi)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    clo[h] = window >= 0 ? r - window + 1 : 0;
    chi[h] = r >= S ? -1 : min(causal ? r : S - 1, seq_len - 1);
  }
}

// The scores of one 64 x 64 tile (a wgmma D fragment) times mult, in place,
// and their row maxima over this thread's columns; with MASKED, -inf where
// the row does not see the key (fragment_keys). Fragment columns are
// k0 + 8 j + 2 t + e % 2.
template <bool MASKED>
__device__ __forceinline__ void scale_scores(float (&sc)[32], float (&mt)[2], float mult,
                                             const int (&clo)[2], const int (&chi)[2], int k0) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e, h = e / 2, col = k0 + 8 * j + 2 * t + e % 2;
      sc[x] = !MASKED || (col >= clo[h] && col <= chi[h]) ? sc[x] * mult : -INFINITY;
      mt[h] = fmaxf(mt[h], sc[x]);
    }
}

// P of one 64 x 64 tile from its scores s (a D fragment), in place:
// p = 2^(s scale log2(e) - L log2(e)) where the query sees the key, else 0
// (the select is on exp's argument: -inf gives 0). Fragment rows are
// r0 + 16 w + g + 8 (e / 2), columns c0 + 8 j + 2 t + e % 2: queries and keys
// (B2), or keys and queries (KEY_ROWS, B3); nL (-L log2(e)) comes per
// query: B2's two rows, from registers, or B3's 64 columns, from the stage in
// shared memory. MASKED = false skips the mask (whole_tile). The mask is
// visible()'s, as the span of columns [lo, hi] that each of the thread's two
// rows keeps.
template <bool MASKED, bool KEY_ROWS>
__device__ __forceinline__ void probs(float (&s)[32], float sl2, const float* nL, int r0, int c0,
                                      int S, int causal, int window) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * w + g + 8 * h;
    if (KEY_ROWS) {  // key r: queries q >= r (causal) and q < r + window
      lo[h] = causal ? r : 0;
      hi[h] = r >= S ? -1 : window >= 0 ? min(S - 1, r + window - 1) : S - 1;
    } else {  // query r: keys j <= r (causal) and j > r - window
      lo[h] = window >= 0 ? r - window + 1 : 0;
      hi[h] = r >= S ? -1 : causal ? min(r, S - 1) : S - 1;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      float arg = fmaf(s[x], sl2, nL[KEY_ROWS ? 8 * j + 2 * t + e % 2 : e / 2]);
      if (MASKED) {
        const int col = c0 + 8 * j + 2 * t + e % 2;
        arg = col >= lo[e / 2] && col <= hi[e / 2] ? arg : -INFINITY;
      }
      s[x] = rbr_wgmma::fast_exp2(arg);
    }
}

// dS = p (dP - D) of one tile, in place of dP, from its P (probs) and D per
// query, as nL comes to probs.
template <bool KEY_ROWS>
__device__ __forceinline__ void grad_scores(float (&dp)[32], const float (&p)[32],
                                            const float* Dv) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      dp[x] = p[x] * (dp[x] - Dv[KEY_ROWS ? 8 * j + 2 * t + e % 2 : e / 2]);
    }
}

// Query steps [lo, hi) of Q_STEP rows that can hold a row seeing one of the
// keys [k0, k0 + K_ROWS). The wgmma kernels walk 64-row query tiles for 64
// keys: query_steps<64, 64>.
template <int K_ROWS = ROWS, int Q_STEP = STEP>
__device__ __forceinline__ void query_steps(int k0, int S, int causal, int window, int& lo,
                                            int& hi) {
  const int lo_row = causal ? k0 : 0;
  // j > r - window  <=>  r < j + window, and j < k0 + K_ROWS
  const int hi_row = window >= 0 ? min(S, k0 + K_ROWS - 1 + window) : S;
  lo = lo_row / Q_STEP;
  hi = (hi_row + Q_STEP - 1) / Q_STEP;
}

// Raise the kernel's dynamic shared-memory limit to `bytes`, launch `blocks`
// blocks of `threads` on `stream`, and record the grid in
// rbr_flash_blocks[slot]. Returns a CUDA error code.
template <typename Kernel, typename... Args>
inline int launch(LaunchSlot slot, Kernel kernel, long long blocks, int threads, size_t bytes,
                  cudaStream_t stream, Args... args) {
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks);
  kernel<<<grid, threads, bytes, stream>>>(args...);
  err = cudaGetLastError();
  if (err == cudaSuccess) rbr_flash_blocks[slot] = (int)(grid.x * grid.y * grid.z);
  return (int)err;
}

// `launch` in clusters of `cluster` consecutive blocks (thread block
// clusters: their blocks run at once on neighbouring SMs and can read each
// other's shared memory).
template <typename... Params, typename... Args>
inline int launch_cluster(LaunchSlot slot, void (*kernel)(Params...), int cluster,
                          long long blocks, int threads, size_t bytes, cudaStream_t stream,
                          Args... args) {
  if (blocks > 0x7fffffffLL || blocks % cluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) rbr_flash_blocks[slot] = (int)blocks;
  return (int)err;
}

// The float32 B1 on mma.sync (flash_fwd.cu), for the head widths that its
// wgmma kernel (flash_fwd_f32.cu) leaves to it; the arguments of
// rbr_flash_fwd_f32.
int launch_fwd_mma(const float* q, const float* k, const float* v, float* o, float* L, int BH,
                   int S, int dh, int seq_len, int causal, int window, float scale,
                   cudaStream_t stream);

// The float32 B2 and B3 on mma.sync (flash_bwd.cu), for the head widths
// that their wgmma kernels (flash_bwd_f32.cu) leave to them; the arguments
// of rbr_flash_bwd_dq_f32 and rbr_flash_bwd_dkv_f32.
int launch_dq_mma(const float* q, const float* k, const float* v, const float* dO,
                  const float* L, const float* D, float* dq, int BH, int S, int dh, int causal,
                  int window, float scale, cudaStream_t stream);
int launch_dkv_mma(const float* q, const float* k, const float* v, const float* dO,
                   const float* L, const float* D, float* dk, float* dv, int BH, int S, int dh,
                   int causal, int window, float scale, cudaStream_t stream);

}  // namespace rbr_flash
