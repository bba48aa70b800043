// Shared pieces of the flash-attention kernels (flash_fwd.cu: B1 on float32
// inputs, flash_fwd_bf16.cu: B1 on bf16 inputs, flash_bwd.cu: B2 and B3 on
// float32 inputs, flash_bwd_bf16.cu: B2 and B3 on bf16 inputs): the causal /
// sliding-window mask, the ranges of keys a block walks, the launch and, for
// the float32 kernels, their block geometry.
//
// The float32 kernels work on one head of q, k, v laid out (S, DH)
// row-major. A block owns ROWS rows (one m16 fragment of mma.sync: query
// rows in B1 and B2, keys in B3) and splits the range it has to walk over
// its warps in steps of STEP rows (keys in B1 and B2, queries in B3): warp w
// of W takes steps w, w + W, ... All products run on the tensor cores in
// 3xTF32 (tf32_mma.cuh), which keeps float32 accuracy. Each is a template on
// its head width DH (16, 32, 64 or 128); q, k, v, dO, L and D are float32.
// The bf16 kernels have a geometry of their own: 64-row tiles on wgmma
// (flash_fwd_bf16.cu, flash_bwd_bf16.cu, wgmma_bf16.cuh).
//
// Head width 128 keeps the arithmetic of the narrower widths (the same
// products, split the same way and summed in the same order) and changes
// where operands live, so that a block fits the card's 227 KB of shared
// memory and 255 registers a thread without spilling:
// - float32 blocks have 4 warps instead of 8 (block_warps): eight warps'
//   private double buffers of 16 x 128 float32 tiles would take 286-310 KB;
// - B1's Q is read from shared memory at each use instead of being held in
//   registers (128 registers for its split);
// - each B3 block owns half of dh's columns of its keys' dK and dV (the
//   scores still contract all of dh), so its two accumulators stay at 64
//   registers, as at head width 64, and B3 launches twice the blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Warps of a float32 block: 8, or 4 for heads wider than 64 (see the header).
template <int DH, typename T>
constexpr int block_warps() {
  return DH > 64 && sizeof(T) == 4 ? 4 : 8;
}

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
// first seq_len) for query rows [q0, q0 + Q_ROWS). The bf16 kernels walk
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

// Query steps [lo, hi) that can hold a row seeing one of the keys [k0, k0 + ROWS).
__device__ __forceinline__ void query_steps(int k0, int S, int causal, int window, int& lo,
                                            int& hi) {
  const int lo_row = causal ? k0 : 0;
  // j > r - window  <=>  r < j + window, and j < k0 + ROWS
  const int hi_row = window >= 0 ? min(S, k0 + ROWS - 1 + window) : S;
  lo = lo_row / STEP;
  hi = (hi_row + STEP - 1) / STEP;
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

}  // namespace rbr_flash
