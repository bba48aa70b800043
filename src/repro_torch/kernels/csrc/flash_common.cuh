// Shared pieces of the flash-attention kernels (flash_fwd.cu: B1,
// flash_bwd.cu: B2 and B3): block geometry, the causal / sliding-window mask,
// the ranges of steps a block walks, and the launch.
//
// Every kernel works on one head of q, k, v laid out (S, DH) row-major. A
// block owns ROWS rows (one m16 fragment of mma.sync: query rows in B1 and
// B2, keys in B3) and splits the range it has to walk over its warps in
// steps of STEP rows (keys in B1 and B2, queries in B3): warp w of W takes
// steps w, w + W, ... All products run on the tensor cores in 3xTF32
// (tf32_mma.cuh), which keeps float32 accuracy.
//
// Each kernel is a template on its head width DH (16, 32, 64 or 128) and its
// input type T, float or __nv_bfloat16. q, k, v and dO are T, L and D
// float32; every product and sum is float32 and O, dQ, dK and dV are written
// as T. With bf16 inputs, products of two inputs run on mma.sync.m16n8k16
// bf16 (exact products) and products of a float32 P or dS by an input in
// 2xTF32 (tf32_mma.cuh); the streamed tiles are stored as T, half the bytes.
//
// Head width 128 keeps the arithmetic of the narrower widths (the same
// products, split the same way and summed in the same order) and changes
// where operands live, so that a block fits the card's 227 KB of shared
// memory and 255 registers a thread without spilling:
// - float32 blocks have 4 warps instead of 8 (block_warps): eight warps'
//   private double buffers of 16 x 128 float32 tiles would take 286-310 KB;
// - operands that a block holds for its whole range (B1's Q in float32, the
//   bf16 B2's and B3's fixed operands) are read from shared memory at each
//   use instead of being held in registers (128 registers for B1's split Q);
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

// Warps of a block: 8, or 4 for float32 heads wider than 64 (see the header).
template <int DH, typename T>
constexpr int block_warps() {
  return DH > 64 && sizeof(T) == 4 ? 4 : 8;
}

// Elements of T in one 16-byte cp.async copy.
template <typename T>
constexpr int CHUNK = 16 / (int)sizeof(T);

// Row stride, in elements, of a bf16 tile of DH columns: one 16-byte chunk of
// padding makes a row 16 (mod 128) bytes long, which keeps the fragment
// reads free of bank conflicts (32-bit pairs at (row g, col 2t) and 16-bit
// values at (row t, col g)).
template <int DH>
constexpr int LD16 = DH + 8;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Whether query row r sees key column j: r is a row of the tensor, j is one
// of the seq_len valid keys, and the causal and window (window < 0: none)
// conditions hold. The reference's _tile_mask, plus the row bound that its
// zero padding gave it.
__device__ __forceinline__ bool visible(int r, int j, int S, int seq_len, int causal,
                                        int window) {
  return r < S && j < seq_len && (!causal || j <= r) && (window < 0 || j > r - window);
}

// Key steps [lo, hi) that can hold a visible key for query rows [q0, q0 + ROWS).
__device__ __forceinline__ void key_steps(int q0, int seq_len, int causal, int window, int& lo,
                                          int& hi) {
  const int lo_col = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int hi_col = causal ? min(seq_len, q0 + ROWS) : seq_len;
  lo = lo_col / STEP;
  hi = (hi_col + STEP - 1) / STEP;
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
