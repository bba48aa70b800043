// Grouped float32 matrix products C_i[b] = op(A_i[b]) * op(B_i[b]) for Hopper
// (sm_90a), on the tensor cores, accurate to float32.
//
// Replaces: repro/kernels/matmul.py::_matmul_kernel (Pallas, launched by
// `matmul`), the basis-rotation hot spot. Every rotated weight matrix takes
// six products per step: U^T G V and U^T M V rotate the gradient and the
// momentum into the eigenbasis, U S V^T rotates the step back. The optimizer
// issues them as four grouped launches per step over all rotated leaves
// (U^T X for G and M, then X V, then U S, then X V^T), so one launch holds
// up to a few hundred problems of different shapes.
//
// What bounds it on the card: operations, on the tensor route. The products
// must match float32 (rotation parity rtol 2e-3 / atol 1e-4, and the
// card-vs-CPU loss checks), which one TF32 pass does not: it keeps about
// three decimal digits. The 3xTF32 split (tf32_mma.cuh) keeps float32
// accuracy at three tensor-core products per product, so the least time is
// 3 x 2MNK over the dense TF32 rate (495 TFLOP/s on an H100 SXM), against
// 2MNK over the 67 TFLOP/s float32 FMA rate: 2.3x lower. A 384^3 product
// reads 1.8 MB and does 113 MFLOP, so bytes are not the bound.
//
// What the design does about it:
// - One launch per group. The wrapper passes a table of problems (pointers,
//   M, N, K, batch, load flags) and the prefix sum of their output tiles by
//   value as a __grid_constant__ kernel parameter (26 KB for 512 problems;
//   CUDA 12.1+), so nothing is copied to the card and nothing synchronises.
//   Block x finds its problem by binary search over the prefix sum, then its
//   batch entry and 128 x 128 output tile. The wrapper lists the problems
//   with the longest K first, so the longest tiles start first.
// - mma.sync.m16n8k8 tf32, not wgmma. wgmma with tf32 operands reads both
//   from shared memory K-major, and TMA does not transpose 32-bit data; of
//   the path's four cases only X V^T has both operands K-major (U^T X has
//   both MN-major, X V and U S have B N-major), so wgmma would need a
//   producer that transposes every tile on its way in. mma.sync reads its
//   fragments from shared memory in whichever layout the tile arrived, and
//   the row padding (K-major rows of BK + 4 floats, MN-major rows of
//   BM + 8) makes every fragment read free of bank conflicts in all four
//   cases. Each operand is split into big and small halves as its fragment
//   is read.
// - 8 warps of 64 x 32 outputs; K in steps of 32 through a 4-stage ring of
//   cp.async 16-byte copies, so three tiles load while one is multiplied.
//   A problem whose rows are not 16-byte aligned loads by 4-byte copies
//   instead (a flag per operand). The ragged edge is masked in the loads
//   (zero fill) and the stores, not padded. No atomics: each output is one
//   block's, and the result does not depend on the group it ran in.

#include "tf32_mma.cuh"

namespace {

using namespace rbr_tf32;

constexpr int BM = 128;  // output tile rows; matmul.py's TILE_M
constexpr int BN = 128;  // output tile columns; matmul.py's TILE_N
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;                 // 64 rows per warp
constexpr int WN = BN / WARPS_N;                 // 32 columns per warp
constexpr int MI = WM / 16;                      // m16 fragments per warp
constexpr int NI = WN / 8;                       // n8 fragments per warp
constexpr int LD_K = BK + 4;   // row stride of a tile stored [mn][k]: 36 = 4 (mod 32)
constexpr int LD_MN = BM + 8;  // row stride of a tile stored [k][mn]: 136 = 8 (mod 32)
constexpr int MAX_PROBLEMS = 512;  // matmul.py's MAX_PROBLEMS
static_assert(BM == BN, "one tile size serves A and B");

struct Problem {
  const float* A;  // (batch, M, K), or (batch, K, M) when trans_a
  const float* B;  // (batch, K, N), or (batch, N, K) when trans_b
  float* C;        // (batch, M, N)
  int M, N, K, batch;
  int tiles_n;
  int flags;  // bit 0: A loads by 16 bytes, bit 1: B loads by 16 bytes
};

struct Group {
  int count;
  int tile_start[MAX_PROBLEMS + 1];  // output tiles of problems < p, over all batch entries
  Problem p[MAX_PROBLEMS];
};

// Floats of one operand tile: stored [mn][k] when k is contiguous in memory
// (A without trans_a, B with trans_b), else [k][mn].
template <bool K_CONTIG>
__host__ __device__ constexpr int tile_floats() {
  return K_CONTIG ? BM * LD_K : BK * LD_MN;
}

template <bool TA, bool TB>
__host__ __device__ constexpr int stage_floats() {
  return tile_floats<!TA>() + tile_floats<TB>();
}

template <bool TA, bool TB>
constexpr size_t smem_bytes() {
  return sizeof(float) * STAGES * stage_floats<TA, TB>();
}

// Copy an R x C block of a row-major matrix (row stride ld, rows x cols in
// all) from (row0, col0) into shared memory with row stride LDS. Outside the
// matrix it writes zeros.
template <int R, int C, int LDS>
__device__ __forceinline__ void load_tile(float* s, const float* g, long long ld, int row0,
                                          int rows, int col0, int cols, bool vec) {
  constexpr int VECS = R * C / 4;
  static_assert(VECS % THREADS == 0, "whole vectors per thread");
#pragma unroll
  for (int i = 0; i < VECS / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / (C / 4);
    const int c = (v % (C / 4)) * 4;
    const int gr = row0 + r, gc = col0 + c;
    float* dst = s + r * LDS + c;
    const float* src = g + gr * ld + gc;
    if (vec) {  // cols % 4 == 0: a vector is wholly inside or wholly outside
      const bool ok = gr < rows && gc < cols;
      cp_async16(dst, ok ? src : g, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gr < rows && gc + j < cols;
        cp_async4(dst + j, ok ? src + j : g, ok ? 4 : 0);
      }
    }
  }
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(THREADS, 1)
grouped_tf32x3_kernel(const __grid_constant__ Group grp) {
  extern __shared__ __align__(16) float smem[];

  // the problem whose tiles hold this block: tile_start[lo] <= x < tile_start[lo + 1]
  const int tile = blockIdx.x;
  int lo = 0, hi = grp.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (grp.tile_start[mid] <= tile) lo = mid;
    else hi = mid;
  }
  const Problem& P = grp.p[lo];
  const int M = P.M, N = P.N, K = P.K, tiles_n = P.tiles_n;
  const int per_batch = ((M + BM - 1) / BM) * tiles_n;
  const int local = tile - grp.tile_start[lo];
  const int b = local / per_batch;
  const int rem = local - b * per_batch;
  const int m0 = (rem / tiles_n) * BM;
  const int n0 = (rem % tiles_n) * BN;
  const float* A = P.A + (long long)b * M * K;
  const float* B = P.B + (long long)b * K * N;
  float* C = P.C + (long long)b * M * N;
  const bool a_vec = P.flags & 1, b_vec = P.flags & 2;

  auto load_stage = [&](int stage, int kt) {
    float* As = smem + stage * stage_floats<TA, TB>();
    float* Bs = As + tile_floats<!TA>();
    const int k0 = kt * BK;
    if (TA)  // A stored (K, M)
      load_tile<BK, BM, LD_MN>(As, A, M, k0, K, m0, M, a_vec);
    else  // A stored (M, K)
      load_tile<BM, BK, LD_K>(As, A, K, m0, M, k0, K, a_vec);
    if (TB)  // B stored (N, K)
      load_tile<BN, BK, LD_K>(Bs, B, K, n0, N, k0, K, b_vec);
    else  // B stored (K, N)
      load_tile<BK, BN, LD_MN>(Bs, B, N, k0, K, n0, N, b_vec);
  };

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's, and tile kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
    cp_async_commit();

    const float* As = smem + (kt % STAGES) * stage_floats<TA, TB>();
    const float* Bs = As + tile_floats<!TA>();
    auto a_at = [&](int m, int k) { return TA ? As[k * LD_MN + m] : As[m * LD_K + k]; };
    auto b_at = [&](int k, int n) { return TB ? Bs[n * LD_K + k] : Bs[k * LD_MN + n]; };
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragA a[MI];
      FragB bf[NI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm + 16 * i + g;
        a[i] = split_a(a_at(r, kk + t), a_at(r + 8, kk + t), a_at(r, kk + t + 4),
                       a_at(r + 8, kk + t + 4));
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = wn + 8 * j + g;
        bf[j] = split_b(b_at(kk + t, c), b_at(kk + t + 4, c));
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_3xtf32(acc[i][j], a[i], bf[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = n0 + wn + 8 * j + 2 * t;
        if (c < N) C[(long long)r * N + c] = acc[i][j][2 * h];
        if (c + 1 < N) C[(long long)r * N + c + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <bool TA, bool TB>
int launch_grouped(const Group& grp, int tiles, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<TA, TB>();
  cudaError_t err = cudaFuncSetAttribute(grouped_tf32x3_kernel<TA, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  grouped_tf32x3_kernel<TA, TB><<<tiles, THREADS, bytes, stream>>>(grp);
  return (int)cudaGetLastError();
}

}  // namespace

// One grouped launch over `count` problems (1 <= count <= 512), one pair of
// transpose flags for all. ptrs: A, B, C of each problem (each operand and
// output contiguous per batch entry); dims: M, N, K, batch, flags of each;
// tile_start: count + 1 prefix sums of batch * ceil(M/128) * ceil(N/128),
// checked here against dims. Launches on `stream` and returns a CUDA error
// code (0 on success).
extern "C" int rbr_matmul_grouped_f32(const long long* ptrs, const int* dims,
                                      const int* tile_start, int count, int trans_a,
                                      int trans_b, int device, cudaStream_t stream) {
  if (count < 1 || count > MAX_PROBLEMS || tile_start[0] != 0)
    return (int)cudaErrorInvalidValue;
  Group grp;
  grp.count = count;
  grp.tile_start[0] = 0;
  for (int i = 0; i < count; ++i) {
    Problem& p = grp.p[i];
    p.A = reinterpret_cast<const float*>(ptrs[3 * i]);
    p.B = reinterpret_cast<const float*>(ptrs[3 * i + 1]);
    p.C = reinterpret_cast<float*>(ptrs[3 * i + 2]);
    p.M = dims[5 * i];
    p.N = dims[5 * i + 1];
    p.K = dims[5 * i + 2];
    p.batch = dims[5 * i + 3];
    p.flags = dims[5 * i + 4];
    if (p.M < 1 || p.N < 1 || p.K < 1 || p.batch < 1) return (int)cudaErrorInvalidValue;
    p.tiles_n = (p.N + BN - 1) / BN;
    const long long tiles = (long long)p.batch * ((p.M + BM - 1) / BM) * p.tiles_n;
    if ((long long)tile_start[i + 1] - tile_start[i] != tiles) return (int)cudaErrorInvalidValue;
    grp.tile_start[i + 1] = tile_start[i + 1];
  }
  const int tiles = grp.tile_start[count];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (trans_a && trans_b) return launch_grouped<true, true>(grp, tiles, stream);
  if (trans_a) return launch_grouped<true, false>(grp, tiles, stream);
  if (trans_b) return launch_grouped<false, true>(grp, tiles, stream);
  return launch_grouped<false, false>(grp, tiles, stream);
}
