// Flash-attention backward for Hopper (sm_90a): dQ (B2) and dK, dV (B3),
// recomputing the attention weights from the saved logsumexp L.
//
// Replaces: repro/kernels/flash.py::_flash_bwd_dq_kernel (B2) and
// ::_flash_bwd_dkv_kernel (B3), both launched by `_flash_backward`. With
// p_ij = exp(s_ij * scale - L_i) on the visible entries (0 elsewhere),
// dP = dO V^T, D_i = rowsum(dO * O)_i (computed by the caller, as the
// reference computes it outside Pallas) and dS = p * (dP - D):
//     B2:  dQ = scale * dS K
//     B3:  dV = p^T dO,   dK = scale * dS^T Q
//
// What bounds them on the card: bytes, on the tensor route. At the training
// shape (6 heads, S = 256, dh = 64, causal) B2 does 76 MFLOP on 2.0 MB and
// B3 101 MFLOP on 2.4 MB. In 3xTF32 at 495 TFLOP/s that is 0.46 and 0.61 us,
// below the 0.59 and 0.71 us the bytes take at 3.35 TB/s (float32 FMA would
// take 1.13 and 1.51 us). In practice a launch this small is bound by how
// much of the card it occupies and by the latency of its longest block.
//
// What the design does about it (the forward's design, flash_fwd.cu, turned
// to the backward's two loops):
// - Blocks of 16 rows, one m16 fragment. B2 owns 16 query rows and walks the
//   key steps they see; B3 owns 16 keys and walks the query steps that see
//   them. That is 96 blocks at the training shape, and the longest start
//   first: B2's late query tiles, B3's early key tiles.
// - A block's range is split across its 8 warps in steps of 16 (warp w takes
//   steps w, w + 8, ...). Each warp streams its steps' operands (B2: K and V;
//   B3: Q, dO and the step's L and D) through a private double buffer of
//   cp.async copies and keeps its partial sums (B2: 16 x dh of dQ; B3: of dK
//   and dV) in registers. At the end the warps merge through shared memory
//   in warp order: no atomics, and two runs give the same bits, as the
//   reference's two-kernel split intends.
// - Every product runs on the tensor cores, mma.sync.m16n8k8 in 3xTF32
//   (tf32_mma.cuh): dP - D cancels, and the recomputed p must agree with
//   B1's L, which one TF32 pass would not keep. Each k8 product is added to
//   its sum by a float32 add (mma_3xtf32_rn), not by the tensor cores, whose
//   coarser addition would double the error of the model's gradients. The
//   block's fixed operands (B2: Q and dO; B3: K and V) are split once, into
//   shared memory in fragment order, so a warp reads each A fragment as two
//   16-byte loads and holds only its sums and one step's values in
//   registers. P and dS go from the score fragments to the next product's A
//   operand through a small per-warp tile.
// - The streamed tiles are read as B fragments in both orientations (K in
//   B2, Q and dO in B3): at (row g, col t) for the scores and at (row t,
//   col g) for the products over the step. No row padding keeps both free of
//   bank conflicts, so the tiles are stored unpadded with the 16-byte chunks
//   of each row permuted by an XOR on the row (swz), which does.
// - Masked entries are selected to 0 before exp, never multiplied by a mask
//   (fully-masked rows carry L = -1e30); the ragged end of S is masked in the
//   kernel.
// - bf16 inputs (the reference's casts at flash.py:174-177, :193 and
//   :228-229): the same geometry on tiles of half the bytes, stored with
//   rows padded by 16 bytes (LD16) instead of swizzled. The block's fixed
//   operands stay in registers as bf16 pairs (no split to hold). The
//   scores and dP = dO V^T (dP^T = V dO^T in B3) multiply two inputs on
//   mma.sync.m16n8k16 bf16, exact products; dS K, P^T dO and dS^T Q
//   multiply the float32 P or dS by an input in 2xTF32, so P and dS keep
//   their float32 accuracy. Every sum is float32; dQ, dK and dV are rounded
//   to bf16 once, in the merge. At the training shape B2 then moves 1.00 MB
//   (0.30 us) against 0.15 us of products, B3 1.19 MB (0.36 us) against
//   0.26 us: bytes still bound both.
// - Head width 128 (flash_common.cuh): float32 blocks have 4 warps; the bf16
//   fixed operands are stored in shared memory (FixedShared16) and read at
//   each use; each B3 block owns NC = 64 of dh's columns of dK and dV, so
//   B3 launches two blocks per key tile, each recomputing the step's scores
//   over all of dh. The products, their splits and their order are those of
//   the narrower widths.

#include <type_traits>

#include "flash_common.cuh"
#include "tf32_mma.cuh"

namespace rbr_flash {
namespace {

using namespace rbr_tf32;

template <int DH, typename T>
struct BwdGeom {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WARPS = block_warps<DH, T>();
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NF = DH / 8;  // k8 steps over dh, n8 fragments of dh
  // bf16 fixed operands: in registers up to DH 64, in shared memory above
  static constexpr bool FIXED_SHARED = !F32 && DH > 64;
  // B3: blocks per key tile, each owning NC of dh's columns of dK and dV
  static constexpr int CSPLIT = DH > 64 ? 2 : 1;
  static constexpr int NC = DH / CSPLIT;
  // one streamed tile: STEP x DH floats, swizzled (swz); or STEP rows of LD16 bf16
  static constexpr int TILE_ELEMS = F32 ? STEP * DH : STEP * LD16<DH>;
  static constexpr int TILE_BYTES = (int)sizeof(T) * TILE_ELEMS;
  // float32: the two fixed operands' split fragments; bf16: their rows of
  // LD16 (FixedShared16), or nothing when they are held in registers
  static constexpr int FIXED_BYTES =
      F32 ? (int)sizeof(float) * 2 * NF * 2 * 32 * 4
          : (FIXED_SHARED ? (int)sizeof(T) * 2 * ROWS * LD16<DH> : 0);
  // merge rows (B2: DH columns, B3: NC): conflict-free float2 stores
  static constexpr int LDM = DH + 8;
  static constexpr int LDM_KV = NC + 8;
  static constexpr int P_BYTES = (int)sizeof(float) * ROWS * LDP;  // a P or dS tile
  // B2, per warp: two buffers of K and of V, and the dS tile
  static constexpr int DQ_WARP_BYTES = 4 * TILE_BYTES + P_BYTES;
  // B3, per warp: two buffers of Q, of dO and of the step's L and D; the P and dS tiles
  static constexpr int DKV_WARP_BYTES =
      4 * TILE_BYTES + (int)sizeof(float) * 4 * STEP + 2 * P_BYTES;
  static_assert(TILE_BYTES % 16 == 0 && FIXED_BYTES % 16 == 0, "16-byte aligned tiles");
  static_assert((int)sizeof(float) * ROWS * LDM <= DQ_WARP_BYTES &&
                    (int)sizeof(float) * 2 * ROWS * LDM_KV <= DKV_WARP_BYTES,
                "the merge fits the warp buffers");
  static constexpr size_t DQ_BYTES = FIXED_BYTES + WARPS * DQ_WARP_BYTES;
  static constexpr size_t DKV_BYTES = FIXED_BYTES + WARPS * DKV_WARP_BYTES;
};
static_assert(2 * STEP == 32, "one lane per L or D value of a step");

// Offset of element (r, c) in a STEP x DH tile stored unpadded, the 16-byte
// chunks of row r permuted by an XOR with s(r). For rows counted from a
// multiple of 8, both fragment reads, (row g, col t) and (row t, col g) for
// g < 8 and t < 4, then hit 32 distinct banks.
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  const int s = DH == 16 ? (r & 2) + ((r >> 2) & 1) : ((r & 3) << 1) + ((r >> 2) & 1);
  return r * DH + (((c >> 2) ^ s) << 2) + (c & 3);
}

// This lane's share of the cp.async copies of rows [r0, r0 + STEP) of x
// (S, DH) into the tile at dst (float32: swizzled; bf16: rows of LD16);
// rows >= S are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x, int r0, int S,
                                          int lane) {
  static_assert(STEP * DH / 4 % 32 == 0, "whole 16-byte copies per lane");
#pragma unroll
  for (int i = 0; i < STEP * DH / 4 / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    const bool ok = r0 + r < S;
    cp_async16(dst + swz<DH>(r, c), ok ? x + (long long)(r0 + r) * DH + c : x, ok ? 16 : 0);
  }
}

template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x,
                                          int r0, int S, int lane) {
  static_assert(STEP * DH / 8 % 32 == 0, "whole 16-byte copies per lane");
#pragma unroll
  for (int i = 0; i < STEP * DH / 8 / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LD16<DH> + c, ok ? x + (long long)(r0 + r) * DH + c : x, ok ? 16 : 0);
  }
}

// The block's two fixed operands x0, x1 (rows [r0, r0 + ROWS), 0 past S):
// B2's Q and dO, B3's K and V. Float32: split A fragments in shared memory,
// in fragment order: fragment f (operand f / NF, k8 step f % NF) keeps each
// lane's four big values at F[2 f * 32 + lane] and its four small ones at
// F[(2 f + 1) * 32 + lane]; warp w of W splits fragments w, w + W, ...
// straight from device memory. bf16 up to DH 64: each lane's m16n8k16 A
// fragments of both operands in registers, read straight from device
// memory. bf16 above: both operands' rows in shared memory (rows of LD16,
// x0's then x1's), from which a lane reads its fragments at each use.
struct Fixed32 {
  uint4* F;
};
template <int DH>
struct Fixed16 {
  uint32_t a[2][DH / 16][4];
};
struct FixedShared16 {
  const __nv_bfloat16* X;
};

template <int DH>
__device__ __forceinline__ void load_fixed(Fixed32& fx, float* smem, const float* __restrict__ x0,
                                           const float* __restrict__ x1, int r0, int S,
                                           int warp, int nwarps, int lane) {
  constexpr int NF = DH / 8;
  const int g = lane / 4, t = lane % 4;
  fx.F = reinterpret_cast<uint4*>(smem);
  for (int f = warp; f < 2 * NF; f += nwarps) {
    const float* x = f < NF ? x0 : x1;
    const int c = 8 * (f % NF) + t;
    auto at = [&](int r, int cc) {
      return r0 + r < S ? x[(long long)(r0 + r) * DH + cc] : 0.f;
    };
    const FragA a = split_a(at(g, c), at(g + 8, c), at(g, c + 4), at(g + 8, c + 4));
    fx.F[2 * f * 32 + lane] = make_uint4(a.big[0], a.big[1], a.big[2], a.big[3]);
    fx.F[(2 * f + 1) * 32 + lane] = make_uint4(a.small[0], a.small[1], a.small[2], a.small[3]);
  }
}

template <int DH>
__device__ __forceinline__ void load_fixed(Fixed16<DH>& fx, float*,
                                           const __nv_bfloat16* __restrict__ x0,
                                           const __nv_bfloat16* __restrict__ x1, int r0, int S,
                                           int, int, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int op = 0; op < 2; ++op) {
    const __nv_bfloat16* x = op ? x1 : x0;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // rows g, g + 8; columns 2t, 2t + 8
        const int r = g + 8 * (e & 1), c = 16 * kk + 2 * t + 8 * (e >> 1);
        fx.a[op][kk][e] = r0 + r < S ? bf16x2_at(x + (long long)(r0 + r) * DH + c) : 0u;
      }
  }
}

template <int DH>
__device__ __forceinline__ void load_fixed(FixedShared16& fx, float* smem,
                                           const __nv_bfloat16* __restrict__ x0,
                                           const __nv_bfloat16* __restrict__ x1, int r0, int S,
                                           int, int nwarps, int) {
  constexpr int CPR = DH / 8;  // 16-byte chunks a row
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem);
  for (int idx = threadIdx.x; idx < 2 * ROWS * CPR; idx += 32 * nwarps) {
    const int op = idx / (ROWS * CPR), r = idx / CPR % ROWS, c = idx % CPR * 8;
    const __nv_bfloat16* x = op ? x1 : x0;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(x + (long long)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(X + (op * ROWS + r) * LD16<DH> + c) = val;
  }
  fx.X = X;
}

// A lane's m16n8k16 A fragment of k16 step kk of fixed operand op (0: x0, 1: x1).
template <int DH>
__device__ __forceinline__ void fixed16_frag(uint32_t (&a)[4], const FixedShared16& fx, int op,
                                             int kk, int g, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // rows g, g + 8; columns 2t, 2t + 8
    const int r = g + 8 * (e & 1), c = 16 * kk + 2 * t + 8 * (e >> 1);
    a[e] = bf16x2_at(fx.X + (op * ROWS + r) * LD16<DH> + c);
  }
}

__device__ __forceinline__ FragA fixed_frag(const uint4* F, int f, int lane) {
  const uint4 b = F[2 * f * 32 + lane], s = F[(2 * f + 1) * 32 + lane];
  return FragA{{b.x, b.y, b.z, b.w}, {s.x, s.y, s.z, s.w}};
}

// B fragment of X^T for a swizzled tile X, for the scores (contracting dh):
// n8 fragment j of X's rows, k8 step kk of dh.
template <int DH>
__device__ __forceinline__ FragB frag_bt(const float* X, int j, int kk, int g, int t) {
  return split_b(X[swz<DH>(8 * j + g, 8 * kk + t)], X[swz<DH>(8 * j + g, 8 * kk + t + 4)]);
}

// The step's two score tiles, 16 x STEP each, from the fixed operands:
// a += x0 Xa^T and b += x1 Xb^T (B2: s from Q and K, dP from dO and V; B3:
// s^T from K and Q, dP^T from V and dO). UNROLL unrolls the dh loop.
template <int DH, int UNROLL>
__device__ __forceinline__ void score_pair(float (&a)[STEP / 8][4], float (&b)[STEP / 8][4],
                                           const Fixed32& fx, const float* Xa, const float* Xb,
                                           int g, int t, int lane) {
  constexpr int NF = DH / 8;
#pragma unroll (UNROLL)
  for (int kk = 0; kk < NF; ++kk) {
    const FragA fa = fixed_frag(fx.F, kk, lane), fb = fixed_frag(fx.F, NF + kk, lane);
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j) {
      mma_3xtf32_rn(a[j], fa, frag_bt<DH>(Xa, j, kk, g, t));
      mma_3xtf32_rn(b[j], fb, frag_bt<DH>(Xb, j, kk, g, t));
    }
  }
}

template <int DH, int UNROLL>
__device__ __forceinline__ void score_pair(float (&a)[STEP / 8][4], float (&b)[STEP / 8][4],
                                           const Fixed16<DH>& fx, const __nv_bfloat16* Xa,
                                           const __nv_bfloat16* Xb, int g, int t, int) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j) {
      const int off = (8 * j + g) * LD16<DH> + 16 * kk + 2 * t;
      const uint32_t ba[2] = {bf16x2_at(Xa + off), bf16x2_at(Xa + off + 8)};
      const uint32_t bb[2] = {bf16x2_at(Xb + off), bf16x2_at(Xb + off + 8)};
      mma_bf16_rn(a[j], fx.a[0][kk], ba);
      mma_bf16_rn(b[j], fx.a[1][kk], bb);
    }
}

template <int DH, int UNROLL>
__device__ __forceinline__ void score_pair(float (&a)[STEP / 8][4], float (&b)[STEP / 8][4],
                                           const FixedShared16& fx, const __nv_bfloat16* Xa,
                                           const __nv_bfloat16* Xb, int g, int t, int) {
#pragma unroll (UNROLL)
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t fa[4], fb[4];
    fixed16_frag<DH>(fa, fx, 0, kk, g, t);
    fixed16_frag<DH>(fb, fx, 1, kk, g, t);
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j) {
      const int off = (8 * j + g) * LD16<DH> + 16 * kk + 2 * t;
      const uint32_t ba[2] = {bf16x2_at(Xa + off), bf16x2_at(Xa + off + 8)};
      const uint32_t bb[2] = {bf16x2_at(Xb + off), bf16x2_at(Xb + off + 8)};
      mma_bf16_rn(a[j], fa, ba);
      mma_bf16_rn(b[j], fb, bb);
    }
  }
}

// c += a X for the products over the step (contracting X's rows): k8 step
// kk of the rows, n8 fragment j of dh. a is a split float32 P or dS fragment.
template <int DH>
__device__ __forceinline__ void prod_rn(float (&c)[4], const FragA& a, const float* X, int kk,
                                        int j, int g, int t) {
  mma_3xtf32_rn(c, a,
                split_b(X[swz<DH>(8 * kk + t, 8 * j + g)], X[swz<DH>(8 * kk + t + 4, 8 * j + g)]));
}

template <int DH>
__device__ __forceinline__ void prod_rn(float (&c)[4], const FragA& a, const __nv_bfloat16* X,
                                        int kk, int j, int g, int t) {
  const __nv_bfloat16* x = X + (8 * kk + t) * LD16<DH> + 8 * j + g;
  const uint32_t b[2] = {tf32_of(x[0]), tf32_of(x[4 * LD16<DH>])};
  mma_2xtf32_rn(c, a, b);
}

// A fragment of a warp's P or dS tile (ROWS x STEP, row stride LDP): k8 step kk.
__device__ __forceinline__ FragA frag_p(const float* P, int kk, int g, int t) {
  const float* p0 = P + g * LDP + 8 * kk + t;
  const float* p1 = p0 + 8 * LDP;
  return split_a(p0[0], p1[0], p0[4], p1[4]);
}

// Write this warp's ROWS x NC sums (C fragments) as rows of M, stride NC + 8.
template <int NC>
__device__ __forceinline__ void stage_sums(float* M, const float (&acc)[NC / 8][4], int g,
                                           int t) {
  constexpr int LDM = NC + 8;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(M + (g + 8 * h) * LDM + 8 * j + 2 * t) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

// Columns [0, NC) of out row r0 + r (row stride DH) = mul * (sum over the
// warps' staged rows, in warp order), for the rows below S. M holds WARPS
// blocks of ROWS rows, stride NC + 8.
template <int NC, int DH, int WARPS, typename T>
__device__ __forceinline__ void merge_rows(T* __restrict__ out, const float* M, int r0, int S,
                                           float mul) {
  constexpr int LDM = NC + 8;
  for (int idx = threadIdx.x; idx < ROWS * NC / 4; idx += 32 * WARPS) {
    const int r = idx / (NC / 4), c = (idx % (NC / 4)) * 4;
    if (r0 + r >= S) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(M + (w * ROWS + r) * LDM + c);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    store4(out + (long long)(r0 + r) * DH + c,
           make_float4(sum.x * mul, sum.y * mul, sum.z * mul, sum.w * mul));
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(BwdGeom<DH, T>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dO, const float* __restrict__ L,
                    const float* __restrict__ D, T* __restrict__ dq, int BH, int S, int causal,
                    int window, float scale) {
  using G = BwdGeom<DH, T>;
  using Fixed = std::conditional_t<G::F32, Fixed32,
                                   std::conditional_t<G::FIXED_SHARED, FixedShared16, Fixed16<DH>>>;
  constexpr int NF = G::NF, WARPS = G::WARPS;
  // the dh loop of the scores: unrolled whole up to DH 64; by 2 above, where the
  // fixed fragments of every k8 step live at once would spill
  constexpr int UNROLL = DH > 64 ? 2 : NF;
  extern __shared__ __align__(16) float smem[];

  const int ntiles = (S + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % BH;
  const int q0 = (ntiles - 1 - (int)(blockIdx.x / BH)) * ROWS;  // late query tiles first
  const long long head = (long long)bh * S * DH;
  q += head;
  k += head;
  v += head;
  dO += head;
  dq += head;
  L += (long long)bh * S;
  D += (long long)bh * S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* W =
      reinterpret_cast<unsigned char*>(smem) + G::FIXED_BYTES + warp * G::DQ_WARP_BYTES;
  T* Kb = reinterpret_cast<T*>(W);                                // two K buffers
  T* Vb = Kb + 2 * G::TILE_ELEMS;                                 // two V buffers
  float* dSs = reinterpret_cast<float*>(Vb + 2 * G::TILE_ELEMS);  // dS[query row][key], stride LDP

  int lo, hi;
  key_steps(q0, S, causal, window, lo, hi);
  auto load_kv = [&](int buf, int step) {
    load_tile<DH>(Kb + buf * G::TILE_ELEMS, k, step * STEP, S, lane);
    load_tile<DH>(Vb + buf * G::TILE_ELEMS, v, step * STEP, S, lane);
  };
  if (lo + warp < hi) load_kv(0, lo + warp);
  cp_async_commit();
  Fixed fx;  // Q's fragments, then dO's
  load_fixed<DH>(fx, smem, q, dO, q0, S, warp, WARPS, lane);
  float Lr[2], Dr[2];  // rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + g + 8 * h;
    Lr[h] = r < S ? L[r] : 0.f;
    Dr[h] = r < S ? D[r] : 0.f;
  }
  __syncthreads();  // every warp's fragments are in place

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int buf = 0;
  for (int step = lo + warp; step < hi; step += WARPS, buf ^= 1) {
    if (step + WARPS < hi) load_kv(buf ^ 1, step + WARPS);
    cp_async_commit();
    cp_async_wait<1>();  // this step's K and V have landed
    __syncwarp();
    const T* Kc = Kb + buf * G::TILE_ELEMS;
    const T* Vc = Vb + buf * G::TILE_ELEMS;
    const int k0 = step * STEP;

    float s[STEP / 8][4], dp[STEP / 8][4];
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    score_pair<DH, UNROLL>(s, dp, fx, Kc, Vc, g, t, lane);
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = 8 * j + 2 * t + e % 2;
        const bool ok = visible(q0 + g + 8 * h, k0 + c, S, S, causal, window);
        const float p = ok ? expf(s[j][e] * scale - Lr[h]) : 0.f;
        dSs[(g + 8 * h) * LDP + c] = p * (dp[j][e] - Dr[h]);
      }
    __syncwarp();

#pragma unroll
    for (int kk = 0; kk < STEP / 8; ++kk) {
      const FragA sa = frag_p(dSs, kk, g, t);
#pragma unroll
      for (int j = 0; j < NF; ++j) prod_rn<DH>(acc[j], sa, Kc, kk, j, g, t);
    }
    __syncwarp();  // dS and this buffer are read before they are written again
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its buffers: reuse them for the merge
  float* M = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + G::FIXED_BYTES);
  stage_sums<DH>(M + warp * ROWS * G::LDM, acc, g, t);
  __syncthreads();
  merge_rows<DH, DH, WARPS>(dq, M, q0, S, scale);
}

template <int DH, typename T>
__global__ void __launch_bounds__(BwdGeom<DH, T>::THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dO, const float* __restrict__ L,
                     const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int BH,
                     int S, int causal, int window, float scale) {
  using G = BwdGeom<DH, T>;
  using Fixed = std::conditional_t<G::F32, Fixed32,
                                   std::conditional_t<G::FIXED_SHARED, FixedShared16, Fixed16<DH>>>;
  constexpr int NC = G::NC, WARPS = G::WARPS;
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.x % BH;
  const int part = (int)(blockIdx.x / BH);
  const int k0 = part / G::CSPLIT * ROWS;  // early key tiles first
  const int j0 = part % G::CSPLIT * (NC / 8);  // the first n8 fragment of this block's columns
  const long long head = (long long)bh * S * DH;
  q += head;
  k += head;
  v += head;
  dO += head;
  dk += head;
  dv += head;
  L += (long long)bh * S;
  D += (long long)bh * S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* W =
      reinterpret_cast<unsigned char*>(smem) + G::FIXED_BYTES + warp * G::DKV_WARP_BYTES;
  T* Qb = reinterpret_cast<T*>(W);                               // two Q buffers
  T* dOb = Qb + 2 * G::TILE_ELEMS;                               // two dO buffers
  float* LDb = reinterpret_cast<float*>(dOb + 2 * G::TILE_ELEMS);  // two of the step's L, then D
  float* Ps = LDb + 4 * STEP;                                    // P^T[key][query], stride LDP
  float* dSs = Ps + ROWS * LDP;                                  // dS^T[key][query]

  int lo, hi;
  query_steps(k0, S, causal, window, lo, hi);
  auto load_step = [&](int buf, int step) {
    const int q0 = step * STEP;
    load_tile<DH>(Qb + buf * G::TILE_ELEMS, q, q0, S, lane);
    load_tile<DH>(dOb + buf * G::TILE_ELEMS, dO, q0, S, lane);
    const float* src = lane < STEP ? L : D;  // lanes 0-15 copy L, 16-31 copy D
    const int r = q0 + lane % STEP;
    cp_async4(LDb + buf * 2 * STEP + lane, r < S ? src + r : src, r < S ? 4 : 0);
  };
  if (lo + warp < hi) load_step(0, lo + warp);
  cp_async_commit();
  Fixed fx;  // K's fragments, then V's
  load_fixed<DH>(fx, smem, k, v, k0, S, warp, WARPS, lane);
  __syncthreads();  // every warp's fragments are in place

  float dk_acc[NC / 8][4], dv_acc[NC / 8][4];  // this block's columns
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  int buf = 0;
  for (int step = lo + warp; step < hi; step += WARPS, buf ^= 1) {
    if (step + WARPS < hi) load_step(buf ^ 1, step + WARPS);
    cp_async_commit();
    cp_async_wait<1>();  // this step's Q, dO, L and D have landed
    __syncwarp();
    const T* Qc = Qb + buf * G::TILE_ELEMS;
    const T* dOc = dOb + buf * G::TILE_ELEMS;
    const float* Lc = LDb + buf * 2 * STEP;
    const float* Dc = Lc + STEP;
    const int q0 = step * STEP;

    // transposed scores: rows are the block's keys, columns the step's queries
    float st[STEP / 8][4], dpt[STEP / 8][4];
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    // unrolled by 2, not NF: fully unrolled at DH = 64, ptxas keeps the float32
    // fixed fragments of every k8 step live at once and spills (255 registers)
    score_pair<DH, 2>(st, dpt, fx, Qc, dOc, g, t, lane);
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = 8 * j + 2 * t + e % 2;
        const bool ok = visible(q0 + c, k0 + g + 8 * h, S, S, causal, window);
        const float p = ok ? expf(st[j][e] * scale - Lc[c]) : 0.f;
        Ps[(g + 8 * h) * LDP + c] = p;
        dSs[(g + 8 * h) * LDP + c] = p * (dpt[j][e] - Dc[c]);
      }
    __syncwarp();

#pragma unroll
    for (int kk = 0; kk < STEP / 8; ++kk) {
      const FragA pa = frag_p(Ps, kk, g, t), sa = frag_p(dSs, kk, g, t);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        prod_rn<DH>(dv_acc[j], pa, dOc, kk, j0 + j, g, t);
        prod_rn<DH>(dk_acc[j], sa, Qc, kk, j0 + j, g, t);
      }
    }
    __syncwarp();  // P, dS and this buffer are read before they are written again
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its buffers: reuse them for the merge
  float* Mk = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + G::FIXED_BYTES);
  float* Mv = Mk + WARPS * ROWS * G::LDM_KV;
  stage_sums<NC>(Mk + warp * ROWS * G::LDM_KV, dk_acc, g, t);
  stage_sums<NC>(Mv + warp * ROWS * G::LDM_KV, dv_acc, g, t);
  __syncthreads();
  merge_rows<NC, DH, WARPS>(dk + 8 * j0, Mk, k0, S, scale);
  merge_rows<NC, DH, WARPS>(dv + 8 * j0, Mv, k0, S, 1.f);
}

template <int DH, typename T>
int launch_dq(const T* q, const T* k, const T* v, const T* dO, const float* L, const float* D,
              T* dq, int BH, int S, int causal, int window, float scale, cudaStream_t stream) {
  using G = BwdGeom<DH, T>;
  return launch(SLOT_DQ, flash_bwd_dq_kernel<DH, T>, (long long)BH * ((S + ROWS - 1) / ROWS),
                G::THREADS, G::DQ_BYTES, stream, q, k, v, dO, L, D, dq, BH, S, causal, window,
                scale);
}

template <int DH, typename T>
int launch_dkv(const T* q, const T* k, const T* v, const T* dO, const float* L, const float* D,
               T* dk, T* dv, int BH, int S, int causal, int window, float scale,
               cudaStream_t stream) {
  using G = BwdGeom<DH, T>;
  return launch(SLOT_DKV, flash_bwd_dkv_kernel<DH, T>,
                (long long)BH * ((S + ROWS - 1) / ROWS) * G::CSPLIT, G::THREADS, G::DKV_BYTES,
                stream, q, k, v, dO, L, D, dk, dv, BH, S, causal, window, scale);
}

template <typename T>
int dq_entry(const T* q, const T* k, const T* v, const T* dO, const float* L, const float* D,
             T* dq, int BH, int S, int dh, int causal, int window, float scale, int device,
             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (dh) {
    case 16: return launch_dq<16>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
    case 32: return launch_dq<32>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
    case 64: return launch_dq<64>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
    case 128:
      return launch_dq<128>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_entry(const T* q, const T* k, const T* v, const T* dO, const float* L, const float* D,
              T* dk, T* dv, int BH, int S, int dh, int causal, int window, float scale,
              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (dh) {
    case 16:
      return launch_dkv<16>(q, k, v, dO, L, D, dk, dv, BH, S, causal, window, scale, stream);
    case 32:
      return launch_dkv<32>(q, k, v, dO, L, D, dk, dv, BH, S, causal, window, scale, stream);
    case 64:
      return launch_dkv<64>(q, k, v, dO, L, D, dk, dv, BH, S, causal, window, scale, stream);
    case 128:
      return launch_dkv<128>(q, k, v, dO, L, D, dk, dv, BH, S, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rbr_flash

// q, k, v, dO, dq: (BH, S, dh) float32 (or bfloat16: _bf16) contiguous and
// 16-byte aligned; L, D: (BH, S) float32. window < 0 means no window.
// Returns a CUDA error code.
extern "C" int rbr_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                    const float* dO, const float* L, const float* D, float* dq,
                                    int BH, int S, int dh, int causal, int window, float scale,
                                    int device, cudaStream_t stream) {
  return rbr_flash::dq_entry(q, k, v, dO, L, D, dq, BH, S, dh, causal, window, scale, device,
                             stream);
}

extern "C" int rbr_flash_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, const __nv_bfloat16* dO,
                                     const float* L, const float* D, __nv_bfloat16* dq, int BH,
                                     int S, int dh, int causal, int window, float scale,
                                     int device, cudaStream_t stream) {
  return rbr_flash::dq_entry(q, k, v, dO, L, D, dq, BH, S, dh, causal, window, scale, device,
                             stream);
}

// As above, writing dk and dv: (BH, S, dh).
extern "C" int rbr_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                     const float* dO, const float* L, const float* D, float* dk,
                                     float* dv, int BH, int S, int dh, int causal, int window,
                                     float scale, int device, cudaStream_t stream) {
  return rbr_flash::dkv_entry(q, k, v, dO, L, D, dk, dv, BH, S, dh, causal, window, scale,
                              device, stream);
}

extern "C" int rbr_flash_bwd_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const __nv_bfloat16* dO,
                                      const float* L, const float* D, __nv_bfloat16* dk,
                                      __nv_bfloat16* dv, int BH, int S, int dh, int causal,
                                      int window, float scale, int device,
                                      cudaStream_t stream) {
  return rbr_flash::dkv_entry(q, k, v, dO, L, D, dk, dv, BH, S, dh, causal, window, scale,
                              device, stream);
}
