// Flash-attention backward on bfloat16 inputs for Hopper (sm_90a): dQ (B2)
// and dK, dV (B3), on wgmma. The float32 entry points have kernels of their
// own (flash_bwd_f32.cu, flash_bwd.cu).
//
// Replaces: repro/kernels/flash.py::_flash_bwd_dq_kernel (B2) and
// ::_flash_bwd_dkv_kernel (B3), both launched by `_flash_backward`, on bf16
// inputs (the reference's casts at flash.py:174-177, :193 and :228-229).
// With p_ij = exp(s_ij * scale - L_i) on the visible entries (0 elsewhere),
// dP = dO V^T, D_i = rowsum(dO * O)_i (computed by the caller) and
// dS = p * (dP - D):
//     B2:  dQ = scale * dS K
//     B3:  dV = p^T dO,   dK = scale * dS^T Q
// q, k, v and dO are bf16, L and D float32; every sum is float32, and dQ,
// dK and dV are rounded to bf16 once, at the end.
//
// What bounds them on the card: bytes. At qwen3_0_6b's path shape (16 heads,
// S = 256, dh = 128, causal; chip_smoke.py::flash_work(..., elem=2)) B2
// moves 5.3 MB (1.57 us at 3.35 TB/s) for 0.27 GFLOP of bf16 products
// (0.27 us at 989 TFLOP/s), B3 6.3 MB (1.89 us) for 0.34 GFLOP. As with
// every launch this small, what sets the time in practice is the serial
// chain of the longest block.
//
// What the old design (the float32 kernels' geometry on bf16 tiles) lost: blocks
// of 16 rows on mma.sync, split over 8 warps with one 16-row step each, so
// that at S = 256 a block's fixed costs (its fixed operands, L and D, the
// merge of its warps' sums through shared memory) outweighed its two steps;
// P and dS products in 2xTF32 (two tensor-core passes and a hi/lo split of
// every element); at head dim 128 fixed operands re-read from shared memory
// at each use, and B3 split dh's columns over two blocks, each recomputing
// the scores over all of dh. It took 17.86 us (B2) and 32.24 us (B3) at the
// path shape against SDPA's whole bf16 backward at 28.30 (chip_smoke.py, one
// NVIDIA H100 80GB HBM3 at 700 W).
//
// What this design does about it:
// - A block owns 64 rows over the whole head width: B2 64 query rows, and
//   walks the 64-key tiles they see; B3 64 keys, and walks the 64-row query
//   tiles that see them. 64 is wgmma's M. One consumer warpgroup holds the
//   block's sums in registers for its whole range (B2: dQ, DH / 2 floats a
//   thread; B3: dK and dV, 64 + 64 at head dim 128), so nothing merges and
//   B3 computes each score once. Longest ranges start first (B2's late query
//   tiles, B3's early key tiles): 64 blocks a launch at the path shape, the
//   longest walking 4 tiles. The range is not split over a second consumer
//   warpgroup: B3 at dh 128 already takes all 255 registers a thread may
//   hold.
// - Every product is a bf16 wgmma.mma_async with a float32 accumulator. The
//   scores (B2: S = Q K^T and dP = dO V^T; B3: S^T = K Q^T and dP^T = V dO^T)
//   read both operands from shared memory, K-major, in two commit groups:
//   P is computed while dP is still on the tensor cores. P and dS are
//   computed in float32 (exp, then p (dP - D) from the float32 p), rounded
//   to bf16 once, and become the A operand of dQ += dS K (B2), dV += P^T dO
//   and dK += dS^T Q (B3) without leaving the registers (wgmma_bf16.cuh);
//   B is the streamed tile itself, read MN-major through the transpose bit,
//   as it lies in memory. B3 starts dV's product before it computes dS. The
//   reference's TPU fed its matrix unit bf16 P and dS the same way; the
//   plain versions round them alike (flash.py). scale multiplies dQ and dK
//   once, at the end. The tensor cores sum at most dh = 128 products into a
//   score and 64 keys (or queries) a tile into dQ, dK, dV, the tiles in
//   their accumulator too. Against float64 (chip_smoke.py's rel_err_f64) the
//   error equals the plain versions' within 1e-7: 2.35e-3 at the path
//   shapes, against 1.65e-3 for the old kernels, which kept P and dS in
//   float32. The rounding of P and dS explains the whole difference, so no
//   sum is moved out of the accumulator.
// - One producer warp streams the tiles through a ring of STAGES = 3
//   shared-memory stages (B2: K and V; B3: Q and dO) with TMA
//   (cp.async.bulk.tensor), one 64-row box per 64-column panel, behind
//   mbarriers: each stage's `full` barrier completes when its bytes have
//   landed, its `empty` barrier when the consumers' last wgmma on it has
//   completed, and the producer refills it then. So up to three tiles load
//   while one is multiplied. TMA writes the swizzled layout that wgmma's
//   descriptors name, through the same async proxy that wgmma reads, and
//   zero-fills the rows past S. For B3 the producer warp's lanes copy each
//   tile's rows of L and D into its stage. TMA's tensor maps
//   (cuTensorMapEncodeTiled, four a launch) are encoded on the host at every
//   launch: 0.25-0.46 us (rbr_flash_bwd_bf16_maps_ns, timed by
//   chip_smoke.py), against the 35-100 us of host time a wrapper call
//   takes. Loading by cp.async from the producer warp's 32 lanes instead,
//   B2 took 11.9 us at paper_95m's shape with the exp below, against 9.0
//   with TMA and unmasked whole tiles (launch/bench_flash.py).
// - Registers: 160 threads and one block per SM leave each thread 255
//   registers, what the consumer needs (ptxas: B2 at dh 128 172, B3 255, no
//   spills), so no setmaxnreg moves registers from the producer.
//   Shared memory: 2 fixed tiles and 3 stages of 2, 32 KB a tile pair at
//   dh 128 (132 KB a block).
// - exp is ex2.approx on the special function unit (exp2f's accurate path,
//   selected after it, cost the cp.async variant's B2 1.7 us more at
//   paper_95m's shape: 13.6 against 11.9 us), on an argument that the mask
//   has already selected: -inf where the query does not see the key, from
//   each row's span of visible columns. Tiles that every query row sees
//   whole skip the mask.
// - Masked entries are selected to 0 before exp, never multiplied by a mask;
//   the ragged end of S is zero-filled in the copies and masked in the
//   kernel. Each block writes only the rows it owns, with no atomics: two
//   runs give the same bits.
//
// Measured (launch/bench_flash.py, one NVIDIA H100 80GB HBM3 at 700 W): B2 +
// B3 take 10.3-10.6 + 12.4-12.5 us at (16, 256, 128) against SDPA's bf16
// backward at 27.3-27.4, and 8.6-8.7 + 9.8-9.9 us at (6, 256, 64) against
// 21.7-21.8. About
// 4.9 us of each is what any launch costs timed this way (a 16-float
// zero_); the rest is the longest block's chain of 4 tiles and the loads of
// its first ones.

#include <chrono>
#include <cmath>

#include "flash_common.cuh"
#include "wgmma_bf16.cuh"

namespace rbr_flash {
namespace {

using namespace rbr_wgmma;

using bf16 = __nv_bfloat16;

constexpr int BR = TILE_ROWS;             // rows a block owns, rows of a streamed tile
constexpr int STAGES = 3;                 // the ring's stages
constexpr int CONSUMERS = 128;            // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr float LOG2E = 1.4426950408889634f;

// The four heads' tensor maps (q, k, v, dO), passed by value.
struct Maps {
  CUtensorMap q, k, v, dO;
};

template <int DH>
struct Bf16Geom {
  static constexpr int TILE = TileGeom<DH>::BYTES;
  static constexpr int FIXED = 2 * TILE;             // B2: Q, dO; B3: K, V
  // B2: K, V; B3: Q, dO, then the tile's L and D (2 x 64 floats, padded to
  // keep the tiles on 1024-byte boundaries)
  static constexpr int STAGE = 2 * TILE + 1024;
  static constexpr int BARS = 8 * (1 + 2 * STAGES);  // fixed; full and empty per stage
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes in the kernel
  static constexpr size_t BYTES = 1024 + FIXED + STAGES * STAGE + BARS;
};

// The block's shared memory: tiles from a 1024-byte boundary, then the barriers.
struct Ring {
  unsigned char* ptr;  // the fixed tiles, then the stages
  uint32_t base;       // ptr's shared-memory address
  uint32_t bars;       // the barriers: fixed, full[STAGES], empty[STAGES]

  __device__ uint32_t fixed() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + STAGES + s); }
};

// The L and D rows of stage s (B3), after its two tiles.
template <int DH>
__device__ __forceinline__ float* stage_stats(const Ring& ring, int s) {
  using G = Bf16Geom<DH>;
  return reinterpret_cast<float*>(ring.ptr + G::FIXED + s * G::STAGE + 2 * G::TILE);
}

template <int DH>
__device__ __forceinline__ Ring make_ring(unsigned char* raw) {
  using G = Bf16Geom<DH>;
  const uint32_t a = smem_addr(raw), base = (a + 1023) & ~1023u;
  const Ring ring{raw + (base - a), base, base + G::FIXED + STAGES * G::STAGE};
  if (threadIdx.x == 0) {
    mbar_init(ring.fixed(), 1);  // the producer's arrival, then the copies' bytes
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), 32);  // the producer warp's lanes, then the copies' bytes
      mbar_init(ring.empty(s), CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return ring;
}

// The producer warp. Lane 0 starts the TMA copies of the fixed tiles x0, x1
// (rows [f0, f0 + BR)) and then, stage after stage, of the range's tiles
// y0, y1 (rows (lo + i) BR), refilling a stage once the consumers have
// released it: up to STAGES tiles are in flight ahead of the consumers. With
// L and D (B3), the lanes copy the tile's rows of -L log2(e) and of D into
// the stage beside them, 0 past S. Every lane arrives on the stage's `full`
// barrier, lane 0 with the bytes its copies bring.
template <int DH>
__device__ __forceinline__ void produce(const Ring& ring, const CUtensorMap& x0,
                                        const CUtensorMap& x1, int f0, const CUtensorMap& y0,
                                        const CUtensorMap& y1, int lo, int n, int bh, int S,
                                        const float* L, const float* D) {
  using G = Bf16Geom<DH>;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect_tx(ring.fixed(), G::FIXED);
    load_tile<DH>(ring.base, x0, f0, bh, ring.fixed());
    load_tile<DH>(ring.base + G::TILE, x1, f0, bh, ring.fixed());
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, r0 = (lo + i) * BR;
    if (i >= STAGES) mbar_wait(ring.empty(s), (i / STAGES - 1) & 1);
    const uint32_t dst = ring.base + G::FIXED + s * G::STAGE;
    if (L != nullptr) {
      float* LD = stage_stats<DH>(ring, s);
#pragma unroll
      for (int k = 0; k < 2 * BR / 32; ++k) {  // L, then D
        const int idx = lane + 32 * k, r = r0 + idx % BR;
        LD[idx] = r >= S ? 0.f : idx < BR ? -L[r] * LOG2E : D[r];
      }
    }
    if (lane == 0) {
      mbar_expect_tx(ring.full(s), 2 * G::TILE);
      load_tile<DH>(dst, y0, r0, bh, ring.full(s));
      load_tile<DH>(dst + G::TILE, y1, r0, bh, ring.full(s));
    } else {
      mbar_arrive(ring.full(s));
    }
  }
}

// Rows [r0, r0 + BR) of out (row stride DH) = mul * acc, the D fragment of a
// 64 x DH tile, for the rows below S.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[DH / 2],
                                           int r0, int S, float mul) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * w + g + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * DH + 8 * j + 2 * t) =
          __floats2bfloat162_rn(mul * acc[4 * j + 2 * h], mul * acc[4 * j + 2 * h + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The two score tiles of a step, 64 x 64 each: a = x0 y0^T, b = x1 y1^T over
// dh (B2: S from Q and K, dP from dO and V; B3: S^T from K and Q, dP^T from
// V and dO), all four tiles K-major in shared memory, in two commit groups:
// this returns once a is complete, while b may still be computing (wait
// for it with wgmma_wait<0> and fence_regs(b)).
template <int DH>
__device__ __forceinline__ void scores(float (&a)[32], float (&b)[32], uint32_t x0, uint32_t y0,
                                       uint32_t x1, uint32_t y1) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(a, desc_k<DH>(x0, kk), desc_k<DH>(y0, kk), kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(b, desc_k<DH>(x1, kk), desc_k<DH>(y1, kk), kk);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(a);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ Maps maps, const float* __restrict__ L,
                         const float* __restrict__ D, bf16* __restrict__ dq, int BH, int S,
                         int causal, int window, float scale) {
  using G = Bf16Geom<DH>;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring<DH>(smem_raw);

  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (ntiles - 1 - (int)(blockIdx.x / BH)) * BR;  // late query tiles first
  int lo, hi;
  key_steps<BR, BR>(q0, S, causal, window, lo, hi);
  const int n = hi - lo;

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    produce<DH>(ring, maps.q, maps.dO, q0, maps.k, maps.v, lo, n, bh, S, nullptr, nullptr);
    return;
  }

  // the consumer warpgroup: rows are the block's queries, columns a tile's keys
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  L += (long long)bh * S;
  D += (long long)bh * S;
  const float sl2 = scale * LOG2E;
  float nL[2], Dr[2];  // -L log2(e) and D of rows g and g + 8 of this warp's 16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    nL[h] = r < S ? -L[r] * LOG2E : 0.f;
    Dr[h] = r < S ? D[r] : 0.f;
  }
  float acc[DH / 2];
  zero(acc);
  const uint32_t Qa = ring.base, dOa = ring.base + G::TILE;
  mbar_wait(ring.fixed(), 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, k0 = (lo + i) * BR;
    const uint32_t Ka = ring.base + G::FIXED + s * G::STAGE, Va = Ka + G::TILE;
    mbar_wait(ring.full(s), (i / STAGES) & 1);
    float sc[32], dp[32];  // S, then P; dP, then dS
    scores<DH>(sc, dp, Qa, Ka, dOa, Va);
    // P while dP is still on the tensor cores
    if (whole_tile<BR>(q0, k0, S, S, causal, window))
      probs<false, false>(sc, sl2, nL, q0, k0, S, causal, window);
    else
      probs<true, false>(sc, sl2, nL, q0, k0, S, causal, window);
    wgmma_wait<0>();
    fence_regs(dp);
    grad_scores<false>(dp, sc, Dr);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(acc, a[kk], desc_mn<DH>(Ka, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    mbar_arrive(ring.empty(s));
  }
  store_rows<DH>(dq + (long long)bh * S * DH, acc, q0, S, scale);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ Maps maps, const float* __restrict__ L,
                          const float* __restrict__ D, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int BH, int S, int causal, int window,
                          float scale) {
  using G = Bf16Geom<DH>;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring<DH>(smem_raw);

  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * BR;  // early key tiles first
  int lo, hi;
  query_steps<BR, BR>(k0, S, causal, window, lo, hi);
  const int n = hi - lo;

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    produce<DH>(ring, maps.k, maps.v, k0, maps.q, maps.dO, lo, n, bh, S, L + (long long)bh * S,
                D + (long long)bh * S);
    return;
  }

  // the consumer warpgroup: rows are the block's keys, columns a tile's queries
  const float sl2 = scale * LOG2E;
  float dk_acc[DH / 2], dv_acc[DH / 2];
  zero(dk_acc);
  zero(dv_acc);
  const uint32_t Ka = ring.base, Va = ring.base + G::TILE;
  mbar_wait(ring.fixed(), 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, q0 = (lo + i) * BR;
    const uint32_t Qa = ring.base + G::FIXED + s * G::STAGE, dOa = Qa + G::TILE;
    mbar_wait(ring.full(s), (i / STAGES) & 1);
    float sc[32], dp[32];  // S^T, then P^T; dP^T, then dS^T
    scores<DH>(sc, dp, Ka, Qa, Va, dOa);
    // P^T while dP^T is still on the tensor cores, then dV += P^T dO while
    // dS^T is computed
    const float* LD = stage_stats<DH>(ring, s);  // -L log2(e), then D, of the tile's queries
    if (whole_tile<BR>(q0, k0, S, S, causal, window))
      probs<false, true>(sc, sl2, LD, k0, q0, S, causal, window);
    else
      probs<true, true>(sc, sl2, LD, k0, q0, S, causal, window);
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], sc, kk);
    wgmma_wait<0>();
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dv_acc, pa[kk], desc_mn<DH>(dOa, kk), 1);
    wgmma_commit();
    grad_scores<true>(dp, sc, LD + BR);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(sa[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dk_acc, sa[kk], desc_mn<DH>(Qa, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(sa[kk]);
    }
    mbar_arrive(ring.empty(s));
  }
  const long long head = (long long)bh * S * DH;
  store_rows<DH>(dk + head, dk_acc, k0, S, scale);
  store_rows<DH>(dv + head, dv_acc, k0, S, 1.f);
}

template <int DH>
bool make_maps(Maps& m, const bf16* q, const bf16* k, const bf16* v, const bf16* dO, int BH,
               int S) {
  return head_map<DH>(&m.q, q, BH, S) && head_map<DH>(&m.k, k, BH, S) &&
         head_map<DH>(&m.v, v, BH, S) && head_map<DH>(&m.dO, dO, BH, S);
}

template <int DH>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dO, const float* L,
              const float* D, bf16* dq, int BH, int S, int causal, int window, float scale,
              cudaStream_t stream) {
  Maps maps;
  if (!make_maps<DH>(maps, q, k, v, dO, BH, S)) return (int)cudaErrorInvalidValue;
  return launch(SLOT_DQ, flash_bwd_dq_bf16_kernel<DH>, (long long)BH * ((S + BR - 1) / BR),
                THREADS, Bf16Geom<DH>::BYTES, stream, maps, L, D, dq, BH, S, causal, window,
                scale);
}

template <int DH>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dO, const float* L,
               const float* D, bf16* dk, bf16* dv, int BH, int S, int causal, int window,
               float scale, cudaStream_t stream) {
  Maps maps;
  if (!make_maps<DH>(maps, q, k, v, dO, BH, S)) return (int)cudaErrorInvalidValue;
  return launch(SLOT_DKV, flash_bwd_dkv_bf16_kernel<DH>, (long long)BH * ((S + BR - 1) / BR),
                THREADS, Bf16Geom<DH>::BYTES, stream, maps, L, D, dk, dv, BH, S, causal,
                window, scale);
}

}  // namespace
}  // namespace rbr_flash

// q, k, v, dO, dq: (BH, S, dh) bfloat16 contiguous and 16-byte aligned; L, D:
// (BH, S) float32. window < 0 means no window. Returns a CUDA error code.
extern "C" int rbr_flash_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, const __nv_bfloat16* dO,
                                     const float* L, const float* D, __nv_bfloat16* dq, int BH,
                                     int S, int dh, int causal, int window, float scale,
                                     int device, cudaStream_t stream) {
  using namespace rbr_flash;
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

// As above, writing dk and dv: (BH, S, dh) bfloat16.
extern "C" int rbr_flash_bwd_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const __nv_bfloat16* dO,
                                      const float* L, const float* D, __nv_bfloat16* dk,
                                      __nv_bfloat16* dv, int BH, int S, int dh, int causal,
                                      int window, float scale, int device,
                                      cudaStream_t stream) {
  using namespace rbr_flash;
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

// Host nanoseconds to encode the four tensor maps of one launch, the mean of
// `reps` encodings of x as a (BH, S, dh) bf16 tensor; -1 if they fail. The
// cost the TMA route adds to each launch on the host.
extern "C" int rbr_flash_bwd_bf16_maps_ns(const __nv_bfloat16* x, int BH, int S, int dh,
                                          int reps) {
  using namespace rbr_flash;
  if (reps < 1) return -1;
  Maps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    bool ok = false;
    switch (dh) {
      case 16: ok = make_maps<16>(maps, x, x, x, x, BH, S); break;
      case 32: ok = make_maps<32>(maps, x, x, x, x, BH, S); break;
      case 64: ok = make_maps<64>(maps, x, x, x, x, BH, S); break;
      case 128: ok = make_maps<128>(maps, x, x, x, x, BH, S); break;
    }
    if (!ok) return -1;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return (int)(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() / reps);
}
