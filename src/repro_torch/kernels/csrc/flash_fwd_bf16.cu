// Flash-attention forward (B1) on bfloat16 inputs for Hopper (sm_90a), on
// wgmma: causal or sliding-window attention with an online softmax, emitting
// O and the row logsumexp L. The float32 entry point keeps its own kernel
// (flash_fwd.cu).
//
// Replaces: repro/kernels/flash.py::_flash_fwd_kernel (launched by
// `_flash_forward`) on bf16 inputs. The reference upcasts q, k and v
// (flash.py:94-96), keeps P and every sum in float32 (:108-113) and writes O
// in the input dtype and L in float32 (:116-124). Per head and query row i:
//     s_ij = (q_i . k_j) * scale             over the visible keys j
//     O_i  = sum_j softmax(s_i)_j v_j,   L_i = max_j s_ij + log sum_j exp(s_ij - max)
// A row that sees no key gives O_i = 0 and L_i = -1e30, as in the reference.
//
// What bounds it on the card: bytes. At qwen3_0_6b's path shape (16 heads,
// S = 256, dh = 128, causal; chip_smoke.py::flash_work(..., elem=2)) a
// launch moves 4.2 MB (1.26 us at 3.35 TB/s) for 0.13 GFLOP of bf16 S and
// 2 x 0.13 of P V in two bf16 passes (0.41 us at 989 TFLOP/s). As with
// every launch this small, what sets the time in practice is the serial
// chain of the longest block.
//
// Why a kernel of its own: on the float32 kernel's geometry (16-row blocks
// on mma.sync, each of 8 warps streaming its own K and V, P through shared
// memory, P V in 2xTF32, an 8-warp merge of 16 x dh float32 sums) bf16 B1
// took 21.02 us at (16, 256, 128) against SDPA's bf16 forward at 12.80
// (chip_smoke.py, one NVIDIA H100 80GB HBM3 at 700 W); the merge alone moved
// 64 KB through shared memory per block at dh 128.
//
// What this design does about it:
// - A block owns 64 query rows (wgmma's M) over the whole head width and
//   walks the 64-key tiles those rows can see (key_steps<64, 64>: the
//   causal diagonal, the window and seq_len). Late query tiles start first.
//   BH * ceil(S / 64) blocks: 64 at (16, 256, 128), 24 at (6, 256, 64).
// - One producer warp streams Q once, then K and V tiles, by TMA
//   (cp.async.bulk.tensor) through a ring of STAGES shared-memory stages
//   behind full/empty mbarriers, into the swizzled panels wgmma's
//   descriptors name (wgmma_bf16.cuh); TMA zero-fills rows past S. The
//   tensor maps are encoded on the host at each launch.
// - Two consumer warpgroups take the block's key tiles in turn (tile i goes
//   to warpgroup i % 2), so the longest block's serial chain halves (4
//   tiles at S = 256 become 2 each) and one warpgroup's softmax overlaps the
//   other's products; each keeps its own m, l and 64 x dh accumulator in
//   registers, and at the end warpgroup 1 hands them to warpgroup 0 through
//   shared memory once, so the result repeats bit for bit. 288 threads and
//   one block an SM leave 224 registers a thread (ptxas: 160 at dh 128).
// - S = Q K^T is a bf16 wgmma (m64n64k16) with both operands read K-major
//   from shared memory, over dh in the k16 order of the bf16 B2's S: the
//   forward's scores, and so its L, are the ones B2 and B3 recompute.
// - The online softmax runs in float32 on the score registers, in base 2:
//   row max across the quad by shuffles, ex2.approx on s scale log2(e) - m.
//   Tiles that every query row sees whole skip the mask; elsewhere the mask
//   (keys past seq_len too) selects exp's argument to -inf, never multiplies.
// - P V from registers: P is split into P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi), two wgmma chains (m64n{dh}k16, A from the score
//   registers, B the V tile read MN-major through the transpose bit, as it
//   lies in memory) into one float32 accumulator. V is exact in bf16, so P V
//   keeps P to ~2^-17, as the reference keeps P in float32; the plain
//   version (kernels/flash.py) needs no rounding of its own.
// - O is divided by l, rounded to bf16 once and written from the fragments;
//   rows past S are not written. Nothing is atomic.
//
// Measured (launch/bench_flash.py, this kernel and the old one in turns in
// one call, two calls, NVIDIA H100 80GB HBM3 at 700 W): 10.59-11.01 us at
// (16, 256, 128) against 20.67-20.96 before and SDPA's bf16 forward at
// 12.19-12.70; 8.51-9.20 us at (6, 256, 64) against 10.30-10.62 and
// 10.94-11.41. About 5 us of each is what any launch costs timed this way
// (a 16-float zero_). In the first call one consumer warpgroup took
// 11.39-11.52 and 9.52-9.66 us (two: 10.82-11.01, 9.12-9.20); P rounded
// once to bf16 (one P V pass) 10.29-10.37 and 8.74 us, with 1.23x the
// error against float64 (1.94e-3 against 1.58e-3).

#include <chrono>
#include <cmath>

#include "flash_common.cuh"
#include "wgmma_bf16.cuh"

namespace rbr_flash {
namespace {

using namespace rbr_wgmma;

using bf16 = __nv_bfloat16;

constexpr int BR = TILE_ROWS;  // query rows a block owns, keys of a streamed tile
constexpr int STAGES = 4;      // the ring's stages: a 256-key range loads at once
constexpr int WG = 128;        // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;       // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The three heads' tensor maps (q, k, v), passed by value.
struct FwdMaps {
  CUtensorMap q, k, v;
};

template <int DH>
struct FwdBf16Geom {
  static constexpr int TILE = TileGeom<DH>::BYTES;
  static constexpr int STAGE = 2 * TILE;  // K, V
  // warpgroup 1's state for the merge: m and l of its 2 rows a thread, then
  // its accumulator, each float at [i][thread of the warpgroup]
  static constexpr int MERGE = (4 + DH / 2) * WG * 4;
  static constexpr int BARS = 8 * (1 + 2 * STAGES);  // Q; full and empty per stage
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes in the kernel
  static constexpr size_t BYTES = 1024 + TILE + STAGES * STAGE + MERGE + BARS;
};

// Synchronise the consumer warpgroups alone (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The scores of one 64 x 64 tile (a D fragment) times scale log2(e), in
// place, and their row maxima over this thread's columns; with MASKED, -inf
// where the row does not see the key: each of the thread's two rows sees
// the keys [clo, chi]. Fragment columns are k0 + 8 j + 2 t + e % 2.
template <bool MASKED>
__device__ __forceinline__ void scale_scores(float (&sc)[32], float (&mt)[2], float sl2,
                                             const int (&clo)[2], const int (&chi)[2], int k0) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e, h = e / 2, col = k0 + 8 * j + 2 * t + e % 2;
      sc[x] = !MASKED || (col >= clo[h] && col <= chi[h]) ? sc[x] * sl2 : -INFINITY;
      mt[h] = fmaxf(mt[h], sc[x]);
    }
}

// The A fragments of k16 step kk of P (the D fragment of a 64 x 64 float32
// tile): hi = bf16(p), lo = bf16(p - hi), so that hi + lo keeps p to ~2^-17.
__device__ __forceinline__ void split_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&d)[32], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // pairs as a_frag takes them (wgmma_bf16.cuh)
    const float x0 = d[8 * kk + 2 * i], x1 = d[8 * kk + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ FwdMaps maps, bf16* __restrict__ o,
                      float* __restrict__ L, int BH, int S, int seq_len, int causal, int window,
                      float scale) {
  using G = FwdBf16Geom<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t Qa = base, stages = base + G::TILE;
  float* merge = reinterpret_cast<float*>(smem_raw + (base - raw) + G::TILE +
                                          STAGES * G::STAGE);
  const uint32_t bars = base + G::TILE + STAGES * G::STAGE + G::MERGE;
  const uint32_t fixed = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  if (threadIdx.x == 0) {
    mbar_init(fixed, 1);  // the producer's arrival, then Q's bytes
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);     // the producer's arrival, then the tile pair's bytes
      mbar_init(empty(s), WG);   // the warpgroup that took the stage's tile
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x % BH;
  const int q0 = (ntiles - 1 - (int)(blockIdx.x / BH)) * BR;  // late query tiles first
  int lo, hi;
  key_steps<BR, BR>(q0, seq_len, causal, window, lo, hi);
  const int n = max(hi - lo, 0);

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: lane 0 issues every copy
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(fixed, G::TILE);
      load_tile<DH>(Qa, maps.q, q0, bh, fixed);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, k0 = (lo + i) * BR;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        const uint32_t dst = stages + s * G::STAGE;
        mbar_expect_tx(full(s), G::STAGE);
        load_tile<DH>(dst, maps.k, k0, bh, full(s));
        load_tile<DH>(dst + G::TILE, maps.v, k0, bh, full(s));
      }
    }
    return;
  }

  // the consumer warpgroups: rows are the block's queries, columns a tile's keys
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const float sl2 = scale * LOG2E;
  // the keys [clo, chi] that each of the thread's two rows sees (none past S)
  int clo[2], chi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    clo[h] = window >= 0 ? r - window + 1 : 0;
    chi[h] = r >= S ? -1 : min(causal ? r : S - 1, seq_len - 1);
  }
  // running max (base 2) and this thread's share of the row sums
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  mbar_wait(fixed, 0);

  for (int i = wg; i < n; i += 2) {
    const int s = i % STAGES, k0 = (lo + i) * BR;
    const uint32_t Ka = stages + s * G::STAGE, Va = Ka + G::TILE;
    mbar_wait(full(s), (i / STAGES) & 1);
    float sc[32];  // S, then P
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(sc, desc_k<DH>(Qa, kk), desc_k<DH>(Ka, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // s scale log2(e); tiles that every row sees whole skip the mask
    float mt[2] = {-INFINITY, -INFINITY};
    if (whole_tile<BR>(q0, k0, S, seq_len, causal, window))
      scale_scores<false>(sc, mt, sl2, clo, chi, k0);
    else
      scale_scores<true>(sc, mt, sl2, clo, chi, k0);
    float corr[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four lanes of a quad share rows g and g + 8
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      mu[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p and corr 0
      corr[h] = fast_exp2(m[h] - mu[h]);
      m[h] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        sc[x] = fast_exp2(sc[x] - mu[e / 2]);
        ps[e / 2] += sc[x];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
#pragma unroll
    for (int a = 0; a < DH / 2; ++a) acc[a] *= corr[a % 4 / 2];

    // acc += P_lo V + P_hi V, k16 step by k16 step
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_frag(ph[kk], pl[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DH>(acc, pl[kk], desc_mn<DH>(Va, kk), 1);
      wgmma_rs<DH>(acc, ph[kk], desc_mn<DH>(Va, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    mbar_arrive(empty(s));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sums over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // warpgroup 1 hands its state to warpgroup 0, which merges it into its own
  if (wg == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      merge[h * WG + tid] = m[h];
      merge[(2 + h) * WG + tid] = l[h];
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) merge[(4 + i) * WG + tid] = acc[i];
  }
  consumers_sync();
  if (wg == 1) return;
  float f0[2], f1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = merge[h * WG + tid], l1 = merge[(2 + h) * WG + tid];
    const float mx = fmaxf(m[h], m1), mm = mx == -INFINITY ? 0.f : mx;
    f0[h] = fast_exp2(m[h] - mm);
    f1[h] = fast_exp2(m1 - mm);
    l[h] = l[h] * f0[h] + l1 * f1[h];
    m[h] = mx;
  }
#pragma unroll
  for (int i = 0; i < DH / 2; ++i)
    acc[i] = acc[i] * f0[i % 4 / 2] + merge[(4 + i) * WG + tid] * f1[i % 4 / 2];

  o += (long long)bh * S * DH;
  L += (long long)bh * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= S) continue;
    const bool live = l[h] > 0.f;
    const float inv = live ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r * DH + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (t == 0) L[r] = live ? m[h] * LN2 + logf(l[h]) : NEG_INF;
  }
}

template <int DH>
bool make_fwd_maps(FwdMaps& m, const bf16* q, const bf16* k, const bf16* v, int BH, int S) {
  return head_map<DH>(&m.q, q, BH, S) && head_map<DH>(&m.k, k, BH, S) &&
         head_map<DH>(&m.v, v, BH, S);
}

template <int DH>
int launch_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* L, int BH,
                    int S, int seq_len, int causal, int window, float scale,
                    cudaStream_t stream) {
  FwdMaps maps;
  if (!make_fwd_maps<DH>(maps, q, k, v, BH, S)) return (int)cudaErrorInvalidValue;
  return launch(SLOT_FWD, flash_fwd_bf16_kernel<DH>, (long long)BH * ((S + BR - 1) / BR),
                THREADS, FwdBf16Geom<DH>::BYTES, stream, maps, o, L, BH, S, seq_len, causal, window,
                scale);
}

}  // namespace
}  // namespace rbr_flash

// q, k, v, o: (BH, S, dh) bfloat16 contiguous and 16-byte aligned; L: (BH, S)
// float32. Keys j >= seq_len are masked (seq_len <= S); window < 0 means no
// window. Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int rbr_flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, __nv_bfloat16* o, float* L, int BH,
                                  int S, int dh, int seq_len, int causal, int window,
                                  float scale, int device, cudaStream_t stream) {
  using namespace rbr_flash;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (dh) {
    case 16:
      return launch_fwd_bf16<16>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    case 32:
      return launch_fwd_bf16<32>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    case 64:
      return launch_fwd_bf16<64>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    case 128:
      return launch_fwd_bf16<128>(q, k, v, o, L, BH, S, seq_len, causal, window, scale,
                                  stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Host nanoseconds to encode the three tensor maps of one launch, the mean of
// `reps` encodings of x as a (BH, S, dh) bf16 tensor; -1 if they fail. The
// cost the TMA route adds to each launch on the host.
extern "C" int rbr_flash_fwd_bf16_maps_ns(const __nv_bfloat16* x, int BH, int S, int dh,
                                          int reps) {
  using namespace rbr_flash;
  if (reps < 1) return -1;
  FwdMaps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    bool ok = false;
    switch (dh) {
      case 16: ok = make_fwd_maps<16>(maps, x, x, x, BH, S); break;
      case 32: ok = make_fwd_maps<32>(maps, x, x, x, BH, S); break;
      case 64: ok = make_fwd_maps<64>(maps, x, x, x, BH, S); break;
      case 128: ok = make_fwd_maps<128>(maps, x, x, x, BH, S); break;
    }
    if (!ok) return -1;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return (int)(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() / reps);
}
