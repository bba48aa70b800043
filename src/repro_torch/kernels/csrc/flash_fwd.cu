// Flash-attention forward (B1) on float32 inputs on mma.sync, at head widths
// 16 and 32: causal or sliding-window attention with an online softmax,
// emitting O and the row logsumexp L. The float32 entry point
// (rbr_flash_fwd_f32, flash_fwd_f32.cu) runs its wgmma kernel at head widths
// 64 and 128 and this one at 16 and 32 (launch_fwd_mma); bf16 inputs take
// flash_fwd_bf16.cu.
//
// Replaces: repro/kernels/flash.py::_flash_fwd_kernel (Pallas, launched by
// `_flash_forward`). Per head and query row i:
//     s_ij = (q_i . k_j) * scale             over the visible keys j
//     O_i  = sum_j softmax(s_i)_j v_j,   L_i = max_j s_ij + log sum_j exp(s_ij - max)
// A row that sees no key gives O_i = 0 and L_i = -1e30, as in the reference.
//
// What bounds it on the card: bytes, on the tensor route. At head width 32
// (the smoke configurations') both products run as 3xTF32 on the tensor
// cores (tf32_mma.cuh) and a launch this small is bound by how much of the
// card it occupies and by the latency of its longest block.
//
// What the design does about it:
// - Blocks of 16 query rows (one m16 fragment) instead of 64, four times the
//   blocks. Blocks are numbered so that the late query tiles, which see the
//   most keys under the causal mask, start first.
// - The key range a tile can see is split across the block's 8 warps in
//   steps of 16 keys (warp w takes steps w, w + 8, ...), so the longest
//   tile's 256 keys take two steps per warp. Each warp streams its own K and
//   V steps through a private double buffer of cp.async copies (the next
//   step loads while this one is multiplied) and keeps its own running max
//   m, normaliser l and 16 x dh accumulator in registers. At the end the
//   warps merge through shared memory in warp order, so the result is
//   deterministic.
// - QK^T and PV on the tensor cores, mma.sync.m16n8k8 in 3xTF32, so the
//   scores stay within float32 roundoff of the scores that the backward
//   kernels (B2, B3) recompute, also in 3xTF32, against this kernel's L: one
//   TF32 pass would put its L off theirs by ~1e-3 and the gradients with it.
//   Q's fragments are split once and stay in registers; P goes from the
//   score fragments to the PV operand through a small per-warp tile in
//   shared memory. Padded rows keep every fragment read free of bank
//   conflicts.
// - The ragged end of S and keys past seq_len are masked in the kernel;
//   masked scores are selected away before exp, never multiplied by a mask;
//   nothing is atomic.

#include "flash_common.cuh"
#include "tf32_mma.cuh"

namespace rbr_flash {
namespace {

using namespace rbr_tf32;

template <int DH>
struct FwdGeom {
  static_assert(DH <= 32, "head widths 64 and 128 run on wgmma (flash_fwd_f32.cu)");
  static constexpr int WARPS = MMA_WARPS;
  static constexpr int THREADS = 32 * WARPS;
  // Q and K rows: 4 * odd floats; conflict-free fragment reads
  static constexpr int LDK = DH + 4;
  // V rows: 8 (mod 32) floats for DH 32, 24 for 16
  static constexpr int LDV = DH + 8;
  static constexpr int K_ELEMS = STEP * LDK;
  static constexpr int V_ELEMS = STEP * LDV;
  static constexpr int Q_BYTES = (int)sizeof(float) * ROWS * LDK;
  static constexpr int WARP_BYTES =
      (int)sizeof(float) * 2 * (K_ELEMS + V_ELEMS) + (int)sizeof(float) * ROWS * LDP;
  static_assert(Q_BYTES % 16 == 0 && WARP_BYTES % 16 == 0, "16-byte aligned regions");
  // the merge reuses the warps' space: m, l and a ROWS x DH accumulator per warp
  static constexpr int MERGE_FLOATS = WARPS * (2 * ROWS + ROWS * DH);
  static_assert((int)sizeof(float) * MERGE_FLOATS <= WARPS * WARP_BYTES,
                "merge fits the warp buffers");
  static constexpr size_t BYTES = Q_BYTES + WARPS * WARP_BYTES;
};

// Q's A fragments, held in registers for the whole block, split once into
// TF32 halves.
template <int DH>
struct QFrag32 {
  FragA f[DH / 8];
};

template <int DH>
__device__ __forceinline__ void load_q(QFrag32<DH>& qf, const float* Qs, int g, int t) {
  constexpr int LDK = FwdGeom<DH>::LDK;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const float* r0 = Qs + g * LDK + 8 * kk + t;
    const float* r1 = r0 + 8 * LDK;
    qf.f[kk] = split_a(r0[0], r1[0], r0[4], r1[4]);
  }
}

// s += Q K^T for the step's keys 8j .. 8j + 7, over all of dh.
template <int DH>
__device__ __forceinline__ void scores(float (&s)[4], const QFrag32<DH>& qf, const float* Kc,
                                       int j, int g, int t) {
  constexpr int LDK = FwdGeom<DH>::LDK;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const float* kr = Kc + (8 * j + g) * LDK + 8 * kk + t;
    mma_3xtf32(s, qf.f[kk], split_b(kr[0], kr[4]));
  }
}

// acc[j] += P V over the step's keys 8kk .. 8kk + 7, for every n8 fragment j of dh.
template <int DH>
__device__ __forceinline__ void pv_step(float (&acc)[DH / 8][4], const FragA& pa,
                                        const float* Vc, int kk, int g, int t) {
  constexpr int LDV = FwdGeom<DH>::LDV;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const float* vr = Vc + (8 * kk + t) * LDV + 8 * j + g;
    mma_3xtf32(acc[j], pa, split_b(vr[0], vr[4 * LDV]));
  }
}

template <int DH>
__global__ void __launch_bounds__(FwdGeom<DH>::THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ L,
                 int BH, int S, int seq_len, int causal, int window, float scale) {
  using G = FwdGeom<DH>;
  constexpr int NF = DH / 8;  // n8 fragments of an output row block
  constexpr int WARPS = G::WARPS, THREADS = G::THREADS;
  constexpr int CH = CHUNK<float>;
  extern __shared__ __align__(16) float smem[];

  const int ntiles = (S + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % BH;
  const int q0 = (ntiles - 1 - (int)(blockIdx.x / BH)) * ROWS;  // late tiles first
  const long long head = (long long)bh * S * DH;
  q += head;
  k += head;
  v += head;
  o += head;
  L += (long long)bh * S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  float* Qs = reinterpret_cast<float*>(base);
  unsigned char* W = base + G::Q_BYTES + warp * G::WARP_BYTES;
  float* Kb = reinterpret_cast<float*>(W);              // two K buffers
  float* Vb = Kb + 2 * G::K_ELEMS;                      // two V buffers
  float* Ps = reinterpret_cast<float*>(Vb + 2 * G::V_ELEMS);

  for (int idx = threadIdx.x; idx < ROWS * DH / CH; idx += THREADS) {
    const int r = idx / (DH / CH), c = (idx % (DH / CH)) * CH;
    const bool ok = q0 + r < S;
    cp_async16(Qs + r * G::LDK + c, ok ? q + (long long)(q0 + r) * DH + c : q, ok ? 16 : 0);
  }
  cp_async_commit();

  int lo, hi;
  key_steps(q0, seq_len, causal, window, lo, hi);

  auto load_kv = [&](int buf, int step) {
    const int k0 = step * STEP;
    for (int idx = lane; idx < STEP * DH / CH; idx += 32) {
      const int r = idx / (DH / CH), c = (idx % (DH / CH)) * CH;
      const bool ok = k0 + r < S;
      const long long off = (long long)(k0 + r) * DH + c;
      cp_async16(Kb + buf * G::K_ELEMS + r * G::LDK + c, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(Vb + buf * G::V_ELEMS + r * G::LDV + c, ok ? v + off : v, ok ? 16 : 0);
    }
  };
  if (lo + warp < hi) load_kv(0, lo + warp);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's part of Q has landed
  __syncthreads();     // ... and everyone's

  QFrag32<DH> qf;
  load_q<DH>(qf, Qs, g, t);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NF][4];
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
    const float* Kc = Kb + buf * G::K_ELEMS;
    const float* Vc = Vb + buf * G::V_ELEMS;
    const int k0 = step * STEP;

    float s[STEP / 8][4];
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      scores<DH>(s[j], qf, Kc, j, g, t);
    }

    bool ok[STEP / 8][4];
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        ok[j][e] = visible(q0 + g + 8 * h, k0 + 8 * j + 2 * t + e % 2, S, seq_len, causal,
                           window);
        s[j][e] = ok[j][e] ? s[j][e] * scale : NEG_INF;
        mt[h] = fmaxf(mt[h], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four lanes of a quad share rows g and g + 8
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float p = ok[j][e] ? expf(s[j][e] - m[h]) : 0.f;
        Ps[(g + 8 * h) * LDP + 8 * j + 2 * t + e % 2] = p;
        ps[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];  // this lane's columns
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e / 2];
    __syncwarp();

#pragma unroll
    for (int kk = 0; kk < STEP / 8; ++kk) {
      const float* p0 = Ps + g * LDP + 8 * kk + t;
      const float* p1 = p0 + 8 * LDP;
      pv_step<DH>(acc, split_a(p0[0], p1[0], p0[4], p1[4]), Vc, kk, g, t);
    }
    __syncwarp();  // P and this buffer are read before they are written again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its buffers: reuse them for the merge
  float* Ms = reinterpret_cast<float*>(base + G::Q_BYTES);
  float* Ls = Ms + WARPS * ROWS;
  float* As = Ls + WARPS * ROWS;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Ms[warp * ROWS + g + 8 * h] = m[h];
      Ls[warp * ROWS + g + 8 * h] = l[h];
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      As[(warp * ROWS + g + 8 * (e / 2)) * DH + 8 * j + 2 * t + e % 2] = acc[j][e];
  __syncthreads();

  for (int idx = threadIdx.x; idx < ROWS * DH; idx += THREADS) {
    const int r = idx / DH, c = idx % DH;
    if (q0 + r >= S) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, Ms[w * ROWS + r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {  // in warp order: deterministic
      const float f = expf(Ms[w * ROWS + r] - mx);
      lsum += Ls[w * ROWS + r] * f;
      out += As[(w * ROWS + r) * DH + c] * f;
    }
    const bool live = lsum > 0.f;
    o[(long long)(q0 + r) * DH + c] = live ? out / fmaxf(lsum, EPS) : 0.f;
    if (c == 0) L[q0 + r] = live ? mx + logf(fmaxf(lsum, EPS)) : NEG_INF;
  }
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* L, int BH, int S,
               int seq_len, int causal, int window, float scale, cudaStream_t stream) {
  using G = FwdGeom<DH>;
  return launch(SLOT_FWD, flash_fwd_kernel<DH>, (long long)BH * ((S + ROWS - 1) / ROWS),
                G::THREADS, G::BYTES, stream, q, k, v, o, L, BH, S, seq_len, causal, window,
                scale);
}

}  // namespace
}  // namespace rbr_flash

int rbr_flash_blocks[3] = {0, 0, 0};  // declared in flash_common.cuh

namespace rbr_flash {

int launch_fwd_mma(const float* q, const float* k, const float* v, float* o, float* L, int BH,
                   int S, int dh, int seq_len, int causal, int window, float scale,
                   cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_fwd<16>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    case 32: return launch_fwd<32>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rbr_flash
