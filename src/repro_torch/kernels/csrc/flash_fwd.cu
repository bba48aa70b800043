// Flash-attention forward (B1) for Hopper (sm_90a): causal or sliding-window
// attention with an online softmax, emitting O and the row logsumexp L.
//
// Replaces: repro/kernels/flash.py::_flash_fwd_kernel (Pallas, launched by
// `_flash_forward`). Per head and query row i:
//     s_ij = (q_i . k_j) * scale             over the visible keys j
//     O_i  = sum_j softmax(s_i)_j v_j,   L_i = max_j s_ij + log sum_j exp(s_ij - max)
// A row that sees no key gives O_i = 0 and L_i = -1e30, as in the reference.
//
// What bounds it on the card: bytes, on the tensor route. At the training
// shape (6 heads, S = 256, dh = 64, causal) a launch does 50 MFLOP on
// 1.6 MB. Both products run as 3xTF32 on the tensor cores (tf32_mma.cuh):
// 150 MFLOP of TF32 at 495 TFLOP/s is 0.30 us, below the 0.47 us the bytes
// take at 3.35 TB/s (float32 FMA would take 0.75 us). In practice a launch
// this small is bound by how much of the card it occupies and by the
// latency of its longest block.
//
// What the design does about it:
// - Blocks of 16 query rows (one m16 fragment) instead of 64: 96 blocks at
//   the training shape instead of 24. Blocks are numbered so that the late
//   query tiles, which see the most keys under the causal mask, start first.
// - The key range a tile can see is split across the block's 8 warps in
//   steps of 16 keys (warp w takes steps w, w + 8, ...), so the longest
//   tile's 256 keys take two steps per warp. Each warp streams its own K and
//   V steps through a private double buffer of cp.async copies (the next
//   step loads while this one is multiplied) and keeps its own running max
//   m, normaliser l and 16 x dh accumulator in registers. At the end the
//   warps merge through shared memory in warp order, so the result is
//   deterministic.
// - QK^T and PV on the tensor cores, mma.sync.m16n8k8 in 3xTF32, so the
//   scores stay within float32 roundoff of the FFMA scores that the
//   backward kernels (B2, B3) recompute against this kernel's L: one TF32
//   pass would put its L off theirs by ~1e-3 and the gradients with it.
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

constexpr int QT = 16;                     // query rows per block
constexpr int KT = 16;                     // keys per warp step
constexpr int FWD_WARPS = 8;
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr int LDP = KT + 4;                // P tile row stride: 20 = 4 * odd

template <int DH>
struct FwdGeom {
  static constexpr int LDK = DH + 4;  // Q and K rows: 4 * odd, conflict-free (g, t) reads
  static constexpr int LDV = DH + 8;  // V rows: 8 (mod 32) for DH 32 and 64, 24 for 16
  static constexpr int K_FLOATS = KT * LDK;
  static constexpr int V_FLOATS = KT * LDV;
  static constexpr int WARP_FLOATS = 2 * (K_FLOATS + V_FLOATS) + QT * LDP;
  static constexpr int Q_FLOATS = QT * LDK;
  // the merge reuses the warps' space: m, l and a QT x DH accumulator per warp
  static constexpr int MERGE_FLOATS = FWD_WARPS * (2 * QT + QT * DH);
  static_assert(MERGE_FLOATS <= FWD_WARPS * WARP_FLOATS, "merge fits the warp buffers");
  static constexpr size_t BYTES = sizeof(float) * (Q_FLOATS + FWD_WARPS * WARP_FLOATS);
};

template <int DH>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ L,
                 int BH, int S, int seq_len, int causal, int window, float scale) {
  using G = FwdGeom<DH>;
  constexpr int NF = DH / 8;  // n8 fragments of an output row block, k8 steps of QK^T
  extern __shared__ __align__(16) float smem[];

  const int ntiles = (S + QT - 1) / QT;
  const int bh = blockIdx.x % BH;
  const int q0 = (ntiles - 1 - (int)(blockIdx.x / BH)) * QT;  // late tiles first
  const long long head = (long long)bh * S * DH;
  q += head;
  k += head;
  v += head;
  o += head;
  L += (long long)bh * S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* Qs = smem;
  float* W = smem + G::Q_FLOATS + warp * G::WARP_FLOATS;
  float* Kb = W;                    // two K buffers
  float* Vb = W + 2 * G::K_FLOATS;  // two V buffers
  float* Ps = Vb + 2 * G::V_FLOATS;

  for (int idx = threadIdx.x; idx < QT * DH / 4; idx += FWD_THREADS) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    const bool ok = q0 + r < S;
    cp_async16(Qs + r * G::LDK + c, ok ? q + (long long)(q0 + r) * DH + c : q, ok ? 16 : 0);
  }
  cp_async_commit();

  // key steps [lo, hi) that can hold a visible key for these rows
  const int lo_col = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int hi_col = causal ? min(seq_len, q0 + QT) : seq_len;
  const int lo = lo_col / KT, hi = (hi_col + KT - 1) / KT;

  auto load_kv = [&](int buf, int step) {
    const int k0 = step * KT;
    for (int idx = lane; idx < KT * DH / 4; idx += 32) {
      const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
      const bool ok = k0 + r < S;
      const long long off = (long long)(k0 + r) * DH + c;
      cp_async16(Kb + buf * G::K_FLOATS + r * G::LDK + c, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(Vb + buf * G::V_FLOATS + r * G::LDV + c, ok ? v + off : v, ok ? 16 : 0);
    }
  };
  if (lo + warp < hi) load_kv(0, lo + warp);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's part of Q has landed
  __syncthreads();     // ... and everyone's

  FragA qf[NF];
#pragma unroll
  for (int kk = 0; kk < NF; ++kk) {
    const float* r0 = Qs + g * G::LDK + 8 * kk + t;
    const float* r1 = r0 + 8 * G::LDK;
    qf[kk] = split_a(r0[0], r1[0], r0[4], r1[4]);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int buf = 0;
  for (int step = lo + warp; step < hi; step += FWD_WARPS, buf ^= 1) {
    if (step + FWD_WARPS < hi) load_kv(buf ^ 1, step + FWD_WARPS);
    cp_async_commit();
    cp_async_wait<1>();  // this step's K and V have landed
    __syncwarp();
    const float* Kc = Kb + buf * G::K_FLOATS;
    const float* Vc = Vb + buf * G::V_FLOATS;
    const int k0 = step * KT;

    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        const float* kr = Kc + (8 * j + g) * G::LDK + 8 * kk + t;
        mma_3xtf32(s[j], qf[kk], split_b(kr[0], kr[4]));
      }
    }

    bool ok[KT / 8][4];
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
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
    for (int j = 0; j < KT / 8; ++j)
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
    for (int kk = 0; kk < KT / 8; ++kk) {
      const float* p0 = Ps + g * LDP + 8 * kk + t;
      const float* p1 = p0 + 8 * LDP;
      const FragA pa = split_a(p0[0], p1[0], p0[4], p1[4]);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const float* vr = Vc + (8 * kk + t) * G::LDV + 8 * j + g;
        mma_3xtf32(acc[j], pa, split_b(vr[0], vr[4 * G::LDV]));
      }
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
  float* Ms = smem + G::Q_FLOATS;
  float* Ls = Ms + FWD_WARPS * QT;
  float* As = Ls + FWD_WARPS * QT;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Ms[warp * QT + g + 8 * h] = m[h];
      Ls[warp * QT + g + 8 * h] = l[h];
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      As[(warp * QT + g + 8 * (e / 2)) * DH + 8 * j + 2 * t + e % 2] = acc[j][e];
  __syncthreads();

  for (int idx = threadIdx.x; idx < QT * DH; idx += FWD_THREADS) {
    const int r = idx / DH, c = idx % DH;
    if (q0 + r >= S) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < FWD_WARPS; ++w) mx = fmaxf(mx, Ms[w * QT + r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < FWD_WARPS; ++w) {  // in warp order: deterministic
      const float f = expf(Ms[w * QT + r] - mx);
      lsum += Ls[w * QT + r] * f;
      out += As[(w * QT + r) * DH + c] * f;
    }
    const bool live = lsum > 0.f;
    o[(long long)(q0 + r) * DH + c] = live ? out / fmaxf(lsum, EPS) : 0.f;
    if (c == 0) L[q0 + r] = live ? mx + logf(fmaxf(lsum, EPS)) : NEG_INF;
  }
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* L, int BH,
               int S, int seq_len, int causal, int window, float scale, cudaStream_t stream) {
  const size_t bytes = FwdGeom<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + QT - 1) / QT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<DH><<<(unsigned)blocks, FWD_THREADS, bytes, stream>>>(
      q, k, v, o, L, BH, S, seq_len, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rbr_flash

// q, k, v, o: (BH, S, dh) float32 contiguous and 16-byte aligned; L: (BH, S).
// Keys j >= seq_len are masked (seq_len <= S); window < 0 means no window.
// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int rbr_flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                                 float* L, int BH, int S, int dh, int seq_len, int causal,
                                 int window, float scale, int device, cudaStream_t stream) {
  using namespace rbr_flash;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (dh) {
    case 16: return launch_fwd<16>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    case 32: return launch_fwd<32>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    case 64: return launch_fwd<64>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
