// Flash-attention forward (B1) for Hopper (sm_90a): causal or sliding-window
// attention with an online softmax, emitting O and the row logsumexp L.
//
// Replaces: repro/kernels/flash.py::_flash_fwd_kernel (Pallas, launched by
// `_flash_forward`). Per head and query row i:
//     s_ij = (q_i . k_j) * scale             over the visible keys j
//     O_i  = sum_j softmax(s_i)_j v_j,   L_i = max_j s_ij + log sum_j exp(s_ij - max)
// A row that sees no key gives O_i = 0 and L_i = -1e30, as in the reference.
//
// What bounds it on the card: operations, barely. At the training shape
// (6 heads, S = 256, dh = 64, causal) a launch does 50 MFLOP of float32 FMA
// on 1.6 MB, 0.75 us at an H100 SXM's 67 TFLOP/s float32 rate, with 24
// blocks on 132 SMs: in practice it is bound by launch and latency, not by
// either rate.
//
// What the design does about it: one block per (head, 64-row query tile);
// the TPU kernel's sequential K grid axis becomes a loop inside the block
// over only the key tiles that the causal mask and the window leave alive.
// Q stays in shared memory for the whole loop, K and V tiles pass through
// it, and each thread keeps the running max m, the normaliser l and its
// 4 x dh/16 slice of the accumulator in registers. The score and P.V
// products are register-blocked 4 x 4 FFMA micro-tiles over shared memory.
// The ragged end of S is masked in the kernel instead of padded, masked
// scores never reach exp (select, not multiply by a 0/1 mask), and nothing
// is atomic, so the result is deterministic.

#include "flash_common.cuh"

namespace rbr_flash {
namespace {

template <int DH>
constexpr size_t fwd_smem_bytes() {
  // Qt, Kt [DH][TLD]; Vs [TILE][DH + PAD]; Pt [TILE][TLD]
  return sizeof(float) * (2 * DH * TLD + TILE * row_ld<DH>() + TILE * TLD);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ L,
                 int S, int seq_len, int causal, int window, float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + DH * TLD;
  float* Vs = Kt + DH * TLD;
  float* Pt = Vs + TILE * row_ld<DH>();  // P transposed: Pt[j * TLD + r]

  const long long head = (long long)blockIdx.y * S * DH;
  q += head;
  k += head;
  v += head;
  o += head;
  L += (long long)blockIdx.y * S;
  const int q0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = ty * 4;

  load_t<DH>(q, q0, S, Qt);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  key_tiles(q0, seq_len, causal, window, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers of Kt, Vs and Pt are done
    load_t<DH>(k, k0, S, Kt);
    load_r<DH>(v, k0, S, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_fma<DH, 4>(s, Qt, TLD, r0, Kt, TLD, tx * 4);

    bool ok[4][4];
    float mt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mt[i] = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[i][j] = visible(q0 + r0 + i, k0 + tx * 4 + j, S, seq_len, causal, window);
        s[i][j] = ok[i][j] ? s[i][j] * scale : NEG_INF;
        mt[i] = fmaxf(mt[i], s[i][j]);
      }
      mt[i] = row_max16(mt[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mt[i]);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[i][j] ? expf(s[i][j] - m_new) : 0.f;
        Pt[(tx * 4 + j) * TLD + r0 + i] = p;
        ps += p;
      }
      ps = row_sum16(ps);
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
    tile_fma<TILE, NC>(acc, Pt, TLD, r0, Vs, row_ld<DH>(), tx * NC);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + r0 + i;
    if (r >= S) continue;
    const bool live = l[i] > 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[(long long)r * DH + tx * NC + c] = live ? acc[i][c] / fmaxf(l[i], EPS) : 0.f;
    if (tx == 0) L[r] = live ? m[i] + logf(fmaxf(l[i], EPS)) : NEG_INF;
  }
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* L, int BH,
               int S, int seq_len, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, BH);
  return launch(flash_fwd_kernel<DH>, grid, fwd_smem_bytes<DH>(), stream, q, k, v, o, L, S,
                seq_len, causal, window, scale);
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
