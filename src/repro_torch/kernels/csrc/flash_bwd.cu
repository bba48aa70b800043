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
// What bounds them on the card: operations, barely. At the training shape
// (6 heads, S = 256, dh = 64, causal) B2 does 76 MFLOP and B3 101 MFLOP of
// float32 FMA on about 2 MB, 1.1-1.5 us at an H100 SXM's 67 TFLOP/s float32
// rate, with 24 blocks on 132 SMs: bound by launch and latency in practice.
//
// What the design does about it: the reference's two-kernel split, which
// keeps the backward free of atomics and therefore deterministic. B2 runs
// one block per (head, 64-row query tile) and loops over the live key
// tiles, accumulating its dQ tile in registers; B3 runs one block per
// (head, 64-column key tile) and loops over the live query tiles,
// accumulating dK and dV in registers. B3 computes the transposed scores
// S^T = K Q^T directly, so its softmax needs no reduction across threads.
// Intermediate p and dS tiles pass through shared memory between the two
// products of a step. Masked entries are selected to 0 before they meet an
// overflowing exp (fully-masked rows carry L = -1e30).

#include "flash_common.cuh"

namespace rbr_flash {
namespace {

template <int DH>
constexpr size_t dq_smem_bytes() {
  // Qt, dOt, Kt, Vt [DH][TLD]; Ks [TILE][DH + PAD]; dSt [TILE][TLD]
  return sizeof(float) * (4 * DH * TLD + TILE * row_ld<DH>() + TILE * TLD);
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  // Kt, Vt, Qt, dOt [DH][TLD]; Qs, dOs [TILE][DH + PAD]; Ps, dSs [TILE][TLD]; Ls, Ds [TILE]
  return sizeof(float) * (4 * DH * TLD + 2 * TILE * row_ld<DH>() + 2 * TILE * TLD + 2 * TILE);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ L, const float* __restrict__ D,
                    float* __restrict__ dq, int S, int causal, int window, float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* dOt = Qt + DH * TLD;
  float* Kt = dOt + DH * TLD;
  float* Vt = Kt + DH * TLD;
  float* Ks = Vt + DH * TLD;
  float* dSt = Ks + TILE * row_ld<DH>();  // dS transposed: dSt[j * TLD + r]

  const long long head = (long long)blockIdx.y * S * DH;
  q += head;
  k += head;
  v += head;
  dO += head;
  dq += head;
  L += (long long)blockIdx.y * S;
  D += (long long)blockIdx.y * S;
  const int q0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = ty * 4;

  load_t<DH>(q, q0, S, Qt);
  load_t<DH>(dO, q0, S, dOt);
  float Lr[4], Dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + r0 + i;
    Lr[i] = r < S ? L[r] : 0.f;
    Dr[i] = r < S ? D[r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  key_tiles(q0, S, causal, window, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_t<DH>(k, k0, S, Kt);
    load_t<DH>(v, k0, S, Vt);
    load_r<DH>(k, k0, S, Ks);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_fma<DH, 4>(s, Qt, TLD, r0, Kt, TLD, tx * 4);
    tile_fma<DH, 4>(dp, dOt, TLD, r0, Vt, TLD, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(q0 + r0 + i, k0 + tx * 4 + j, S, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - Lr[i]) : 0.f;
        dSt[(tx * 4 + j) * TLD + r0 + i] = p * (dp[i][j] - Dr[i]);
      }
    __syncthreads();
    tile_fma<TILE, NC>(acc, dSt, TLD, r0, Ks, row_ld<DH>(), tx * NC);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + r0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[(long long)r * DH + tx * NC + c] = acc[i][c] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ L, const float* __restrict__ D,
                     float* __restrict__ dk, float* __restrict__ dv, int S, int causal,
                     int window, float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;
  float* Vt = Kt + DH * TLD;
  float* Qt = Vt + DH * TLD;
  float* dOt = Qt + DH * TLD;
  float* Qs = dOt + DH * TLD;
  float* dOs = Qs + TILE * row_ld<DH>();
  float* Ps = dOs + TILE * row_ld<DH>();  // Ps[r * TLD + j]
  float* dSs = Ps + TILE * TLD;           // dSs[r * TLD + j]
  float* Ls = dSs + TILE * TLD;
  float* Ds = Ls + TILE;

  const long long head = (long long)blockIdx.y * S * DH;
  q += head;
  k += head;
  v += head;
  dO += head;
  dk += head;
  dv += head;
  L += (long long)blockIdx.y * S;
  D += (long long)blockIdx.y * S;
  const int k0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;  // score tile: query columns 4tx..; outputs: dh columns
  const int ty = threadIdx.x / 16;  // key rows 4ty..4ty+3
  const int j0 = ty * 4;

  load_t<DH>(k, k0, S, Kt);
  load_t<DH>(v, k0, S, Vt);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int lo, hi;
  query_tiles(k0, S, S, causal, window, lo, hi);
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_t<DH>(q, q0, S, Qt);
    load_t<DH>(dO, q0, S, dOt);
    load_r<DH>(q, q0, S, Qs);
    load_r<DH>(dO, q0, S, dOs);
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      Ls[r] = q0 + r < S ? L[q0 + r] : 0.f;
      Ds[r] = q0 + r < S ? D[q0 + r] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];  // transposed: [key row][query column]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_fma<DH, 4>(st, Kt, TLD, j0, Qt, TLD, tx * 4);
    tile_fma<DH, 4>(dpt, Vt, TLD, j0, dOt, TLD, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = tx * 4 + j;
        const bool ok = visible(q0 + rr, k0 + j0 + i, S, S, causal, window);
        const float p = ok ? expf(st[i][j] * scale - Ls[rr]) : 0.f;
        Ps[rr * TLD + j0 + i] = p;
        dSs[rr * TLD + j0 + i] = p * (dpt[i][j] - Ds[rr]);
      }
    __syncthreads();
    tile_fma<TILE, NC>(dv_acc, Ps, TLD, j0, dOs, row_ld<DH>(), tx * NC);
    tile_fma<TILE, NC>(dk_acc, dSs, TLD, j0, Qs, row_ld<DH>(), tx * NC);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = k0 + j0 + i;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[(long long)j * DH + tx * NC + c] = dk_acc[i][c] * scale;
      dv[(long long)j * DH + tx * NC + c] = dv_acc[i][c];
    }
  }
}

template <int DH>
int launch_dq(const float* q, const float* k, const float* v, const float* dO, const float* L,
              const float* D, float* dq, int BH, int S, int causal, int window, float scale,
              cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, BH);
  return launch(flash_bwd_dq_kernel<DH>, grid, dq_smem_bytes<DH>(), stream, q, k, v, dO, L, D,
                dq, S, causal, window, scale);
}

template <int DH>
int launch_dkv(const float* q, const float* k, const float* v, const float* dO, const float* L,
               const float* D, float* dk, float* dv, int BH, int S, int causal, int window,
               float scale, cudaStream_t stream) {
  const dim3 grid((S + TILE - 1) / TILE, BH);
  return launch(flash_bwd_dkv_kernel<DH>, grid, dkv_smem_bytes<DH>(), stream, q, k, v, dO, L,
                D, dk, dv, S, causal, window, scale);
}

}  // namespace
}  // namespace rbr_flash

// q, k, v, dO, dq: (BH, S, dh) float32 contiguous and 16-byte aligned;
// L, D: (BH, S). window < 0 means no window. Returns a CUDA error code.
extern "C" int rbr_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                    const float* dO, const float* L, const float* D, float* dq,
                                    int BH, int S, int dh, int causal, int window, float scale,
                                    int device, cudaStream_t stream) {
  using namespace rbr_flash;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (dh) {
    case 16: return launch_dq<16>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
    case 32: return launch_dq<32>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
    case 64: return launch_dq<64>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As above, writing dk and dv: (BH, S, dh).
extern "C" int rbr_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                     const float* dO, const float* L, const float* D, float* dk,
                                     float* dv, int BH, int S, int dh, int causal, int window,
                                     float scale, int device, cudaStream_t stream) {
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
    default: return (int)cudaErrorInvalidValue;
  }
}
