// Batched float32 matrix product C[b] = op(A[b]) * op(B[b]) for Hopper (sm_90a).
//
// Replaces: repro/kernels/matmul.py::_matmul_kernel (Pallas, launched by
// `matmul`), the basis-rotation hot spot. On the training path every rotated
// weight matrix takes six of these per step: U^T G V and U^T M V rotate the
// gradient and the momentum into the eigenbasis, U S V^T rotates the step back.
//
// What bounds it on the card: operations. The products are exact float32 with
// float32 accumulation (the reference accumulates in exact f32, and the
// rotation parity tolerance is rtol 2e-3 / atol 1e-4), so they run on the FMA
// pipes, not the tensor cores: 67 TFLOP/s on an H100 SXM. A 384^3 product
// reads 1.8 MB and does 113 MFLOP, about 64 FLOP per byte, well above the
// float32 ridge of about 20.
//
// What the design does about it: a shared-memory tiled SGEMM. Each block of
// 256 threads owns a 64x64 tile of C and walks K in steps of 16; each thread
// keeps a 4x4 micro-tile of C in registers and reads its operands from shared
// memory as float4, so each k step costs two shared loads per 16 FMAs. Every
// output element is one FMA chain over k in order, with no TF32 anywhere.
// The transposes that the rotations need (U^T X and X V^T) are template flags
// that change only how a tile is loaded, so no transposed copy is made; the
// loads are coalesced along whichever index is contiguous in memory. The
// ragged edge is masked in the loads (zeros) and the stores, not padded.
// The batch index is blockIdx.z, for stage-stacked (batch, m, n) leaves.
// Later work: TF32x3 or wgmma designs, and grouping a step's products into
// one launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps float4 rows aligned and spreads the stores over banks

// A is (M, K) row-major, or (K, M) when TA; B is (K, N), or (N, K) when TB.
template <bool TA, bool TB>
__global__ void __launch_bounds__(THREADS)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K) {
  const long long b = blockIdx.z;
  A += b * (long long)M * K;
  B += b * (long long)K * N;
  C += b * (long long)M * N;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15: column group
  const int ty = tid / (BN / TN);  // 0..15: row group

  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      int m, k;
      if (TA) {  // stored (K, M): m is contiguous
        k = idx / BM;
        m = idx % BM;
      } else {  // stored (M, K): k is contiguous
        m = idx / BK;
        k = idx % BK;
      }
      const int gm = row0 + m;
      const int gk = k0 + k;
      float val = 0.0f;
      if (gm < M && gk < K)
        val = TA ? A[(long long)gk * M + gm] : A[(long long)gm * K + gk];
      As[k][m] = val;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      int k, n;
      if (TB) {  // stored (N, K): k is contiguous
        n = idx / BK;
        k = idx % BK;
      } else {  // stored (K, N): n is contiguous
        k = idx / BN;
        n = idx % BN;
      }
      const int gk = k0 + k;
      const int gn = col0 + n;
      float val = 0.0f;
      if (gk < K && gn < N)
        val = TB ? B[(long long)gn * K + gk] : B[(long long)gk * N + gn];
      Bs[k][n] = val;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < N) C[(long long)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// C[b] (M, N) = op(A[b]) (M, K) * op(B[b]) (K, N) for b < batch, all float32,
// each operand contiguous per batch entry. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int rbr_matmul_f32(const float* A, const float* B, float* C,
                              int batch, int M, int N, int K,
                              int trans_a, int trans_b, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const dim3 block(THREADS);
  if (trans_a && trans_b)
    sgemm_kernel<true, true><<<grid, block, 0, stream>>>(A, B, C, M, N, K);
  else if (trans_a)
    sgemm_kernel<true, false><<<grid, block, 0, stream>>>(A, B, C, M, N, K);
  else if (trans_b)
    sgemm_kernel<false, true><<<grid, block, 0, stream>>>(A, B, C, M, N, K);
  else
    sgemm_kernel<false, false><<<grid, block, 0, stream>>>(A, B, C, M, N, K);
  return (int)cudaGetLastError();
}
