// Fused rotated-Adam scale for Hopper (sm_90a):
//     v'   = b2 * v + (1 - b2) * g * g
//     step = (m / bc1) / (sqrt(v' / bc2) + eps)
// over float32 arrays, writing (step, v').
//
// Replaces: repro/kernels/adam_step.py::_adam_kernel (Pallas, launched by
// `fused_adam_scale`), called once per rotated weight matrix per step on the
// eigenbasis gradient g, momentum m and second moment v.
//
// What bounds it on the card: bytes. It reads g, m, v and writes step and v',
// 20 bytes per element for about ten flops, far below the ridge point, so the
// floor is 20 bytes per element over the 3.35 TB/s of an H100 SXM's memory.
//
// What the design does about it: one pass, each element read and written
// once, with 16-byte vector loads and stores when every pointer is 16-byte
// aligned and the length is a multiple of four, and a grid-stride loop sized
// to the SM count. The scalars arrive by value, so one build serves every
// step and nothing is read back to the host. The arithmetic keeps the
// reference's order and sqrt-then-add-eps (not rsqrt), with IEEE division
// and square root, and the products and sums use round-to-nearest
// intrinsics so the compiler cannot contract them into FMAs: the result is
// the reference expression rounded step by step in float32.
// At the paper's 384x384 leaves a launch moves 2.9 MB, so launch overhead is
// a large share of its time; grouping leaves into one launch is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Scalars {
  float b2, omb2, eps, bc1, bc2;
};

__device__ __forceinline__ void adam_one(float g, float m, float v, const Scalars& s,
                                         float* step, float* v_new) {
  const float vn = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  *v_new = vn;
  *step = (m / s.bc1) / (sqrtf(vn / s.bc2) + s.eps);
}

__global__ void __launch_bounds__(THREADS)
adam_scale_vec4(const float4* __restrict__ g, const float4* __restrict__ m,
                const float4* __restrict__ v, float4* __restrict__ step,
                float4* __restrict__ v_out, long long n4, Scalars s) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 gg = g[i], mm = m[i], vv = v[i];
    float4 st, vn;
    adam_one(gg.x, mm.x, vv.x, s, &st.x, &vn.x);
    adam_one(gg.y, mm.y, vv.y, s, &st.y, &vn.y);
    adam_one(gg.z, mm.z, vv.z, s, &st.z, &vn.z);
    adam_one(gg.w, mm.w, vv.w, s, &st.w, &vn.w);
    step[i] = st;
    v_out[i] = vn;
  }
}

__global__ void __launch_bounds__(THREADS)
adam_scale_scalar(const float* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ v, float* __restrict__ step,
                  float* __restrict__ v_out, long long n, Scalars s) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    adam_one(g[i], m[i], v[i], s, &step[i], &v_out[i]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// (step, v_out) from (g, m, v), n float32 elements each. (1 - b2) is formed
// in float32 here, as the reference kernel forms it from its float32 scalar
// operand. Launches on `stream` and returns cudaGetLastError().
extern "C" int rbr_adam_scale_f32(const float* g, const float* m, const float* v,
                                  float* step, float* v_out, long long n,
                                  float b2, float eps, float bc1, float bc2,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const Scalars s{b2, 1.0f - b2, eps, bc1, bc2};
  const bool vec = n % 4 == 0 && aligned16(g) && aligned16(m) && aligned16(v) &&
                   aligned16(step) && aligned16(v_out);
  const long long work = vec ? n / 4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long max_blocks = 8LL * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  if (vec)
    adam_scale_vec4<<<(unsigned)blocks, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(m),
        reinterpret_cast<const float4*>(v), reinterpret_cast<float4*>(step),
        reinterpret_cast<float4*>(v_out), work, s);
  else
    adam_scale_scalar<<<(unsigned)blocks, THREADS, 0, stream>>>(g, m, v, step, v_out, n, s);
  return (int)cudaGetLastError();
}
