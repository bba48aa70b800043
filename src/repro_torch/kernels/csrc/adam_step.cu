// Fused rotated-Adam scale for Hopper (sm_90a), over a group of leaves:
//     v'   = b2 * v + (1 - b2) * g * g
//     step = (m / bc1) / (sqrt(v' / bc2) + eps)
// over float32 arrays, writing (step, v') for every leaf in one launch.
//
// Replaces: repro/kernels/adam_step.py:28 `_adam_kernel` (Pallas, launched by
// `fused_adam_scale` at repro/kernels/adam_step.py:47), called once per
// rotated weight matrix per step on the eigenbasis gradient g, momentum m
// and second moment v. Here one launch covers every rotated leaf of a step:
// 192 leaves (56.6 M elements) on the paper_95m sim path, 6 stacked leaves
// of the same size on the SPMD path.
//
// What bounds it on the card: bytes. It reads g, m, v and writes step and v',
// 20 bytes per element for about ten flops, far below the ridge point, so the
// floor is 20 bytes per element over the 3.35 TB/s of an H100 SXM's memory:
// 0.338 ms per step at paper_95m on either path.
//
// What the design does about that bound:
// - One launch per step. The wrapper passes a table of leaves (five
//   pointers, the element count, a 16-byte-load flag) and the prefix sum of
//   their chunks by value as a __grid_constant__ parameter (15 KB for 256
//   leaves; CUDA 12.1+), so nothing is copied to the card and nothing
//   synchronises. Block x finds its leaf by binary search over the prefix
//   sum. A leaf with no elements has no chunk.
// - Enough blocks and bytes in flight to keep HBM busy for the whole step.
//   The wrapper picks the chunk (1,024 to 8,192 elements, the largest that
//   still gives about a thousand blocks), so the step's 56.6 M elements make
//   6,912 blocks and the ramp-up and tail are a small part of the launch;
//   a leaf alone still spreads over the SMs. Each thread issues the 16-byte
//   loads of UNROLL float4 of g, m and v (12 loads, 192 bytes) before any
//   arithmetic. Each input is read exactly once, so the loads are streaming
//   (ld.global.cs, evict first); step (read next by the back rotation) and
//   v' (read at the next step) are stored normally.
// - Offsets inside a leaf are 64-bit: a stacked SPMD leaf holds 18.9 M
//   elements and a step's buffers pass 2^31 bytes.
// - A leaf whose pointers are not all 16-byte aligned, or whose length is
//   not a multiple of four, takes a scalar loop inside the same launch.
// - The arithmetic keeps the reference's order and sqrt-then-add-eps (not
//   rsqrt), with IEEE division and square root, and the products and sums
//   use round-to-nearest intrinsics so the compiler cannot contract them
//   into FMAs: the result is the reference expression rounded step by step
//   in float32, element by element, whatever group a leaf runs in.
// - One block per chunk. A persistent grid (as many blocks as fit on the
//   card, each walking the chunks) measured 4-5% slower at a step's leaves.
// - v_out may be v itself: the optimizer's in-place update writes v' over
//   v, with no second copy of the second moments. That is safe because
//   each element of v is read and then written by the same thread and by
//   no other: block x owns chunk x alone, thread t of it owns the elements
//   (or float4s) t, t + THREADS, ..., each of those threads loads v[i]
//   before it stores v_out[i] at the same i (vec_chunk loads all UNROLL
//   float4s before any store), and nothing reads v again after the store.
//   The step output must not alias any input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // adam_step.py's THREADS
constexpr int UNROLL = 4;         // float4 of each operand a thread loads before computing
constexpr int MAX_LEAVES = 256;   // adam_step.py's MAX_LEAVES

struct Scalars {
  float b2, omb2, eps, bc1, bc2;
};

struct Leaf {
  const float* g;
  const float* m;
  const float* v;
  float* step;
  float* v_out;
  long long n;  // elements
  int vec;      // 1: all five pointers 16-byte aligned and n % 4 == 0
};

struct Group {
  Scalars s;
  int count;
  int chunk;                         // elements per chunk, a multiple of 4 * THREADS
  int chunk_start[MAX_LEAVES + 1];   // chunks of leaves < i
  Leaf leaf[MAX_LEAVES];
};

__device__ __forceinline__ void adam_one(float g, float m, float v, const Scalars& s,
                                         float* step, float* v_new) {
  const float vn = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  *v_new = vn;
  *step = (m / s.bc1) / (sqrtf(vn / s.bc2) + s.eps);
}

// float4 i0 <= i < i1 of a leaf whose flag is set
__device__ __forceinline__ void vec_chunk(const Leaf& L, long long i0, long long i1,
                                          const Scalars& s) {
  const float4* g = reinterpret_cast<const float4*>(L.g);
  const float4* m = reinterpret_cast<const float4*>(L.m);
  const float4* v = reinterpret_cast<const float4*>(L.v);
  float4* step = reinterpret_cast<float4*>(L.step);
  float4* v_out = reinterpret_cast<float4*>(L.v_out);
  for (long long base = i0 + threadIdx.x; base < i1; base += (long long)UNROLL * THREADS) {
    float4 gg[UNROLL], mm[UNROLL], vv[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + j * THREADS;
      if (i < i1) {
        gg[j] = __ldcs(g + i);
        mm[j] = __ldcs(m + i);
        vv[j] = __ldcs(v + i);
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + j * THREADS;
      if (i < i1) {
        float4 st, vn;
        adam_one(gg[j].x, mm[j].x, vv[j].x, s, &st.x, &vn.x);
        adam_one(gg[j].y, mm[j].y, vv[j].y, s, &st.y, &vn.y);
        adam_one(gg[j].z, mm[j].z, vv[j].z, s, &st.z, &vn.z);
        adam_one(gg[j].w, mm[j].w, vv[j].w, s, &st.w, &vn.w);
        step[i] = st;
        v_out[i] = vn;
      }
    }
  }
}

// elements i0 <= i < i1 of a leaf whose flag is clear
__device__ __forceinline__ void scalar_chunk(const Leaf& L, long long i0, long long i1,
                                             const Scalars& s) {
  for (long long i = i0 + threadIdx.x; i < i1; i += THREADS)
    adam_one(__ldcs(L.g + i), __ldcs(L.m + i), __ldcs(L.v + i), s, &L.step[i], &L.v_out[i]);
}

// One chunk per block: block x takes chunk x.
__global__ void __launch_bounds__(THREADS)
adam_scale_grouped_kernel(const __grid_constant__ Group grp) {
  const int c = blockIdx.x;
  // the leaf that holds chunk c: chunk_start[lo] <= c < chunk_start[lo + 1]
  int lo = 0, hi = grp.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (grp.chunk_start[mid] <= c) lo = mid;
    else hi = mid;
  }
  const Leaf& L = grp.leaf[lo];
  const long long begin = (long long)(c - grp.chunk_start[lo]) * grp.chunk;
  const long long end = begin + grp.chunk < L.n ? begin + grp.chunk : L.n;
  if (L.vec) vec_chunk(L, begin / 4, end / 4, grp.s);
  else scalar_chunk(L, begin, end, grp.s);
}

}  // namespace

// (step_i, v_out_i) from (g_i, m_i, v_i) for `count` <= MAX_LEAVES leaves in
// one launch. ptrs: int64 (count, 5) g, m, v, step, v_out addresses (v_out
// may equal v; see the header); n:
// int64 (count) elements; vec: int32 (count) 16-byte-load flags;
// chunk_start: int32 (count + 1) prefix sum of each leaf's chunks of `chunk`
// elements. All four tables are host memory, read before the launch.
// (1 - b2) is formed in float32 here, as the reference kernel forms it from
// its float32 scalar operand. Launches one block per chunk on `stream`
// (nothing when there is no chunk) and returns cudaGetLastError().
extern "C" int rbr_adam_scale_grouped_f32(const long long* ptrs, const long long* n,
                                          const int* vec, const int* chunk_start, int count,
                                          int chunk, float b2, float eps, float bc1, float bc2,
                                          int device, cudaStream_t stream) {
  if (count < 1 || count > MAX_LEAVES || chunk < 4 * THREADS || chunk % (4 * THREADS) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Group grp{};
  grp.s = Scalars{b2, 1.0f - b2, eps, bc1, bc2};
  grp.count = count;
  grp.chunk = chunk;
  for (int i = 0; i <= count; ++i) grp.chunk_start[i] = chunk_start[i];
  for (int i = 0; i < count; ++i) {
    Leaf& L = grp.leaf[i];
    L.g = reinterpret_cast<const float*>(ptrs[5 * i + 0]);
    L.m = reinterpret_cast<const float*>(ptrs[5 * i + 1]);
    L.v = reinterpret_cast<const float*>(ptrs[5 * i + 2]);
    L.step = reinterpret_cast<float*>(ptrs[5 * i + 3]);
    L.v_out = reinterpret_cast<float*>(ptrs[5 * i + 4]);
    L.n = n[i];
    L.vec = vec[i];
  }
  const int blocks = chunk_start[count];
  if (blocks < 1) return 0;
  adam_scale_grouped_kernel<<<blocks, THREADS, 0, stream>>>(grp);
  return (int)cudaGetLastError();
}
