// Float32-accurate products on Hopper's tensor cores, shared by the rotation
// matmul (matmul.cu, B4), the flash forward (flash_fwd.cu, B1) and the flash
// backward (flash_bwd.cu, B2 and B3).
//
// The 3xTF32 split: a float32 x is written as big + small, where
// big = rna_tf32(x) keeps the top 11 significant bits and
// small = rna_tf32(x - big) the next 11 (x - big is exact in float32). Then
//     a * b ~= small_a * big_b + big_a * small_b + big_a * big_b,
// dropping small_a * small_b, which is below 2^-22 of the product. Each
// tf32 x tf32 product is exact in float32, but the tensor cores' addition into
// their float32 accumulator rounds more coarsely than an FFMA; one TF32 pass
// would keep about three decimal digits. The small terms go first so the big
// term is added last.
//
// Two ways to sum a chain of k8 products:
//   mma_3xtf32     accumulates in the tensor cores. The rotation matmul (B4)
//                  and the flash forward (B1) use it; both stay within their
//                  parity limits against float32 references.
//   mma_3xtf32_rn  sums each k8 product from zero and adds it to the running
//                  sum with a float32 add. The flash backward (B2, B3) uses
//                  it: its sums feed dP - D, which cancels, and accumulating
//                  in the tensor cores there doubled the error of the model's
//                  gradients at full width (chip_smoke.py's schedule check on
//                  an H100: 6.3e-6 against 2.75e-6 with this form, limit 1e-5)
//                  for 0.6 us (B2) and 1.0 us (B3) more per launch at the
//                  path shape. Its cost and gain in B1 and B4 are not
//                  measured.
//
// mma.sync.m16n8k8 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, k by n):      b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8):             c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rbr_tf32 {

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment and a B fragment, each as its big and small halves.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.big[i] = s.big;
    f.small[i] = s.small;
  }
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.big, s1.big}, {s0.small, s1.small}};
}

// c += a * b in 3xTF32, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// c += a * b as above, but the k8 product is summed from zero and added to c
// with a float32 add, rounded to nearest, for 4 adds per call (see the header).
__device__ __forceinline__ void mma_3xtf32_rn(float (&c)[4], const FragA& a, const FragB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(d, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// cp.async copies into shared memory; src_bytes < size zero-fills the rest
// (0 for a masked copy, which still needs a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace rbr_tf32
