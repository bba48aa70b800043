// Hopper's asynchronous pieces for the bf16 flash kernels (flash_fwd_bf16.cu:
// B1, flash_bwd_bf16.cu: B2 and B3): shared-memory tiles in the layout
// wgmma's descriptors name, filled by TMA from tensor maps encoded on the
// host, mbarriers, and wgmma.mma_async on bf16 operands with float32
// accumulators (sm_90a).
//
// Tiles. A tile holds 64 rows of a (S, DH) bf16 head, row-major, as DH / PW
// panels of PW = min(DH, 64) columns: panel p holds columns [p PW, (p + 1) PW)
// of all 64 rows, rows RB = 2 PW bytes long (128, 64 or 32 bytes). TMA
// writes each panel as one box (64 rows by PW columns) with the 128-, 64- or
// 32-byte swizzle: within a panel the 16-byte chunks of row r are permuted
// by an XOR with ((r RB) >> 7) & (RB / 16 - 1), the layout that wgmma's
// descriptors name with modes 1, 2 and 3, so that neither the copies nor
// wgmma's reads meet bank conflicts. Rows past the end of S are zero-filled
// by TMA. A tile starts on a 1024-byte boundary. One tile serves both
// orientations:
// - K-major (desc_k): the tile's rows are M or N and its columns the
//   contraction, as Q and K in S = Q K^T. A k16 step advances 32 bytes
//   within a panel row (the swizzle is applied to the resulting address);
//   8-row groups are SBO = 8 RB apart.
// - MN-major (desc_mn, the transpose bit): its columns are N and its rows
//   the contraction, as K in dQ = dS K. A k16 step is 16 rows further
//   (whole swizzle atoms); 8-row groups are SBO = 8 RB apart and panels
//   LBO = 64 RB apart.
//
// wgmma fragments (warp w of the warpgroup holds rows 16 w to 16 w + 15;
// lane l, g = l / 4, t = l % 4):
//   D (64 x N, float32): d[4 j + e] at row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2
//   A (64 x 16, bf16 pairs, from registers): a0 (16 w + g, 2t..2t+1),
//     a1 (16 w + g + 8, 2t..), a2 (16 w + g, 2t+8..), a3 (16 w + g + 8, 2t+8..)
// so the D fragment of columns [16 k, 16 k + 16) is, pair by pair, the A
// fragment of k16 step k: a score tile becomes the next product's A operand
// without leaving the registers (a_frag).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace rbr_wgmma {

constexpr int TILE_ROWS = 64;  // rows of a tile: wgmma's M

template <int DH>
struct TileGeom {
  static constexpr int PW = DH < 64 ? DH : 64;  // columns of a panel
  static constexpr int RB = 2 * PW;             // bytes of a panel row
  static constexpr int PANEL = TILE_ROWS * RB;  // bytes of a panel
  static constexpr int BYTES = DH / PW * PANEL; // bytes of a tile
  static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // the swizzle
  static_assert(DH % 16 == 0 && DH <= 256, "whole k16 steps, wgmma's N <= 256");
  static_assert(PANEL % 1024 == 0, "panels keep tiles on 1024-byte boundaries");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// k16 step kk of a tile read K-major (columns are the contraction).
template <int DH>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using G = TileGeom<DH>;
  const uint32_t addr = tile + 16 * kk / G::PW * G::PANEL + 16 * kk % G::PW * 2;
  return descriptor(addr, 16, 8 * G::RB, G::MODE);
}

// k16 step kk of a tile read MN-major (rows are the contraction).
template <int DH>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using G = TileGeom<DH>;
  return descriptor(tile + 16 * kk * G::RB, G::PANEL, 8 * G::RB, G::MODE);
}

// A fragment of k16 step kk from the D fragment of a 64 x 64 float32 tile,
// each value rounded to bf16 once.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[32], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a0 a1 from columns 16 kk + 2t, a2 a3 from 16 kk + 8 + 2t
    const __nv_bfloat162 b = __floats2bfloat162_rn(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
}

// mbarriers in shared memory, by their shared-memory address.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A phase
// that has not completed after ~2^34 cycles (seconds) traps, so that a
// fault in the protocol ends the launch with an error instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// Arrive on the barrier and add `bytes` to the transaction count its phase
// waits for (the TMA copies that complete on it).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared.b64 state, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// TMA: copy the box of `map` at coordinates (c0, c1, c2) into shared memory
// at dst, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// TMA copies of rows [r0, r0 + TILE_ROWS) of head bh of `map` (head_map) into
// the tile at dst, one box per panel; rows past S arrive as zeros.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, int r0, int bh,
                                          uint32_t bar) {
  using G = TileGeom<DH>;
#pragma unroll
  for (int p = 0; p < DH / G::PW; ++p)
    tma_load_3d(dst + p * G::PANEL, &map, p * G::PW, r0, bh, bar);
}

// 2^x on the special function unit (ex2.approx.ftz: relative error ~2^-22;
// 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across an
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d = A B (scale_d 0) or d += A B (scale_d 1): A (64 x 16) from registers
// (a_frag), B (16 x N) read MN-major from shared memory (desc_mn).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

// d = A B^T (scale_d 0) or d += A B^T (scale_d 1): A (64 x 16) and B (64 x 16)
// read from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda; null if the driver does not offer it.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The tensor map of a (BH, S, DH) bf16 tensor: boxes of TILE_ROWS rows of one
// head by PW columns, swizzled as TileGeom<DH> lays a panel out; rows past S
// (outside the head) are filled with zeros.
template <int DH>
bool head_map(CUtensorMap* map, const __nv_bfloat16* x, int BH, int S) {
  using G = TileGeom<DH>;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * 2, (cuuint64_t)S * DH * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)G::PW, (cuuint32_t)TILE_ROWS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(x), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace rbr_wgmma
