// Hopper's pieces for float32 operands on the tensor cores in 3xTF32, on
// wgmma (sm_90a): K-major float32 tiles in shared memory that threads write
// already split into their TF32 halves, the tf32 wgmma.mma_async products,
// and the cluster's barrier, mbarrier signals and shared-memory stores.
// Used by the float32 B1 (flash_fwd_f32.cu) and the float32 B2 and B3 at
// head width 128 (flash_bwd_f32.cu); the dtype-neutral pieces
// (mbarriers, descriptors, fences) are in wgmma.cuh.
//
// Why threads write the tiles: tf32 wgmma reads its shared-memory operands
// only K-major (no transpose bit, unlike bf16), and TMA copies cannot
// transpose. So a producer splits each float32 x into big = rna_tf32(x) and
// small = rna_tf32(x - big) (tf32_mma.cuh) and writes both halves, each in
// its own tile; a tile whose rows lie along the contraction in memory (V in
// B1's P V, K in B2's dS K, Q and dO in B3's dS^T Q and P^T dO) is
// transposed on the way (store_t).
//
// Tiles. A K-major tile of R rows (M or N) holds C float32 columns of the
// contraction as C / 32 panels of 32 columns: panel p holds columns
// [32 p, 32 p + 32) of all R rows, rows 128 bytes long, with the 128-byte
// swizzle (the 16-byte chunk c of row r lies at chunk c ^ (r % 8); wgmma's
// descriptor mode 1): chunk_at. A k8 step advances 32 bytes within a panel
// row, 4 steps a panel; 8-row groups are SBO = 1024 bytes apart: desc_tf32.
// A tile starts on a 1024-byte boundary.
//
// wgmma fragments (warp w of the warpgroup holds rows 16 w to 16 w + 15;
// lane l, g = l / 4, t = l % 4):
//   D (64 x N, float32): d[4 j + e] at row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2
//   A (64 x 8, tf32, from registers): a0 (16 w + g, t), a1 (16 w + g + 8, t),
//     a2 (16 w + g, t + 4), a3 (16 w + g + 8, t + 4)
// The D fragment of columns [8 j, 8 j + 8) holds columns 2t and 2t + 1 where
// A wants t and t + 4. So a score tile feeds the next product from the
// registers if that product's contraction runs over each 8 columns in the
// order KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7): A's column c is the score
// column KEY_ORDER[c], and B's row c must be too (a_frag_tf32).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace rbr_wgmma {

// Byte offset of the 16-byte chunk that holds columns [4 c, 4 c + 4) of row
// r in a K-major float32 tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  return (uint32_t)((c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4));
}

// k8 step kk of a K-major float32 tile of R rows.
template <int R>
__device__ __forceinline__ uint64_t desc_tf32(uint32_t tile, int kk) {
  return descriptor(tile + kk / 4 * (R * 128) + kk % 4 * 32, 16, 1024, 1);
}

// rna_tf32(x) for a finite x: its top 19 bits rounded to nearest, ties away
// from zero, in two integer operations. cvt.rna.tf32.f32 (tf32_mma.cuh's
// split) gives the same bits for finite inputs and spends two more
// instructions on keeping infinities and NaNs, which attention's finite
// inputs and probabilities never hold.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as big = rna_tf32(x) and small = rna_tf32(x - big): tf32_mma.cuh's split.
__device__ __forceinline__ void split_fast(uint32_t& big, uint32_t& small, float x) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The big and small TF32 halves of four floats.
__device__ __forceinline__ void split4(uint4& big, uint4& small, const float4& x) {
  split_fast(big.x, small.x, x.x);
  split_fast(big.y, small.y, x.y);
  split_fast(big.z, small.z, x.z);
  split_fast(big.w, small.w, x.w);
}

// A 16-byte load from global memory through the non-coherent path that does
// not allocate in L1: the loaded tiles are written to shared memory, and L1
// shares its SRAM (and bandwidth) with the shared memory that wgmma reads.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Copy `bytes` (a multiple of 16) from global memory at src to shared memory
// at dst (16-byte aligned) in one bulk copy, completing the bytes on the
// mbarrier `bar` (whose phase expects them: mbar_expect_tx).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads) before it arrives on a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A warpgroup's writes of split tiles. Thread p (0-127) of the warpgroup
// holds a tile's values as C / 8 float4s, in one of two orders:
// - rows (store_rows): float4s f = p + 128 i, chunk f % (C / 4)
//   of row f / (C / 4) of 64 rows of C floats, for the K-major tile of 64
//   rows by C; 8 neighbouring threads write the 8 chunks of one panel row,
//   so the stores meet no bank conflict;
// - transposed (load_t, store_t): 64 rows (keys) of C floats written as
//   the K-major tile of C rows by the 64 keys, each 8 keys in KEY_ORDER, so
//   that a score fragment over those keys is the A operand of the product
//   with it where it lies (a_frag_tf32). Unit u = p + 128 m (m < C / 32)
//   covers chunk kc = 8 (u / (2 C)) + u % 8 of the transposed rows 4 n to
//   4 n + 3, n = u / 8 % (C / 4): the keys 8 G + h + 2 e (e = 0..3) of
//   parity h = kc % 2 in k8 group G = kc / 2; x[4 m + e] holds key
//   8 G + h + 2 e's columns [4 n, 4 n + 4).
// Each value is split into big = rna_tf32(x) and small = rna_tf32(x - big),
// the small half `half` bytes after the big one. Rows past S are zeros.
constexpr int WG = 128;  // threads of a warpgroup

// Synchronise one warpgroup alone, on named barrier BAR (0 is __syncthreads):
// the producer's is 1.
template <int BAR>
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(WG) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

template <int C>
__device__ __forceinline__ void store_rows(uint32_t tile, uint32_t half,
                                           const float4 (&x)[C / 8], int p) {
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const int f = p + WG * i;
    uint4 big, small;
    split4(big, small, x[i]);
    const uint32_t at = tile + chunk_at<TILE_ROWS>(f / (C / 4), f % (C / 4));
    st_shared_v4(at, big);
    st_shared_v4(at + half, small);
  }
}

// Split the raw rows that a bulk copy landed row-major (C floats a row) at
// `tile` (`rows` of them valid; the rest of the 64 become zeros) into the
// tile's halves: big over the raw rows, swizzled, small `half` bytes on.
// Every thread of the warpgroup (named barrier BAR) reads its float4s (8
// neighbouring threads a 128-byte run: no bank conflicts) before any thread
// writes.
template <int C, int BAR = 1>
__device__ __forceinline__ void split_in_place(uint32_t tile, uint32_t half, int rows, int p) {
  float4 x[C / 8];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const int f = p + WG * i;
    x[i] = f / (C / 4) < rows ? ld_shared_v4(tile + 16 * f) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  warpgroup_sync<BAR>();
  store_rows<C>(tile, half, x, p);
}

template <int C>
__device__ __forceinline__ void unit(int u, int& kc, int& n) {
  kc = 8 * (u / (2 * C)) + u % 8;
  n = u / 8 % (C / 4);
}

// Keys [k0, k0 + 64) of a tensor of S rows, row stride ld floats, columns
// [0, C) from src, in store_t's order.
template <int C>
__device__ __forceinline__ void load_t(float4 (&x)[C / 8], const float* __restrict__ src, int k0,
                                       int S, int ld, int p) {
#pragma unroll
  for (int m = 0; m < C / 32; ++m) {
    int kc, n;
    unit<C>(p + WG * m, kc, n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * (kc / 2) + kc % 2 + 2 * e;
      const float4 y =
          ld_stream(reinterpret_cast<const float4*>(src + (long long)min(key, S - 1) * ld) + n);
      x[4 * m + e] = key < S ? y : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int C>
__device__ __forceinline__ void store_t(uint32_t tile, uint32_t half, const float4 (&x)[C / 8],
                                        int p) {
#pragma unroll
  for (int m = 0; m < C / 32; ++m) {
    int kc, n;
    unit<C>(p + WG * m, kc, n);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 col = make_float4(lane_of(x[4 * m], j), lane_of(x[4 * m + 1], j),
                                     lane_of(x[4 * m + 2], j), lane_of(x[4 * m + 3], j));
      uint4 big, small;
      split4(big, small, col);
      const uint32_t at = tile + chunk_at<C>(4 * n + j, kc);
      st_shared_v4(at, big);
      st_shared_v4(at + half, small);
    }
  }
}

// The A fragments of k8 step kk of a 64 x 64 float32 D fragment, each value
// split into its TF32 halves, columns in KEY_ORDER (see the header): big =
// rna_tf32(x) by cvt.rna, and small = x - big, exact in float32, whose low
// bits the tensor cores drop as they read it. (With split_fast's integer
// operations on the score registers, ptxas serialized the kernel's wgmma
// chains, "C7520: wgmma.mma_async instructions are serialized", and S
// slowed down.)
__device__ __forceinline__ void a_frag_tf32(uint32_t (&big)[4], uint32_t (&small)[4],
                                            const float (&d)[32], int kk) {
  const float x[4] = {d[4 * kk], d[4 * kk + 2], d[4 * kk + 1], d[4 * kk + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = rbr_tf32::to_tf32(x[i]);
    small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
  }
}

// The cluster's barrier in two halves: every thread of the cluster arrives
// once (release), and waits (acquire) before it relies on the others'
// earlier work, such as their mbarriers being initialised.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address `addr` of this block's shared memory, in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// Store v at cluster address `remote` (cluster_addr, 16-byte aligned) in the
// peer block, asynchronously: the store completes its 16 bytes on the
// peer's mbarrier at cluster address `remote_bar`, whose phase expects them
// (mbar_expect_tx); a thread that has waited for that phase sees v.
__device__ __forceinline__ void st_async_v4(uint32_t remote, uint32_t remote_bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

// Arrive, releasing at cluster scope, on the mbarrier at cluster address
// `remote` (cluster_addr): the peer block sees this thread's earlier writes
// once the barrier's phase completes (mbar_wait_cluster).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t remote) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// mbar_wait, acquiring at cluster scope: the writes that the peer block's
// arrivals released are visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// d = A B^T (scale_d 0) or d += A B^T (scale_d 1) on tf32 operands: A (64 x 8)
// and B (64 x 8) read from shared memory, both K-major (desc_tf32).
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


// d = A B (scale_d 0) or d += A B (scale_d 1) on tf32 operands: A (64 x 8)
// from registers (a_frag_tf32), B (8 x N) read K-major from shared memory
// (desc_tf32 of a tile of N rows).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace rbr_wgmma
