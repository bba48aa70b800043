// Flash-attention backward (B2: dQ; B3: dK, dV) on float32 inputs for
// Hopper (sm_90a), on TF32 wgmma in 3xTF32, recomputing the attention
// weights from the saved logsumexp L. The float32 entry points
// rbr_flash_bwd_dq_f32 and rbr_flash_bwd_dkv_f32 live here; they run these
// kernels at head width 128 and leave 16, 32 and 64 to the mma.sync kernels
// of flash_bwd.cu (see "Widths" below). bf16 inputs take flash_bwd_bf16.cu.
//
// Replaces: repro/kernels/flash.py::_flash_bwd_dq_kernel (B2) and
// ::_flash_bwd_dkv_kernel (B3), both launched by `_flash_backward`. With
// p_ij = exp(s_ij * scale - L_i) on the visible entries (0 elsewhere),
// dP = dO V^T, D_i = rowsum(dO * O)_i (computed by the caller, as the
// reference computes it outside Pallas) and dS = p * (dP - D):
//     B2:  dQ = scale * dS K
//     B3:  dV = p^T dO,   dK = scale * dS^T Q
//
// What bounds them on the card: bytes. At qwen3_0_6b's path shape (16
// heads, S = 256, dh = 128, causal; chip_smoke.py::flash_work) B2 moves
// 10.5 MB (3.14 us at 3.35 TB/s) for 0.40 GFLOP of products, 1.21 in three
// TF32 passes (2.45 us at 495 TFLOP/s); B3 12.6 MB (3.77 us) for 0.54
// GFLOP, 1.62 in three passes (3.27 us). What sets a launch this small is
// the serial chain of its longest block: 4 tiles of 64 keys (B2) or
// queries (B3) at S = 256.
//
// Why a redesign: the mma.sync kernels (16-row blocks, each warp streaming
// its own operands through cp.async and splitting every B fragment as it
// reads it, P and dS through shared memory, a merge of the warps' sums; at
// dh 128 only 4 warps a block, and B3 splitting dh's columns over two
// blocks that each recompute the scores over all of dh) took 36.06 (B2) +
// 71.89 (B3) us at (16, 256, 128) against SDPA's whole float32 backward at
// 100.6 (chip_smoke.py, one NVIDIA H100 80GB HBM3 at 700 W).
//
// What this design does about it:
// - 64-row tiles (wgmma's M). B2 owns 64 query rows and walks the 64-key
//   tiles they see (key_steps<64, 64>); B3 owns 64 keys and walks the
//   64-row query tiles that see them (query_steps<64, 64>). Longest ranges
//   start first: B2's late query tiles, B3's early key tiles.
// - Shared memory and registers set the geometry. tf32 wgmma reads its
//   shared-memory operands only K-major, so the products over the walked
//   axis need their streamed operand again, transposed (B2: K for dS K; B3:
//   Q and dO for dS^T Q and P^T dO), and every tile is held as two TF32
//   halves: 64 KB a 64-row tile at dh 128. One block holding everything
//   would need 320 KB (B2) or 384 KB (B3) of the 227 KB a block may use, and
//   B3's dK and dV over all of dh 128 registers a thread. So a cluster of
//   two blocks owns the 64 rows, and each block computes one score tile
//   over all of dh from its fixed tile and its streamed tile:
//   - B2: block 0 S = Q K^T, block 1 dP = dO V^T. Each stores its 64 x 64
//     tile into the other's shared memory (st.async, completing on an
//     mbarrier there), so both hold S and dP with the same bits, and block r
//     writes dQ's columns [64 r, 64 r + 64) from K's transposed columns.
//   - B3: block 0 S^T = K Q^T, then P^T, which it sends to block 1, and dV
//     over all of dh from dO transposed; block 1 dP^T = V dO^T and, once P^T
//     has come, dS^T and dK from Q transposed. Only block 1 waits for the
//     exchange; the two-way exchange of B2's form took B3 29.9-30.0 us
//     against 26.5-26.6 for this one (bench_flash.py, one NVIDIA H100
//     80GB HBM3 at 700 W, as every time below).
//   Per block (BYTES, one stage): the fixed and the streamed tile (64 KB
//   each), the transposed tile (B2: 32 KB, 64 of K's columns; B3: 64 KB),
//   B3's L and D of a query tile and the other block's score tile (16 KB):
//   177.1 KB (B2) and 209.6 KB (B3). A first design split dh between the
//   blocks for every product and exchanged partial S and dP both ways (32
//   KB each way a step): 27.9 + 32.8 us. The exchange is slow: 16 KB takes
//   ~1,300 cycles alone and ~2,200-3,900 beside the producer's refill.
// - Warp specialisation, 256 threads: a producer warpgroup feeds one
//   consumer warpgroup behind full/empty mbarriers. The fixed tile and each
//   streamed K-major tile come by bulk copy (cp.async.bulk: a tile's rows
//   are one contiguous run) into their big half and are split in place:
//   the streamed tile by the producer, as soon as the scores are done with
//   the last one; the fixed tile by the consumer, idle until then, while the
//   producer splits the first streamed tile (0.3-0.4 us a launch). The
//   transposed tile is loaded into registers a step ahead (16-byte loads
//   that skip L1) and written split, each 8 rows in KEY_ORDER
//   (wgmma_tf32.cuh), so that P's and dS's score fragments serve as wgmma's
//   A operand where they lie. The streamed tile in registers as well
//   spilled the producer.
// - Every product is 3xTF32 on wgmma: each product's cross terms first over
//   its whole contraction (small * big, then big * small), its big terms
//   last, as the float32 B1 sums (flash_fwd_f32.cu). Interleaving the three
//   passes per k8 step gave 5.6x (B2) and 4.9x (B3) the plain versions'
//   error against float64, past chip_smoke.py's 4x. The scores read both
//   operands from shared memory (m64n64k8); dQ += dS K, dV += P^T dO and
//   dK += dS^T Q take A from the score registers (big by cvt.rna, small =
//   x - big, whose low bits the tensor cores drop), m64n64k8 over each 64
//   of the output's columns. Each step's product is summed from zero in the
//   tensor cores and added to the running sum in float32: accumulating
//   across the steps in the tensor cores, B3 was 5.6x the plain version's
//   error. scale multiplies dQ and dK once, at the end.
// - p = 2^(s scale log2(e) - L log2(e)) (ex2.approx) where the query sees
//   the key; tiles that every row sees whole skip the mask, elsewhere it
//   selects the exponent to -inf, never multiplies. dS = p (dP - D).
// - Each block writes only its rows and columns of the outputs, once, with
//   no atomics: two runs give the same bits.
//
// Measured (launch/bench_flash.py, in turns with the mma.sync kernels in one
// call, one NVIDIA H100 80GB HBM3 at 700 W): B2 22.91-23.04 us and B3
// 26.53-26.77 at (16, 256, 128), against 35.78-35.95 and 71.46-71.97 and
// SDPA's float32 backward at 99.1-99.9. About 4.8 us of each is what any
// launch costs timed this way (a 16-float zero_). Within a launch (clock64
// stamps of an instrumented copy, 1.98 GHz): ~5,100 cycles until the fixed
// tile is split and ~5,800 (B2) or ~7,600 (B3) until the first scores, then
// a tile of ~6,500 cycles in B2 (scores 2,100, exchange 2,300, exp and dS
// 1,000, dQ 1,200) and ~7,900 in B3's block 1 (scores 2,300, waiting for
// P^T 2,600, dK 2,200).
//
// Widths: 128 runs here. At 64 (paper_95m) the first design, a block per
// 64 rows over all of dh, took 19.3 (B2) and 24.6 us (B3) against the
// mma.sync kernels' 14.4 and 16.8 on the same card (two blocks splitting
// dh: 22.9 and 25.7), so 64 keeps them, as do 16 and 32, which no
// full-width configuration has.

#include <cmath>

#include "flash_common.cuh"
#include "wgmma_tf32.cuh"

namespace rbr_flash {
namespace {

using namespace rbr_wgmma;

constexpr int BR = TILE_ROWS;    // rows a cluster owns; rows of a streamed tile
constexpr int THREADS = 2 * WG;  // the consumer warpgroup, then the producer warpgroup
constexpr int CL = 2;            // blocks of a cluster
constexpr float LOG2E = 1.4426950408889634f;
constexpr int XBYTES = BR * BR * 4;  // one 64 x 64 score tile, sent to the other block

// DKV: B3 (else B2).
template <int DH, bool DKV>
struct BwdF32Geom {
  // the columns of dh a block's outputs hold: the rows of its transposed tile
  static constexpr int DC = DKV ? DH : DH / CL;
  static constexpr int HALF = BR * DH * 4;   // one TF32 half of a 64-row tile
  static constexpr int THALF = DC * BR * 4;  // one TF32 half of the transposed tile
  static constexpr int STATS = DKV ? 2 * BR * 4 : 0;  // B3: a query tile's L and D
  static constexpr int BARS = 8 * 8;         // Smem's eight mbarriers
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes in the kernel
  static constexpr size_t BYTES = 1024 + 4 * HALF + 2 * THALF + STATS + XBYTES + BARS;
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// The block's shared memory: the fixed tile x, the streamed K-major tile y
// and the transposed tile t, each from a 1024-byte boundary, each its big
// half then its small half; then B3's L and D, the other block's score
// tile, the barriers.
template <int DH, bool DKV>
struct Smem {
  using G = BwdF32Geom<DH, DKV>;
  unsigned char* ptr;  // the tiles' generic address
  uint32_t base;       // their shared-memory address

  __device__ uint32_t x() const { return base; }
  __device__ uint32_t y() const { return base + 2 * G::HALF; }
  __device__ uint32_t t() const { return base + 4 * G::HALF; }
  __device__ float* stats() const {  // -L log2(e) of the tile's 64 queries, then D
    return reinterpret_cast<float*>(ptr + 4 * G::HALF + 2 * G::THALF);
  }
  __device__ uint32_t xbuf() const { return t() + 2 * G::THALF + G::STATS; }
  __device__ uint32_t bar(int i) const { return xbuf() + XBYTES + 8 * i; }
  // the fixed tile's raw rows have landed
  __device__ uint32_t fxraw() const { return bar(0); }
  // a step's K-major tile: its raw rows have landed; it is split; the
  // scores are done with it
  __device__ uint32_t yraw() const { return bar(1); }
  __device__ uint32_t yfull() const { return bar(2); }
  __device__ uint32_t yempty() const { return bar(3); }
  // the transposed tile (and B3's L and D) is written; the products are done
  __device__ uint32_t tfull() const { return bar(4); }
  __device__ uint32_t tempty() const { return bar(5); }
  // the other block's score tile has landed in xbuf; it has read this block's
  __device__ uint32_t xfull() const { return bar(6); }
  __device__ uint32_t xempty() const { return bar(7); }
};

template <int DH, bool DKV>
__device__ __forceinline__ Smem<DH, DKV> make_smem(unsigned char* raw) {
  const uint32_t a = smem_addr(raw), base = (a + 1023) & ~1023u;
  const Smem<DH, DKV> sm{raw + (base - a), base};
  if (threadIdx.x == 0) {
    mbar_init(sm.fxraw(), 1);  // the issuing thread's arrival, then the copy's bytes
    mbar_init(sm.yraw(), 1);
    mbar_init(sm.yfull(), WG);  // the next four count a warpgroup's 128 threads
    mbar_init(sm.yempty(), WG);
    mbar_init(sm.tfull(), WG);
    mbar_init(sm.tempty(), WG);
    mbar_init(sm.xfull(), 1);  // an arrival of this block, then the other's bytes
    mbar_init(sm.xempty(), WG);  // the other block's consumer threads
    fence_barrier_init();
    mbar_expect_tx(sm.xfull(), XBYTES);  // the first step's
  }
  __syncthreads();
  // the other block's barriers are initialised before this block first
  // signals it (cluster_wait, in the consumer)
  cluster_arrive();
  return sm;
}

// The producer warpgroup. The fixed tile x: rows [f0, f0 + 64) of `fixed`,
// by bulk copy into its big half (the consumer splits it: split_fixed).
// Then step j (rows (lo + j) 64): the K-major tile y of `streamed` and the
// transposed tile t of DC columns of `tsrc` (for B3 with the rows' -L
// log2(e) and D, from Lr and Dr). y comes by bulk copy into its big half as
// soon as the scores are done with the last one, and is split in place; t's
// values come into registers a step ahead (y's in registers as well made
// the kernel spill). `fixed` and `streamed` point at their head, `tsrc` at
// its first column; rows are DH floats apart.
template <int DH, bool DKV>
__device__ __forceinline__ void produce(const Smem<DH, DKV>& sm, const float* __restrict__ fixed,
                                        int f0, const float* __restrict__ streamed,
                                        const float* __restrict__ tsrc,
                                        const float* __restrict__ Lr,
                                        const float* __restrict__ Dr, int lo, int n, int S) {
  using G = BwdF32Geom<DH, DKV>;
  constexpr int DC = G::DC;
  const int p = threadIdx.x - WG;
  auto copy_rows = [&](uint32_t dst, const float* src, int r0, uint32_t bar) {
    if (p == 0) {
      const uint32_t bytes = min(BR, S - r0) * DH * 4;
      mbar_expect_tx(bar, bytes);
      bulk_load(dst, src + (long long)r0 * DH, bytes, bar);
    }
  };
  copy_rows(sm.x(), fixed, f0, sm.fxraw());
  if (n > 0) copy_rows(sm.y(), streamed, lo * BR, sm.yraw());
  float4 ta[DC / 8];  // the next step's transposed tile
  float st = 0.f;     // B3: the next step's -L log2(e) (p < 64) or D of row p % 64
  auto load_tr = [&](int j) {
    const int r0 = (lo + j) * BR, r = r0 + p % BR;
    load_t<DC>(ta, tsrc, r0, S, DH, p);
    if (DKV) st = r >= S ? 0.f : p < BR ? -Lr[r] * LOG2E : Dr[r];
  };
  if (n > 0) load_tr(0);
  for (int j = 0; j < n; ++j) {
    const int r0 = (lo + j) * BR;
    mbar_wait(sm.yraw(), j & 1);
    split_in_place<DH>(sm.y(), G::HALF, S - r0, p);
    fence_proxy_async();
    mbar_arrive(sm.yfull());
    if (j > 0) mbar_wait(sm.tempty(), (j - 1) & 1);
    store_t<DC>(sm.t(), G::THALF, ta, p);
    if (DKV) sm.stats()[p] = st;
    fence_proxy_async();
    mbar_arrive(sm.tfull());
    if (j + 1 < n) {
      load_tr(j + 1);
      mbar_wait(sm.yempty(), j & 1);
      copy_rows(sm.y(), streamed, r0 + BR, sm.yraw());
    }
  }
}

// The consumer warpgroup splits the fixed tile x (rows [f0, f0 + 64)) once
// its raw rows have landed, while the producer splits the first streamed
// tile; then every thread's halves are visible to wgmma.
template <int DH, bool DKV>
__device__ __forceinline__ void split_fixed(const Smem<DH, DKV>& sm, int f0, int S) {
  mbar_wait(sm.fxraw(), 0);
  split_in_place<DH, 2>(sm.x(), BwdF32Geom<DH, DKV>::HALF, min(BR, S - f0), threadIdx.x);
  fence_proxy_async();
  warpgroup_sync<2>();
}

// d = x y^T over all of dh in 3xTF32, x and y 64-row K-major tiles in
// shared memory (their small halves HALF bytes on): the cross terms over
// all DH columns first, then the big terms.
template <int DH>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t x, uint32_t y) {
  constexpr uint32_t H = BR * DH * 4;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk)
    wgmma_tf32_ss_n64(d, desc_tf32<BR>(x + H, kk), desc_tf32<BR>(y, kk), kk);
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk)
    wgmma_tf32_ss_n64(d, desc_tf32<BR>(x, kk), desc_tf32<BR>(y + H, kk), 1);
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk)
    wgmma_tf32_ss_n64(d, desc_tf32<BR>(x, kk), desc_tf32<BR>(y, kk), 1);
}

// The step's score tile of this block, over all of dh, once the streamed
// tile has come; the tile is released after it.
template <int DH, bool DKV>
__device__ __forceinline__ void step_scores(const Smem<DH, DKV>& sm, float (&d)[32], int j) {
  mbar_wait(sm.yfull(), j & 1);
  wgmma_fence();
  product_ss<DH>(d, sm.x(), sm.y());
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  mbar_arrive(sm.yempty());
}

// A score tile's A fragments over its 64 columns, split (a_frag_tf32).
__device__ __forceinline__ void a_frags(uint32_t (&big)[8][4], uint32_t (&small)[8][4],
                                        const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) a_frag_tf32(big[kk], small[kk], d, kk);
}

// acc += A B over a step's 64 rows in 3xTF32: A the split fragments of a
// score tile, B the transposed tile t of R rows (acc's columns, in halves of
// 64; its small half R 64 4 bytes on). Each half is summed from zero in the
// tensor cores, cross terms first, and added to acc in float32: the tensor
// cores sum only one step's products.
template <int R>
__device__ __forceinline__ void add_product(float (&acc)[R / 2], const float (&scores)[32],
                                            uint32_t t) {
  constexpr uint32_t H = R * BR * 4;
  uint32_t big[8][4], small[8][4];
  a_frags(big, small, scores);
#pragma unroll
  for (int h = 0; h < R / 64; ++h) {
    const uint32_t th = t + h * 64 * 128;  // rows [64 h, 64 h + 64) of each panel
    float d[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs<64>(d, small[kk], desc_tf32<R>(th, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs<64>(d, big[kk], desc_tf32<R>(th + H, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs<64>(d, big[kk], desc_tf32<R>(th, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * h + i] += d[i];
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    fence_regs(big[kk]);
    fence_regs(small[kk]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The score tiles between the two blocks of a cluster (distributed shared
// memory): send_tile stores a block's tile of step j into the other's xbuf
// (st.async, 16-byte chunk i of thread tid at (i 128 + tid) 16: 8
// neighbouring threads a 128-byte run), completing on the other's xfull,
// once the other has read step j - 1's (xempty); recv_tile reads the
// other's from this block's xbuf and, but after the last of the n steps
// (when the other may have exited), tells it so.
template <int DH, bool DKV>
__device__ __forceinline__ void send_tile(const Smem<DH, DKV>& sm, int rank,
                                          const float (&d)[32], int j) {
  const int tid = threadIdx.x;
  if (j > 0) mbar_wait_cluster(sm.xempty(), (j - 1) & 1);
  const uint32_t peer_buf = cluster_addr(sm.xbuf(), rank ^ 1);
  const uint32_t peer_full = cluster_addr(sm.xfull(), rank ^ 1);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    st_async_v4(peer_buf + 16 * (i * WG + tid), peer_full,
                make_float4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]));
}

template <int DH, bool DKV>
__device__ __forceinline__ void recv_tile(const Smem<DH, DKV>& sm, int rank, float (&o)[32],
                                          int j, int n) {
  const int tid = threadIdx.x;
  mbar_wait(sm.xfull(), j & 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = ld_shared_v4(sm.xbuf() + 16 * (i * WG + tid));
    o[4 * i] = v.x;
    o[4 * i + 1] = v.y;
    o[4 * i + 2] = v.z;
    o[4 * i + 3] = v.w;
  }
  if (j + 1 < n) {
    if (tid == 0) mbar_expect_tx(sm.xfull(), XBYTES);  // the next step's bytes
    mbar_arrive_remote(cluster_addr(sm.xempty(), rank ^ 1));
  }
}

// Rows [r0, r0 + 64) of out (row stride DH) = mul * acc, the D fragment of a
// 64 x DC tile, for the rows below S.
template <int DC, int DH>
__device__ __forceinline__ void store_out(float* __restrict__ out, const float (&acc)[DC / 2],
                                          int r0, int S, float mul) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * w + g + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
      *reinterpret_cast<float2*>(out + (long long)r * DH + 8 * j + 2 * t) =
          make_float2(mul * acc[4 * j + 2 * h], mul * acc[4 * j + 2 * h + 1]);
  }
}

// B2: block 0 computes S and block 1 dP, and they exchange them, so both
// hold S and dP with the same bits (dQ's columns [64 r, 64 r + 64) in block
// r need all of dS).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ L, const float* __restrict__ D,
                        float* __restrict__ dq, int BH, int S, int causal, int window,
                        float scale) {
  constexpr int DC = BwdF32Geom<DH, false>::DC;
  extern __shared__ unsigned char smem_raw[];
  const Smem<DH, false> sm = make_smem<DH, false>(smem_raw);

  const int ntiles = (S + BR - 1) / BR;
  const int cluster = blockIdx.x / CL, rank = (int)cluster_rank();
  const int bh = cluster % BH;
  const int q0 = (ntiles - 1 - cluster / BH) * BR;  // late query tiles first
  int lo, hi;
  key_steps<BR, BR>(q0, S, causal, window, lo, hi);
  const int n = max(hi - lo, 0);
  const long long head = (long long)bh * S * DH;

  if (threadIdx.x >= WG) {  // block 0: Q and K for S; block 1: dO and V for dP
    produce<DH, false>(sm, (rank == 0 ? q : dO) + head, q0, (rank == 0 ? k : v) + head,
                       k + head + rank * DC, nullptr, nullptr, lo, n, S);
    cluster_wait();
    return;
  }

  // the consumer: rows are the cluster's queries, columns a tile's keys
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  L += (long long)bh * S;
  D += (long long)bh * S;
  float nL[2], Dr[2];  // -L log2(e) and D of rows g and g + 8 of this warp's 16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    nL[h] = r < S ? -L[r] * LOG2E : 0.f;
    Dr[h] = r < S ? D[r] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  float acc[DC / 2];
  zero(acc);
  split_fixed(sm, q0, S);
  cluster_wait();  // the other block's barriers are initialised

  for (int j = 0; j < n; ++j) {
    const int k0 = (lo + j) * BR;
    float d[32], o[32], sc[32], dp[32];  // this block's tile, the other's; S, then P; dP, then dS
    step_scores(sm, d, j);
    send_tile(sm, rank, d, j);
    recv_tile(sm, rank, o, j, n);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = rank == 0 ? d[i] : o[i];
      dp[i] = rank == 0 ? o[i] : d[i];
    }
    if (whole_tile<BR>(q0, k0, S, S, causal, window))
      probs<false, false>(sc, sl2, nL, q0, k0, S, causal, window);
    else
      probs<true, false>(sc, sl2, nL, q0, k0, S, causal, window);
    grad_scores<false>(dp, sc, Dr);
    mbar_wait(sm.tfull(), j & 1);
    add_product<DC>(acc, dp, sm.t());  // dQ += dS K, K transposed
    mbar_arrive(sm.tempty());
  }
  store_out<DC, DH>(dq + head + rank * DC, acc, q0, S, scale);
}

// B3: block 0 computes S^T and P^T, sends P^T to block 1 and computes dV
// over all of dh; block 1 computes dP^T, takes P^T, and computes dS^T and
// dK. Only block 1 waits for the exchange.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dO,
                         const float* __restrict__ L, const float* __restrict__ D,
                         float* __restrict__ dk, float* __restrict__ dv, int BH, int S,
                         int causal, int window, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<DH, true> sm = make_smem<DH, true>(smem_raw);

  const int cluster = blockIdx.x / CL, rank = (int)cluster_rank();
  const int bh = cluster % BH;
  const int k0 = cluster / BH * BR;  // early key tiles first
  int lo, hi;
  query_steps<BR, BR>(k0, S, causal, window, lo, hi);
  const int n = max(hi - lo, 0);
  const long long head = (long long)bh * S * DH;

  if (threadIdx.x >= WG) {  // block 0: K, Q and dO^T; block 1: V, dO and Q^T
    produce<DH, true>(sm, (rank == 0 ? k : v) + head, k0, (rank == 0 ? q : dO) + head,
                      (rank == 0 ? dO : q) + head, L + (long long)bh * S,
                      D + (long long)bh * S, lo, n, S);
    cluster_wait();
    return;
  }

  // the consumer: rows are the cluster's keys, columns a tile's queries
  const float sl2 = scale * LOG2E;
  float acc[DH / 2];  // block 0: dV; block 1: dK
  zero(acc);
  const float* LD = sm.stats();  // -L log2(e), then D, of the tile's queries
  split_fixed(sm, k0, S);
  cluster_wait();  // the other block's barriers are initialised

  for (int j = 0; j < n; ++j) {
    const int q0 = (lo + j) * BR;
    float d[32];  // S^T, then P^T (block 0); dP^T, then dS^T (block 1)
    step_scores(sm, d, j);
    mbar_wait(sm.tfull(), j & 1);  // Q or dO transposed, and the queries' L and D
    if (rank == 0) {
      if (whole_tile<BR>(q0, k0, S, S, causal, window))
        probs<false, true>(d, sl2, LD, k0, q0, S, causal, window);
      else
        probs<true, true>(d, sl2, LD, k0, q0, S, causal, window);
      send_tile(sm, rank, d, j);
    } else {
      float p[32];
      recv_tile(sm, rank, p, j, n);
      grad_scores<true>(d, p, LD + BR);
    }
    add_product<DH>(acc, d, sm.t());  // dV += P^T dO or dK += dS^T Q
    mbar_arrive(sm.tempty());
  }
  store_out<DH, DH>((rank == 0 ? dv : dk) + head, acc, k0, S, rank == 0 ? 1.f : scale);
}

template <int DH>
int launch_dq_f32(const float* q, const float* k, const float* v, const float* dO,
                  const float* L, const float* D, float* dq, int BH, int S, int causal,
                  int window, float scale, cudaStream_t stream) {
  return launch_cluster(SLOT_DQ, flash_bwd_dq_f32_kernel<DH>, CL,
                        (long long)CL * BH * ((S + BR - 1) / BR), THREADS,
                        BwdF32Geom<DH, false>::BYTES, stream, q, k, v, dO, L, D, dq, BH, S,
                        causal, window, scale);
}

template <int DH>
int launch_dkv_f32(const float* q, const float* k, const float* v, const float* dO,
                   const float* L, const float* D, float* dk, float* dv, int BH, int S,
                   int causal, int window, float scale, cudaStream_t stream) {
  return launch_cluster(SLOT_DKV, flash_bwd_dkv_f32_kernel<DH>, CL,
                        (long long)CL * BH * ((S + BR - 1) / BR), THREADS,
                        BwdF32Geom<DH, true>::BYTES, stream, q, k, v, dO, L, D, dk, dv, BH, S,
                        causal, window, scale);
}

}  // namespace
}  // namespace rbr_flash

// q, k, v, dO, dq: (BH, S, dh) float32 contiguous and 16-byte aligned; L, D:
// (BH, S) float32. window < 0 means no window. Launches on `stream`; returns
// a CUDA error code (0 on success).
extern "C" int rbr_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                    const float* dO, const float* L, const float* D, float* dq,
                                    int BH, int S, int dh, int causal, int window, float scale,
                                    int device, cudaStream_t stream) {
  using namespace rbr_flash;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dh == 128)
    return launch_dq_f32<128>(q, k, v, dO, L, D, dq, BH, S, causal, window, scale, stream);
  return launch_dq_mma(q, k, v, dO, L, D, dq, BH, S, dh, causal, window, scale, stream);
}

// As above, writing dk and dv: (BH, S, dh).
extern "C" int rbr_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                     const float* dO, const float* L, const float* D, float* dk,
                                     float* dv, int BH, int S, int dh, int causal, int window,
                                     float scale, int device, cudaStream_t stream) {
  using namespace rbr_flash;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dh == 128)
    return launch_dkv_f32<128>(q, k, v, dO, L, D, dk, dv, BH, S, causal, window, scale,
                               stream);
  return launch_dkv_mma(q, k, v, dO, L, D, dk, dv, BH, S, dh, causal, window, scale, stream);
}
