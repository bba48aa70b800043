// Flash-attention forward (B1) on float32 inputs for Hopper (sm_90a), on
// TF32 wgmma in 3xTF32: causal or sliding-window attention with an online
// softmax, emitting O and the row logsumexp L. The float32 entry point
// rbr_flash_fwd_f32 lives here; it runs this kernel at head widths 64 and
// 128 and leaves 16 and 32 to the mma.sync kernel of flash_fwd.cu (see
// "Widths" below). bf16 inputs take flash_fwd_bf16.cu.
//
// Replaces: repro/kernels/flash.py::_flash_fwd_kernel (Pallas, launched by
// `_flash_forward`). Per head and query row i:
//     s_ij = (q_i . k_j) * scale             over the visible keys j
//     O_i  = sum_j softmax(s_i)_j v_j,   L_i = max_j s_ij + log sum_j exp(s_ij - max)
// A row that sees no key gives O_i = 0 and L_i = -1e30, as in the reference.
//
// What bounds it on the card: bytes. At qwen3_0_6b's path shape (16 heads,
// S = 256, dh = 128, causal; chip_smoke.py::flash_work) a launch moves
// 8.4 MB (2.51 us at 3.35 TB/s) for 0.27 GFLOP of products, 0.81 in three
// TF32 passes (1.64 us at 495 TFLOP/s). What sets a launch this small is
// the serial chain of its longest block, and along it the shared-memory
// port: S on wgmma reads both operands from shared memory (4 KB per
// m64n64k8 of 32 tensor cycles, all of the port's 128 bytes a cycle), and
// the producer's split tiles pass through the same port.
//
// Why a redesign: the mma.sync kernel (16-row blocks, each warp streaming
// its own K and V through cp.async, P through shared memory, a merge of the
// warps' 16 x dh sums; at dh 128 only 4 warps, Q split again at every use)
// took 38.34 us at (16, 256, 128) against SDPA's float32 forward at 30.77
// (chip_smoke.py, one NVIDIA H100 80GB HBM3 at 700 W).
//
// What this design does about it:
// - A cluster of CL blocks (four at dh 64, two at dh 128) owns 64 query
//   rows (wgmma's M) over the whole head width; its blocks take the 64-key
//   tiles those rows can see (key_steps<64, 64>) in turn (tile i to block
//   i % CL), so the longest chain shortens (4 tiles at S = 256 become 1 or 2
//   a block). CL BH ceil(S / 64) blocks: 128 at (16, 256, 128), 96 at (6,
//   256, 64); four a cluster at dh 128 would need 256, more than the card's
//   132 SMs. Late query tiles start first. At the end block r owns columns
//   [r dh / CL, (r + 1) dh / CL): each block stores its m, l and its sums of
//   each other block's columns into that block's Q tile (distributed shared
//   memory, st.async), once every block has signalled that its last S is
//   done; each merges its columns over the blocks in rank order and writes
//   them, so the result repeats bit for bit. The signals are mbarriers in
//   the peer blocks (wgmma_tf32.cuh); two cluster barriers in their place
//   made the kernel slower.
// - Warp specialisation, 256 threads: a producer warpgroup feeds one
//   consumer warpgroup behind full/empty mbarriers. Q and K lie K-major, as
//   wgmma wants them: one thread copies a tile's raw rows with one bulk copy
//   (cp.async.bulk: a tile's rows are one contiguous run, no tensor map),
//   and the warpgroup splits them in place into their TF32 halves, big =
//   rna_tf32(x) and small = rna_tf32(x - big) (B2's and B3's split, so the
//   scores, and L, stay within float32 roundoff of the ones they
//   recompute), written swizzled into the tiles wgmma's descriptors name
//   (wgmma_tf32.cuh). V must reach wgmma transposed (tf32 wgmma reads shared
//   memory only K-major, and no copy engine transposes): the producer reads
//   it with 16-byte loads that skip L1, the next tile's while this one is
//   in use, and writes both halves transposed, each 8 keys in the order (0,
//   2, 4, 6, 1, 3, 5, 7) so that P's score fragment serves as wgmma's A
//   operand where it lies.
// - Every product is 3xTF32 on wgmma with a float32 accumulator, the cross
//   terms first over the whole contraction (small * big, then big * small)
//   and big * big last, so that the accumulator takes the small terms while
//   it is small: O's error against a float64 forward is 1.5x the plain
//   version's (3.6x with the three products interleaved per k8 step). S =
//   Q K^T: m64n64k8, both operands from shared memory. P V: m64n{dh}k8, A
//   from the score registers (big by cvt.rna; small = p - big, whose low
//   bits the tensor cores drop).
// - The online softmax runs in float32 on the score registers, in base 2
//   (ex2.approx, as the bf16 B1): row max across the quad by shuffles. Tiles
//   that every query row sees whole skip the mask; elsewhere the mask (keys
//   past seq_len too) selects the score to -inf, never multiplies.
// - O = acc / l, written from the fragments; rows past S are not written;
//   nothing is atomic.
//
// Shared memory (STAGES K and V tiles in flight): Q's two halves (64 rows x
// dh, 2 x 32 KB at dh 128), and per stage a K tile and a transposed V tile,
// each as two halves (2 x 2 x 32 KB at dh 128): 193.1 KB with one stage at
// dh 128 (two would need 321 KB of the card's 227), 161.1 KB with two at
// dh 64. A bulk copy lands in the big half it is split into, so staging
// takes no room. With one stage the producer still overlaps: it splits the
// next K while the consumer runs the softmax and P V, and writes the next V
// while it runs S.
//
// Measured (launch/bench_flash.py, this kernel and the mma.sync kernel in
// turns in one call, one NVIDIA H100 80GB HBM3 at 700 W): 19.39-19.42 us at
// (16, 256, 128) against 38.59-38.66 and SDPA's float32 forward at
// 30.37-30.74; 12.58 us at (6, 256, 64) against 13.41-13.47 (two blocks a
// cluster there: 13.34-13.47). About 4.9 us of each is what any launch
// costs timed this way (a 16-float zero_).
//
// Widths: 64 and 128 run here. 16 and 32 keep the mma.sync kernel: no
// full-width configuration has them (only the smoke configurations, at 32,
// and the tests), so the A/B that would move them was not made.

#include <cmath>

#include "flash_common.cuh"
#include "wgmma_tf32.cuh"

namespace rbr_flash {
namespace {

using namespace rbr_wgmma;

constexpr int BR = TILE_ROWS;    // query rows a cluster owns; keys of a tile
constexpr int THREADS = 2 * WG;  // the consumer warpgroup, then the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
struct FwdF32Geom {
  static constexpr int HALF = BR * DH * 4;  // one TF32 half of a Q, K or transposed V tile
  static constexpr int TILE = 2 * HALF;     // the big half, then the small half
  static constexpr int STAGES = DH > 64 ? 1 : 2;  // K and V tiles in flight (see the header)
  // blocks of a cluster, sharing one query tile's key tiles: four at DH 128
  // would need more blocks than the card's 132 SMs at qwen3_0_6b's shape
  static constexpr int CL = DH > 64 ? 2 : 4;
  static constexpr int NL = DH / 8;         // float4 loads of a producer thread per tile
  // Q landed, Q full; K landed, K full, K empty, V full, V empty a stage;
  // the merge's two
  static constexpr int BARS = 8 * (2 + 5 * STAGES + 2);
  // what a consumer thread sends each other block of the cluster for the
  // merge, into its Q tile at [sender][thread][i]: m and l of its 2 rows,
  // then its sums of that block's columns (4 + DH / 2 / CL floats: 8
  // neighbouring threads' 16-byte stores fall on distinct banks at DH 64
  // and 128)
  static constexpr int STRIDE = 4 + DH / 2 / CL;
  static_assert(STRIDE % 4 == 0 && CL * STRIDE * WG * 4 <= TILE, "the merge fits Q's tile");
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes in the kernel
  static constexpr size_t BYTES = 1024 + TILE + 2 * STAGES * TILE + BARS;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ L,
                     int BH, int S, int seq_len, int causal, int window, float scale) {
  using G = FwdF32Geom<DH>;
  constexpr int ST = G::STAGES, CL = G::CL;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t Qt = base, Kt = base + G::TILE, Vt = Kt + ST * G::TILE;
  const uint32_t bars = Vt + ST * G::TILE, qraw = bars, qfull = bars + 8;
  // a tile "lands" when its raw rows have arrived by bulk copy, and is "full"
  // when its split halves are written
  auto kraw = [&](int s) { return bars + 8 * (2 + s); };
  auto kfull = [&](int s) { return bars + 8 * (2 + ST + s); };
  auto kempty = [&](int s) { return bars + 8 * (2 + 2 * ST + s); };
  auto vfull = [&](int s) { return bars + 8 * (2 + 3 * ST + s); };
  auto vempty = [&](int s) { return bars + 8 * (2 + 4 * ST + s); };
  // the merge's signals: the other blocks are done with their Q tiles, and
  // their states have landed in this one's
  const uint32_t qfree = bars + 8 * (2 + 5 * ST), mfull = qfree + 8;
  if (threadIdx.x == WG) {  // the producer's first thread, which issues the copies
    mbar_init(qraw, 1);  // the issuing thread's arrival, then the copy's bytes
    mbar_init(qfull, WG);  // the other barriers count the 128 threads of a warpgroup
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(kraw(s), 1);
      mbar_init(kfull(s), WG);
      mbar_init(kempty(s), WG);
      mbar_init(vfull(s), WG);
      mbar_init(vempty(s), WG);
    }
    mbar_init(qfree, (CL - 1) * WG);  // the other blocks of the cluster
    mbar_init(mfull, 1);
    fence_barrier_init();
    // the other blocks' 128 threads' states, each G::STRIDE floats (st_async_v4)
    mbar_expect_tx(mfull, (CL - 1) * WG * G::STRIDE * 4);
  }
  __syncthreads();
  // the peer's barriers are initialised before this block first signals it
  // (cluster_wait, below)
  cluster_arrive();

  const int ntiles = (S + BR - 1) / BR;
  const int cluster = blockIdx.x / CL, rank = (int)cluster_rank();
  const int bh = cluster % BH;
  const int q0 = (ntiles - 1 - cluster / BH) * BR;  // late query tiles first
  int lo, hi;
  key_steps<BR, BR>(q0, seq_len, causal, window, lo, hi);
  const int n = max(hi - lo, 0);
  const int mine = n > rank ? (n - rank + CL - 1) / CL : 0;  // tiles lo + rank + CL j
  auto key0 = [&](int j) { return (lo + rank + CL * j) * BR; };
  const long long head = (long long)bh * S * DH;
  const int tid = threadIdx.x % WG;

  // the consumer's running max (base 2), its share of the row sums and its
  // 64 x DH sums
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  if (threadIdx.x >= WG) {
    // the producer. Q and K lie K-major already: one thread copies each
    // tile's raw rows by bulk copy, and the warpgroup splits them in place.
    // V is read by 16-byte loads, the next tile's while this one is used,
    // and written transposed
    auto copy_rows = [&](uint32_t dst, const float* src, int r0, uint32_t bar) {
      if (tid == 0) {
        const uint32_t bytes = min(BR, S - r0) * DH * 4;
        mbar_expect_tx(bar, bytes);
        bulk_load(dst, src + (long long)r0 * DH, bytes, bar);
      }
    };
    copy_rows(Qt, q + head, q0, qraw);
    if (mine > 0) copy_rows(Kt, k + head, key0(0), kraw(0));
    if (ST > 1 && mine > 1) copy_rows(Kt + G::TILE, k + head, key0(1), kraw(1));
    float4 y[G::NL];  // V's next tile
    if (mine > 0) load_t<DH>(y, v + head, key0(0), S, DH, tid);
    mbar_wait(qraw, 0);
    split_in_place<DH>(Qt, G::HALF, S - q0, tid);
    fence_proxy_async();
    mbar_arrive(qfull);
    for (int j = 0; j < mine; ++j) {
      const int s = j % ST;
      mbar_wait(kraw(s), (j / ST) & 1);
      split_in_place<DH>(Kt + s * G::TILE, G::HALF, S - key0(j), tid);
      fence_proxy_async();
      mbar_arrive(kfull(s));
      if (j >= ST) mbar_wait(vempty(s), (j / ST - 1) & 1);
      store_t<DH>(Vt + s * G::TILE, G::HALF, y, tid);
      fence_proxy_async();
      mbar_arrive(vfull(s));
      // the next tiles: V's loads go out, and K's rows land once the
      // consumer is done with the stage
      if (j + 1 < mine) load_t<DH>(y, v + head, key0(j + 1), S, DH, tid);
      if (j + ST < mine) {
        mbar_wait(kempty(s), (j / ST) & 1);
        copy_rows(Kt + s * G::TILE, k + head, key0(j + ST), kraw(s));
      }
    }
    cluster_wait();
    return;
  }

  // the consumer: rows are the cluster's queries, columns a tile's keys
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  int clo[2], chi[2];  // the keys that each of the thread's two rows sees
  fragment_keys(q0, warp, g, S, seq_len, causal, window, clo, chi);
  const float sl2 = scale * LOG2E;  // scores in base 2: p = 2^(s sl2 - m)
  mbar_wait(qfull, 0);
  // done with the Q tile after the last S: the other blocks of the cluster
  // may store their states there
  auto release_q = [&] {
#pragma unroll
    for (int b = 0; b < CL; ++b)
      if (b != rank) mbar_arrive_remote(cluster_addr(qfree, b));
  };
  cluster_wait();  // the cluster's barriers are initialised (long since)
  if (mine == 0) release_q();
  for (int j = 0; j < mine; ++j) {
    const int s = j % ST, k0 = key0(j);
    const uint32_t phase = (j / ST) & 1, Kb = Kt + s * G::TILE, Vb = Vt + s * G::TILE;
    mbar_wait(kfull(s), phase);
    float sc[32];  // S, then P
    wgmma_fence();
    // small * big and big * small over all of dh, then big * big: the
    // accumulator takes the small terms while it is small
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      wgmma_tf32_ss_n64(sc, desc_tf32<BR>(Qt + G::HALF, kk), desc_tf32<BR>(Kb, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      wgmma_tf32_ss_n64(sc, desc_tf32<BR>(Qt, kk), desc_tf32<BR>(Kb + G::HALF, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      wgmma_tf32_ss_n64(sc, desc_tf32<BR>(Qt, kk), desc_tf32<BR>(Kb, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(kempty(s));
    if (j == mine - 1) release_q();

    float mt[2] = {-INFINITY, -INFINITY};
    if (whole_tile<BR>(q0, k0, S, seq_len, causal, window))
      scale_scores<false>(sc, mt, sl2, clo, chi, k0);
    else
      scale_scores<true>(sc, mt, sl2, clo, chi, k0);
    float corr[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four lanes of a quad share rows g and g + 8
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      mu[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p and corr 0
      corr[h] = fast_exp2(m[h] - mu[h]);
      m[h] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      sc[x] = fast_exp2(sc[x] - mu[x % 4 / 2]);
      ps[x % 4 / 2] += sc[x];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= corr[i % 4 / 2];

    // acc += P V in 3xTF32, k8 step by k8 step (V's small half HALF on)
    uint32_t pb[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) a_frag_tf32(pb[kk], pl[kk], sc, kk);
    mbar_wait(vfull(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs<DH>(acc, pl[kk], desc_tf32<DH>(Vb, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_rs<DH>(acc, pb[kk], desc_tf32<DH>(Vb + G::HALF, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs<DH>(acc, pb[kk], desc_tf32<DH>(Vb, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      fence_regs(pb[kk]);
      fence_regs(pl[kk]);
    }
    mbar_arrive(vempty(s));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sums over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // The merge. Block r owns column groups [r CG, (r + 1) CG) of O. Every
  // block stores m, l and its sums of each other block's columns into that
  // block's Q tile, slot r, once every block is done with its Q tile
  // (release_q); each then merges its columns over the blocks in rank
  // order, its own terms from its registers (picked by the loop's block
  // index, never by rank: a register array indexed at run time would go to
  // local memory).
  constexpr int CG = DH / 8 / CL, PART = 4 * CG, STRIDE = G::STRIDE;  // STRIDE = 4 + PART
  mbar_wait_cluster(qfree, 0);
  const uint32_t slot = Qt + 4 * STRIDE * (rank * WG + tid);
#pragma unroll
  for (int b = 0; b < CL; ++b) {
    if (b == rank) continue;
    const uint32_t dst = cluster_addr(slot, b), bar = cluster_addr(mfull, b);
    st_async_v4(dst, bar, make_float4(m[0], m[1], l[0], l[1]));
#pragma unroll
    for (int i = 0; i < PART; i += 4)
      st_async_v4(dst + 16 + 4 * i, bar,
                  make_float4(acc[b * PART + i], acc[b * PART + i + 1], acc[b * PART + i + 2],
                              acc[b * PART + i + 3]));
  }
  mbar_wait(mfull, 0);
  const float* in = reinterpret_cast<const float*>(smem_raw + (Qt - raw)) + STRIDE * tid;
  float f[CL][2];  // each block's factor onto the merged max, by row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mb[CL], mx = -INFINITY;
#pragma unroll
    for (int b = 0; b < CL; ++b) {
      mb[b] = b == rank ? m[h] : in[b * WG * STRIDE + h];
      mx = fmaxf(mx, mb[b]);
    }
    const float mm = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f;
#pragma unroll
    for (int b = 0; b < CL; ++b) {
      f[b][h] = fast_exp2(mb[b] - mm);
      lsum += (b == rank ? l[h] : in[b * WG * STRIDE + 2 + h]) * f[b][h];
    }
    l[h] = lsum;
    m[h] = mx;
  }
  float out[PART];
#pragma unroll
  for (int i = 0; i < PART; ++i) {
    float own = acc[i];  // this block's sums of its columns, by select
#pragma unroll
    for (int c = 1; c < CL; ++c) own = rank == c ? acc[c * PART + i] : own;
    out[i] = 0.f;
#pragma unroll
    for (int b = 0; b < CL; ++b)
      out[i] += (b == rank ? own : in[b * WG * STRIDE + 4 + i]) * f[b][i % 4 / 2];
  }

  o += head;
  L += (long long)bh * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= S) continue;
    const bool live = l[h] > 0.f;
    const float lc = fmaxf(l[h], EPS), inv = live ? 1.f / lc : 0.f;
#pragma unroll
    for (int j = 0; j < CG; ++j)
      *reinterpret_cast<float2*>(o + (long long)r * DH + 8 * (rank * CG + j) + 2 * t) =
          make_float2(out[4 * j + 2 * h] * inv, out[4 * j + 2 * h + 1] * inv);
    if (t == 0 && rank == 0) L[r] = live ? m[h] * LN2 + logf(lc) : NEG_INF;
  }
}

template <int DH>
int launch_fwd_f32(const float* q, const float* k, const float* v, float* o, float* L, int BH,
                   int S, int seq_len, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int CL = FwdF32Geom<DH>::CL;
  return launch_cluster(SLOT_FWD, flash_fwd_f32_kernel<DH>, CL,
                        (long long)CL * BH * ((S + BR - 1) / BR), THREADS,
                        FwdF32Geom<DH>::BYTES, stream, q, k, v, o, L, BH, S, seq_len, causal,
                        window, scale);
}

}  // namespace
}  // namespace rbr_flash

// q, k, v, o: (BH, S, dh) float32 contiguous and 16-byte aligned; L: (BH, S)
// float32. Keys j >= seq_len are masked (seq_len <= S); window < 0 means no
// window. Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int rbr_flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                                 float* L, int BH, int S, int dh, int seq_len, int causal,
                                 int window, float scale, int device, cudaStream_t stream) {
  using namespace rbr_flash;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (dh) {
    case 64:
      return launch_fwd_f32<64>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    case 128:
      return launch_fwd_f32<128>(q, k, v, o, L, BH, S, seq_len, causal, window, scale, stream);
    default:
      return launch_fwd_mma(q, k, v, o, L, BH, S, dh, seq_len, causal, window, scale, stream);
  }
}
